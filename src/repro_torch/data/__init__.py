from repro_torch.data.pipeline import TokenPipeline, peer_key  # noqa: F401
