from repro_torch.data.pipeline import (  # noqa: F401
    TokenPipeline, classification_batch, peer_key, peer_seed)
