from repro_torch.optim.optimizers import apply_updates, sgd  # noqa: F401
