from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adam,
    apply_updates,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    global_norm,
    lamb,
    sgd,
    warmup_cosine_schedule,
)
