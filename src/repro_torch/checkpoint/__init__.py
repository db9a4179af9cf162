"""Checkpoints in the JAX package's msgpack format (version 2), written and
read by a codec of this package's own (``msgpack_lite``)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    FORMAT_VERSION,
    load_checkpoint,
    save_checkpoint,
)
