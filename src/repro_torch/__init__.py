"""BTARD in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The counterpart of the JAX package ``repro``, ported slice by slice under
the same module names. It imports neither ``jax`` nor ``repro``: what it
needs from there it keeps in its own copy.

Entry points (``lm_setup``, ``init_state``, ``BTARDTrainer``, the
``launch.train_byzantine`` command) run on the CUDA device unless the
caller asks for the CPU (``device="cpu"``), which is what the parity tests
do. Below them, every kernel wrapper dispatches on the device of the tensor
it is given: a CUDA tensor launches the kernel, a CPU tensor runs its plain
PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (or implied) and no CUDA device exists:
    nothing falls back to the CPU without being asked.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
