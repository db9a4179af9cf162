"""Weights across the two packages.

``from_jax_params`` maps a JAX parameter tree (``Model.init_params`` of
the JAX package, leaves converted to numpy arrays, bf16 as ml_dtypes'
bfloat16) onto the port's parameters: the same nested names, shapes and
dtypes, so both packages compute the same loss and ``FlatBoundary`` gives
the same flat vector bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(leaf, device):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # reinterpret the 16 bits: no numeric conversion, so no rounding
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_params(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    return _tensor(tree, device)
