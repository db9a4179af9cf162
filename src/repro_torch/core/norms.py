"""Euclidean norms of the port, accurate in float32 on the CPU.

On the CPU, torch's float32 ``linalg.vector_norm`` accumulates far less
accurately than a pairwise sum: it errs by about 2.4e-5 relative over rows
of 1.6e6 elements and by 3.7e-4 over 1e7, where a reduced LM's gradient
rows lie. The protocol's clip weights, tables and |g_hat| inherit that
error, so the port takes every norm from ``vector_norm`` here: on the CPU
the squares are accumulated in float64 (each float32 square is exact
there) and the root is rounded once to the input's dtype, within about
6e-8 of the exact norm. On the card torch's own float32 reduction is kept:
a tree over the columns, accurate to float32 rounding, with no temporary
the size of its input (the protocol step normalises a (4, 4.3e8) z in
place), and the bits it always had.
"""
from __future__ import annotations

import torch


def vector_norm(x, dim=None, keepdim=False):
    """The 2-norm of ``x`` over ``dim`` (an int, or None for all of it), in
    ``x``'s dtype; ``torch.linalg.vector_norm``'s signature and shapes."""
    if x.device.type != "cpu":
        return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim,
                                    dtype=torch.float64).to(x.dtype)
