"""CenteredClip (Karimireddy et al. 2020) — the robust mean at BTARD's heart.

Fixed-point iteration (paper eq. (CenteredClip)):
    v_{l+1} = v_l + (1/n) sum_i (x_i - v_l) * min(1, tau_l / ||x_i - v_l||)

tau -> inf recovers the mean; tau -> 0 approaches the geometric median.
``weights`` masks banned peers (Alg. 7 bans). Counterpart of
``repro.core.centered_clip``: the stacked framework-level forms over
``(P, n, part)`` partitions. The protocol path runs the kernels
(``kernels.ops``); these are the algorithm as written, shared by the fixed
and adaptive budgets so that adaptive at tol = 0 reproduces the fixed
budget bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _clip_weights(diff_norm, tau):
    """min(1, tau/||.||), safe at 0; tau=inf -> 1."""
    if math.isinf(float(tau)):
        return torch.ones_like(diff_norm)
    return torch.clamp(float(tau) / torch.clamp(diff_norm, min=1e-30),
                       max=1.0)


def _stacked_update(xs, v, tau, weights, wsum):
    """One CenteredClip iteration over stacked partitions.

    xs: (P, n, part) f32; v: (P, part) f32 -> the update (P, part) f32.
    The single update rule of the fixed and adaptive loops."""
    diff = xs - v[:, None, :]
    norms = torch.linalg.vector_norm(diff, dim=2)  # (P, n)
    cw = _clip_weights(norms, tau) * weights[None, :]
    return (cw[..., None] * diff).sum(1) / wsum


def _stacked_args(stacked, weights, v0):
    P, n, part = stacked.shape
    if weights is None:
        weights = torch.ones((n,), dtype=torch.float32, device=stacked.device)
    weights = weights.to(torch.float32)
    wsum = torch.clamp(weights.sum(), min=1e-30)
    v = (torch.zeros((P, part), dtype=torch.float32, device=stacked.device)
         if v0 is None else v0.to(torch.float32))
    return stacked.to(torch.float32), weights, wsum, v


def centered_clip_stacked(stacked, tau, n_iters: int = 20, weights=None,
                          v0=None):
    """Batched CenteredClip: (P, n, part) -> (P, part). tau: a scalar or an
    (n_iters,) schedule."""
    xs, weights, wsum, v = _stacked_args(stacked, weights, v0)
    taus = np.broadcast_to(np.asarray(tau, np.float32), (n_iters,))
    for tau_l in taus:
        v = v + _stacked_update(xs, v, tau_l, weights, wsum)
    return v


def centered_clip_adaptive_stacked(stacked, tau, tol, max_iters: int,
                                   weights=None, v0=None):
    """Adaptive-budget CenteredClip: iterate until ``||v_{l+1} - v_l|| <=
    tol`` PER PARTITION, at most ``max_iters`` times. A converged partition
    is frozen while the others go on (per-partition results equal
    independent loops). Returns (v (P, part), iters (P,) int32)."""
    xs, weights, wsum, v = _stacked_args(stacked, weights, v0)
    P = xs.shape[0]
    tol2 = float(np.float32(tol) ** 2)
    d2 = torch.full((P,), math.inf, device=xs.device)
    iters = torch.zeros((P,), dtype=torch.int32, device=xs.device)
    for _ in range(max_iters):
        active = d2 > tol2
        if not bool(active.any()):
            break
        upd = _stacked_update(xs, v, tau, weights, wsum)
        v = torch.where(active[:, None], v + upd, v)
        d2 = torch.where(active, (upd * upd).sum(-1), d2)
        iters += active.to(torch.int32)
    return v, iters


def clip_residuals(xs, v, tau):
    """Delta_i = (x_i - v) * min(1, tau/||x_i - v||)  (paper Alg. 1 L7).

    At the exact fixed point sum_i Delta_i = 0 — the basis of Verification 2.
    """
    diff = xs - v[None, :]
    norms = torch.linalg.vector_norm(diff.to(torch.float32), dim=1)
    return diff * _clip_weights(norms, tau)[:, None]
