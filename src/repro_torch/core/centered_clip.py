"""CenteredClip (Karimireddy et al. 2020) — the robust mean at BTARD's heart.

Fixed-point iteration (paper eq. (CenteredClip)):
    v_{l+1} = v_l + (1/n) sum_i (x_i - v_l) * min(1, tau_l / ||x_i - v_l||)

with the paper's tau schedule eq. (5):
    tau_l = 4 * sqrt((1 - delta) * (B_l^2/3 + sigma^2) / (sqrt(3) * delta))
    B_{l+1}^2 = 6.45 * delta * B_l^2 + 5 * sigma^2

tau -> inf recovers the mean; tau -> 0 approaches the geometric median.
``weights`` masks banned peers (Alg. 7 bans). Counterpart of
``repro.core.centered_clip``:

* ``centered_clip`` — the fixed budget over one ``(n, d)`` stack: kernel
  #12 (``kernels.ops.centered_clip_op``) on a CUDA tensor, its plain
  version on a CPU one;
* ``centered_clip_to_tol`` and the adaptive forms — framework-level loops,
  plain torch on both devices; the stacked forms over ``(P, n, part)``
  partitions share one update rule, so adaptive at tol = 0 reproduces the
  fixed budget bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.norms import vector_norm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import freeze_by_select


def tau_schedule(delta: float, sigma: float, n_iters: int, b0: float = 0.0):
    """Paper eq. (5). delta=0 => tau = inf (plain mean)."""
    taus = []
    b2 = float(b0) ** 2
    for _ in range(n_iters):
        if delta <= 0.0:
            taus.append(np.inf)
        else:
            taus.append(4.0 * np.sqrt((1.0 - delta) * (b2 / 3.0 + sigma**2)
                                      / (np.sqrt(3.0) * delta)))
        b2 = 6.45 * delta * b2 + 5.0 * sigma**2
    return np.asarray(taus, np.float32)


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
    norms = vector_norm(diff, dim=2)  # (P, n)
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

    def step(v, _):
        upd = _stacked_update(xs, v, tau, weights, wsum)
        return v + upd, (upd * upd).sum(-1), None

    return freeze_by_select(step, v, None, tol, max_iters)


def centered_clip_adaptive(xs, tau, tol, max_iters: int, weights=None,
                           v0=None):
    """Single-partition adaptive CenteredClip: (n, d) -> ((d,) f32, iters);
    :func:`centered_clip_adaptive_stacked` at one partition."""
    v, iters = centered_clip_adaptive_stacked(
        torch.as_tensor(xs)[None], tau, tol, max_iters, weights=weights,
        v0=None if v0 is None else torch.as_tensor(v0)[None])
    return v[0], int(iters[0])


def centered_clip(xs, tau, n_iters: int = 20, weights=None, v0=None):
    """Robust aggregate of ``xs``: (n, d) -> (d,) f32, ``n_iters``
    iterations from v0 (zero by default, or the caller's warm start).

    tau: a scalar or an (n_iters,) schedule. weights: optional (n,) peer
    mask (0 = banned). The iteration runs in f32 whatever the input dtype
    (float32 or bfloat16): kernel #12 on a CUDA tensor, which widens a bf16
    stack in registers, and its plain version on a CPU one."""
    return ops.centered_clip_op(torch.as_tensor(xs), tau, weights, v0,
                                n_iters=n_iters)


def centered_clip_to_tol(xs, tau, eps: float = 1e-6, max_iters: int = 200,
                         weights=None, v0=None):
    """Run CenteredClip until ||v_{l+1} - v_l|| <= eps or ``max_iters``
    (paper §4.1 runs 'iterative algorithms to convergence with eps=1e-6').

    The iterate stays in the input's dtype; the norms are taken in f32.
    v0: optional warm start (e.g. last step's aggregate): the fixed point
    is unique for tau > 0, so it changes the iteration count, never the
    limit. Returns (v (d,), iters)."""
    xs = torch.as_tensor(xs)
    n, d = xs.shape
    if weights is None:
        weights = torch.ones((n,), dtype=xs.dtype, device=xs.device)
    wsum = torch.clamp(weights.sum(), min=1e-30)
    v = (torch.zeros((d,), dtype=xs.dtype, device=xs.device) if v0 is None
         else v0.to(xs.dtype))
    eps32 = float(np.float32(eps))  # the reference compares in float32
    tau32 = float(np.float32(tau))
    delta, iters = float("inf"), 0
    while delta > eps32 and iters < max_iters:
        diff = xs - v[None, :]
        norms = vector_norm(diff.to(torch.float32), dim=1)
        cw = _clip_weights(norms, tau32) * weights
        step = (cw[:, None] * diff).sum(0) / wsum
        v = (v + step).to(xs.dtype)
        delta = float(vector_norm(step.to(torch.float32)))
        iters += 1
    return v, iters


def clip_residuals(xs, v, tau):
    """Delta_i = (x_i - v) * min(1, tau/||x_i - v||)  (paper Alg. 1 L7).

    At the exact fixed point sum_i Delta_i = 0 — the basis of Verification 2.
    """
    diff = xs - v[None, :]
    norms = vector_norm(diff.to(torch.float32), dim=1)
    return diff * _clip_weights(norms, tau)[:, None]
