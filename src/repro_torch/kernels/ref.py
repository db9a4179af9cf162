"""Plain PyTorch versions of the CUDA kernels: the CPU path of every wrapper
and the yardstick the kernels are held against on the card.

Counterparts of ``repro.kernels.ref`` (the JAX oracles). Every function
takes a stack ``xs (..., n, d)``: the leading axes are partitions, so one
call covers all partitions of the butterfly at once. Each follows its
kernel's dataflow:

* ``centered_clip_ref`` — the two-phase kernel: norms recomputed from x
  every iteration, then the update;
* ``adaptive_step_ref`` — one iteration whose clip weights come from the
  CARRIED squared norms, emitting the next ones as sum ||diff - upd||^2;
* ``centered_clip_fused_ref`` — the fused kernel: a norm prologue, then
  ``adaptive_step_ref`` iterations (the incremental norms, never recomputed
  from x), then the table epilogue. The JAX oracle carries the same
  recurrence in its expanded form; this one uses the kernels' direct form,
  so a fixed budget and an adaptive run at tol = 0 agree bit for bit;
* ``verify_tables_ref`` — the tau-clipped digest and norm in one pass;
* ``digest_tables_ref`` — the verified:* digests, the same without tau;
* ``digest_tables_rows_ref`` — either of the two over the sampled
  partitions ``rows`` only;
* ``mean_digest_fused_ref`` — the weighted mean, then its digests;
* ``dequantize_ref`` and the ``*_dequant_ref`` twins — the same functions
  over int8/bf16 wire payloads, dequantized as ``f32(q) * scale``;
* ``freeze_by_select`` — the early-exit loop of the adaptive budget, shared
  by the adaptive kernel's plain version and ``core.centered_clip``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.norms import vector_norm


def _peer_weights(weights, xs):
    n = xs.shape[-2]
    if weights is None:
        return torch.ones((n,), dtype=torch.float32, device=xs.device)
    return weights.to(torch.float32)


def _clip(norms, tau):
    """min(1, tau / max(norm, 1e-30)); tau = inf -> 1."""
    tau = float(tau)
    if math.isinf(tau):
        return torch.ones_like(norms)
    return torch.clamp(tau / torch.clamp(norms, min=1e-30), max=1.0)


def centered_clip_ref(xs, taus, weights=None, v0=None):
    """Two-phase CenteredClip. xs (..., n, d); taus: per-iteration radii;
    weights (n,); v0 (..., d). Returns v (..., d) f32."""
    xs = xs.to(torch.float32)
    w = _peer_weights(weights, xs)
    wsum = torch.clamp(w.sum(), min=1e-30)
    v = (torch.zeros(xs.shape[:-2] + xs.shape[-1:], dtype=torch.float32,
                     device=xs.device)
         if v0 is None else v0.to(torch.float32))
    for tau in taus:
        diff = xs - v.unsqueeze(-2)
        norms = vector_norm(diff, dim=-1)
        cw = _clip(norms, tau) * w
        v = v + (cw.unsqueeze(-1) * diff).sum(-2) / wsum
    return v


def adaptive_step_ref(xs, v, sq, tau, weights=None):
    """One iteration of the adaptive loop. xs (..., n, d); v (..., d); sq
    (..., n) = ||x_i - v||^2 (the carried state). Returns (v_new, sq_new)."""
    xs = xs.to(torch.float32)
    v = v.to(torch.float32)
    w = _peer_weights(weights, xs)
    wsum = torch.clamp(w.sum(), min=1e-30)
    norms = torch.sqrt(torch.clamp(sq, min=1e-30))
    cw = _clip(norms, tau) * w
    diff = xs - v.unsqueeze(-2)
    upd = (cw.unsqueeze(-1) * diff).sum(-2) / wsum
    nd = diff - upd.unsqueeze(-2)
    return v + upd, (nd * nd).sum(-1)


def freeze_by_select(step, v, carry, tol, max_iters):
    """The adaptive loop over partitions: ``step(v, carry) -> (v_new,
    d2 (P,), carry_new)`` with d2 the step's squared update norm. A
    partition whose last d2 is <= tol^2 is frozen by select (its v and
    carry stop changing) while the others go on; the loop stops when every
    partition is frozen, or after ``max_iters``. v (P, part); carry (P, ...)
    or None. Returns (v, iters (P,) int32)."""
    tol2 = float(np.float32(tol) ** 2)
    d2 = torch.full((v.shape[0],), math.inf, device=v.device)
    iters = torch.zeros((v.shape[0],), dtype=torch.int32, device=v.device)
    for _ in range(max_iters):
        active = d2 > tol2
        if not bool(active.any()):
            break
        v_new, d2_new, carry_new = step(v, carry)
        v = torch.where(active[:, None], v_new, v)
        if carry is not None:
            carry = torch.where(active[:, None], carry_new, carry)
        d2 = torch.where(active, d2_new, d2)
        iters += active.to(torch.int32)
    return v, iters


def sq_norms(xs, v):
    """The norm prologue: ||x_i - v||^2, (..., n)."""
    diff = xs.to(torch.float32) - v.to(torch.float32).unsqueeze(-2)
    return (diff * diff).sum(-1)


def centered_clip_fused_ref(xs, taus, z, tau_v=None, weights=None, v0=None):
    """Fused CenteredClip + Alg. 6 tables. xs (..., n, d); z (..., d).
    Returns (v (..., d), s (..., n), norms (..., n)) f32."""
    xs = xs.to(torch.float32)
    taus = [float(t) for t in taus]
    tau_v = taus[-1] if tau_v is None else float(tau_v)
    v = (torch.zeros(xs.shape[:-2] + xs.shape[-1:], dtype=torch.float32,
                     device=xs.device)
         if v0 is None else v0.to(torch.float32))
    sq = sq_norms(xs, v)
    for tau in taus:
        v, sq = adaptive_step_ref(xs, v, sq, tau, weights)
    norms = torch.sqrt(torch.clamp(sq, min=0.0))
    dots = ((xs - v.unsqueeze(-2)) * z.to(torch.float32).unsqueeze(-2)).sum(-1)
    return v, _clip(norms, tau_v) * dots, norms


def verify_tables_ref(xs, v, z, tau):
    """s_i = min(1, tau/||x_i - v||) <z, x_i - v>, norm_i = ||x_i - v||.
    xs (..., n, d); v, z (..., d). Returns (s, norms), both (..., n)."""
    diff = xs.to(torch.float32) - v.to(torch.float32).unsqueeze(-2)
    norms = vector_norm(diff, dim=-1)
    dots = (diff * z.to(torch.float32).unsqueeze(-2)).sum(-1)
    return _clip(norms, tau) * dots, norms


def digest_tables_ref(xs, v, z):
    """The verified:* digests: s_i = <z, x_i - v>, norm_i = ||x_i - v||
    (no clip weight). xs (..., n, d); v, z (..., d). Returns (s, norms),
    both (..., n)."""
    diff = xs.to(torch.float32) - v.to(torch.float32).unsqueeze(-2)
    dots = (diff * z.to(torch.float32).unsqueeze(-2)).sum(-1)
    return dots, vector_norm(diff, dim=-1)


def digest_tables_rows_ref(xs, v, z, rows, tau=0.0):
    """The digests of the sampled partitions ``rows`` only: for tau > 0
    ``verify_tables_ref`` (the butterfly_clip clip weight, tau = inf ->
    1), else ``digest_tables_ref`` (verified:*). xs (P, n, d); v, z
    (P, d); rows (k,) partition ids. Returns (s, norms), both (k, n);
    row j is partition rows[j]."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=xs.device)
    xs, v, z = xs[rows], v[rows], z[rows]
    if float(tau) > 0:
        return verify_tables_ref(xs, v, z, tau)
    return digest_tables_ref(xs, v, z)


def mean_digest_fused_ref(xs, z, weights=None):
    """verified:mean: v = sum_i w_i x_i / max(sum_i w_i, 1e-30), then the
    digests against it. xs (..., n, d); z (..., d); weights (n,).
    Returns (v (..., d), s (..., n), norms (..., n)) f32."""
    xs = xs.to(torch.float32)
    w = _peer_weights(weights, xs)
    v = (w[:, None] * xs).sum(-2) / torch.clamp(w.sum(), min=1e-30)
    s, norms = digest_tables_ref(xs, v, z)
    return v, s, norms


def dequantize_ref(wire, scales):
    """Wire payloads -> f32: upcast, then one f32 multiply by the payload's
    scale (``core.compression.dequantize``). wire (..., d) int8/bf16;
    scales (...)."""
    return wire.to(torch.float32) * scales.to(torch.float32)[..., None]


def centered_clip_fused_dequant_ref(qs, scales, taus, z, tau_v=None,
                                    weights=None, v0=None):
    """``centered_clip_fused_ref`` over dequantized wire payloads.
    qs (..., n, d) int8/bf16; scales (..., n)."""
    return centered_clip_fused_ref(dequantize_ref(qs, scales), taus, z,
                                   tau_v=tau_v, weights=weights, v0=v0)


def mean_digest_fused_dequant_ref(qs, scales, z, weights=None):
    """``mean_digest_fused_ref`` over dequantized wire payloads."""
    return mean_digest_fused_ref(dequantize_ref(qs, scales), z, weights)
