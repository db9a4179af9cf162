"""Public wrappers around the CenteredClip kernels, named as
``repro.kernels.ops``.

The peer stack is the (n, d) gradient matrix, or its (n, d) int8/bf16
wire payloads with (n_parts, n) scales, read as ``n_parts`` partitions
(``kernels.centered_clip``); s/norms come back transposed to the
(peer, partition) layout of ``core.butterfly.verification_tables``. The
device of ``grads`` decides the path: a CUDA tensor runs the kernels, a CPU
tensor the plain versions. There is no switch beside that.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import centered_clip as _k


def centered_clip_op(xs, tau, weights=None, v0=None, *, n_iters: int = 20):
    """Kernel-backed single-partition CenteredClip (#12): xs (n, d) f32 or
    bf16, tau a scalar or an (n_iters,) schedule, broadcast to n_iters
    float32 radii -> v (d,) f32. v0: optional (d,) warm start."""
    taus = np.broadcast_to(np.asarray(tau, np.float32), (n_iters,))
    return _k.centered_clip(xs, taus.tolist(), weights, v0)


def centered_clip_fused_op(xs, tau, z, weights=None, tau_v=None, v0=None, *,
                           n_iters: int = 20):
    """One owner's fused CenteredClip + Alg. 6 tables: xs (n, part) f32,
    z (part,) -> (agg (part,), s (n,), norms (n,)). v0: optional (part,)
    warm start."""
    return _k.centered_clip_fused(xs, [tau] * n_iters, z, tau_v=tau_v,
                                  weights=weights, v0=v0)


def verify_tables_op(xs, v, z, tau):
    """One owner's tables against a given aggregate (one pass): xs (n, part),
    v, z (part,) -> (s (n,), norms (n,))."""
    return _k.verify_tables(xs, v, z, tau)


def butterfly_clip_op(grads, n_parts, tau, weights=None, v0=None, *,
                      n_iters: int = 20):
    """Two-phase all-partition CenteredClip -> agg (n_parts, part)."""
    return _k.butterfly_clip(grads, n_parts, [tau] * n_iters, weights, v0)


def butterfly_clip_fused_op(grads, n_parts, tau, z, weights=None, tau_v=None,
                            v0=None, *, n_iters: int = 20):
    """Fused aggregation + Alg. 6 tables: -> (agg (n_parts, part),
    s (n, n_parts), norms (n, n_parts))."""
    agg, s, norms = _k.butterfly_clip_fused(
        grads, n_parts, [tau] * n_iters, z, tau_v=tau_v, weights=weights,
        v0=v0,
    )
    return agg, s.T, norms.T


def butterfly_clip_adaptive_op(grads, n_parts, tau, tol, weights=None,
                               v0=None, *, max_iters: int = 60):
    """Early-exit aggregation -> (agg (n_parts, part), iters (n_parts,))."""
    return _k.butterfly_clip_adaptive(grads, n_parts, tau, tol, max_iters,
                                      weights, v0)


def butterfly_clip_fused_adaptive_op(grads, n_parts, tau, z, tol,
                                     weights=None, v0=None, *,
                                     max_iters: int = 60):
    """Early-exit aggregation, then ONE table pass against the final
    aggregate -> (agg, s (n, n_parts), norms (n, n_parts), iters)."""
    agg, iters = _k.butterfly_clip_adaptive(grads, n_parts, tau, tol,
                                            max_iters, weights, v0)
    s, norms = _k.verify_tables_batched(grads, n_parts, agg, z, tau)
    return agg, s.T, norms.T, iters


def verify_tables_all_op(grads, n_parts, agg, z, tau):
    """All-partition tables against a given aggregate (one pass) ->
    (s (n, n_parts), norms (n, n_parts))."""
    s, norms = _k.verify_tables_batched(grads, n_parts, agg, z, tau)
    return s.T, norms.T


def digest_tables_all_op(grads, n_parts, agg, z):
    """All-partition verified:* digests against a given aggregate (one
    pass, no clip weight) -> (s (n, n_parts), norms (n, n_parts))."""
    s, norms = _k.digest_tables_batched(grads, n_parts, agg, z)
    return s.T, norms.T


def mean_digest_fused_op(grads, n_parts, z, weights=None):
    """verified:mean's aggregation and digests in one read of the stack ->
    (agg (n_parts, part), s (n, n_parts), norms (n, n_parts))."""
    agg, s, norms = _k.mean_digest_fused(grads, n_parts, z, weights)
    return agg, s.T, norms.T


def butterfly_clip_fused_dequant_op(qs, scales, n_parts, tau, z,
                                    weights=None, tau_v=None, v0=None, *,
                                    n_iters: int = 20):
    """``butterfly_clip_fused_op`` over wire payloads: qs (n, d) int8/bf16,
    scales (n_parts, n) f32 -> (agg, s (n, n_parts), norms (n, n_parts))."""
    agg, s, norms = _k.butterfly_clip_fused_dequant(
        qs, scales, n_parts, [tau] * n_iters, z, tau_v=tau_v,
        weights=weights, v0=v0)
    return agg, s.T, norms.T


def mean_digest_fused_dequant_op(qs, scales, n_parts, z, weights=None):
    """``mean_digest_fused_op`` over wire payloads: qs (n, d) int8/bf16,
    scales (n_parts, n) f32 -> (agg, s (n, n_parts), norms (n, n_parts))."""
    agg, s, norms = _k.mean_digest_fused_dequant(qs, scales, n_parts, z,
                                                 weights)
    return agg, s.T, norms.T


def digest_tables_rows_op(grads, n_parts, agg, z, rows, tau=0.0):
    """The digests of the sampled partitions ``rows`` (k,) only, in one
    pass of those k partitions: tau > 0 applies the clip weight, tau = 0
    gives the plain verified:* digests -> (s (n, k), norms (n, k)), column
    j = partition rows[j]."""
    s, norms = _k.digest_tables_rows(grads, n_parts, agg, z, rows, tau)
    return s.T, norms.T
