"""ButterflyClip (paper Alg. 2/5) and the Alg. 6 verification tables over
the stacked peer gradients ``G (n, d)``.

Counterpart of ``repro.core.butterfly``. Partition j of peer i is the
slice ``G[i, j*part:(j+1)*part]`` with ``part = ceil(d / n)``; the JAX
package materializes the zero-padded ``(n, n_parts, part)`` stack and its
``(n_parts, n, part)`` transpose, while here the kernels read the slices
straight out of ``G`` (``kernels.centered_clip``). So these functions take
``G`` itself and return no ``parts``; ``split_parts`` is kept for the
plain versions and the tests.

The aggregation and table computations go through ``kernels.ops``, which
runs the CUDA kernels on a CUDA tensor and their plain versions on a CPU
one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.norms import vector_norm
from repro_torch.kernels import centered_clip as kc
from repro_torch.kernels import ops


def pad_to_parts(d: int, n: int) -> int:
    return kc.part_len(d, n) * n


def split_parts(grads, n_parts):
    """(n, d) -> (n, n_parts, part) with zero padding (a view when d is a
    multiple of n_parts, a copy otherwise)."""
    return kc.stacked(grads, n_parts).transpose(0, 1)


def merge_parts(agg, d):
    """(n_parts, part) -> (d,)."""
    return agg.reshape(-1)[:d]


def butterfly_clip(grads, tau, n_iters: int = 50, weights=None, v0=None):
    """Per-partition CenteredClip without tables (the two-phase kernel).
    Returns agg (n_parts, part)."""
    return ops.butterfly_clip_op(grads, grads.shape[0], tau, weights, v0,
                                 n_iters=n_iters)


def butterfly_clip_adaptive(grads, tau, tol, max_iters: int, weights=None,
                            v0=None):
    """Early-exit CenteredClip: each partition iterates until
    ``||v_{l+1} - v_l|| <= tol`` or ``max_iters``. Returns (agg, iters)."""
    return ops.butterfly_clip_adaptive_op(grads, grads.shape[0], tau, tol,
                                          weights, v0, max_iters=max_iters)


def butterfly_clip_verified_adaptive(grads, tau, z, tol, max_iters: int,
                                     weights=None, v0=None):
    """Early-exit aggregation, then the Alg. 6 tables computed once against
    the final aggregate. Returns (agg, s (n, n_parts), norms, iters)."""
    return ops.butterfly_clip_fused_adaptive_op(
        grads, grads.shape[0], tau, z, tol, weights, v0, max_iters=max_iters)


def _clip_verified_fixed(grads, tau, z, n_iters: int = 50, weights=None,
                         v0=None):
    """Fixed-budget aggregation and the Alg. 6 tables together (the fused
    kernel, n_iters + 2 passes of G). Returns (agg, s, norms)."""
    return ops.butterfly_clip_fused_op(grads, grads.shape[0], tau, z,
                                       weights, v0=v0, n_iters=n_iters)


def clip_aggregate(grads, tau, n_iters: int, *, z=None, adaptive_tol=None,
                   weights=None, v0=None):
    """The four ButterflyClip branches: fixed or adaptive budget, with
    (``z`` given) or without the tables.

    Returns (agg (n_parts, part), s, norms, iters); s/norms are None when
    z is None; iters is the largest budget any partition ran (an int).
    """
    if z is None:
        if adaptive_tol is not None:
            agg, it = butterfly_clip_adaptive(grads, tau, adaptive_tol,
                                              n_iters, weights, v0)
            return agg, None, None, int(it.max())
        agg = butterfly_clip(grads, tau, n_iters, weights, v0)
        return agg, None, None, n_iters
    if adaptive_tol is not None:
        agg, s, norms, it = butterfly_clip_verified_adaptive(
            grads, tau, z, adaptive_tol, n_iters, weights, v0)
        return agg, s, norms, int(it.max())
    agg, s, norms = _clip_verified_fixed(grads, tau, z, n_iters, weights, v0)
    return agg, s, norms, n_iters


def get_random_directions(seed, n_parts: int, part: int):
    """z[j]: one unit vector per partition from the MPRNG seed (Alg. 1 L5).
    ``seed`` is an integer (tensor) or an already-made key."""
    key = seed if (isinstance(seed, torch.Tensor) and seed.shape == (2,)) \
        else prng.key(seed)
    z = prng.normal(key, (n_parts, part))  # in blocks: prng.NORMAL_BLOCK
    return z.div_(torch.clamp(vector_norm(z, dim=1, keepdim=True),
                              min=1e-30))


def verification_tables(grads, agg, z, tau):
    """Alg. 6 tables against a given aggregate: s[i, j] = <z_j, Delta_i^j>
    with the tau-clipped residual, norm[i, j] = ||x_i^j - v_j||.
    Returns (s, norms), both (n, n_parts)."""
    return ops.verify_tables_all_op(grads, grads.shape[0], agg, z, tau)


def checksum_violations(s, weights, tol):
    """Verification 2 checksum: |sum_i s_i^j| per partition (Alg. 1 L14).
    s (n, n_parts). Returns (sums (n_parts,), violated (n_parts,) bool)."""
    w = s if weights is None else s * weights[:, None]
    sums = w.sum(0)
    return sums, sums.abs() > tol


def delta_max_votes(norms, weights, delta_max):
    """Verification 3: the number of active peers whose partition residual
    exceeds Delta_max; a majority vote triggers CHECKAVERAGING(j).
    Returns (votes (n_parts,), majority (n_parts,) bool)."""
    active = (norms.shape[0] if weights is None
              else torch.clamp(weights.sum(), min=1.0))
    check = norms > delta_max  # (n, n_parts)
    if weights is not None:
        check = check & (weights[:, None] > 0)
    votes = check.sum(0)
    return votes, votes > active / 2.0


def checksum_offender_peers(checksums, rel: float = 1e-2):
    """The aggregating peers of violated Verification 2 checksums: partition
    j is aggregated by peer j (Alg. 2), so |checksum_j| above ``rel`` times
    (1 + the mean magnitude) implicates peer j. Host-side (numpy in, numpy
    out): the launcher's ban policy. Returns the offending peer indices."""
    if isinstance(checksums, torch.Tensor):
        checksums = checksums.detach().cpu().numpy()
    cs = np.abs(np.asarray(checksums, np.float32))
    return np.nonzero(cs > rel * (1.0 + cs.mean()))[0]


def checksum_tolerance(agg, grads, rel=1e-3):
    """Tolerance of the Verification 2 zero checksum: ``rel`` times the mean
    norm of the (peer, partition) slices of ``grads`` (the zero-padded
    slices of the JAX package have the same norms)."""
    n, d = grads.shape
    P = agg.shape[0]
    part = agg.shape[1]
    full = min(P, d // part)  # partitions that lie wholly inside d
    norms = torch.zeros((n, P), dtype=torch.float32, device=grads.device)
    if full:
        body = grads[:, :full * part].reshape(n, full, part)
        norms[:, :full] = vector_norm(body, dim=-1)
    if full < P:
        norms[:, full] = vector_norm(grads[:, full * part:],
                                                  dim=-1)
    return rel * torch.clamp(norms.mean(), min=1e-6)
