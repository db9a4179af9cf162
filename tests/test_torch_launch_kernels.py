"""Kernels #10 and #11 of the port on the CPU: the plain versions of
``centered_clip_fused`` and ``verify_tables`` (one partition owner's
fused CenteredClip + tables, and its tables against a given aggregate),
reached through ``repro_torch.kernels.ops`` as the launch path calls them,
against the JAX package's ``centered_clip_fused_pallas`` and
``verify_tables_pallas`` in interpret mode, in process, as
tests/test_fused_kernels.py runs them.

n in {1, 3, 4, 8} peers, a ragged partition (not a multiple of 128),
weights with a zero, a warm start v0 and a separate table radius tau_v.
Tolerance rtol = atol = 1e-5, the reference's own kernel tolerance: the two
frameworks sum in different orders. The card-only checks (kernel against
plain, bitwise repeat) are in tests/test_torch_cuda.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import centered_clip as jkc
from repro_torch.kernels import centered_clip as tkc
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)
PART = 300  # ragged: not a multiple of the 128 lanes
NS = [1, 3, 4, 8]


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed + n)
    xs = (rng.standard_normal((n, PART)) * 0.1).astype(np.float32)
    xs[-1] *= 10.0  # one outlier peer, so the clip matters
    z = rng.standard_normal(PART).astype(np.float32)
    z /= np.linalg.norm(z)
    v0 = (rng.standard_normal(PART) * 0.05).astype(np.float32)
    w = np.ones(n, np.float32)
    if n > 1:
        w[n // 2] = 0.0  # a banned peer
    return xs, z, v0, w


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("tau", [0.1, 1.0, math.inf])
@pytest.mark.parametrize("warm", [False, True])
def test_centered_clip_fused_plain_matches_pallas(n, tau, warm):
    xs, z, v0, w = _inputs(n)
    n_iters = 5
    jagg, js, jn = jkc.centered_clip_fused_pallas(
        jnp.asarray(xs), jnp.full((n_iters,), tau, jnp.float32),
        jnp.asarray(z), weights=jnp.asarray(w),
        v0=jnp.asarray(v0) if warm else None, interpret=True)
    before = dict(tkc.LAUNCHES)
    tagg, ts, tn = tops.centered_clip_fused_op(
        torch.from_numpy(xs), tau, torch.from_numpy(z), torch.from_numpy(w),
        v0=torch.from_numpy(v0) if warm else None, n_iters=n_iters)
    assert tkc.LAUNCHES == before, "a CPU tensor must not reach a kernel"
    assert tagg.shape == (PART,) and ts.shape == tn.shape == (n,)
    for t, j in ((tagg, jagg), (ts, js), (tn, jn)):
        _close(t, j)


@pytest.mark.parametrize("n", NS)
def test_centered_clip_fused_plain_with_table_radius_matches_pallas(n):
    xs, z, v0, w = _inputs(n, seed=7)
    taus = np.asarray([2.0, 1.0, 0.5], np.float32)
    out_j = jkc.centered_clip_fused_pallas(
        jnp.asarray(xs), jnp.asarray(taus), jnp.asarray(z), tau_v=0.25,
        weights=jnp.asarray(w), v0=jnp.asarray(v0), interpret=True)
    out_t = tkc.centered_clip_fused(
        torch.from_numpy(xs), taus.tolist(), torch.from_numpy(z),
        tau_v=0.25, weights=torch.from_numpy(w), v0=torch.from_numpy(v0))
    for t, j in zip(out_t, out_j):
        _close(t, j)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("tau", [0.1, 1.0, math.inf])
def test_verify_tables_plain_matches_pallas(n, tau):
    xs, z, v, _ = _inputs(n, seed=3)
    js, jn = jkc.verify_tables_pallas(jnp.asarray(xs), jnp.asarray(v),
                                      jnp.asarray(z), tau, interpret=True)
    before = dict(tkc.LAUNCHES)
    ts, tn = tops.verify_tables_op(torch.from_numpy(xs), torch.from_numpy(v),
                                   torch.from_numpy(z), tau)
    assert tkc.LAUNCHES == before
    _close(ts, js)
    _close(tn, jn)


def test_single_partition_plain_equals_batched_plain_at_one_partition():
    """#10/#11's plain versions are #1/#2's at n_parts = 1, bit for bit:
    the launch owner's stack read as one partition."""
    xs, z, v0, w = map(torch.from_numpy, _inputs(4, seed=11))
    a = tkc.centered_clip_fused(xs, [1.0] * 4, z, weights=w, v0=v0)
    b = tkc.butterfly_clip_fused(xs, 1, [1.0] * 4, z[None], weights=w,
                                 v0=v0[None])
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))
    a = tkc.verify_tables(xs, v0, z, 1.0)
    b = tkc.verify_tables_batched(xs, 1, v0[None], z[None], 1.0)
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))


def test_single_partition_wrappers_refuse_bad_shapes():
    xs = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        tkc._one_partition(torch.zeros((3, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        tkc._one_partition(xs, torch.zeros(7))
    with pytest.raises(ValueError):
        tkc._one_partition(torch.zeros(8))
