"""Kernels #1-#4 of the port on the CPU (their plain versions, reached
through repro_torch.kernels.ops dispatch) against the JAX package's Pallas
kernels in interpret mode and its kernels/ref.py oracles; plus the
framework-level CenteredClip and ButterflyClip functions against their JAX
counterparts.

Shapes are ragged (part not a multiple of 128), tau in {0.1, 1, inf},
weights with zeros (banned peers and validators), with and without a warm
start. Tolerance rtol = atol = 1e-5, the reference's own
(tests/test_fused_kernels.py): the two frameworks sum in different orders.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import butterfly as tbf
from repro_torch.core import centered_clip as tcc
from repro_torch.kernels import centered_clip as tkc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the module, not the function repro.core re-exports under the same name
jcc = importlib.import_module("repro.core.centered_clip")

TOL = dict(rtol=1e-5, atol=1e-5)
N, D = 4, 4 * 300 - 7  # part = 300: ragged, not a multiple of 128
K = 8
TAUS = [0.1, 1.0, math.inf]
WEIGHTS = {
    "all": None,
    "banned": np.array([1.0, 1.0, 0.0, 1.0], np.float32),
    "banned_and_validator": np.array([0.0, 1.0, 0.0, 1.0], np.float32),
}


def _inputs(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    part = -(-d // n)
    G = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    G[-1] *= 10.0  # one outlier peer, so the clip matters
    z = rng.standard_normal((n, part)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    v0 = (rng.standard_normal((n, part)) * 0.05).astype(np.float32)
    agg = (rng.standard_normal((n, part)) * 0.05).astype(np.float32)
    return G, z, v0, agg


def _jparts(G):
    """The JAX package's (n_parts, n, part) zero-padded stack."""
    return jnp.swapaxes(jbf.split_parts(jnp.asarray(G), G.shape[0]), 0, 1)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("wkey", list(WEIGHTS))
def test_fused_kernel_matches_jax(wkey, warm):
    """#1 butterfly_clip_fused: aggregate and both tables, every tau."""
    G, z, v0, _ = _inputs()
    w = WEIGHTS[wkey]
    v0 = v0 if warm else None
    before = dict(tkc.LAUNCHES)
    for tau in TAUS:
        ja, js, jn = jops.butterfly_clip_fused_op(
            _jparts(G), tau, jnp.asarray(z),
            None if w is None else jnp.asarray(w),
            v0=None if v0 is None else jnp.asarray(v0), n_iters=K)
        ta, ts, tn = tops.butterfly_clip_fused_op(
            _t(G), N, tau, _t(z), _t(w), v0=_t(v0), n_iters=K)
        _close(ta, ja)
        _close(ts, js)
        _close(tn, jn)
    assert tkc.LAUNCHES == before, "a CPU tensor must not reach a kernel"


@pytest.mark.parametrize("wkey", list(WEIGHTS))
def test_verify_tables_kernel_matches_jax(wkey):
    """#2 verify_tables_batched against a given (corrupted) aggregate."""
    G, z, _, agg = _inputs(1)
    for tau in TAUS:
        js, jn = jops.verify_tables_all_op(_jparts(G), jnp.asarray(agg),
                                           jnp.asarray(z), tau)
        ts, tn = tops.verify_tables_all_op(_t(G), N, _t(agg), _t(z), tau)
        _close(ts, js)
        _close(tn, jn)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("wkey", list(WEIGHTS))
def test_adaptive_kernel_matches_jax(wkey, warm):
    """#3 adaptive loop (+ #2 epilogue): the same iteration counts per
    partition, the aggregate and the tables within tolerance."""
    G, z, v0, _ = _inputs(2)
    w = WEIGHTS[wkey]
    v0 = v0 if warm else None
    for tau in TAUS:
        ja, js, jn, ji = jops.butterfly_clip_fused_adaptive_op(
            _jparts(G), tau, jnp.asarray(z), 1e-3,
            None if w is None else jnp.asarray(w),
            v0=None if v0 is None else jnp.asarray(v0), max_iters=K)
        ta, ts, tn, ti = tops.butterfly_clip_fused_adaptive_op(
            _t(G), N, tau, _t(z), 1e-3, _t(w), _t(v0), max_iters=K)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(ta, ja)
        _close(ts, js)
        _close(tn, jn)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("wkey", list(WEIGHTS))
def test_two_phase_kernel_matches_jax(wkey, warm):
    """#4 butterfly_clip: norms recomputed from x every iteration."""
    G, _, v0, _ = _inputs(3)
    w = WEIGHTS[wkey]
    v0 = v0 if warm else None
    for tau in TAUS:
        ja = jops.butterfly_clip_op(
            _jparts(G), tau, None if w is None else jnp.asarray(w),
            None if v0 is None else jnp.asarray(v0), n_iters=K)
        ta = tops.butterfly_clip_op(_t(G), N, tau, _t(w), _t(v0), n_iters=K)
        _close(ta, ja)


@pytest.mark.parametrize("tau", TAUS)
def test_plain_versions_match_jax_oracles(tau):
    """kernels/ref.py: each plain version against the JAX oracle, one
    partition at a time (the port's take a leading partition axis)."""
    G, z, v0, agg = _inputs(4)
    w = WEIGHTS["banned"]
    xs = np.swapaxes(np.asarray(_jparts(G)), 0, 1)  # (n, P, part)
    taus = [tau] * K
    tv, ts, tn = tref.centered_clip_fused_ref(
        tkc.stacked(_t(G), N), taus, _t(z), weights=_t(w))
    t_cc = tref.centered_clip_ref(tkc.stacked(_t(G), N), taus, _t(w), _t(v0))
    t_vs, t_vn = tref.verify_tables_ref(tkc.stacked(_t(G), N), _t(agg),
                                        _t(z), tau)
    sq = tref.sq_norms(tkc.stacked(_t(G), N), _t(v0))
    t_av, t_asq = tref.adaptive_step_ref(tkc.stacked(_t(G), N), _t(v0), sq,
                                         tau, _t(w))
    jtaus = jnp.full((K,), tau, jnp.float32)
    for p in range(N):
        x = jnp.asarray(xs[:, p])
        jv, js, jn = jref.centered_clip_fused_ref(x, jtaus, jnp.asarray(z[p]),
                                                  weights=jnp.asarray(w))
        _close(tv[p], jv)
        _close(ts[p], js)
        _close(tn[p], jn)
        _close(t_cc[p], jref.centered_clip_ref(x, jtaus, jnp.asarray(w),
                                               jnp.asarray(v0[p])))
        js, jn = jref.verify_tables_ref(x, jnp.asarray(agg[p]),
                                        jnp.asarray(z[p]), tau)
        _close(t_vs[p], js)
        _close(t_vn[p], jn)
        jv, jsq = jref.adaptive_step_ref(x, jnp.asarray(v0[p]),
                                         jnp.asarray(sq[p].numpy()), tau,
                                         jnp.asarray(w))
        _close(t_av[p], jv)
        _close(t_asq[p], jsq)


@pytest.mark.parametrize("wkey", list(WEIGHTS))
def test_adaptive_at_tol_zero_is_fixed_budget_bitwise(wkey):
    """Inside the port: the early-exit loop at tol = 0 runs the full
    budget through the same step as the fixed-budget kernel, bit for bit;
    likewise the framework-level stacked loops."""
    G, z, v0, _ = _inputs(5)
    w = _t(WEIGHTS[wkey])
    for tau in TAUS:
        fixed, _, _ = tops.butterfly_clip_fused_op(_t(G), N, tau, _t(z), w,
                                                   v0=_t(v0), n_iters=K)
        adapt, iters = tops.butterfly_clip_adaptive_op(
            _t(G), N, tau, 0.0, w, _t(v0), max_iters=K)
        assert torch.equal(adapt, fixed)
        assert iters.tolist() == [K] * N
        xs = tkc.stacked(_t(G), N)
        a = tcc.centered_clip_stacked(xs, tau, K, w, _t(v0))
        b, it = tcc.centered_clip_adaptive_stacked(xs, tau, 0.0, K, w,
                                                   _t(v0))
        assert torch.equal(a, b) and it.tolist() == [K] * N


@pytest.mark.parametrize("tau", TAUS)
def test_core_centered_clip_matches_jax(tau):
    """core.centered_clip: the stacked fixed and adaptive loops (with
    per-partition freezing) and the clipped residuals."""
    G, _, v0, agg = _inputs(6)
    w = WEIGHTS["banned_and_validator"]
    xs = np.asarray(_jparts(G))
    ja = jcc.centered_clip_stacked(jnp.asarray(xs), tau, K, jnp.asarray(w),
                                   jnp.asarray(v0))
    ta = tcc.centered_clip_stacked(_t(xs), tau, K, _t(w), _t(v0))
    _close(ta, ja)
    jv, ji = jcc.centered_clip_adaptive_stacked(
        jnp.asarray(xs), tau, 1e-3, 30, jnp.asarray(w), jnp.asarray(v0))
    tv, ti = tcc.centered_clip_adaptive_stacked(_t(xs), tau, 1e-3, 30, _t(w),
                                                _t(v0))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    _close(tcc.clip_residuals(_t(xs[0]), _t(agg[0]), tau),
           jcc.clip_residuals(jnp.asarray(xs[0]), jnp.asarray(agg[0]), tau))
    norms = np.array([0.0, 0.5, 2.0, 1e9], np.float32)
    _close(tcc._clip_weights(_t(norms), tau),
           jcc._clip_weights(jnp.asarray(norms), jnp.float32(tau)))


@pytest.mark.parametrize("adaptive_tol", [None, 1e-3])
@pytest.mark.parametrize("with_z", [True, False])
def test_clip_aggregate_branches_match_jax(with_z, adaptive_tol):
    """core.butterfly.clip_aggregate's four branches (fixed/adaptive x
    tables/none) against the JAX function on its Pallas path, plus the
    table recompute and the checksum tolerance."""
    G, z, v0, agg = _inputs(7)
    w = WEIGHTS["banned"]
    ja, jparts, js, jn, jit = jbf.clip_aggregate(
        jnp.asarray(G), 1.0, K, z=jnp.asarray(z) if with_z else None,
        adaptive_tol=adaptive_tol, weights=jnp.asarray(w), use_pallas=True,
        v0=jnp.asarray(v0))
    ta, ts, tn, tit = tbf.clip_aggregate(
        _t(G), 1.0, K, z=_t(z) if with_z else None,
        adaptive_tol=adaptive_tol, weights=_t(w), v0=_t(v0))
    _close(ta, ja)
    assert tit == int(jit)
    if with_z:
        _close(ts, js)
        _close(tn, jn)
    else:
        assert ts is None and tn is None
    js, jn = jbf.verification_tables(jparts, jnp.asarray(agg),
                                     jnp.asarray(z), 1.0)
    ts, tn = tbf.verification_tables(_t(G), _t(agg), _t(z), 1.0)
    _close(ts, js)
    _close(tn, jn)
    _close(tbf.checksum_tolerance(_t(agg), _t(G)),
           jbf.checksum_tolerance(jnp.asarray(agg), jparts))
    np.testing.assert_array_equal(tbf.split_parts(_t(G), N).numpy(),
                                  np.asarray(jparts))
    np.testing.assert_array_equal(
        tbf.merge_parts(_t(agg), D).numpy(),
        np.asarray(jbf.merge_parts(jnp.asarray(agg), D)))


def test_wrappers_refuse_other_devices_and_shapes():
    """Dispatch is by device only: a tensor that is neither CPU nor CUDA is
    refused, and so is a peer count the kernels do not take."""
    G, z, _, _ = _inputs()
    meta = torch.empty((N, D), device="meta")
    with pytest.raises(ValueError):
        tkc.verify_tables_batched(meta, N, _t(z), _t(z), 1.0)
    assert tkc.MAX_PEERS >= 16
