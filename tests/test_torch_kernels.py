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
    refused; the kernels' stack validation takes any peer count (a
    64-peer stack passes, above the 32 of a register tile) and refuses a
    stack with no peer."""
    G, z, _, _ = _inputs()
    meta = torch.empty((N, D), device="meta")
    with pytest.raises(ValueError):
        tkc.verify_tables_batched(meta, N, _t(z), _t(z), 1.0)
    assert tkc._Stack.check(torch.empty((64, D), device="meta")) is None
    with pytest.raises(ValueError, match="peer"):
        tkc._Stack.check(torch.empty((0, D), device="meta"))


# ---------------------------------------------------------------------------
# Kernels #5-#8: the verified:* digests and the wire-payload twins
# ---------------------------------------------------------------------------
CODECS = ("int8", "bf16")


def _jwire(G, codec):
    """The JAX package's wire payloads of the stack: (qs (n_parts, n, part)
    wire dtype, scales (n_parts, n)), plus the port's kernel input, the
    (n, d) payload matrix with the same bits."""
    from repro.core import compression as jcomp

    n, d = G.shape
    jq, jsc = jcomp.quantize(_jparts(G), codec)
    q = np.array(jq)  # a writable copy
    if codec == "bf16":  # ml_dtypes bfloat16 -> its bits -> torch bfloat16
        q = torch.from_numpy(q.view(np.int16)).view(torch.bfloat16)
    else:
        q = torch.from_numpy(q)
    q = q.transpose(0, 1).reshape(n, -1)[:, :d]
    return jq, jsc, q, _t(jsc)


def _zero_payload(G):
    """Peer 1's slice of partition 0 all zero: its int8 scale is 0."""
    G = G.copy()
    G[1, :-(-G.shape[1] // G.shape[0])] = 0.0
    return G


def test_digest_kernel_matches_jax():
    """#6 digest_tables_batched: the tau-less digests against a given
    aggregate, ragged partitions."""
    G, z, _, agg = _inputs(8)
    before = dict(tkc.LAUNCHES)
    js, jn = jops.digest_tables_all_op(_jparts(G), jnp.asarray(agg),
                                       jnp.asarray(z))
    ts, tn = tops.digest_tables_all_op(_t(G), N, _t(agg), _t(z))
    _close(ts, js)
    _close(tn, jn)
    assert tkc.LAUNCHES == before, "a CPU tensor must not reach a kernel"


@pytest.mark.parametrize("wkey", list(WEIGHTS))
def test_mean_digest_kernel_matches_jax(wkey):
    """#5 mean_digest_fused: the weighted mean and its digests, with the
    banned and sat-out peers at weight zero."""
    G, z, _, _ = _inputs(9)
    w = WEIGHTS[wkey]
    ja, js, jn = jops.mean_digest_fused_op(
        _jparts(G), jnp.asarray(z), None if w is None else jnp.asarray(w))
    ta, ts, tn = tops.mean_digest_fused_op(_t(G), N, _t(z), _t(w))
    _close(ta, ja)
    _close(ts, js)
    _close(tn, jn)


@pytest.mark.parametrize("wkey", ["all", "banned_and_validator"])
@pytest.mark.parametrize("codec", CODECS)
def test_dequant_kernels_match_jax(codec, wkey):
    """#7 butterfly_clip_fused_dequant (every tau) and #8
    mean_digest_fused_dequant over the JAX package's wire payloads, with
    an all-zero payload (int8 scale 0) and a ragged last partition."""
    G, z, _, _ = _inputs(10)
    G = _zero_payload(G)
    w = WEIGHTS[wkey]
    jw = None if w is None else jnp.asarray(w)
    jq, jsc, q, sc = _jwire(G, codec)
    if codec == "int8":
        assert float(sc[0, 1]) == 0.0
    for tau in TAUS:
        ja, js, jn = jops.butterfly_clip_fused_dequant_op(
            jq, jsc, tau, jnp.asarray(z), jw, n_iters=K)
        ta, ts, tn = tops.butterfly_clip_fused_dequant_op(
            q, sc, N, tau, _t(z), _t(w), n_iters=K)
        _close(ta, ja)
        _close(ts, js)
        _close(tn, jn)
    ja, js, jn = jops.mean_digest_fused_dequant_op(jq, jsc, jnp.asarray(z),
                                                   jw)
    ta, ts, tn = tops.mean_digest_fused_dequant_op(q, sc, N, _t(z), _t(w))
    _close(ta, ja)
    _close(ts, js)
    _close(tn, jn)


@pytest.mark.parametrize("codec", CODECS)
def test_dequant_twins_equal_f32_kernels_on_dequantized_bitwise(codec):
    """The contract the card holds #7 and #8 to, on the plain versions:
    over (q, s) they give the bits of #1 and #5 on dequantize(q, s)."""
    G, z, v0, _ = _inputs(11)
    _, _, q, sc = _jwire(_zero_payload(G), codec)
    xd = tkc.stacked(q, N).to(torch.float32) * sc[..., None]
    xd = xd.transpose(0, 1).reshape(N, -1)[:, :D]
    w = _t(WEIGHTS["banned"])
    a = tkc.butterfly_clip_fused_dequant(q, sc, N, [1.0] * K, _t(z),
                                         weights=w, v0=_t(v0))
    b = tkc.butterfly_clip_fused(xd, N, [1.0] * K, _t(z), weights=w,
                                 v0=_t(v0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = tkc.mean_digest_fused_dequant(q, sc, N, _t(z), w)
    b = tkc.mean_digest_fused(xd, N, _t(z), w)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("codec", CODECS)
def test_new_plain_versions_match_jax_oracles(codec):
    """kernels/ref.py #5-#8 oracles, one partition at a time, against the
    JAX package's kernels/ref.py."""
    G, z, _, agg = _inputs(12)
    G = _zero_payload(G)
    w = WEIGHTS["banned_and_validator"]
    jq, jsc, q, sc = _jwire(G, codec)
    xs = tkc.stacked(_t(G), N)
    qs = tkc.stacked(q, N)
    t_ds, t_dn = tref.digest_tables_ref(xs, _t(agg), _t(z))
    t_mv, t_ms, t_mn = tref.mean_digest_fused_ref(xs, _t(z), _t(w))
    t_dq = tref.dequantize_ref(qs, sc)
    t_cv, t_cs, t_cn = tref.centered_clip_fused_dequant_ref(
        qs, sc, [1.0] * K, _t(z), weights=_t(w))
    t_qv, t_qs, t_qn = tref.mean_digest_fused_dequant_ref(qs, sc, _t(z),
                                                          _t(w))
    jx = np.asarray(_jparts(G))
    jtaus = jnp.full((K,), 1.0, jnp.float32)
    for p in range(N):
        x, zp = jnp.asarray(jx[p]), jnp.asarray(z[p])
        js, jn = jref.digest_tables_ref(x, jnp.asarray(agg[p]), zp)
        _close(t_ds[p], js)
        _close(t_dn[p], jn)
        for t, j in zip((t_mv[p], t_ms[p], t_mn[p]),
                        jref.mean_digest_fused_ref(x, zp, jnp.asarray(w))):
            _close(t, j)
        np.testing.assert_array_equal(
            t_dq[p].numpy(), np.asarray(jref.dequantize_ref(jq[p], jsc[p])))
        for t, j in zip((t_cv[p], t_cs[p], t_cn[p]),
                        jref.centered_clip_fused_dequant_ref(
                            jq[p], jsc[p], jtaus, zp,
                            weights=jnp.asarray(w))):
            _close(t, j)
        for t, j in zip((t_qv[p], t_qs[p], t_qn[p]),
                        jref.mean_digest_fused_dequant_ref(
                            jq[p], jsc[p], zp, jnp.asarray(w))):
            _close(t, j)
