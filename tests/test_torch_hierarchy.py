"""The port's flat-cost verification building blocks against the JAX
package's: the closed forms of repro_torch.core.hierarchy (error cases
included), the sampled audit cells bit for bit over a grid of keys, steps,
ages and sizes, the sampled-column digest kernel's plain version against
the Pallas kernel in interpret mode, the spec-aware
verification.digest_tables_rows, and the two-level aggregation
(hier_aggregate, hier_tables, level2_combine) within 1e-5."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.core import hierarchy as jhier
from repro.core import verification as jverif
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import compression as tcomp
from repro_torch.core import hierarchy as thier
from repro_torch.core import prng
from repro_torch.core import verification as tverif
from repro_torch.kernels import centered_clip as tkc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# Closed forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,groups", [(16, None), (16, 1), (16, 4), (8, 2),
                                      (12, 6), (16, 3), (8, 8), (6, 4)])
def test_group_shape_like_jax(n, groups):
    try:
        want = jhier.group_shape(n, groups)
    except ValueError:
        with pytest.raises(ValueError):
            thier.group_shape(n, groups)
        return
    assert thier.group_shape(n, groups) == want


@pytest.mark.parametrize("n", [4, 8, 16, 24, 1024])
@pytest.mark.parametrize("m,k", [(1, 1), (2, 1), (2, 3), (8, 8), (0, 0)])
def test_sampled_k_and_staleness_bound_like_jax(n, m, k):
    assert thier.sampled_k(n, m, k) == jhier.sampled_k(n, m, k)
    assert thier.staleness_bound(n, m, k) == jhier.staleness_bound(n, m, k)


@pytest.mark.parametrize("n,kw", [
    (16, {}), (1024, {}), (1024, dict(m_validators=2, audit_k=2)),
    (1024, dict(groups=32)), (1024, dict(m_validators=2, audit_k=2,
                                         groups=32)),
    (16, dict(m_validators=8, audit_k=8)), (8, dict(groups=2, audit_k=1)),
    (16, dict(groups=3)), (8, dict(groups=8)),
])
def test_table_scalars_and_bytes_like_jax(n, kw):
    try:
        want = jhier.table_scalars(n, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            thier.table_scalars(n, **kw)
        with pytest.raises(ValueError):
            thier.table_bytes(n, **kw)
        return
    assert thier.table_scalars(n, **kw) == want
    for bytes_per in (4, 2):
        assert (thier.table_bytes(n, bytes_per=bytes_per, **kw)
                == jhier.table_bytes(n, bytes_per=bytes_per, **kw))


# ---------------------------------------------------------------------------
# The sampled audit cells, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_cells,m,k", [(4, 2, 1), (8, 2, 1), (16, 1, 1),
                                         (24, 2, 3), (32, 2, 2), (8, 8, 8)])
def test_sample_audit_cells_bitwise_like_jax(n_cells, m, k):
    """Over keys, steps and ledgers (never audited, random ages, ties of
    age): the same indices in the same order and the same mask."""
    rng = np.random.default_rng(n_cells * 31 + m * 7 + k)
    for seed in (0, 5, 2**31 - 2):
        for step in (0, 1, 7, 40):
            ledgers = [np.full((n_cells,), -1, np.int32),
                       rng.integers(-1, step + 1, n_cells).astype(np.int32),
                       np.full((n_cells,), max(step - 1, -1), np.int32)]
            for col_checked in ledgers:
                jkey = jax.random.fold_in(jax.random.key(seed), step)
                tkey = prng.fold_in(prng.key(seed), step)
                jidx, jmask = jhier.sample_audit_cells(
                    jkey, step, jnp.asarray(col_checked), m, k, n_cells)
                tidx, tmask = thier.sample_audit_cells(
                    tkey, step, _t(col_checked), m, k, n_cells)
                assert tidx.dtype == torch.int32
                np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
                np.testing.assert_array_equal(tmask.numpy(),
                                              np.asarray(jmask))


def test_sampler_age_stays_below_staleness_bound():
    """The pure sampler's ledger: past the warm-up no drawn column is
    older than the bound, and every column is drawn within one bound."""
    n_cells, m, k = 24, 2, 3
    bound = thier.staleness_bound(n_cells, m, k)
    col_checked = torch.full((n_cells,), -1, dtype=torch.int32)
    key = prng.key(42)
    worst = 0
    for t in range(6 * bound):
        idx, mask = thier.sample_audit_cells(prng.fold_in(key, t), t,
                                             col_checked, m, k, n_cells)
        ages = t - col_checked[idx.long()]
        if t >= bound:
            worst = max(worst, int(ages.max()))
        col_checked = torch.where(mask, torch.full_like(col_checked, t),
                                  col_checked)
        if t == bound - 1:
            assert (col_checked >= 0).all()
    assert worst <= bound
    assert int(mask.sum()) == thier.sampled_k(n_cells, m, k)


# ---------------------------------------------------------------------------
# The sampled-column digests (kernel #9's plain version)
# ---------------------------------------------------------------------------
def _digest_inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    part = -(-d // n)
    G = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    G[-1] *= 10.0
    G[1, :part] = 0.0  # an all-zero payload
    z = rng.standard_normal((n, part)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    agg = (rng.standard_normal((n, part)) * 0.05).astype(np.float32)
    return G, z, agg


def _jparts(G, n_parts):
    return jnp.swapaxes(jbf.split_parts(jnp.asarray(G), n_parts), 0, 1)


ROWS = [[3, 1], [0], [2, 0, 3, 1], [1, 1]]


@pytest.mark.parametrize("tau", [0.0, 1.0, math.inf])
@pytest.mark.parametrize("shape", [(4, 4 * 300 - 7), (5, 5 * 131 - 3)])
def test_rows_digest_plain_matches_pallas_interpret(shape, tau):
    n, d = shape
    G, z, agg = _digest_inputs(n, d)
    before = dict(tkc.LAUNCHES)
    for rows in ROWS:
        rows = [r % n for r in rows]
        js, jn = jops.digest_tables_rows_op(
            _jparts(G, n), jnp.asarray(agg), jnp.asarray(z),
            jnp.asarray(rows, jnp.int32), tau)
        ts, tn = tops.digest_tables_rows_op(_t(G), n, _t(agg), _t(z), rows,
                                            tau)
        assert tuple(ts.shape) == (n, len(rows))
        _close(ts.numpy(), js)
        _close(tn.numpy(), jn)
        # the oracle itself, on the JAX package's padded stack
        rs, rn = tref.digest_tables_rows_ref(
            tkc.stacked(_t(G), n), _t(agg), _t(z), _t(rows), tau)
        jrs, jrn = jref.digest_tables_rows_ref(
            _jparts(G, n), jnp.asarray(agg), jnp.asarray(z),
            jnp.asarray(rows, jnp.int32), tau)
        _close(rs.numpy(), jrs)
        _close(rn.numpy(), jrn)
    assert tkc.LAUNCHES == before  # CPU tensors never count a launch


@pytest.mark.parametrize("tau", [0.0, 1.0, math.inf])
def test_rows_digest_columns_equal_full_tables(tau):
    """Column j of the sampled digests is column rows[j] of the full
    all-partition pass (#2 for tau > 0, #6 for tau = 0)."""
    n, d = 5, 5 * 131 - 3
    G, z, agg = _digest_inputs(n, d, seed=1)
    rows = [4, 0, 2]
    s, norms = tkc.digest_tables_rows(_t(G), n, _t(agg), _t(z), rows, tau)
    if tau > 0:
        fs, fn = tkc.verify_tables_batched(_t(G), n, _t(agg), _t(z), tau)
    else:
        fs, fn = tkc.digest_tables_batched(_t(G), n, _t(agg), _t(z))
    assert torch.equal(s, fs[rows]) and torch.equal(norms, fn[rows])


@pytest.mark.parametrize("rows", [[4], [-1], [0, 7], [], [[0, 1]]])
def test_rows_digest_rejects_bad_rows(rows):
    n, d = 4, 4 * 30
    G, z, agg = _digest_inputs(n, d)
    with pytest.raises(ValueError, match="rows"):
        tkc.digest_tables_rows(_t(G), n, _t(agg), _t(z), rows, 1.0)


@pytest.mark.parametrize("spec", ["butterfly_clip", "butterfly_clip:tau=0.5",
                                  "verified:mean",
                                  "verified:trimmed_mean:trim_ratio=0.25",
                                  "compressed:butterfly_clip",
                                  "compressed:verified:mean:codec=bf16"])
def test_verification_digest_tables_rows_like_jax(spec):
    n, d = 6, 6 * 41 - 5
    G, z, agg = _digest_inputs(n, d, seed=2)
    rows = [5, 2, 0]
    wire = G
    if spec.startswith("compressed:"):
        codec = tcomp.codec_of(spec)
        wire = tcomp.wire_grads(_t(G), codec, n).numpy()
    js, jn = jverif.digest_tables_rows(
        spec, jbf.split_parts(jnp.asarray(wire), n), jnp.asarray(agg),
        jnp.asarray(z), jnp.asarray(rows, jnp.int32))
    ts, tn = tverif.digest_tables_rows(spec, _t(wire), _t(agg), _t(z), rows)
    _close(ts.numpy(), js)
    _close(tn.numpy(), jn)


@pytest.mark.parametrize("spec", ["mean", "trimmed_mean:trim_ratio=0.25"])
def test_digest_tables_rows_refuses_non_verifiable(spec):
    n, d = 4, 40
    G, z, agg = _digest_inputs(n, d)
    with pytest.raises(ValueError):
        jverif.digest_tables_rows(spec, jbf.split_parts(jnp.asarray(G), n),
                                  jnp.asarray(agg), jnp.asarray(z),
                                  jnp.asarray([0], jnp.int32))
    with pytest.raises(ValueError, match="not verifiable"):
        tverif.digest_tables_rows(spec, _t(G), _t(agg), _t(z), [0])


# ---------------------------------------------------------------------------
# Two-level aggregation
# ---------------------------------------------------------------------------
HIER_SPECS = ["butterfly_clip:n_iters=8", "verified:mean",
              "verified:trimmed_mean:trim_ratio=0.25",
              "compressed:butterfly_clip:n_iters=8"]


def _hier_inputs(n=8, d=61, seed=3):
    rng = np.random.default_rng(seed)
    G = (rng.standard_normal((n, d)) * 0.3 + 0.1).astype(np.float32)
    G[2] *= 8.0
    w = np.ones((n,), np.float32)
    w[[1, 6]] = 0.0  # a validator and a banned peer
    return G, w


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("spec", HIER_SPECS)
def test_hier_aggregate_and_tables_like_jax(spec, groups):
    n, d = 8, 61
    G, w = _hier_inputs(n, d)
    seed = 12345
    gs = n // groups
    v0 = (np.random.default_rng(9).standard_normal(d) * 0.05
          ).astype(np.float32)
    spec_full = spec if "clip" not in spec else spec + ",warm_start=true"
    for v0_flat in (None, v0):
        jh = jhier.hier_aggregate(
            spec_full, jnp.asarray(G), jnp.asarray(w), seed, groups,
            v0_flat=None if v0_flat is None else jnp.asarray(v0_flat))
        th = thier.hier_aggregate(
            spec_full, _t(G), _t(w), seed, groups,
            v0_flat=None if v0_flat is None else _t(v0_flat))
        assert tuple(th.u.shape) == (groups, gs, -(-d // gs))
        _close(th.u.numpy(), jh.u)
        np.testing.assert_allclose(th.z1.numpy(), np.asarray(jh.z1),
                                   rtol=1e-6, atol=1e-6)
        _close(th.s1.numpy(), jh.s1)
        _close(th.norms1.numpy(), jh.norms1)
        np.testing.assert_array_equal(th.group_w.numpy(),
                                      np.asarray(jh.group_w))
        assert th.iters == int(jh.iters)
    # without tables, then tables against a shifted aggregate
    jh = jhier.hier_aggregate(spec, jnp.asarray(G), jnp.asarray(w), seed,
                              groups, with_tables=False)
    th = thier.hier_aggregate(spec, _t(G), _t(w), seed, groups,
                              with_tables=False)
    assert th.s1 is None and th.norms1 is None
    _close(th.u.numpy(), jh.u)
    shift = np.zeros(th.u.shape, np.float32)
    shift[0, 1] = 0.5
    js, jn = jhier.hier_tables(spec, jh.parts1, jh.u + jnp.asarray(shift),
                               jh.z1)
    wire = _t(G)
    if spec.startswith("compressed:"):
        wire = tcomp.wire_grads(wire, tcomp.codec_of(spec), gs)
    ts, tn = thier.hier_tables(spec, wire, th.u + _t(shift), th.z1)
    _close(ts.numpy(), js)
    _close(tn.numpy(), jn)


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("d", [61, 64])
def test_level2_combine_like_jax(groups, d):
    n = 8
    gs = n // groups
    rng = np.random.default_rng(groups * 100 + d)
    u = rng.standard_normal((groups, gs, -(-d // gs))).astype(np.float32)
    for group_w in (np.full((groups,), gs, np.float32),
                    np.arange(groups, dtype=np.float32)):
        seed = 2**31 - 2  # seed + 1 still fits in int32
        j = jhier.level2_combine(jnp.asarray(u), jnp.asarray(group_w), d,
                                 jnp.int32(seed))
        t = thier.level2_combine(_t(u), _t(group_w), d, torch.tensor(seed))
        _close(t.v2.numpy(), j.v2)
        np.testing.assert_allclose(t.z2.numpy(), np.asarray(j.z2),
                                   rtol=1e-6, atol=1e-6)
        _close(t.s2.numpy(), j.s2)
        _close(t.norms2.numpy(), j.norms2)
        _close(tkc.stacked(t.u_flat, groups).transpose(0, 1).numpy(),
               j.parts2)
