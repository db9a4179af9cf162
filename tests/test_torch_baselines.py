"""The §4.1 full-vector baselines of the port (geometric_median, krum, the
trusted-server centered_clip) against the JAX package on the CPU: the
functions with their iteration counts, warm starts and weights, through
aggregate(spec, ...) and the registry, with_byzantine_default, and Krum's
row-at-a-time distances against the JAX (n, n, d) form at n = 20.

Tolerance: values within rtol = atol = 1e-5 (the frameworks sum in
different orders); iteration counts and Krum's pick exactly. The
geometric-median grid stops at eps 1e-4 and 1e-3, or at a cap it reaches
first: at eps 1e-6 the last Weiszfeld steps of these ~1-sized vectors are
~7e-7 long, float32 rounding of a 57-vector, so the stopping iteration
there depends on the summation order (12 here, 13 in JAX on one case).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro_torch.core import aggregators as tagg


def _grads(n=10, d=57, seed=0, n_byz=3):
    rng = np.random.default_rng(seed)
    G = (rng.standard_normal((n, d)) * 0.5 + 1.0).astype(np.float32)
    G[n - n_byz:] = -8.0 * G[n - n_byz:]  # colluders far out
    return G


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


WEIGHTS = {
    "none": None,
    "banned": np.array([1, 1, 0, 1, 1, 1, 1, 0, 1, 1], np.float32),
    "soft": np.array([1, .5, 1, 1, 2, 1, 1, 1, 0, 1], np.float32),
}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("eps, max_iters", [(1e-4, 200), (1e-3, 200),
                                            (1e-6, 7)])
def test_geometric_median_matches_jax(eps, max_iters, weights):
    G, w = _grads(), WEIGHTS[weights]
    jv, ji = jagg.geometric_median(
        jnp.asarray(G), eps=eps, max_iters=max_iters,
        weights=None if w is None else jnp.asarray(w), return_iters=True)
    tv, ti = tagg.geometric_median(
        _t(G), eps=eps, max_iters=max_iters,
        weights=None if w is None else _t(w), return_iters=True)
    assert ti == int(ji)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert torch.equal(tagg.geometric_median(
        _t(G), eps=eps, max_iters=max_iters,
        weights=None if w is None else _t(w)), tv)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("tau", [1.0, 10.0])
def test_ps_centered_clip_matches_jax(tau, weights, warm):
    G, w = _grads(seed=1), WEIGHTS[weights]
    v0 = np.full(G.shape[1], 0.9, np.float32) if warm else None
    kw = dict(eps=1e-4, max_iters=200, return_iters=True)
    jv, ji = jagg.ps_centered_clip(
        jnp.asarray(G), tau, weights=None if w is None else jnp.asarray(w),
        v0=None if v0 is None else jnp.asarray(v0), **kw)
    tv, ti = tagg.ps_centered_clip(
        _t(G), tau, weights=None if w is None else _t(w),
        v0=None if v0 is None else _t(v0), **kw)
    assert ti == int(ji) and ti < 200
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("n_byz", [0, 2, 3, 4])
def test_krum_pick_matches_jax(n_byz, weights):
    """The colluders (rows 7-9) sit close together: without the pairwise
    mask a banned colluder would be a cheap neighbour of the others."""
    G, w = _grads(seed=2), WEIGHTS[weights]
    G[7:] = G[7] + 0.01 * np.arange(3, dtype=np.float32)[:, None]
    j = jagg.krum(jnp.asarray(G), n_byz,
                  weights=None if w is None else jnp.asarray(w))
    t = tagg.krum(_t(G), n_byz, weights=None if w is None else _t(w))
    pick = [i for i in range(len(G)) if np.array_equal(G[i], np.asarray(j))]
    assert len(pick) == 1 and torch.equal(t, _t(G[pick[0]]))


def test_krum_masks_banned_rows_in_the_pairwise_matrix():
    """Two colluders 0 and 1 next to each other, 1 banned: with 1 masked
    out of the pairwise matrix, 0 pays the "infinite" distance like
    everyone else and an honest row wins, as in the JAX package."""
    rng = np.random.default_rng(3)
    G = (rng.standard_normal((7, 12)) * 1.0).astype(np.float32)
    G[1] = G[0] + 1e-3
    w = np.array([1, 0, 1, 1, 1, 1, 1], np.float32)
    j = np.asarray(jagg.krum(jnp.asarray(G), 2, weights=jnp.asarray(w)))
    t = tagg.krum(_t(G), 2, weights=_t(w)).numpy()
    np.testing.assert_array_equal(t, j)
    assert not np.array_equal(t, G[1])


def test_krum_row_wise_distances_equal_the_jax_form_at_n20():
    """n = 20: the row-at-a-time sums of (x_i - x_j)^2 against the JAX
    (n, n, d) differences, and the same pick."""
    G = _grads(n=20, d=333, seed=4, n_byz=6)
    jd2 = np.asarray(jnp.sum((jnp.asarray(G)[:, None, :]
                              - jnp.asarray(G)[None, :, :]) ** 2, axis=-1))
    td2 = tagg.pairwise_sq_dists(_t(G)).numpy()
    np.testing.assert_allclose(td2, jd2, **TOL)
    np.testing.assert_array_equal(td2, td2.T)
    assert (np.diag(td2) == 0).all()
    for b in (0, 6, 8):
        j = np.asarray(jagg.krum(jnp.asarray(G), b))
        np.testing.assert_array_equal(tagg.krum(_t(G), b).numpy(), j)


@pytest.mark.parametrize("text", [
    "geometric_median", "geometric_median:eps=0.001,max_iters=5",
    "krum", "krum:n_byzantine=2",
    "centered_clip", "centered_clip:tau=3.0,eps=1e-4,warm_start=true"])
@pytest.mark.parametrize("weights", ["none", "banned"])
def test_aggregate_entry_point_matches_jax(text, weights):
    G, w = _grads(seed=5), WEIGHTS[weights]
    v0 = np.full(G.shape[1], 0.9, np.float32)
    j, ji = jagg.aggregate(text, jnp.asarray(G),
                           weights=None if w is None else jnp.asarray(w),
                           v0=jnp.asarray(v0))
    t, ti = tagg.aggregate(text, _t(G), weights=None if w is None else _t(w),
                           v0=_t(v0))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert ti.iters == int(ji.iters)


@pytest.mark.parametrize("text", ["geometric_median", "krum",
                                  "krum:n_byzantine=2", "centered_clip",
                                  "centered_clip:tau=2.5,warm_start=true"])
def test_registry_entries_match_jax(text):
    t, j = tagg.AggregatorSpec.parse(text), jagg.AggregatorSpec.parse(text)
    assert t.canonical() == j.canonical()
    assert t.param_dict() == j.param_dict()
    assert (t.verifiable, t.weighted, t.warm_startable, t.adaptive,
            t.coordinatewise) == (j.verifiable, j.weighted, j.warm_startable,
                                  j.adaptive, j.coordinatewise)
    for n_byz in (0, 3):
        assert tagg.with_byzantine_default(t, n_byz) == \
            tagg.AggregatorSpec.parse(
                jagg.with_byzantine_default(j, n_byz).canonical())
    assert set(tagg.AGGREGATORS) == set(jagg.AGGREGATORS)
    assert tagg.registered_aggregators() == jagg.registered_aggregators()
