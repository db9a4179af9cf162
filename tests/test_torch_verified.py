"""The port's coordinatewise baselines and verified:* wrappers
(repro_torch.core.aggregators, repro_torch.core.verification) against the
JAX package's: each baseline weighted and unweighted, on even and odd
active counts, within 1e-6 (an even count is where torch.median's lower
middle value and jnp.median's mean of the two middles part); the
verified:* grammar round-trips to the JAX strings; and the verifiable
aggregation with its digest tables (the kernels' plain versions here)
matches the JAX package's within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import verification as jverif
from repro_torch.core import aggregators as tagg
from repro_torch.core import verification as tverif

N, D = 8, 4 * 50 + 3
WEIGHTS = {
    "none": None,
    "odd_active": np.array([1, 1, 0, 1, 1, 0, 1, 0], np.float32),  # 5
    "even_active": np.array([1, 0, 1, 1, 0, 1, 0, 0], np.float32),  # 4
    "two_active": np.array([0, 0, 1, 0, 0, 1, 0, 0], np.float32),
}
BASELINES = {
    "mean": {},
    "coordinate_median": {},
    "trimmed_mean": {"trim_ratio": 0.25},
    "trimmed_mean_odd_count": {"trim_ratio": 0.3},
}


def _grads(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    G[:, ::5] = np.round(G[:, ::5])  # ties across peers
    G[-1] *= 100.0  # an outlier
    return G


@pytest.mark.parametrize("wkey", list(WEIGHTS))
@pytest.mark.parametrize("base", list(BASELINES))
def test_baselines_match_jax(base, wkey):
    G = _grads(1)
    w = WEIGHTS[wkey]
    name = base.removesuffix("_odd_count")
    jfn = getattr(jagg, "mean_agg" if name == "mean" else name)
    tfn = getattr(tagg, "mean_agg" if name == "mean" else name)
    kw = BASELINES[base]
    j = jfn(jnp.asarray(G), weights=None if w is None else jnp.asarray(w),
            **kw)
    t = tfn(torch.from_numpy(G),
            weights=None if w is None else torch.from_numpy(w), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)


def test_even_median_is_the_mean_of_the_middle_pair():
    """The trap: on [1, 3, banned, banned] jnp gives 2, torch.median 1."""
    xs = torch.tensor([[1.0], [3.0], [5.0], [7.0]])
    w = torch.tensor([1.0, 1.0, 0.0, 0.0])
    assert float(tagg.coordinate_median(xs, w)) == 2.0
    assert float(tagg.coordinate_median(xs)) == 4.0


@pytest.mark.parametrize("text", [
    "verified:mean",
    "verified:trimmed_mean",
    "verified:trimmed_mean:trim_ratio=0.25",
    "verified:coordinate_median",
    "verified:butterfly_clip:n_iters=7",
])
def test_verified_grammar_round_trips_like_jax(text):
    t, j = tagg.AggregatorSpec.parse(text), jagg.AggregatorSpec.parse(text)
    assert t.canonical() == j.canonical()
    assert tagg.AggregatorSpec.parse(t.canonical()) == t
    assert t.params == j.params and t.param_dict() == j.param_dict()
    assert (t.verifiable, t.weighted, t.warm_startable,
            t.coordinatewise) == (j.verifiable, j.weighted, j.warm_startable,
                                  j.coordinatewise)
    assert tverif.has_zero_checksum(t) == jverif.has_zero_checksum(j)
    if tverif.is_wrapped(t):
        assert tverif.base_spec(t).canonical() == \
            jverif.base_spec(j).canonical()


def test_registry_and_combinators_like_jax():
    assert set(tagg.REGISTRY) == set(jagg.REGISTRY)
    for name in ("mean", "trimmed_mean", "coordinate_median",
                 "butterfly_clip"):
        assert tverif.verified(name).canonical() == \
            jverif.verified(name).canonical()
    # the full-vector baselines are ported; like JAX's, the verified:
    # wrapper refuses them (no per-partition contributions to digest)
    for name in ("krum", "geometric_median", "centered_clip"):
        assert tagg.AggregatorSpec.parse(name).canonical() == name
        for verified in (tverif.verified, jverif.verified):
            with pytest.raises(ValueError, match="not coordinatewise"):
                verified(name)
    # owner_aggregate, once a stub naming item 14, is the launch owner's
    # one-partition aggregation now (tests/test_torch_launch_stage.py)
    stack = torch.arange(12.0).reshape(3, 4)
    agg, _, _, _ = tverif.owner_aggregate("verified:mean", stack,
                                          torch.ones(4) / 2)
    torch.testing.assert_close(agg, stack.mean(0))
    with pytest.raises(ValueError, match="not verifiable"):
        tverif.digest_tables_rows("mean", None, None, None, None)


@pytest.mark.parametrize("text", ["mean", "coordinate_median",
                                  "trimmed_mean:trim_ratio=0.25",
                                  "butterfly_clip:n_iters=8",
                                  "compressed:butterfly_clip:n_iters=8"])
def test_aggregate_entry_point_matches_jax(text):
    G = _grads(2)
    w = WEIGHTS["even_active"]
    j, jinfo = jagg.aggregate(text, jnp.asarray(G), weights=jnp.asarray(w))
    t, tinfo = tagg.aggregate(text, torch.from_numpy(G),
                              weights=torch.from_numpy(w))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)
    assert tinfo.iters == int(jinfo.iters)


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("text", ["verified:mean",
                                  "verified:trimmed_mean:trim_ratio=0.25",
                                  "verified:coordinate_median"])
def test_spec_aggregate_and_tables_match_jax(text, with_z):
    """The aggregate in the butterfly layout and the digest tables (the
    fused mean+digest kernel's plain version for verified:mean, the
    standalone digest kernel's for the others), then the digests against a
    corrupted aggregate (spec_tables) — against the JAX package on its
    Pallas path, with the banned peers and validators at weight zero."""
    G = _grads(3)
    part = -(-D // N)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((N, part)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    w = WEIGHTS["even_active"]
    jz = jnp.asarray(z) if with_z else None
    tz = torch.from_numpy(z) if with_z else None
    ja, jparts, js, jn, jit = jverif.spec_aggregate(
        jagg.AggregatorSpec.parse(text), jnp.asarray(G), z=jz,
        weights=jnp.asarray(w), use_pallas=True)
    ta, ts, tn, tit = tagg.verified_aggregate(
        text, torch.from_numpy(G), tz, weights=torch.from_numpy(w))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    assert tit == int(jit)
    if not with_z:
        assert ts is None and tn is None
        return
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-5)
    bad = ja.at[2].add(0.5)
    js2, jn2 = jverif.spec_tables(text, jparts, bad, jz, use_pallas=True)
    ts2, tn2 = tverif.spec_tables(text, torch.from_numpy(G),
                                  torch.from_numpy(np.array(bad)), tz)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tn2.numpy(), np.asarray(jn2), rtol=1e-5,
                               atol=1e-5)
    js3, jn3 = jverif.digest_tables(jparts, bad, jz)
    ts3, tn3 = tverif.digest_tables(torch.from_numpy(G),
                                    torch.from_numpy(np.array(bad)), tz)
    np.testing.assert_allclose(ts3.numpy(), np.asarray(js3), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tn3.numpy(), np.asarray(jn3), rtol=1e-5,
                               atol=1e-5)
