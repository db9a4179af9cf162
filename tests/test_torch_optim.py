"""The port's optimizers and schedules (repro_torch.optim) against the JAX
package's (repro.optim): sgd with and without weight decay, momentum and
Nesterov, adam and lamb, 5 steps from the same numpy gradients, on one
flat tensor and on a list of leaves (LAMB's trust ratio per leaf), within
1e-5; the three schedules at their first, middle and last steps;
global_norm and clip_by_global_norm; apply_updates passing integer leaves
through untouched."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim.optimizers import apply_updates as japply
from repro_torch import optim as topt

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(7, 5), (13,), (3, 2, 4)]


def _tree(seed, flat):
    rng = np.random.default_rng(seed)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    if flat:
        return np.concatenate([x.reshape(-1) for x in leaves])
    return leaves


def _to_j(tree):
    return jnp.asarray(tree) if isinstance(tree, np.ndarray) else [
        jnp.asarray(x) for x in tree]


def _to_t(tree):
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else [
        torch.from_numpy(x) for x in tree]


def _assert_close(t, j):
    if isinstance(t, torch.Tensor):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    else:
        assert len(t) == len(j)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_weight_decay": lambda m: m.sgd(0.1, weight_decay=0.05),
    "sgd_nesterov_weight_decay": lambda m: m.sgd(
        0.1, momentum=0.9, nesterov=True, weight_decay=0.01),
    "sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "adam": lambda m: m.adam(1e-2),
    "adam_weight_decay": lambda m: m.adam(1e-2, weight_decay=0.1),
    "lamb": lambda m: m.lamb(2e-3),
    "lamb_cosine": lambda m: m.lamb(m.cosine_schedule(2e-3, 5)),
}


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "leaves"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_five_steps_equal_jax(name, flat):
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    p0 = _tree(0, flat)
    jp, tp = _to_j(p0), _to_t(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _tree(step + 1, flat)
        ju, js = jo.update(_to_j(g), js, jp, step)
        tu, ts = to.update(_to_t(g), ts, tp, step)
        _assert_close(tu, ju)
        jp, tp = japply(jp, ju), topt.apply_updates(tp, tu)
        _assert_close(tp, jp)
    for key in js:
        _assert_close(ts[key], js[key])


def test_lamb_trust_ratio_is_per_leaf():
    """The same values as one flat tensor and as leaves give different
    LAMB updates (one trust ratio against one per leaf), each equal to
    the JAX package's on the same structure."""
    flat, leaves = _tree(0, True), _tree(0, False)
    g_flat, g_leaves = _tree(1, True), _tree(1, False)
    opt = topt.lamb(2e-3)
    u_flat, _ = opt.update(_to_t(g_flat), opt.init(_to_t(flat)),
                           _to_t(flat), 0)
    u_leaves, _ = opt.update(_to_t(g_leaves), opt.init(_to_t(leaves)),
                             _to_t(leaves), 0)
    joined = torch.cat([u.reshape(-1) for u in u_leaves])
    assert not torch.allclose(u_flat, joined, rtol=1e-3, atol=0)
    jo = jopt.lamb(2e-3)
    ju, _ = jo.update(_to_j(g_leaves), jo.init(_to_j(leaves)),
                      _to_j(leaves), 0)
    _assert_close(u_leaves, ju)


@pytest.mark.parametrize("name, args", [
    ("constant_schedule", (0.3,)),
    ("cosine_schedule", (0.3, 10)),
    ("cosine_schedule", (0.3, 10, 0.1)),
    ("warmup_cosine_schedule", (0.3, 4, 20)),
    ("warmup_cosine_schedule", (0.3, 4, 20, 0.2)),
])
def test_schedules_equal_jax(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in (0, 1, 4, 5, 10, 19, 20, 25):
        t = tf(step)
        assert t.dtype == torch.float32 and t.ndim == 0
        np.testing.assert_allclose(float(t), float(jf(step)), rtol=1e-6,
                                   atol=1e-7)


def test_global_norm_and_clip_equal_jax():
    leaves = _tree(3, False)
    leaves[1] = leaves[1] * 100.0
    jt, tt = _to_j(leaves), _to_t(leaves)
    tn, jn = topt.global_norm(tt), jopt.global_norm(jt)
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for max_norm in (1.0, 1e6):
        tc, tg = topt.clip_by_global_norm(tt, max_norm)
        jc, jg = jopt.clip_by_global_norm(jt, max_norm)
        np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6)
        _assert_close(tc, jc)
    half = [torch.from_numpy(x).to(torch.bfloat16) for x in leaves]
    clipped, _ = topt.clip_by_global_norm(half, 1.0)
    assert [c.dtype for c in clipped] == [torch.bfloat16] * len(half)


@pytest.mark.parametrize("name", ["sgd_momentum", "adam", "lamb"])
def test_integer_leaves_pass_through(name):
    """A counter leaf gets a zero update and keeps every bit, also above
    2**24; its state is carried untouched; a dict tree keeps its keys."""
    opt = OPTIMIZERS[name](topt)
    big = 2**24 + 1
    params = {"w": torch.ones(3), "count": torch.tensor([big, 7],
                                                         dtype=torch.int32)}
    grads = {"w": torch.full((3,), 0.5), "count": torch.zeros(2,
                                                               dtype=torch.int32)}
    state = opt.init(params)
    ups, state = opt.update(grads, state, params, 0)
    assert torch.equal(ups["count"], torch.zeros(2))
    new = topt.apply_updates(params, ups)
    assert new["count"].dtype == torch.int32
    assert new["count"].tolist() == [big, 7]
    assert (new["w"] < 1.0).all()
    jparams = {"w": jnp.ones(3), "count": jnp.asarray([big, 7], jnp.int32)}
    jo = OPTIMIZERS[name](jopt)
    ju, _ = jo.update({"w": jnp.full((3,), 0.5),
                       "count": jnp.zeros(2, jnp.int32)}, jo.init(jparams),
                      jparams, 0)
    _assert_close(ups["w"], ju["w"])
    assert np.asarray(japply(jparams, ju)["count"]).tolist() == [big, 7]
