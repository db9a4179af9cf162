"""The SSM of the port (Mamba2-2.7B's SSD mixer) against the JAX package on
the same numpy inputs from a seed, float32 at reduced widths, within 1e-5
of the reference's largest value:

* ``ssd_chunked`` with S a multiple of the chunk, with a ragged tail and
  shorter than one chunk, with and without ``init_state``: y, the final
  state and the gradients of <y, c> (finite: the decay is masked before
  its exp);
* ``ssm_apply`` in "train", "prefill" (the conv's tail left-padded when S
  < K - 1) and "decode" (from a random cache), and ``causal_conv1d_step``;
* the chunked form against the one-step recurrence (prefill against
  decode from an empty cache, token by token, and prefill then decode);
* the reduced Mamba2-2.7B: layout, init, loss and gradients, and
  ``run_scan`` over 4 peers with a sign flip on peer 3 (the same bans,
  |g_hat| within 1e-5);
* the parameter counts of the whole config and of the depth cut the card
  trains (36 of 64 layers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce
from repro.core.btard_sgd import BTARDTrainer as JTrainer
from repro.core.btard_sgd import TrainerConfig as JTrainerConfig
from repro.core.flatten import FlatBoundary as JBoundary
from repro.core.protocol import AttackConfig as JAttack
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_config as treduce
from repro_torch.configs.base import SSM
from repro_torch.core import prng
from repro_torch.core.btard_sgd import BTARDTrainer as TTrainer
from repro_torch.core.btard_sgd import TrainerConfig as TTrainerConfig
from repro_torch.core.flatten import FlatBoundary as TBoundary
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.core.protocol import AttackConfig as TAttack
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.optim import sgd as tsgd

ARCH = "mamba2-2.7b"
SEQ = 40  # two chunks of the reduced 16 and a ragged tail
WHOLE, CUT, CUT_REPEATS = 2_831_296_000, 1_705_232_320, 36


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(jparams, seed):
    """Random values in the leaves whose init is constant (zeros, ones, a
    linspace), which would test nothing."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("bias", "norm", "conv_b", "A_log",
                                   "'D'")):
            return jnp.asarray(rng.normal(1.0, 0.5, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, jparams)


def _close(t, j, tol=1e-5):
    """Within ``tol`` of the largest value of the reference."""
    j = np.asarray(j, np.float32)
    scale = max(float(np.abs(j).max()), 1e-30)
    err = float(np.abs(np.asarray(t, np.float32) - j).max())
    assert err <= tol * scale, f"max err {err:.3e} of {scale:.3e}"


def _cfgs():
    return jreduce(jget_config(ARCH)), treduce(tget_config(ARCH))


def _params(seed=0):
    jcfg, tcfg = _cfgs()
    jp = _perturbed(jssm.ssm_init(jax.random.key(seed), jcfg), seed + 1)
    return jcfg, tcfg, jp, from_jax_params(_np_tree(jp))


# ---------------------------------------------------------------------------
# ssd_chunked
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S, init", [(32, False), (37, False), (37, True),
                                     (5, True)])
def test_ssd_chunked_matches_jax(S, init):
    """y, the final state, and the gradients of <y, c> + <state, c_s> to
    every input: the chunk is 16, so S = 37 pads a ragged tail and S = 5
    is one short chunk."""
    B, H, P, N, Q = 2, 3, 8, 6, 16
    rng = np.random.default_rng(S + 100 * init)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, (B, S, H)).astype(np.float32)
    a_log = (-dt * rng.uniform(0.5, 8.0, H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32)
              for _ in range(2))
    s0 = rng.normal(size=(B, H, N, P)).astype(np.float32) if init else None
    c = rng.normal(size=(B, S, H, P)).astype(np.float32)
    cs = rng.normal(size=(B, H, N, P)).astype(np.float32)
    args = [x, a_log, dt, Bm, Cm] + ([s0] if init else [])

    def jf(*a):
        y, st = jssm.ssd_chunked(*a[:5], Q, init_state=a[5] if init else None)
        return jnp.sum(y * c) + jnp.sum(st * cs), (y, st)

    (_, (jy, jst)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(args))), has_aux=True))(
            *map(jnp.asarray, args))
    ta = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ty, tst = tssm.ssd_chunked(*ta[:5], Q, init_state=ta[5] if init else None)
    assert ty.shape == (B, S, H, P) and tst.dtype == torch.float32
    tg = torch.autograd.grad((ty * torch.from_numpy(c)).sum()
                             + (tst * torch.from_numpy(cs)).sum(), ta)
    _close(ty.detach().numpy(), jy)
    _close(tst.detach().numpy(), jst)
    for t, j in zip(tg, jg):
        assert torch.isfinite(t).all()
        _close(t.numpy(), j)


# ---------------------------------------------------------------------------
# ssm_apply and the conv step
# ---------------------------------------------------------------------------
def test_causal_conv1d_step_matches_jax():
    rng = np.random.default_rng(11)
    jp = jlayers.conv1d_init(jax.random.key(12), 24, 4, jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.normal(size=24), jnp.float32)
    buf = rng.normal(size=(2, 3, 24)).astype(np.float32)
    x_t = rng.normal(size=(2, 24)).astype(np.float32)
    jbuf, jout = jax.jit(jlayers.causal_conv1d_step)(jp, jnp.asarray(buf),
                                                     jnp.asarray(x_t))
    tbuf, tout = tlayers.causal_conv1d_step(from_jax_params(_np_tree(jp)),
                                            torch.from_numpy(buf),
                                            torch.from_numpy(x_t))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    _close(tout.numpy(), jout)


@pytest.mark.parametrize("mode, S", [("train", 37), ("prefill", 37),
                                     ("prefill", 2), ("decode", 1)])
def test_ssm_apply_matches_jax(mode, S):
    """y and, with a cache, every cache leaf. "prefill" at S = 2 < K - 1
    left-pads the conv's tail; "decode" starts from a random cache."""
    jcfg, tcfg, jp, tp = _params(3)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    shapes = jssm.ssm_cache_shape(jcfg, SSM, 2, 0, False)
    cache = None if mode == "train" else {
        k: (rng.normal(size=shp) if mode == "decode" else np.zeros(shp))
        .astype(np.float32) for k, (shp, _) in shapes.items()}
    jy, jc = jax.jit(lambda p, x, c: jssm.ssm_apply(
        p, jcfg, SSM, x, cache=c, mode=mode))(
            jp, jnp.asarray(x),
            None if cache is None else jax.tree.map(jnp.asarray, cache))
    tc = None if cache is None else from_jax_params(cache)
    ty = tssm.ssm_apply(tp, tcfg, SSM, torch.from_numpy(x), cache=tc,
                        mode=mode)
    _close(ty.numpy(), jy)
    if cache is not None:
        assert sorted(tc) == sorted(jc)
        want = {k: (tuple(s), torch.float32) for k, (s, _) in shapes.items()}
        assert tssm.ssm_cache_shape(tcfg, SSM, 2, 0, False) == want
        for k in tc:
            _close(tc[k].numpy(), jc[k])


def test_ssm_train_gradients_match_jax():
    """The gradients of <y, c> to x and every parameter, within 1e-5 of
    their largest values; ``A_log``'s within 2e-5: it sums the decay's
    effect over every position, with cancellation, and in float32 both
    packages land up to 1.7e-5 of its largest value from a float64
    evaluation of the same function."""
    jcfg, tcfg, jp, tp = _params(5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 21, jcfg.d_model)).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jssm.ssm_apply(p, jcfg, SSM, x)[0] * c)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tssm.ssm_apply(tree_unflatten(tp, leaves), tcfg, SSM, tx)
    grads = torch.autograd.grad((ty * torch.from_numpy(c)).sum(),
                                leaves + [tx])
    _close(grads[-1].numpy(), jgx)
    assert sorted(tp) == sorted(jgp)
    for name, t in zip(sorted(tp), grads[:-1]):  # tree_leaves' order
        _close(t.numpy(), jgp[name], 2e-5 if name == "A_log" else 1e-5)


@pytest.mark.parametrize("S", [2, 21])
def test_chunked_form_equals_the_recurrence(S):
    """The port alone: prefill over S tokens against S decode steps from an
    empty cache (outputs, state and conv buffer), then one more decode
    step after each."""
    _, cfg, _, p = _params(7)
    x = torch.from_numpy(np.random.default_rng(S).normal(
        size=(2, S + 1, cfg.d_model)).astype(np.float32))

    def empty():
        return {k: torch.zeros(s, dtype=dt) for k, (s, dt) in
                tssm.ssm_cache_shape(cfg, SSM, 2, 0, False).items()}

    chunked, stepped = empty(), empty()
    y = tssm.ssm_apply(p, cfg, SSM, x[:, :S], cache=chunked, mode="prefill")
    ys = torch.cat([tssm.ssm_apply(p, cfg, SSM, x[:, t:t + 1],
                                   cache=stepped, mode="decode")
                    for t in range(S)], 1)
    _close(ys.numpy(), y.numpy())
    for k in chunked:
        _close(stepped[k].numpy(), chunked[k].numpy())
    nxt = [tssm.ssm_apply(p, cfg, SSM, x[:, S:], cache=c, mode="decode")
           for c in (chunked, stepped)]
    _close(nxt[0].numpy(), nxt[1].numpy())


# ---------------------------------------------------------------------------
# the reduced Mamba2-2.7B
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced():
    jcfg, tcfg = _cfgs()
    jm, tm = JModel(jcfg), TModel(tcfg)
    return jm, tm, jm.init_params(jax.random.key(0))


def test_reduced_layout_and_init(reduced):
    jm, tm, jparams = reduced
    assert [s.mixer for s in tm.cfg.prefix] == ["ssm", "ssm"]
    assert (tm.cfg.ssm_chunk, tm.cfg.ssm_heads, tm.cfg.ssm_inner) == \
        (16, 16, 512)
    tparams = from_jax_params(_np_tree(jparams))
    jb, tb = JBoundary(jparams), TBoundary(tparams)
    assert tb.shapes == jb.shapes and tb.d == jb.d
    np.testing.assert_array_equal(tb.flatten(tparams).numpy(),
                                  np.asarray(jb.flatten(jparams)))
    own = tm.init_params(prng.key(0))
    for j, t in zip(jax.tree.leaves(_np_tree(jparams)), tree_leaves(own)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


def test_reduced_loss_and_grads_match_jax(reduced):
    jm, tm, jparams = reduced
    jparams = _perturbed(jparams, 8)
    tokens = np.random.default_rng(2).integers(
        0, jm.cfg.vocab_size, (2, SEQ + 1)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(tokens)})[0]))(jparams)
    tparams = from_jax_params(_np_tree(jparams))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tloss = tm.loss_fn(tree_unflatten(tparams, leaves),
                       {"tokens": torch.from_numpy(tokens)})[0]
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TBoundary(tparams).flatten_leaves(tgrads).numpy(),
        np.asarray(JBoundary(jparams).flatten(jgrads)), rtol=1e-5,
        atol=1e-5)


def test_reduced_run_scan_matches_jax(reduced):
    """4 peers, sign flip on peer 3 from step 0, 2 validators, 4 steps, at
    seq 40: the same bans, ban steps and accusations, |g_hat| and the
    final parameters within 1e-5."""
    jm, tm, jparams = reduced

    def config(cls, attack, **kw):
        return cls(n_peers=4, byzantine=(3,),
                   attack=attack(kind="sign_flip", start_step=0, delay=5),
                   tau=1.0, clip_iters=5, m_validators=2, **kw)

    def trainer(cls, model, params, pipe, cfg, opt):
        return cls(lambda p, b: model.loss_fn(p, b)[0], params,
                   lambda peer, step, flipped: pipe.device_batch(step, peer),
                   cfg, optimizer=opt)

    jtr = trainer(JTrainer, jm, jparams, JPipeline(512, SEQ, 2),
                  config(JTrainerConfig, JAttack), jsgd(0.05))
    jtr.run_scan(4)
    ttr = trainer(TTrainer, tm, from_jax_params(_np_tree(jparams)),
                  TPipeline(512, SEQ, 2),
                  config(TTrainerConfig, TAttack, device="cpu"), tsgd(0.05))
    ttr.run_scan(4)
    assert [r["banned_now"] for r in ttr.history] == \
        [r["banned_now"] for r in jtr.history]
    assert ttr.banned == jtr.banned == {3}
    for t, j in zip(ttr.history, jtr.history):
        assert t["accused_peers"] == j["accused_peers"] and \
            not set(t["accused_peers"]) - {3}
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(ttr.params.numpy(), np.asarray(jtr.params),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("repeats, count", [(64, WHOLE),
                                            (CUT_REPEATS, CUT)])
def test_param_counts_equal_jax(repeats, count):
    """Whole, and cut to 36 of its 64 layers as the card trains it
    (``chip_smoke.py`` phase (w)), from shapes alone."""
    jcfg, tcfg = (dataclasses.replace(c, n_repeats=repeats) for c in
                  (jget_config(ARCH), tget_config(ARCH)))
    assert TModel(tcfg).param_count() == JModel(jcfg).param_count() == count
