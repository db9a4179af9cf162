"""Local attention and the RG-LRU of the port (Gemma3-27B,
RecurrentGemma-9B) against the JAX package on the same numpy inputs from
a seed, float32 at reduced widths:

* ``causal_attention(window=32)`` at S = 32, 33, 64 and 1100 (past 1024 the
  JAX package's ``_windowed_attention`` runs two query blocks) within
  1e-5, and which keys each position sees: exactly i - 31 .. i;
* the sqrt(d_model) embedding scale of both names, bit for bit in bf16 at
  the published widths (sqrt(5376) rounds to 73.5) and in float32;
* ``causal_conv1d`` in float32 and bf16, bit for bit;
* ``rglru_init`` (``lam`` bit for bit) and ``rglru_apply`` against the
  JAX package's ``associative_scan`` at S = 1, 7, 64, 257, forward and
  gradients within 1e-5 of the largest values;
* the reduced Gemma3-27B (local + global attention) and RecurrentGemma-9B
  (RG-LRU + local attention) at seq 48 (> window 32): the converted flat
  vector bit for bit, the port's own init within 1e-6, loss and flat
  gradients within 1e-5; ``run_scan`` over 4 peers with a sign flip on
  peer 3 for 4 steps: the same bans, ban steps and accusations, |g_hat|
  and final parameters within 1e-5;
* the parameter counts of both whole configs and of the depth cuts the
  card trains, from shapes alone, equal to the JAX package's."""
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
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models.model import Model as JModel
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_config as treduce
from repro_torch.configs.base import LSA, RG
from repro_torch.core import prng
from repro_torch.core.btard_sgd import BTARDTrainer as TTrainer
from repro_torch.core.btard_sgd import TrainerConfig as TTrainerConfig
from repro_torch.core.flatten import FlatBoundary as TBoundary
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.core.protocol import AttackConfig as TAttack
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.optim import sgd as tsgd

ARCHS = ["gemma3-27b", "recurrentgemma-9b"]
SEQ = 48  # longer than the reduced window, 32
COUNTS = {  # the JAX package's param_count: whole, and the card's cut
    "gemma3-27b": (27_008_335_616, 1_822_179_328),
    "recurrentgemma-9b": (9_396_195_328, 1_705_062_400),
}
CUTS = {  # one LSA layer; one (RG, RG, LSA) repeat without the prefix
    "gemma3-27b": dict(prefix=(LSA,), pattern=(), n_repeats=0),
    "recurrentgemma-9b": dict(prefix=(), n_repeats=1),
}


def _cfgs(arch, **kw):
    """The same configuration in both packages."""
    return (dataclasses.replace(jget_config(arch), **kw),
            dataclasses.replace(tget_config(arch), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(jparams, seed):
    """Random values in every bias and norm scale (their init is zeros and
    ones, which would test nothing)."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if "bias" in name or "norm" in name or "conv_b" in name:
            return jnp.asarray(rng.normal(1.0, 0.5, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, jparams)


def _close(t, j, tol=1e-5):
    """Within ``tol`` of the largest value of the reference."""
    j = np.asarray(j, np.float32)
    scale = max(float(np.abs(j).max()), 1e-30)
    err = float(np.abs(np.asarray(t, np.float32) - j).max())
    assert err <= tol * scale, f"max err {err:.3e} of {scale:.3e}"


# ---------------------------------------------------------------------------
# local attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [32, 33, 64, 1100])
def test_local_attention_matches_jax(S):
    B, H, D, window = 2, 2, 16, 32
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    j = jattn.causal_attention(jnp.asarray(q).reshape(B, S, H, 1, D),
                               jnp.asarray(k), jnp.asarray(v), window=window)
    t = tattn.causal_attention(*map(torch.from_numpy, (q, k, v)),
                               window=window)
    assert t.shape == (B, S, H, D)
    np.testing.assert_allclose(t.numpy(), np.asarray(j).reshape(B, S, H, D),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [33, 1100])
def test_local_attention_sees_exactly_its_window(S):
    """Equal scores and one-hot values: position i's output is uniform
    over the keys it sees, which must be i - 31 .. i."""
    window = 32
    q = torch.zeros((1, S, 1, 4))
    v = torch.eye(S)[None, :, None, :]
    out = tattn.causal_attention(q, q, v, window=window)[0, :, 0]
    for i in range(S):
        seen = torch.nonzero(out[i]).flatten().tolist()
        assert seen == list(range(max(0, i - window + 1), i + 1)), i
        np.testing.assert_allclose(out[i, seen].numpy(), 1.0 / len(seen),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# embeddings and the conv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_embed_scale_matches_jax(arch, reduced):
    """Published widths in bf16 (the scale rounded to bf16 before the
    product), reduced widths in float32, bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    if reduced:
        jcfg, tcfg = jreduce(jcfg), treduce(tcfg)
    jcfg, tcfg = (dataclasses.replace(c, vocab_size=64) for c in (jcfg, tcfg))
    jdt = jnp.bfloat16 if jcfg.dtype == "bfloat16" else jnp.float32
    table = jax.random.normal(jax.random.key(1), (64, jcfg.d_model), jdt)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 9)).astype(np.int32)
    j = jlayers.embed_tokens({"embed": table}, jcfg, jnp.asarray(tokens))
    t = tlayers.embed_tokens(from_jax_params({"embed": np.asarray(table)}),
                             tcfg, torch.from_numpy(tokens))
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))
    scale = float(tlayers.embed_scale(tcfg, t.dtype))
    assert scale == {(False, "gemma3-27b"): 73.5,
                     (False, "recurrentgemma-9b"): 64.0}.get(
                         (reduced, arch), 16.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jlayers.conv1d_init(jax.random.key(3), 24, 4, jdt)
    jp["conv_b"] = jnp.asarray(np.random.default_rng(4).normal(size=24), jdt)
    x = jnp.asarray(np.random.default_rng(5).normal(size=(2, 13, 24)), jdt)
    j = jlayers.causal_conv1d(jp, x)
    tp = from_jax_params(_np_tree(jp))
    t = tlayers.causal_conv1d(tp, from_jax_params(np.asarray(x)))
    assert t.dtype == tp["conv_w"].dtype and t.shape == (2, 13, 24)
    own = tlayers.conv1d_init(prng.key(3), 24, 4, tp["conv_w"].dtype)
    np.testing.assert_allclose(own["conv_w"].float().numpy(),
                               np.asarray(jp["conv_w"].astype(jnp.float32)),
                               rtol=0, atol=1e-6)
    # the same products added in the same order: the same bits
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def _rglru_cfgs():
    jcfg, tcfg = (jreduce(c) for c in _cfgs("recurrentgemma-9b"))
    return (dataclasses.replace(jcfg, d_model=32, rglru_width=48),
            dataclasses.replace(tcfg, d_model=32, rglru_width=48))


def test_rglru_init_matches_jax():
    jcfg, tcfg = _rglru_cfgs()
    j = _np_tree(jrglru.rglru_init(jax.random.key(6), jcfg))
    t = trglru.rglru_init(prng.key(6), tcfg)
    assert sorted(t) == sorted(j)
    np.testing.assert_array_equal(t["lam"].numpy(), j["lam"])
    assert t["lam"].dtype == torch.float32
    for jl, tl in zip(jax.tree.leaves(j), tree_leaves(t)):
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-6)


@pytest.mark.parametrize("S", [1, 7, 64, 257])
def test_rglru_apply_matches_jax(S):
    """y and the gradients of <y, c> for a random c, to the inputs and every
    parameter, within 1e-5 of the largest values."""
    jcfg, tcfg = _rglru_cfgs()
    jp = _perturbed(jrglru.rglru_init(jax.random.key(7), jcfg), 8)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 32)).astype(np.float32)
    c = rng.normal(size=(2, S, 32)).astype(np.float32)

    def jloss(p, x):
        y, _ = jrglru.rglru_apply(p, jcfg, RG, x)
        return jnp.sum(y * c), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = from_jax_params(_np_tree(jp))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = trglru.rglru_apply(tree_unflatten(tp, leaves), tcfg, RG, tx)
    grads = torch.autograd.grad((ty * torch.from_numpy(c)).sum(),
                                leaves + [tx])
    _close(ty.detach().numpy(), jy)
    _close(grads[-1].numpy(), jgx)
    for t, j in zip(grads[:-1], jax.tree.leaves(jgp)):
        _close(t.numpy(), j)


def test_linear_scan_is_the_recurrence():
    """The odd/even scan computes h_t = a_t h_{t-1} + b_t (float64 loop)."""
    rng = np.random.default_rng(9)
    log_a = -rng.uniform(0.0, 0.5, (2, 37, 5))
    b = rng.normal(size=(2, 37, 5))
    cum, h = trglru.linear_scan(torch.from_numpy(log_a), torch.from_numpy(b))
    ref, hh = np.zeros_like(b), np.zeros((2, 5))
    for t in range(37):
        hh = np.exp(log_a[:, t]) * hh + b[:, t]
        ref[:, t] = hh
    np.testing.assert_allclose(h.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cum.numpy(), np.cumsum(log_a, 1), rtol=1e-12)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
def _reduced(arch):
    jm = JModel(jreduce(jget_config(arch)))
    tm = TModel(treduce(tget_config(arch)))
    return jm, tm, jm.init_params(jax.random.key(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_layout_and_init(arch):
    jm, tm, jparams = _reduced(arch)
    mixers = [s.mixer for s in tm.cfg.prefix]
    assert mixers == {"gemma3-27b": ["attn_local", "attn_full"],
                      "recurrentgemma-9b": ["rglru", "attn_local"]}[arch]
    assert tm.cfg.window == 32 and tm.cfg.name.endswith("-smoke")
    tparams = from_jax_params(_np_tree(jparams))
    jb, tb = JBoundary(jparams), TBoundary(tparams)
    assert tb.shapes == jb.shapes and tb.d == jb.d
    np.testing.assert_array_equal(tb.flatten(tparams).numpy(),
                                  np.asarray(jb.flatten(jparams)))
    own = tm.init_params(prng.key(0))
    for j, t in zip(jax.tree.leaves(_np_tree(jparams)), tree_leaves(own)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_and_grads_match_jax(arch):
    jm, tm, jparams = _reduced(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_run_scan_matches_jax(arch):
    """4 peers, sign flip on peer 3 from step 0, 2 validators, 4 steps, at
    seq 48."""
    jm, tm, jparams = _reduced(arch)

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


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch):
    """Whole, and cut as the card trains it (``chip_smoke.py`` phases (s)
    and (t)), from shapes alone: the meta device allocates nothing."""
    whole, cut = COUNTS[arch]
    jcfg, tcfg = _cfgs(arch, **CUTS[arch])
    assert TModel(tget_config(arch)).param_count() == whole
    assert JModel(jget_config(arch)).param_count() == whole
    assert TModel(tcfg).param_count() == JModel(jcfg).param_count() == cut


@pytest.mark.parametrize("spec", [LSA, RG])
def test_local_and_rglru_blocks_are_ported(spec):
    cfg = treduce(tget_config("recurrentgemma-9b"))
    p = ttfm.block_init(prng.key(0), cfg, spec)
    assert sorted(p) == ["mixer", "mlp", "norm1", "norm2"]
    x = torch.randn(1, 5, cfg.d_model)
    y, aux = ttfm.block_apply(p, cfg, spec, x, torch.arange(5))
    assert y.shape == x.shape and float(aux) == 0.0
