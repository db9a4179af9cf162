"""The dense-decoder family of the port (RoPE, QKV bias, QK-norm, unshared
layers) against the JAX package on the same numpy inputs from a seed:

* layers: ``rope_freqs`` bit for bit; ``apply_rope`` in its three modes at
  (2, 16, 4, 64), float32 within 1e-6 and bfloat16 within one bfloat16 ulp
  (2^-7 relative: both sides round the same float32 rotation, which may
  differ in its last bit); ``rms_head_norm`` within 1e-6;
* ``gqa_apply`` in train mode with rope, random QKV biases and QK-norm
  scales, 4 heads over 2 KV heads, within 1e-5;
* a small Qwen3 (the real config at d_model 128, 4 heads over 2 KV heads,
  head_dim 32, d_ff 256, vocab 512, three unshared repeats, float32): the
  converted flat vector bit for bit, the port's own init within 1e-6 (one
  key per repeat), loss and flat gradients within 1e-4 (also with random
  biases and norm scales), and ``run_scan`` over 4 peers with a sign flip
  on peer 3 for 4 steps: the same bans, ban steps and reasons, final
  parameters within 1e-4;
* loss and gradients of the reduced ChatGLM3-6B (QKV bias, GLM's half
  rope) and Qwen1.5-110B (QKV bias);
* cross attention, beside a local or global self-attention or alone,
  builds in the small Qwen3's config and applies over a memory within
  1e-5 of the JAX package's block; so do the two SSM blocks (the mixer
  alone, and with a dense MLP)."""
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
from repro.models.model import Model as JModel
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_config as treduce
from repro_torch.configs.base import LayerSpec
from repro_torch.core import prng
from repro_torch.core.btard_sgd import BTARDTrainer as TTrainer
from repro_torch.core.btard_sgd import TrainerConfig as TTrainerConfig
from repro_torch.core.flatten import FlatBoundary as TBoundary
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.core.protocol import AttackConfig as TAttack
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.optim import sgd as tsgd

SMALL_QWEN3 = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                   d_ff=256, vocab_size=512, n_repeats=3, dtype="float32")
BF16_ULP = 2.0 ** -7


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
        if "bias" in name or "norm" in name:
            return jnp.asarray(rng.normal(1.0, 0.5, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, jparams)


def _rope_cfgs(mode):
    return _cfgs("chatglm3-6b", rope=mode, rope_theta=10000.0)


@pytest.mark.parametrize("arch, dims", [("qwen3-1.7b", (128, 64)),
                                        ("chatglm3-6b", (64, 32))])
def test_rope_freqs_equal_jax_bitwise(arch, dims):
    jcfg, tcfg = _cfgs(arch)
    for dim in dims:
        j, t = jlayers.rope_freqs(jcfg, dim), tlayers.rope_freqs(tcfg, dim)
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mode", ["standard", "half", "none"])
def test_apply_rope_matches_jax(mode):
    jcfg, tcfg = _rope_cfgs(mode)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 64)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32) + 3
    j = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None],
                                      jcfg))
    t = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)[None],
                           tcfg)
    assert t.dtype == torch.float32 and t.shape == x.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)
    if mode == "half":  # the second half of the head dim passes through
        np.testing.assert_array_equal(t.numpy()[..., 32:], x[..., 32:])
    if mode == "none":
        np.testing.assert_array_equal(t.numpy(), x)
    jb = jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos)[None],
                            jcfg)
    tb = tlayers.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(pos)[None], tcfg)
    assert tb.dtype == torch.bfloat16
    np.testing.assert_allclose(tb.float().numpy(),
                               np.asarray(jb.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=BF16_ULP)


def test_rms_head_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 4, 64)).astype(np.float32)
    scale = rng.normal(1.0, 0.5, 64).astype(np.float32)
    j = jlayers.rms_head_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6)
    t = tlayers.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x),
                              1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["standard", "half"])
def test_gqa_apply_train_matches_jax(mode):
    """Projection, random biases, heads, random QK-norm scales, rope, 4
    heads over 2 KV heads, causal softmax, output projection."""
    jcfg, tcfg = _cfgs("qwen3-1.7b", d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, qkv_bias=True, rope=mode,
                       dtype="float32")
    spec = jcfg.pattern[0]
    jp = _perturbed(jattn.gqa_init(jax.random.key(4), jcfg, spec), 5)
    assert {"wq_bias", "wk_bias", "wv_bias", "q_norm", "k_norm"} <= set(jp)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    j, _ = jattn.gqa_apply(jp, jcfg, spec, jnp.asarray(x),
                           pos=jnp.asarray(pos), mode="train")
    t = tattn.gqa_apply(from_jax_params(_np_tree(jp)), tcfg, spec,
                        torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


def _small_qwen3(**kw):
    jcfg, tcfg = _cfgs("qwen3-1.7b", **SMALL_QWEN3, **kw)
    return JModel(jcfg), TModel(tcfg)


def test_small_qwen3_flat_layout_and_init():
    """Stacked (n_repeats, ...) leaves and float32 norm scales cross bit
    for bit; the port's init draws each repeat from its own split key."""
    jm, tm = _small_qwen3()
    assert not jm.cfg.share_pattern_params and jm.cfg.n_repeats == 3
    jparams = jm.init_params(jax.random.key(3))
    tparams = from_jax_params(_np_tree(jparams))
    jb, tb = JBoundary(jparams), TBoundary(tparams)
    assert tb.shapes == jb.shapes and tb.d == jb.d
    assert tparams["pattern"]["l0"]["mixer"]["wq"].shape == (3, 128, 128)
    assert tparams["pattern"]["l0"]["mixer"]["q_norm"].dtype == torch.float32
    np.testing.assert_array_equal(tb.flatten(tparams).numpy(),
                                  np.asarray(jb.flatten(jparams)))
    own = tm.init_params(prng.key(3))
    for j, t in zip(jax.tree.leaves(_np_tree(jparams)), tree_leaves(own)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


def _loss_and_grads(jm, tm, jparams, seed=0, B=2, S=16):
    tokens = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    tparams = from_jax_params(_np_tree(jparams))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(tokens)})[0])(jparams)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tloss = tm.loss_fn(tree_unflatten(tparams, leaves),
                       {"tokens": torch.from_numpy(tokens)})[0]
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        TBoundary(tparams).flatten_leaves(tgrads).numpy(),
        np.asarray(JBoundary(jparams).flatten(jgrads)), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("perturb", [False, True])
def test_small_qwen3_loss_and_grads_match_jax(perturb):
    jm, tm = _small_qwen3(qkv_bias=perturb)
    jparams = jm.init_params(jax.random.key(0))
    if perturb:
        jparams = _perturbed(jparams, 7)
    _loss_and_grads(jm, tm, jparams, seed=int(perturb))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen1.5-110b"])
def test_reduced_dense_decoders_match_jax(arch):
    jm = JModel(jreduce(jget_config(arch)))
    tm = TModel(treduce(tget_config(arch)))
    assert tm.cfg.qkv_bias and tm.cfg.d_model == 256
    _loss_and_grads(jm, tm, _perturbed(jm.init_params(jax.random.key(1)), 8),
                    seed=2)


def test_small_qwen3_run_scan_matches_jax():
    """4 peers, sign flip on peer 3 from step 0, 2 validators, 4 steps."""
    jm, tm = _small_qwen3()
    jparams = jm.init_params(jax.random.key(0))

    def config(cls, attack, **kw):
        return cls(n_peers=4, byzantine=(3,),
                   attack=attack(kind="sign_flip", start_step=0, delay=5),
                   tau=1.0, clip_iters=5, m_validators=2, **kw)

    def trainer(cls, model, params, pipe, cfg, opt):
        return cls(lambda p, b: model.loss_fn(p, b)[0], params,
                   lambda peer, step, flipped: pipe.device_batch(step, peer),
                   cfg, optimizer=opt)

    jtr = trainer(JTrainer, jm, jparams, JPipeline(512, 16, 2),
                  config(JTrainerConfig, JAttack), jsgd(0.05))
    jtr.run_scan(4)
    ttr = trainer(TTrainer, tm, from_jax_params(_np_tree(jparams)),
                  TPipeline(512, 16, 2),
                  config(TTrainerConfig, TAttack, device="cpu"), tsgd(0.05))
    ttr.run_scan(4)
    assert [r["banned_now"] for r in ttr.history] == \
        [r["banned_now"] for r in jtr.history]
    assert ttr.banned == jtr.banned == {3}
    for t, j in zip(ttr.history, jtr.history):
        assert t["accused_peers"] == j["accused_peers"] and \
            not set(t["accused_peers"]) - {3}
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(ttr.params.numpy(), np.asarray(jtr.params),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mixer, cross", [
    ("attn_local", True), ("attn_cross", False), ("attn_full", True)])
def test_cross_blocks_build_and_apply_with_memory(mixer, cross):
    """The three cross-attending blocks that used to raise: the JAX
    package's init carried over, random biases and norm scales, and where
    the block is gated ``xgate`` 0.5; the block over x (2, 40, d) (past the
    reduced window of 32 for the local one) and a memory (2, 24, d) within
    1e-5 of the JAX package's."""
    from repro.configs.base import LayerSpec as JLayerSpec
    from repro.models import transformer as jtfm

    jspec, tspec = (JLayerSpec(mixer, "dense", cross),
                    LayerSpec(mixer, "dense", cross))
    jcfg, tcfg = _cfgs("qwen3-1.7b", **SMALL_QWEN3, pattern=(tspec,),
                       window=32)
    jcfg = dataclasses.replace(jcfg, pattern=(jspec,))
    jp = _perturbed(jtfm.block_init(jax.random.key(3), jcfg, jspec), 4)
    if mixer == "attn_cross":
        jp["mixer"]["xgate"] = jnp.asarray(0.5, jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, 128)).astype(np.float32)
    mem = rng.normal(size=(2, 24, 128)).astype(np.float32)
    jy, _, _ = jtfm.block_apply(jp, jcfg, jspec, jnp.asarray(x),
                                pos=jnp.arange(40), memory=jnp.asarray(mem),
                                cache=None, mode="train")
    tp = from_jax_params(_np_tree(jp))
    assert sorted(tp["mixer"]) == sorted(jp["mixer"])
    ty, aux = ttfm.block_apply(tp, tcfg, tspec, torch.from_numpy(x),
                               torch.arange(40),
                               memory=torch.from_numpy(mem))
    assert float(aux) == 0.0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    own = ttfm.block_init(prng.key(3), tcfg, tspec)
    assert sorted(own) == sorted(jp) and sorted(own["mixer"]) == \
        sorted(jp["mixer"])


@pytest.mark.parametrize("spec", [LayerSpec("ssm", "none"),
                                  LayerSpec("ssm", "dense")])
def test_blocks_not_ported_raise_naming_item_13(spec):
    """The two SSM blocks, which raised ``NotImplementedError`` naming item
    13 until the SSM was ported: built in the small Qwen3's config with
    the SSM's sizes (state 16, head dim 32, chunk 8), the JAX package's
    init carried over with random biases and norm scales (``dt_bias`` and
    ``gate_norm`` among them), ``A_log``, ``D`` and the conv's bias, and
    applied over x (2, 21, d), a ragged last chunk,
    within 1e-5 of the JAX package's block."""
    from repro.configs.base import LayerSpec as JLayerSpec
    from repro.models import transformer as jtfm

    jspec = JLayerSpec(spec.mixer, spec.mlp)
    ssm = dict(ssm_state=16, ssm_head_dim=32, ssm_chunk=8)
    jcfg, tcfg = _cfgs("qwen3-1.7b", **SMALL_QWEN3, **ssm, pattern=(spec,))
    jcfg = dataclasses.replace(jcfg, pattern=(jspec,))
    jp = _perturbed(jtfm.block_init(jax.random.key(3), jcfg, jspec), 4)
    rng = np.random.default_rng(6)
    for name in ("A_log", "D", "conv_b"):
        jp["mixer"][name] = jnp.asarray(
            rng.normal(1.0, 0.5, jp["mixer"][name].shape), jnp.float32)
    x = rng.normal(size=(2, 21, 128)).astype(np.float32)
    jy, _, _ = jax.jit(lambda p, x: jtfm.block_apply(
        p, jcfg, jspec, x, pos=jnp.arange(21), memory=None, cache=None,
        mode="train"))(jp, jnp.asarray(x))
    tp = from_jax_params(_np_tree(jp))
    ty, aux = ttfm.block_apply(tp, tcfg, spec, torch.from_numpy(x),
                               torch.arange(21))
    assert float(aux) == 0.0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    own = ttfm.block_init(prng.key(3), tcfg, spec)
    assert sorted(own) == sorted(jp) and sorted(own["mixer"]) == \
        sorted(jp["mixer"])
