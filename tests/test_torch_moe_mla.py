"""The MoE and MLA family of the port (DeepSeek-V2-Lite, DBRX) against the
JAX package on the same numpy inputs from a seed:

* ``moe_init``: the port's own draw within 1e-6 of the JAX package's (one
  key per expert);
* ``moe_apply`` at small widths, with and without shared experts and the
  gated MLP, without drops, with ``capacity_factor`` 0.5 (tokens dropped)
  and with tied router logits: the routing (top experts, slots, keeps)
  equal exactly, read from the JAX package's per-row ``jax.vmap``; y and
  the gradients within 1e-5, aux within 1e-6;
* ``mla_apply`` in train mode (q/k head 48, v head 16) within 1e-5;
* the reduced DeepSeek-V2-Lite (MLA + dense, MLA + MoE) and DBRX
  (layernorm, GQA + MoE, no shared experts): the converted flat vector bit
  for bit, the port's own init within 1e-6, loss, ``aux_loss`` and flat
  gradients within 1e-4, and ``run_scan`` over 4 peers with a sign flip on
  peer 3 for 4 steps: the same bans, ban steps and reasons, |g_hat| and
  final parameters within 1e-5;
* the parameter count of DeepSeek-V2-Lite cut to 2 of its 26 repeats, from
  shapes alone, equal to the JAX package's ``param_count``;
* the config checks MoE, MLA and SSM blocks need."""
import dataclasses
import functools

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
from repro.models import moe as jmoe
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
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.optim import sgd as tsgd

SMALL_MOE = dict(d_model=64, n_experts=4, top_k=2, d_ff_expert=32,
                 dtype="float32")
MOE_B, MOE_S = 2, 32
DEEPSEEK_CUT = 1_670_135_296  # the JAX package's param_count, 3 layers
DEEPSEEK_FULL = 15_706_484_224  # all 27 layers


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


class _VmapSpy:
    """Stands in for ``jax`` inside ``repro.models.moe``: every name is
    jax's, but the outputs of each ``jax.vmap``-ed call are kept, so the
    per-row routing (buf, slots, keeps, top_e, top_p, aux) can be returned
    from the traced call beside the layer's output."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = jax.vmap(fn, *args, **kwargs)

        def run(*xs):
            out = mapped(*xs)
            self.outputs.append(out)
            return out
        return run


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_moe_init_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, **SMALL_MOE)
    j = _np_tree(jmoe.moe_init(jax.random.key(2), jcfg))
    t = tmoe.moe_init(prng.key(2), tcfg)
    assert ("shared" in t) == bool(tcfg.n_shared_experts)
    assert t["experts_wi"].shape == (4, 64, 32)
    assert t["router"].dtype == torch.float32
    for jl, tl in zip(jax.tree.leaves(j), tree_leaves(t)):
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-6)


MOE_CASES = {
    "shared_glu": ("deepseek-v2-lite-16b", dict(capacity_factor=4.0)),
    "glu": ("dbrx-132b", dict(capacity_factor=4.0)),
    "shared_gelu": ("deepseek-v2-lite-16b",
                    dict(glu=False, act="gelu", capacity_factor=4.0)),
    "dropped": ("deepseek-v2-lite-16b", dict(capacity_factor=0.5)),
    "dropped_no_shared": ("dbrx-132b", dict(capacity_factor=0.5)),
    "ties": ("deepseek-v2-lite-16b", dict(capacity_factor=1.25)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case, monkeypatch):
    arch, kw = MOE_CASES[case]
    jcfg, tcfg = _cfgs(arch, **SMALL_MOE, **kw)
    jp = jmoe.moe_init(jax.random.key(3), jcfg)
    if case == "ties":  # experts 1 and 3 copy 0 and 2: equal logits
        r = jp["router"]
        jp = dict(jp, router=r.at[:, 1].set(r[:, 0]).at[:, 3].set(r[:, 2]))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(MOE_B, MOE_S, 64)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    spy = _VmapSpy()
    monkeypatch.setattr(jmoe, "jax", spy)

    @jax.jit
    def reference(p, xx, ddy):
        """y, aux, their vector-Jacobian product and the routing."""
        def apply(p, xx):
            first = len(spy.outputs)  # the routing's vmap, then the combine's
            out = jmoe.moe_apply(p, jcfg, xx)
            return out, spy.outputs[first][1:]
        out, vjp, routing = jax.vjp(apply, p, xx, has_aux=True)
        return out, vjp((ddy, jnp.ones((), jnp.float32))), routing

    (jy, jaux), (j_dp, j_dx), routing = reference(jp, jnp.asarray(x),
                                                  jnp.asarray(dy))
    j_slots, j_keeps, j_top_e, j_top_p, j_aux = routing

    tp = from_jax_params(_np_tree(jp))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    tparams = tree_unflatten(tp, leaves)
    r = tmoe.route(tparams, tcfg, tx)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(j_top_e))
    np.testing.assert_array_equal(r.slots.numpy(), np.asarray(j_slots))
    np.testing.assert_array_equal(r.keeps.numpy(), np.asarray(j_keeps))
    np.testing.assert_allclose(r.top_p.detach().numpy(), np.asarray(j_top_p),
                               rtol=0, atol=1e-6)
    keeps = r.keeps.numpy()
    if case.startswith("dropped"):
        assert 0 < (~keeps).sum() < keeps.size
    else:
        assert keeps.all()
    if case == "ties":  # tied pairs chosen, the lower expert first
        tied = np.isin(r.top_e[..., 0].numpy(), (0, 2)) & \
            (r.top_e[..., 1].numpy() == r.top_e[..., 0].numpy() + 1)
        assert tied.sum() == MOE_B * MOE_S

    ty, taux = tmoe.moe_apply(tparams, tcfg, tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(r.aux.detach().numpy(), np.asarray(j_aux),
                               rtol=0, atol=1e-6)
    grads = torch.autograd.grad(
        (ty * torch.from_numpy(dy)).sum() + taux, leaves + [tx])
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(j_dx),
                               rtol=1e-5, atol=1e-5)
    for jg, tg in zip(jax.tree.leaves(_np_tree(j_dp)), grads[:-1]):
        np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5, atol=1e-5)


def test_mla_apply_train_matches_jax():
    """q = nope + rope = 48 wide, v 16: the latent normed with a random
    scale, expanded per head, the roped key shared by the heads."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b", d_model=64, n_heads=4,
                       kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32,
                       v_head_dim=16, dtype="float32")
    spec = jcfg.prefix[0]
    jp = _perturbed(jattn.mla_init(jax.random.key(5), jcfg, spec), 6)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    j = jax.jit(lambda p, xx, pp: jattn.mla_apply(
        p, jcfg, spec, xx, pos=pp, mode="train")[0])(
            jp, jnp.asarray(x), jnp.asarray(pos))
    tp = from_jax_params(_np_tree(jp))
    own = tattn.mla_init(prng.key(5), tcfg, spec)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tp["kv_b"].shape == (32, 4 * (32 + 16))
    t = tattn.mla_apply(tp, tcfg, spec, torch.from_numpy(x),
                        torch.from_numpy(pos))
    assert t.shape == x.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b"]


@functools.lru_cache(maxsize=None)
def _reduced(arch):
    """Both packages' reduced models and the JAX package's parameters
    (key 0), made once for the file's tests."""
    jm = JModel(jreduce(jget_config(arch)))
    return jm, TModel(treduce(tget_config(arch))), \
        jm.init_params(jax.random.key(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_flat_layout_and_init(arch):
    """Stacked (E, ...) expert leaves and the MLA leaves cross bit for bit;
    the port's init draws each expert from its own split key."""
    jm, tm, jparams = _reduced(arch)
    kinds = {(s.mixer, s.mlp) for s in tm.cfg.layers}
    assert kinds == ({("mla", "dense"), ("mla", "moe")} if arch.startswith(
        "deepseek") else {("attn_full", "moe")})
    tparams = from_jax_params(_np_tree(jparams))
    jb, tb = JBoundary(jparams), TBoundary(tparams)
    assert tb.shapes == jb.shapes and tb.d == jb.d
    assert tparams["prefix"][1]["moe"]["experts_wdown"].shape == (4, 128, 256)
    np.testing.assert_array_equal(tb.flatten(tparams).numpy(),
                                  np.asarray(jb.flatten(jparams)))
    own = tm.init_params(prng.key(0))
    for j, t in zip(jax.tree.leaves(_np_tree(jparams)), tree_leaves(own)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_aux_and_grads_match_jax(arch):
    jm, tm, jparams = _reduced(arch)
    jparams = _perturbed(jparams, 8)
    tokens = np.random.default_rng(2).integers(
        0, jm.cfg.vocab_size, (2, 17)).astype(np.int32)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jparams)
    tparams = from_jax_params(_np_tree(jparams))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tloss, tmet = tm.loss_fn(tree_unflatten(tparams, leaves),
                             {"tokens": torch.from_numpy(tokens)})
    tgrads = torch.autograd.grad(tloss, leaves)
    assert float(tmet["aux_loss"]) > 0
    for t, j in ((tloss, jloss), (tmet["loss"], jmet["loss"]),
                 (tmet["aux_loss"], jmet["aux_loss"])):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(
        TBoundary(tparams).flatten_leaves(tgrads).numpy(),
        np.asarray(JBoundary(jparams).flatten(jgrads)), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_run_scan_matches_jax(arch):
    """4 peers, sign flip on peer 3 from step 0, 2 validators, 4 steps."""
    jm, tm, jparams = _reduced(arch)

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
        # the port's norms accumulate in float64 on the CPU
        # (core/norms.py), so the clip weights, and |g_hat| with them,
        # follow the JAX engine's to float32 rounding
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(ttr.params.numpy(), np.asarray(jtr.params),
                               rtol=1e-5, atol=1e-5)


def test_cut_deepseek_param_count_equals_jax():
    """The dense MLA layer 0 and 2 of the 26 MLA + MoE repeats at the
    published widths, counted from shapes (the meta device), never
    allocated; the whole model's count beside it."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b", n_repeats=2)
    assert tcfg.n_layers == 3
    assert TModel(tcfg).param_count() == JModel(jcfg).param_count() \
        == DEEPSEEK_CUT
    assert JModel(jget_config("deepseek-v2-lite-16b")).param_count() \
        == DEEPSEEK_FULL


@pytest.mark.parametrize("spec, missing", [
    (LayerSpec("attn_full", "moe"), dict(n_experts=0)),
    (LayerSpec("attn_full", "moe"), dict(top_k=0)),
    (LayerSpec("mla", "dense"), dict(kv_lora_rank=0)),
    (LayerSpec("ssm", "none"), dict(ssm_state=0))])
def test_validate_refuses_blocks_without_their_sizes(spec, missing):
    cfg = dataclasses.replace(tget_config("deepseek-v2-lite-16b"),
                              prefix=(spec,), pattern=(), n_repeats=0,
                              **missing)
    with pytest.raises(AssertionError):
        cfg.validate()
    with pytest.raises(AssertionError):
        TModel(cfg)
