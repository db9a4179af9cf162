"""Cross attention, the encoder and the modality stream of the port
(Whisper-small, Llama-3.2-Vision) against the JAX package on the same
numpy inputs from a seed, float32 at reduced widths:

* the reduced Whisper-small (an encoder of 2 layers over 64 frames, a
  128 -> 256 projector, two self + cross decoder blocks) and
  Llama-3.2-Vision (a projector, one SA and one gated XA block, 4 heads
  over 1 KV head): layout (the ``mem_*`` keys, the ``fold_in(., 7)``
  keys' ``mem_wq``/``mem_wo``, the 0-d ``xgate``, ``enc_pos``, the
  projector) and the converted flat vector bit for bit, the port's own
  init bit for bit in its zeros and ones and within 1e-6 elsewhere;
* ``cross_attn_apply`` of a ``cross`` block and of ``attn_cross`` with
  ``xgate`` 0.5, plain, with QKV biases (only ``attn_cross``'s q takes
  one) and with QK-norm (the memory's keys take the head norm): output
  and every gradient (the weights, x, the memory) within 1e-5 of the
  largest values;
* the encoder alone (``enc_pos`` random), forward and gradients to 1e-5;
* each reduced model's loss and flat gradients fed the same ``memory_raw``
  (random biases, norm scales, ``enc_pos``, ``xgate`` 0.5) within 1e-5;
* the pipeline's extras: the tokens bit for bit, ``memory_raw`` within
  1e-6 (the normals' contract), the tag's crc32;
* ``run_scan`` over 4 peers, sign flip on peer 3 from step 0, 4 steps,
  each peer's ``memory_raw`` from the extras: the same bans, ban steps and
  accusations, |g_hat| and final parameters within 1e-5;
* the port's launcher on reduced Whisper-small (``--device cpu --mesh
  4x1``, host batches, and device batches in chunks of 2): each rank's
  step-0 rows (tokens bit for bit, ``memory_raw`` within 1e-6) and
  gradient against the JAX model's on the same rows (the JAX launcher's
  ``shard_map`` step does not run under this jax), the attacker banned;
* the whole and cut parameter counts, from shapes alone, equal to the JAX
  package's.

Nothing here starts a process; the launcher's ranks are threads of a
``LocalGroup`` with a rendezvous timeout."""
import dataclasses
import functools
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce
from repro.configs.base import DEC_XA as JDEC_XA
from repro.configs.base import SA as JSA
from repro.configs.base import XA as JXA
from repro.core.btard_sgd import BTARDTrainer as JTrainer
from repro.core.btard_sgd import TrainerConfig as JTrainerConfig
from repro.core.flatten import FlatBoundary as JBoundary
from repro.core.protocol import AttackConfig as JAttack
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.models.model import Model as JModel
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_config as treduce
from repro_torch.configs.base import DEC_XA, SA, XA
from repro_torch.core import prng
from repro_torch.core.btard_sgd import BTARDTrainer as TTrainer
from repro_torch.core.btard_sgd import TrainerConfig as TTrainerConfig
from repro_torch.core.flatten import FlatBoundary as TBoundary
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.core.protocol import AttackConfig as TAttack
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.optim import sgd as tsgd

ARCHS = ["whisper-small", "llama-3.2-vision-11b"]
SEQ = 16
COUNTS = {  # the JAX package's param_count: whole, and the card's cut
    "whisper-small": (264_426_240, 264_426_240),
    "llama-3.2-vision-11b": (9_806_614_536, 1_518_358_529),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(jparams, seed):
    """Random values in every bias, norm scale and ``enc_pos`` (their init
    is zeros and ones, which would test nothing), and ``xgate`` 0.5 (at
    its init of 0 the gated block's output is exactly zero)."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if "xgate" in name:
            return jnp.full(leaf.shape, 0.5, leaf.dtype)
        if "bias" in name or "norm" in name or "enc_pos" in name:
            return jnp.asarray(rng.normal(1.0, 0.5, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, jparams)


def _close(t, j, tol=1e-5):
    """Within ``tol`` of the largest value of the reference."""
    j = np.asarray(j, np.float32)
    scale = max(float(np.abs(j).max()), 1e-30)
    err = float(np.abs(np.asarray(t, np.float32) - j).max())
    assert err <= tol * scale, f"max err {err:.3e} of {scale:.3e}"


def _extras(cfg, dtype):
    return {"memory_raw": ((cfg.encoder_len, cfg.encoder_dim), dtype)}


@functools.lru_cache(maxsize=None)
def _reduced(arch):
    """The reduced model in both packages and the JAX init from key 0
    (immutable arrays, so the tests share one)."""
    jm = JModel(jreduce(jget_config(arch)))
    tm = TModel(treduce(tget_config(arch)))
    return jm, tm, jm.init_params(jax.random.key(0))


def _memory_raw(cfg, seed, batch=2):
    return (np.random.default_rng(seed).normal(
        size=(batch, cfg.encoder_len, cfg.encoder_dim)) * 0.02
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# layout and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_layout_and_init(arch):
    jm, tm, jparams = _reduced(arch)
    tparams = from_jax_params(_np_tree(jparams))
    if arch == "whisper-small":
        assert tm.cfg.prefix == (DEC_XA, DEC_XA) and tm.cfg.has_encoder
        blk = tparams["prefix"][0]
        assert sorted(blk) == ["mixer", "mlp", "norm1", "norm2", "norm_x"]
        assert sorted(blk["mixer"]) == ["mem_wk", "mem_wo", "mem_wq",
                                        "mem_wv", "wk", "wo", "wq", "wv"]
        assert tuple(tparams["enc_pos"].shape) == (64, 256)
        assert tuple(tparams["projector"].shape) == (128, 256)
        assert tparams["encoder_layers"]["mixer"]["wq"].shape[0] == 2
    else:
        assert tm.cfg.prefix == (SA, XA) and tm.cfg.is_decoder_only
        mixer = tparams["prefix"][1]["mixer"]
        assert sorted(mixer) == ["mem_wk", "mem_wv", "wo", "wq", "xgate"]
        assert mixer["xgate"].shape == () and float(mixer["xgate"]) == 0.0
        assert tuple(tparams["projector"].shape) == (128, 256)
        assert "enc_pos" not in tparams
    jb, tb = JBoundary(jparams), TBoundary(tparams)
    assert tb.shapes == jb.shapes and tb.d == jb.d
    np.testing.assert_array_equal(tb.flatten(tparams).numpy(),
                                  np.asarray(jb.flatten(jparams)))
    own = tm.init_params(prng.key(0))
    assert TBoundary(own).shapes == jb.shapes
    for j, t in zip(jax.tree.leaves(_np_tree(jparams)), tree_leaves(own)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        if np.all(j == 0) or np.all(j == 1):  # zeros and ones: exact
            np.testing.assert_array_equal(t.numpy(), j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch):
    """Whole, and cut as the card trains Llama-3.2-Vision (one (SA, XA)
    pair; ``chip_smoke.py`` phase (v)), from shapes alone."""
    whole, cut = COUNTS[arch]
    assert TModel(tget_config(arch)).param_count() == whole
    assert JModel(jget_config(arch)).param_count() == whole
    if arch == "llama-3.2-vision-11b":
        tcfg = dataclasses.replace(tget_config(arch), pattern=(SA, XA),
                                   n_repeats=1)
        jcfg = dataclasses.replace(jget_config(arch), pattern=(JSA, JXA),
                                   n_repeats=1)
        assert TModel(tcfg).param_count() == JModel(jcfg).param_count() == cut


# ---------------------------------------------------------------------------
# cross attention and the encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [{}, {"qkv_bias": True},
                                   {"qk_norm": True}])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attn_apply_matches_jax(arch, extra):
    """A ``cross`` block's cross attention (Whisper: 4 heads, 4 KV heads)
    and ``attn_cross`` (Llama-3.2-Vision: 4 heads over 1 KV head, rope
    in the self-attention only), ``xgate`` 0.5: y = cross_attn_apply(x,
    memory), and the gradients of <y, c> to every weight, x and the
    memory."""
    jcfg = dataclasses.replace(jreduce(jget_config(arch)), **extra)
    tcfg = dataclasses.replace(treduce(tget_config(arch)), **extra)
    jspec, tspec = (JDEC_XA, DEC_XA) if arch == "whisper-small" else \
        (JXA, XA)
    jp = _perturbed(jattn.gqa_init(jax.random.key(11), jcfg, jspec), 12)
    assert ("wq_bias" in jp) == bool(extra.get("qkv_bias"))
    assert ("wk" in jp) == (jspec is JDEC_XA)
    assert ("wk_bias" in jp) == ("wk" in jp and bool(extra.get("qkv_bias")))
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 9, 256)).astype(np.float32)
    mem = rng.normal(size=(2, 24, 256)).astype(np.float32)
    c = rng.normal(size=(2, 9, 256)).astype(np.float32)

    def jloss(p, x, mem):
        y, _ = jattn.cross_attn_apply(p, jcfg, jspec, x, memory=mem)
        return jnp.sum(y * c), y

    (_, jy), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(jp, jnp.asarray(x),
                                                 jnp.asarray(mem))
    tp = from_jax_params(_np_tree(jp))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx, tm = (torch.from_numpy(a).requires_grad_(True) for a in (x, mem))
    ty = tattn.cross_attn_apply(tree_unflatten(tp, leaves), tcfg, tspec, tx,
                                tm)
    tgrads = torch.autograd.grad((ty * torch.from_numpy(c)).sum(),
                                 leaves + [tx, tm], allow_unused=True)
    _close(ty.detach().numpy(), jy)
    _close(tgrads[-2].numpy(), jgrads[1])
    _close(tgrads[-1].numpy(), jgrads[2])
    for t, j in zip(tgrads[:-2], jax.tree.leaves(jgrads[0])):
        if t is None:  # the self-attention's weights and q_norm: unused
            assert not np.any(np.asarray(j))
        else:
            _close(t.numpy(), j)


def test_cross_attention_needs_a_memory():
    cfg = treduce(tget_config("llama-3.2-vision-11b"))
    p = tattn.gqa_init(prng.key(0), cfg, XA)
    with pytest.raises(ValueError, match="memory_raw"):
        tattn.cross_attn_apply(p, cfg, XA, torch.zeros(1, 3, 256), None)


def test_encoder_matches_jax():
    """The reduced Whisper's 2-layer encoder over 64 frames, ``enc_pos``
    and the norms random: the memory, and the gradients of <memory, c> to
    every weight and the frames."""
    jcfg = jreduce(jget_config("whisper-small"))
    tcfg = treduce(tget_config("whisper-small"))
    jp = _perturbed(jtfm.encoder_init(jax.random.key(21), jcfg), 22)
    rng = np.random.default_rng(23)
    frames = rng.normal(size=(2, 64, 256)).astype(np.float32)
    c = rng.normal(size=(2, 64, 256)).astype(np.float32)

    def jloss(p, f):
        y = jtfm.encoder_apply(p, jcfg, f)
        return jnp.sum(y * c), y

    (_, jy), (jgp, jgf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(frames))
    tp = from_jax_params(_np_tree(jp))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tf = torch.from_numpy(frames).requires_grad_(True)
    ty = ttfm.encoder_apply(tree_unflatten(tp, leaves), tcfg, tf)
    grads = torch.autograd.grad((ty * torch.from_numpy(c)).sum(),
                                leaves + [tf])
    _close(ty.detach().numpy(), jy)
    _close(grads[-1].numpy(), jgf)
    for t, j in zip(grads[:-1], jax.tree.leaves(jgp)):
        _close(t.numpy(), j)
    # bidirectional: the first frame's output moves with the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    with torch.no_grad():
        y2 = ttfm.encoder_apply(tp, tcfg, torch.from_numpy(moved))
    assert not torch.allclose(y2[:, 0], ty.detach()[:, 0])


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_and_grads_match_jax(arch):
    jm, tm, jparams = _reduced(arch)
    jparams = _perturbed(jparams, 8)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 512, (2, SEQ + 1)).astype(np.int32)
    mem = _memory_raw(jm.cfg, 3)
    jbatch = {"tokens": jnp.asarray(tokens), "memory_raw": jnp.asarray(mem)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jbatch)[0]))(jparams)
    tparams = from_jax_params(_np_tree(jparams))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tloss = tm.loss_fn(tree_unflatten(tparams, leaves),
                       {"tokens": torch.from_numpy(tokens),
                        "memory_raw": torch.from_numpy(mem)})[0]
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    _close(TBoundary(tparams).flatten_leaves(tgrads).numpy(),
           JBoundary(jparams).flatten(jgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_extras_match_jax(arch):
    cfg = treduce(tget_config(arch))
    jpipe, tpipe = JPipeline(512, SEQ, 2), tpipeline.TokenPipeline(512, SEQ,
                                                                   2)
    assert tpipeline._stable_tag("memory_raw") == \
        zlib.crc32(b"memory_raw") & 0x7FFFFFFF
    for step, peer in ((0, 0), (3, 2), (7, 1)):
        j = jpipe.device_batch(step, peer,
                               extras=_extras(cfg, jnp.float32))
        t = tpipe.device_batch(step, peer,
                               extras=_extras(cfg, torch.float32))
        assert sorted(t) == ["memory_raw", "tokens"]
        np.testing.assert_array_equal(t["tokens"].numpy(),
                                      np.asarray(j["tokens"]))
        assert t["memory_raw"].dtype == torch.float32
        assert tuple(t["memory_raw"].shape) == (2, cfg.encoder_len,
                                                cfg.encoder_dim)
        np.testing.assert_allclose(t["memory_raw"].numpy(),
                                   np.asarray(j["memory_raw"]), rtol=0,
                                   atol=1e-6)
        host = tpipe.batch(step, peer, extras=_extras(cfg, torch.float32))
        assert all(torch.equal(host[k], t[k]) for k in t)
    bare = tpipe.device_batch(0, 0)
    assert sorted(bare) == ["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_run_scan_matches_jax(arch):
    """4 peers, sign flip on peer 3 from step 0, 2 validators, 4 steps,
    each peer's ``memory_raw`` from the pipeline's extras."""
    jm, tm, jparams = _reduced(arch)

    def config(cls, attack, **kw):
        return cls(n_peers=4, byzantine=(3,),
                   attack=attack(kind="sign_flip", start_step=0, delay=5),
                   tau=1.0, clip_iters=5, m_validators=2, **kw)

    def trainer(cls, model, params, pipe, extras, cfg, opt):
        return cls(lambda p, b: model.loss_fn(p, b)[0], params,
                   lambda peer, step, flipped: pipe.device_batch(
                       step, peer, extras=extras),
                   cfg, optimizer=opt)

    jtr = trainer(JTrainer, jm, jparams, JPipeline(512, SEQ, 2),
                  _extras(jm.cfg, jnp.float32),
                  config(JTrainerConfig, JAttack), jsgd(0.05))
    jtr.run_scan(4)
    ttr = trainer(TTrainer, tm, from_jax_params(_np_tree(jparams)),
                  tpipeline.TokenPipeline(512, SEQ, 2),
                  _extras(tm.cfg, torch.float32),
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


# ---------------------------------------------------------------------------
# the distributed launcher
# ---------------------------------------------------------------------------
LAUNCH = ["--arch", "whisper-small", "--reduced", "--device", "cpu",
          "--mesh", "4x1", "--steps", "3", "--seq", str(SEQ), "--batch", "8",
          "--attack", "sign_flip", "--byzantine", "3", "--tau", "1",
          "--clip-iters", "5", "--timeout", "120"]


@pytest.mark.parametrize("extra", [[], ["--scan-steps", "2"]])
def test_launcher_rows_and_grads_match_jax(monkeypatch, extra):
    """Each rank's step-0 rows of the global batch and its gradient there
    (from the JAX init carried over), against the JAX pipeline's rows with
    the launcher's extras and the JAX model's gradient on them; the
    attacker banned within the 3 steps, no one else."""
    jm, _, jparams = _reduced("whisper-small")
    rows, grads, ranks = {}, {}, {}
    real_rows, real_grads = tsteps.peer_rows, tsteps.peer_grads

    def rows_of(batch, group):
        out = real_rows(batch, group)
        rows.setdefault(group.rank, out)  # step 0: the rank's first call
        ranks.setdefault(threading.get_ident(), group.rank)
        return out

    def grads_of(model, params, batch_rows):
        out = real_grads(model, params, batch_rows)
        grads.setdefault(ranks[threading.get_ident()], out[1])
        return out

    monkeypatch.setattr(tsteps, "peer_rows", rows_of)
    monkeypatch.setattr(tsteps, "peer_grads", grads_of)
    args = ttrain.build_parser().parse_args(LAUNCH + extra)
    tparams = from_jax_params(_np_tree(jparams))
    rec = ttrain.run(args, params0=tparams)
    assert set(rec["ban_steps"]) == {3}
    assert rec["summary"]["banned_slots"] == [3]
    assert all(np.isfinite(rec["losses"]))

    jbatch = JPipeline(512, SEQ, 8).batch(
        0, extras=_extras(jm.cfg, jnp.float32))
    grad_fn = jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, b)[0]))
    jb, tb = JBoundary(jparams), TBoundary(tparams)
    assert sorted(rows) == sorted(grads) == [0, 1, 2, 3]
    for r in range(4):
        mine = {k: v[2 * r:2 * r + 2] for k, v in jbatch.items()}
        np.testing.assert_array_equal(rows[r]["tokens"].numpy(),
                                      np.asarray(mine["tokens"]))
        np.testing.assert_allclose(rows[r]["memory_raw"].numpy(),
                                   np.asarray(mine["memory_raw"]), rtol=0,
                                   atol=1e-6)
        _close(tb.flatten_leaves(grads[r]).numpy(),
               jb.flatten(grad_fn(jparams, mine)))
