"""The port's ALBERT (repro_torch.models) against the JAX package's, at a
small width that keeps the shared-pattern path the full model runs
(d_model 128, 2 heads, d_ff 256, vocab 512, one shared block applied twice,
f32): converted weights give the same loss and flat gradients within 1e-4,
the flat layout is identical bit for bit, the port's own init draws the
same weights to within the last bit of normal, and the public-seed token
batches are identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.albert_large import CONFIG as JCONFIG
from repro.core.flatten import FlatBoundary as JBoundary
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models.model import Model as JModel
from repro_torch.configs.albert_large import CONFIG as TCONFIG
from repro_torch.core import prng
from repro_torch.core.flatten import FlatBoundary as TBoundary
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel

SMALL = dict(d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
             vocab_size=512, n_repeats=2, max_position=64)


def _models(dtype="float32"):
    jm = JModel(dataclasses.replace(JCONFIG, dtype=dtype, **SMALL))
    tm = TModel(dataclasses.replace(TCONFIG, dtype=dtype, **SMALL))
    return jm, tm


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed=0, B=2, S=16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SMALL["vocab_size"], (B, S + 1)).astype(np.int32)


def test_flat_layout_and_conversion_are_bitwise():
    """Leaf order (sorted dict keys) and widening agree bit for bit, f32
    and bf16 storage alike."""
    for dtype in ("float32", "bfloat16"):
        jm, _ = _models(dtype)
        jparams = jm.init_params(jax.random.key(0))
        tparams = from_jax_params(_np_tree(jparams))
        jb, tb = JBoundary(jparams), TBoundary(tparams)
        assert tb.shapes == jb.shapes and tb.d == jb.d
        np.testing.assert_array_equal(tb.flatten(tparams).numpy(),
                                      np.asarray(jb.flatten(jparams)))
        flat = tb.flatten(tparams) * 1.0001  # f32 -> bf16 rounds to even
        np.testing.assert_array_equal(
            torch.cat([t.float().reshape(-1) for t in
                       tree_leaves(tb.unflatten(flat))]).numpy(),
            np.asarray(jb.flatten(jb.unflatten(jnp.asarray(flat.numpy())))))
    names = []

    def walk(t, pre=""):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{pre}{k}.")
        else:
            names.append(pre[:-1])
    walk(tparams)
    assert names[:4] == ["embed", "final_norm.bias", "final_norm.scale",
                         "lm_head"]
    assert names[-1] == "pos_embed"


def test_port_init_draws_the_jax_weights():
    """Model.init_params on the port's threefry keys: the JAX package's
    weights up to the last bit of normal (f32 storage)."""
    jm, tm = _models()
    jparams = _np_tree(jm.init_params(jax.random.key(3)))
    tparams = tm.init_params(prng.key(3))
    for j, t in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_flat_grads_match_jax(seed):
    jm, tm = _models()
    jparams = jm.init_params(jax.random.key(seed))
    tparams = from_jax_params(_np_tree(jparams))
    tokens = _tokens(seed)
    jb, tb = JBoundary(jparams), TBoundary(tparams)

    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(tokens)})[0])(jparams)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tloss = tm.loss_fn(tree_unflatten(tparams, leaves),
                       {"tokens": torch.from_numpy(tokens)})[0]
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tb.flatten_leaves(tgrads).numpy(),
                               np.asarray(jb.flatten(jgrads)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("vocab", [512, 30000, 2**16])
def test_device_batch_tokens_equal_jax(vocab):
    jp = JPipeline(vocab, 16, 3, global_seed=5)
    tp = TPipeline(vocab, 16, 3, global_seed=5)
    for step, peer in [(0, 0), (1, 3), (7, 2), (123, 15)]:
        j = np.asarray(jp.device_batch(step, peer)["tokens"])
        t = tp.device_batch(step, peer)["tokens"]
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)


def test_gradient_leaves_die_with_the_call():
    """The trainer unflattens the flat params into fresh leaves for every
    gradient; none may outlive the call through a reference cycle (at full
    width they are gigabytes of the card's memory, freed only whenever
    the cyclic collector happens to run): with the collector off, no
    tensor that requires grad is left once a call returns."""
    import gc

    from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig

    _, tm = _models()
    pipe = TPipeline(512, 16, 2)
    tr = BTARDTrainer(lambda p, b: tm.loss_fn(p, b)[0],
                      tm.init_params(prng.key(0)),
                      lambda peer, step, flipped: pipe.device_batch(step, peer),
                      TrainerConfig(n_peers=2, device="cpu"))

    def alive():
        return sum(isinstance(o, torch.Tensor) and o.requires_grad
                   for o in gc.get_objects())

    out = torch.empty_like(tr.params)
    tr._grad(tr.params, pipe.device_batch(0, 0), out=out)  # lazy imports
    gc.collect()
    gc.disable()
    try:
        before = alive()
        for peer in range(2):
            tr._grad(tr.params, pipe.device_batch(0, peer), out=out)
        assert alive() == before
        leaves = [torch.zeros(3, requires_grad=True) for _ in range(2)]
        tree_unflatten({"a": [None], "b": None}, leaves)
        del leaves
        assert alive() == before
    finally:
        gc.enable()
