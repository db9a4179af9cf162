"""Serving in the port against the JAX package, float32 at reduced widths:
the dense decoders (Qwen3-1.7B, ChatGLM3-6B, Qwen1.5-110B), the MoE
decoders with MLA (DeepSeek-V2-Lite-16B, DBRX-132B; the MoE's capacity
at one token a row) and ALBERT-large (learned positions, LayerNorm).
For each, from the same parameters (biases and norm scales random) and
prompts:

* ``Model.prefill`` of 2 prompts of 20 tokens, then 3 ``decode_step``s of
  given tokens, against the JAX package's (each jitted once a model, in a
  module-scoped fixture): the logits and every cache leaf within 1e-5 of
  the reference's largest value, the port's ``init_cache`` the JAX
  package's tree, shapes and dtypes;
* decode against prefill in the port: the logits of each decode step and
  the cache it leaves within 1e-5 of one prefill over the prompt and the
  tokens so far.

Also the stacked pattern's cache (a reduced Qwen3-1.7B whose (SA, SA)
pattern repeats twice, and ALBERT's one shared SA repeated twice over a
cache of two), ``cache_insert`` at the cache's last
position and past it (clamped, as ``dynamic_update_slice`` clamps),
``active_param_count``, and ``launch.serve --device cpu --reduced`` on
Qwen3-1.7B against a greedy loop over the JAX model, its lines and its
refusals (``--mesh`` past 1x1, no CUDA device). ``test_torch_decode_
hybrid.py`` holds the other five architectures with these helpers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_config as treduce
from repro_torch.core.flatten import tree_leaves
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel

ARCHS = ["qwen3-1.7b", "chatglm3-6b", "qwen1.5-110b", "deepseek-v2-lite-16b",
         "dbrx-132b", "albert-large"]
B, PROMPT, STEPS = 2, 20, 3


# ---------------------------------------------------------------------------
# helpers, shared with test_torch_decode_hybrid.py
# ---------------------------------------------------------------------------
def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(jparams, seed):
    """Random values in the leaves whose init is constant (biases, norm
    scales, the conv's bias, the SSM's A_log, D and dt_bias), and a gated
    cross attention's ``xgate`` at 0.5 (0 would gate it off)."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if "xgate" in name:
            return jnp.full(leaf.shape, 0.5, leaf.dtype)
        if any(k in name for k in ("bias", "norm", "conv_b", "A_log",
                                   "'D'")):
            return jnp.asarray(rng.normal(1.0, 0.5, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, jparams)


def close(t, j, tol=1e-5, what=""):
    """Within ``tol`` of the largest value of the reference (exactly where
    the reference is all zeros: cache positions not yet written)."""
    j = np.asarray(j, np.float32)
    t = np.asarray(t, np.float32)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = float(np.abs(t - j).max()) if j.size else 0.0
    scale = float(np.abs(j).max()) if j.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err:.3e} of {scale:.3e}"


def models(arch, **kw):
    """The reduced configuration in both packages, with ``kw`` replaced."""
    jcfg = dataclasses.replace(jreduce(jget_config(arch)), **kw)
    tcfg = dataclasses.replace(treduce(tget_config(arch)), **kw)
    return JModel(jcfg), TModel(tcfg)


def inputs(cfg, prompt, seed=0):
    """Prompts (B, prompt), the tokens fed to the decode steps (STEPS, B)
    and, for an encoder model, ``memory_raw``: numpy, from a seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, prompt))
           .astype(np.int32),
           "next": rng.integers(0, cfg.vocab_size, (STEPS, B))
           .astype(np.int32)}
    if cfg.encoder_len:
        out["memory_raw"] = (0.02 * rng.normal(
            size=(B, cfg.encoder_len, cfg.encoder_dim))).astype(np.float32)
    return out


def jax_reference(jm, data):
    """The JAX package's prefill and STEPS decode steps, each jitted, from
    random-perturbed parameters: (params, [(logits, cache leaves)] after
    the prefill and after each step, the initial cache)."""
    params = perturbed(jm.init_params(jax.random.key(0)), 1)
    prompt = data["tokens"].shape[1]
    cache = jm.init_cache(B, prompt + STEPS + 1)
    init = np_tree(cache)
    batch = {k: jnp.asarray(v) for k, v in data.items() if k != "next"}
    logits, cache = jax.jit(jm.prefill)(params, batch, cache)
    outs = [(np.asarray(logits), [np.asarray(x) for x in
                                  jax.tree.leaves(cache)])]
    decode = jax.jit(jm.decode_step)
    for i in range(STEPS):
        step = {"token": jnp.asarray(data["next"][i]),
                "pos": jnp.full((B,), prompt + i, jnp.int32)}
        logits, cache = decode(params, step, cache)
        outs.append((np.asarray(logits), [np.asarray(x) for x in
                                          jax.tree.leaves(cache)]))
    return np_tree(params), outs, init


def torch_batch(data, upto=None):
    batch = {"tokens": torch.from_numpy(data["tokens"])}
    if upto:
        batch["tokens"] = torch.cat(
            [batch["tokens"], torch.from_numpy(data["next"][:upto].T)], 1)
    if "memory_raw" in data:
        batch["memory_raw"] = torch.from_numpy(data["memory_raw"])
    return batch


def port_run(tm, params, data, T):
    """The port's prefill and STEPS decode steps on the CPU: [(logits,
    cache leaves)] after each, cloned (the cache is written in place)."""
    prompt = data["tokens"].shape[1]
    cache = tm.init_cache(B, T, device="cpu")
    with torch.inference_mode():
        logits, cache = tm.prefill(params, torch_batch(data), cache)
        outs = [(logits.clone(), [x.clone() for x in tree_leaves(cache)])]
        for i in range(STEPS):
            step = {"token": torch.from_numpy(data["next"][i]),
                    "pos": torch.full((B,), prompt + i, dtype=torch.int32)}
            logits, cache = tm.decode_step(params, step, cache)
            outs.append((logits.clone(),
                         [x.clone() for x in tree_leaves(cache)]))
    return outs


def check_against_jax(tm, data, ref):
    """The port's empty cache, prefill and STEPS decode steps (logits and
    every cache leaf) against ``ref``, ``jax_reference``'s run."""
    params, outs, init = ref
    T = data["tokens"].shape[1] + STEPS + 1
    empty = tm.init_cache(B, T, device="cpu")
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(empty)] == \
        [(j.shape, torch.float32) for j in jax.tree.leaves(init)]
    assert tree_structure(empty) == tree_structure(init)
    for n, ((tl, tc), (jl, jc)) in enumerate(zip(
            port_run(tm, from_jax_params(params), data, T), outs)):
        close(tl, jl, what=f"logits after {n} steps")
        assert len(tc) == len(jc)
        for i, (t, j) in enumerate(zip(tc, jc)):
            close(t, j, what=f"cache leaf {i} after {n} steps")


def tree_structure(tree):
    """Nested dict keys and list lengths, leaves as None."""
    if isinstance(tree, dict):
        return {k: tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_structure(v) for v in tree]
    return None


def check_decode_against_prefill(tm, params, data):
    """In the port: after i decode steps, the logits and the cache equal
    (within 1e-5) one prefill over the prompt and the i tokens fed."""
    T = data["tokens"].shape[1] + STEPS + 1
    outs = port_run(tm, params, data, T)
    for i in range(1, STEPS + 1):
        cache = tm.init_cache(B, T, device="cpu")
        with torch.inference_mode():
            logits, cache = tm.prefill(params, torch_batch(data, i), cache)
        close(outs[i][0], logits, what=f"logits at step {i}")
        for n, (t, j) in enumerate(zip(outs[i][1], tree_leaves(cache))):
            close(t, j, what=f"cache leaf {n} at step {i}")


def check_serve_against_jax_greedy(arch, prompt=12, gen=5):
    """``launch.serve --device cpu --reduced``'s generations equal a greedy
    loop over the JAX model (its params from key 0, the reference's
    pipeline batch 0)."""
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", str(B), "--prompt-len", str(prompt),
                      "--gen", str(gen)])
    jm = JModel(jreduce(jget_config(arch)))
    params = jm.init_params(jax.random.key(0))
    tokens = JPipeline(jm.cfg.vocab_size, prompt, B).batch(0)["tokens"]
    np.testing.assert_array_equal(out.batch["tokens"].numpy(),
                                  np.asarray(tokens[:, :prompt]))
    cache = jm.init_cache(B, prompt + gen)
    logits, cache = jax.jit(jm.prefill)(params, {"tokens":
                                                 tokens[:, :prompt]}, cache)
    decode = jax.jit(jm.decode_step)
    toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(gen - 1):
        logits, cache = decode(params, {"token": toks[-1], "pos": jnp.full(
            (B,), prompt + i, jnp.int32)}, cache)
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(jnp.stack(toks, 1)))
    close(out.logits[-1], logits)
    return out


# ---------------------------------------------------------------------------
# the five architectures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The JAX package's run of one model, made once for the module."""
    jm, tm = models(request.param)
    data = inputs(tm.cfg, PROMPT)
    return tm, data, jax_reference(jm, data)


def test_prefill_and_decode_match_jax(reference):
    tm, data, ref = reference
    assert {s.mixer for s in tm.cfg.layers} == (
        {"mla"} if tm.cfg.kv_lora_rank else {"attn_full"})
    check_against_jax(tm, data, ref)


def test_decode_agrees_with_prefill(reference):
    tm, data, (params, _, _) = reference
    check_decode_against_prefill(tm, from_jax_params(params), data)


# ---------------------------------------------------------------------------
# the stacked pattern, the insert's edge, the counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch, blocks", [("qwen3-1.7b", 2),
                                          ("albert-large", 1)])
def test_stacked_pattern_cache_matches_jax(arch, blocks):
    """Qwen3-1.7B reduced with its (SA, SA) pattern repeated twice and no
    prefix, and ALBERT-large reduced with its one SA block's parameters
    shared by 2 repeats: the K and V caches stacked along a leading axis
    of 2, one slice a repeat, written through each repeat's views."""
    jm, tm = (M(dataclasses.replace(c, prefix=(), pattern=c.prefix[:blocks],
                                    n_repeats=2))
              for M, c in ((JModel, jreduce(jget_config(arch))),
                           (TModel, treduce(tget_config(arch)))))
    assert tm.cfg.share_pattern_params == (arch == "albert-large")
    data = inputs(tm.cfg, 9, seed=3)
    ref = jax_reference(jm, data)
    check_against_jax(tm, data, ref)
    leaves = tree_leaves(tm.init_cache(B, 4, device="cpu"))
    assert len(leaves) == 2 * blocks and all(t.shape[0] == 2 for t in leaves)
    check_decode_against_prefill(tm, from_jax_params(ref[0]), data)


@pytest.mark.parametrize("pos", [[3, 7], [7, 8], [100, -1], [-20, 0]])
def test_cache_insert_at_the_edge_clamps_as_jax(pos):
    """T = 8: position 7 is the last slot; past it, a position lands on 7,
    as ``dynamic_update_slice`` clamps it; a negative one counts from the
    end first (-1 on 7, -20 on 0)."""
    rng = np.random.default_rng(sum(map(abs, pos)))
    cache = rng.normal(size=(2, 8, 3)).astype(np.float32)
    new = rng.normal(size=(2, 1, 3)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    j = jattn._cache_insert(jnp.asarray(cache), jnp.asarray(new),
                            jnp.asarray(p))
    t = torch.from_numpy(cache.copy())
    out = tattn.cache_insert(t, torch.from_numpy(new), torch.from_numpy(p))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for row, q in enumerate(pos):
        slot = min(max(q + 8 if q < 0 else q, 0), 7)
        np.testing.assert_array_equal(t[row, slot].numpy(), new[row, 0])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b",
                                  "qwen3-1.7b"])
def test_active_param_count_equals_jax(arch):
    jm, tm = models(arch)
    assert tm.active_param_count() == jm.active_param_count()
    assert tm.param_count() == jm.param_count()


# ---------------------------------------------------------------------------
# launch.serve
# ---------------------------------------------------------------------------
def test_serve_generates_the_jax_greedy_tokens(capsys):
    out = check_serve_against_jax_greedy("qwen3-1.7b")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch=qwen3-1.7b-smoke batch={B} prompt=12"
    assert lines[1].startswith("prefill: ") and "ms/token" in lines[1]
    assert lines[2] == f"first sequences: {out.tokens[:2].tolist()}"
    assert lines[3:] == ["peak memory: not measured on the CPU",
                         "device: cpu"]


@pytest.mark.parametrize("mesh", ["2x1", "4x2", "2x2x1"])
def test_serve_refuses_a_mesh_naming_item_14(mesh):
    with pytest.raises(NotImplementedError, match="item 14"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                    "--mesh", mesh])


def test_serve_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(treduce(tget_config("qwen3-1.7b"))).init_cache(1, 4)
