"""Serving in the port against the JAX package, float32 at reduced widths,
for the models whose mixers carry state or attend to a memory:
Gemma3-27B (local and global attention), RecurrentGemma-9B (the RG-LRU
and local attention), Mamba2-2.7B (the SSM), Whisper-small (the encoder,
learned positions, self and cross attention) and Llama-3.2-Vision-11B
(the projector, gated cross attention). With the helpers of
``test_torch_decode.py``, for each model:

* prefill of 2 prompts, then 3 decode steps of given tokens, against the
  JAX package's (jitted once a model, in a module-scoped fixture): the
  logits and every cache leaf (the RG-LRU's h and conv buffer, the SSM's
  state and conv buffer, the memory's ``mem_k``/``mem_v``) within 1e-5 of
  the reference's largest value; the local-attention models' prompts are
  36 tokens, past their window of 32, so that decode masks the window;
  Mamba2's 20 end in a ragged chunk of 4 (the reduced chunk is 16);
* decode against prefill in the port, within 1e-5.

Also the stacked pattern's cache (a reduced RecurrentGemma-9B whose (RG,
LSA) pattern repeats twice) and ``launch.serve --device cpu --reduced``
on Mamba2-2.7B against a greedy loop over the JAX model."""
import dataclasses

import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce
from repro.models.model import Model as JModel
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_config as treduce
from repro_torch.core.flatten import tree_leaves
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel
from test_torch_decode import (B, check_against_jax,
                               check_decode_against_prefill,
                               check_serve_against_jax_greedy, inputs,
                               jax_reference, models)

ARCHS = ["gemma3-27b", "recurrentgemma-9b", "mamba2-2.7b", "whisper-small",
         "llama-3.2-vision-11b"]
PROMPT = {"gemma3-27b": 36, "recurrentgemma-9b": 36}  # past the window
MIXERS = {"gemma3-27b": {"attn_local", "attn_full"},
          "recurrentgemma-9b": {"rglru", "attn_local"},
          "mamba2-2.7b": {"ssm"},
          "whisper-small": {"attn_full"},
          "llama-3.2-vision-11b": {"attn_full", "attn_cross"}}


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The JAX package's run of one model, made once for the module."""
    jm, tm = models(request.param)
    data = inputs(tm.cfg, PROMPT.get(request.param, 20))
    return request.param, tm, data, jax_reference(jm, data)


def test_prefill_and_decode_match_jax(reference):
    arch, tm, data, ref = reference
    assert {s.mixer for s in tm.cfg.layers} == MIXERS[arch]
    check_against_jax(tm, data, ref)


def test_decode_agrees_with_prefill(reference):
    _, tm, data, (params, _, _) = reference
    check_decode_against_prefill(tm, from_jax_params(params), data)


def test_stacked_pattern_cache_matches_jax():
    """RecurrentGemma-9B reduced with its (RG, LSA) pattern repeated twice
    and no prefix, prompts of 36 past the window: the RG-LRU's and the
    local attention's caches stacked along a leading axis of 2."""
    arch = "recurrentgemma-9b"
    jm, tm = (M(dataclasses.replace(c, prefix=(), pattern=c.prefix,
                                    n_repeats=2))
              for M, c in ((JModel, jreduce(jget_config(arch))),
                           (TModel, treduce(tget_config(arch)))))
    data = inputs(tm.cfg, 36, seed=4)
    ref = jax_reference(jm, data)
    check_against_jax(tm, data, ref)
    leaves = tree_leaves(tm.init_cache(B, 4, device="cpu"))
    assert len(leaves) == 4 and all(t.shape[0] == 2 for t in leaves)
    check_decode_against_prefill(tm, from_jax_params(ref[0]), data)


def test_serve_generates_the_jax_greedy_tokens_on_mamba2():
    out = check_serve_against_jax_greedy("mamba2-2.7b")
    assert out.model.cfg.name == "mamba2-2.7b-smoke"
