"""Block assembly for the ported models: prefix blocks, then the repeated
pattern, then suffix blocks. The pattern's parameters are either one set
applied ``n_repeats`` times (ALBERT's cross-layer sharing) or stacked
along a leading ``n_repeats`` axis, one slice per repeat (the decoders).

Counterpart of ``repro.models.transformer``: blocks whose mixer is GQA
(global or local), MLA, the SSM, the RG-LRU or cross attention over an
encoder's memory (``attn_cross``), a ``cross`` block's second,
cross-attention sub-block, a dense or MoE MLP, or none; and Whisper's
bidirectional encoder. The JAX package scans the pattern and the
encoder's layers; here they are Python loops. Every apply of the stack
returns the summed MoE load-balance loss beside the activations.

Serving passes a cache, the JAX package's tree (``stack_cache_shapes``):
a ``prefix`` list and a ``suffix`` list of per-block dicts, and a
``pattern`` dict of ``l{i}`` whose leaves are stacked along a leading
``n_repeats`` axis; each block's ``mixer`` entry (and a ``cross`` block's
``cross`` entry, the memory's K and V) holds its mixer's cache. The
mixers write into it in place ("prefill" over a sequence, "decode" one
position a row), the pattern's repeats through views of the stacked
leaves.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SA
from repro_torch.core import prng
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_init, norm_init

# mixer -> (init, apply, cache shape)
_MIXERS = {
    "attn_full": (attn.gqa_init, attn.gqa_apply, attn.gqa_cache_shape),
    "attn_local": (attn.gqa_init, attn.gqa_apply, attn.gqa_cache_shape),
    # cross_attn_apply, with the memory
    "attn_cross": (attn.gqa_init, None, attn.gqa_cache_shape),
    "mla": (attn.mla_init, attn.mla_apply, attn.mla_cache_shape),
    "ssm": (ssm_mod.ssm_init, ssm_mod.ssm_apply, ssm_mod.ssm_cache_shape),
    "rglru": (rglru_mod.rglru_init, rglru_mod.rglru_apply,
              rglru_mod.rglru_cache_shape),
}


def block_init(key, cfg, spec):
    ks = prng.split(key, 4)
    p = {"norm1": norm_init(cfg, key.device),
         "mixer": _MIXERS[spec.mixer][0](ks[0], cfg, spec)}
    if spec.cross:
        p["norm_x"] = norm_init(cfg, key.device)
    if spec.mlp == "dense":
        p["norm2"] = norm_init(cfg, key.device)
        p["mlp"] = mlp_init(ks[1], cfg)
    elif spec.mlp == "moe":
        p["norm2"] = norm_init(cfg, key.device)
        p["moe"] = moe_mod.moe_init(ks[2], cfg)
    return p


def block_apply(p, cfg, spec, x, pos, *, memory=None, cache=None,
                mode="train"):
    """Returns (x, aux): aux the MoE's load-balance loss, 0 without one.
    ``memory``: the encoder's (B, M, d) output, which ``attn_cross`` and a
    ``cross`` block attend to (not in "decode": their cache holds its K
    and V). ``cache``: the block's entry of the stack's cache, written in
    place; ``mode``: "train", "prefill" or "decode" (pos then (B,))."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["norm1"], cfg, x)
    mc = cache["mixer"] if cache is not None else None
    if spec.mixer == "attn_cross":
        x = x + attn.cross_attn_apply(p["mixer"], cfg, spec, h, memory,
                                      cache=mc, mode=mode)
    else:
        x = x + _MIXERS[spec.mixer][1](p["mixer"], cfg, spec, h, pos,
                                       cache=mc, mode=mode)
    if spec.cross and spec.mixer != "attn_cross":
        h = apply_norm(p["norm_x"], cfg, x)
        x = x + attn.cross_attn_apply(
            p["mixer"], cfg, spec, h, memory,
            cache=cache["cross"] if cache is not None else None, mode=mode)
    if spec.mlp == "dense":
        x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["norm2"], cfg, x))
    elif spec.mlp == "moe":
        y, a = moe_mod.moe_apply(p["moe"], cfg, apply_norm(p["norm2"], cfg, x))
        x = x + y
        aux = aux + a
    return x, aux


def block_cache_shapes(cfg, spec, batch, seq_len):
    """The block's cache as ((shape), dtype) leaves: its mixer's, and for a
    ``cross`` block the memory's K and V under ``cross``."""
    shapes = {"mixer": _MIXERS[spec.mixer][2](cfg, spec, batch, seq_len,
                                              cfg.has_encoder)}
    if spec.cross and spec.mixer != "attn_cross":
        mixer = shapes["mixer"]
        shapes["cross"] = {k: v for k, v in mixer.items()
                           if k.startswith("mem_")}
        shapes["mixer"] = {k: v for k, v in mixer.items()
                           if not k.startswith("mem_")}
    return shapes


def stack_cache_shapes(cfg, batch, seq_len):
    """The stack's cache as ((shape), dtype) leaves in the JAX package's
    tree; the pattern's leaves gain a leading ``n_repeats`` axis."""
    cache = {}
    if cfg.prefix:
        cache["prefix"] = [block_cache_shapes(cfg, s, batch, seq_len)
                           for s in cfg.prefix]
    if cfg.pattern and cfg.n_repeats:
        cache["pattern"] = {
            f"l{i}": {part: {k: ((cfg.n_repeats,) + shape, dt)
                             for k, (shape, dt) in leaves.items()}
                      for part, leaves in
                      block_cache_shapes(cfg, s, batch, seq_len).items()}
            for i, s in enumerate(cfg.pattern)}
    if cfg.suffix:
        cache["suffix"] = [block_cache_shapes(cfg, s, batch, seq_len)
                           for s in cfg.suffix]
    return cache


def _stacked(trees):
    """Trees of one structure -> one tree whose leaves are the trees'
    leaves stacked along a new leading axis (``jax.vmap``'s output)."""
    cols = zip(*(tree_leaves(t) for t in trees))
    return tree_unflatten(trees[0], [torch.stack(c) for c in cols])


def stack_init(key, cfg):
    p = {}
    kp, kq, ks = prng.split(key, 3)
    if cfg.prefix:
        p["prefix"] = [block_init(prng.fold_in(kp, i), cfg, s)
                       for i, s in enumerate(cfg.prefix)]
    if cfg.pattern and cfg.n_repeats:
        def one_macro(k):
            return {f"l{i}": block_init(prng.fold_in(k, i), cfg, s)
                    for i, s in enumerate(cfg.pattern)}

        if cfg.share_pattern_params:
            p["pattern"] = one_macro(kq)
        else:
            # jax.vmap(one_macro)(split(kq, n_repeats)): repeat r from key r
            p["pattern"] = _stacked([one_macro(k) for k in
                                     prng.split(kq, cfg.n_repeats)])
    if cfg.suffix:
        p["suffix"] = [block_init(prng.fold_in(ks, i), cfg, s)
                       for i, s in enumerate(cfg.suffix)]
    return p


def _repeats(p, cfg):
    """The pattern's parameters of each repeat: the shared set every time,
    or the stacked leaves' slices."""
    if cfg.share_pattern_params:
        return [p["pattern"]] * cfg.n_repeats
    return _unstacked(p["pattern"])


def _unstacked(tree):
    """The slices of a stacked tree along its leading axis, taken with one
    ``torch.unbind`` per leaf (in the backward one stack per leaf, where
    indexing each slice would leave a full-size buffer per slice and
    leaf)."""
    slices = [torch.unbind(leaf) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, list(one)) for one in zip(*slices)]


def stack_apply(p, cfg, x, pos, memory=None, cache=None, mode="train"):
    """Returns (x, aux), aux summed over the blocks in the JAX package's
    order (each repeat's blocks summed, then added to the running sum).
    ``memory``: the encoder's output, for the cross-attending blocks;
    ``cache``: the stack's cache (``stack_cache_shapes``), written in
    place by "prefill" and "decode"."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def one(bp, spec, x, c):
        return block_apply(bp, cfg, spec, x, pos, memory=memory, cache=c,
                           mode=mode)

    for i, spec in enumerate(cfg.prefix):
        x, a = one(p["prefix"][i], spec, x,
                   cache["prefix"][i] if cache is not None else None)
        aux = aux + a
    if cfg.pattern and cfg.n_repeats:
        caches = (_unstacked(cache["pattern"]) if cache is not None
                  else [None] * cfg.n_repeats)
        for macro, mc in zip(_repeats(p, cfg), caches):
            aux_t = torch.zeros_like(aux)
            for i, spec in enumerate(cfg.pattern):
                x, a = one(macro[f"l{i}"], spec, x,
                           mc[f"l{i}"] if mc is not None else None)
                aux_t = aux_t + a
            aux = aux + aux_t
    for i, spec in enumerate(cfg.suffix):
        x, a = one(p["suffix"][i], spec, x,
                   cache["suffix"][i] if cache is not None else None)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Whisper's bidirectional encoder
# ---------------------------------------------------------------------------
def encoder_init(key, cfg):
    """``n_encoder_layers`` SA blocks stacked along a leading axis, one
    from each key of ``split(key, n)`` (``jax.vmap``'s output), the final
    norm and the float32 ``enc_pos``, zeros."""
    return {
        "encoder_layers": _stacked([block_init(k, cfg, SA) for k in
                                    prng.split(key, cfg.n_encoder_layers)]),
        "encoder_norm": norm_init(cfg, key.device),
        "enc_pos": torch.zeros((cfg.encoder_len, cfg.d_model),
                               dtype=torch.float32, device=key.device),
    }


def encoder_apply(p, cfg, frames):
    """frames: (B, M, d_model) after the projector -> the memory (B, M,
    d_model): ``enc_pos`` added, the layers' bidirectional self-attention
    and MLP, the final norm."""
    x = frames + p["enc_pos"].to(frames.dtype)
    for layer in _unstacked(p["encoder_layers"]):
        h = apply_norm(layer["norm1"], cfg, x)
        x = x + _encoder_self_attn(layer["mixer"], cfg, h)
        x = x + apply_mlp(layer["mlp"], cfg,
                          apply_norm(layer["norm2"], cfg, x))
    return apply_norm(p["encoder_norm"], cfg, x)


def _encoder_self_attn(p, cfg, x):
    """An encoder layer's attention: GQA's projections, biases and head
    norms, no rope, no mask."""
    B, S, _ = x.shape
    q, k, v = attn.project_qkv(p, cfg, x)
    k, v = attn.expand_kv(cfg, k, v)
    return attn.full_attention(q, k, v).reshape(B, S, -1) @ p["wo"]
