"""Block assembly for the ported models: prefix blocks, then the repeated
pattern, then suffix blocks. The pattern's parameters are either one set
applied ``n_repeats`` times (ALBERT's cross-layer sharing) or stacked
along a leading ``n_repeats`` axis, one slice per repeat (the decoders).

Counterpart of ``repro.models.transformer`` in training mode: blocks
whose mixer is GQA (global or local), MLA, the RG-LRU or cross attention
over an encoder's memory (``attn_cross``), a ``cross`` block's second,
cross-attention sub-block, a dense or MoE MLP; and Whisper's bidirectional
encoder. The JAX package scans the pattern and the encoder's layers; here
they are Python loops. Every apply of the stack returns the summed MoE
load-balance loss beside the activations.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SA
from repro_torch.core import prng
from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_init, norm_init

_MIXERS = {
    "attn_full": (attn.gqa_init, attn.gqa_apply),
    "attn_local": (attn.gqa_init, attn.gqa_apply),
    "attn_cross": (attn.gqa_init, None),  # cross_attn_apply, with memory
    "mla": (attn.mla_init, attn.mla_apply),
    "rglru": (rglru_mod.rglru_init, rglru_mod.rglru_apply),
}


def _check_spec(spec):
    if spec.mixer not in _MIXERS:
        raise NotImplementedError(
            f"block {spec} is not ported: the SSM (Mamba2) is ROADMAP item "
            "13's step 4")


def block_init(key, cfg, spec):
    _check_spec(spec)
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


def block_apply(p, cfg, spec, x, pos, *, memory=None):
    """Returns (x, aux): aux the MoE's load-balance loss, 0 without one.
    ``memory``: the encoder's (B, M, d) output, which ``attn_cross`` and a
    ``cross`` block attend to."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["norm1"], cfg, x)
    if spec.mixer == "attn_cross":
        x = x + attn.cross_attn_apply(p["mixer"], cfg, spec, h, memory)
    else:
        x = x + _MIXERS[spec.mixer][1](p["mixer"], cfg, spec, h, pos)
    if spec.cross and spec.mixer != "attn_cross":
        h = apply_norm(p["norm_x"], cfg, x)
        x = x + attn.cross_attn_apply(p["mixer"], cfg, spec, h, memory)
    if spec.mlp == "dense":
        x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["norm2"], cfg, x))
    elif spec.mlp == "moe":
        y, a = moe_mod.moe_apply(p["moe"], cfg, apply_norm(p["norm2"], cfg, x))
        x = x + y
        aux = aux + a
    return x, aux


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


def stack_apply(p, cfg, x, pos, memory=None):
    """Returns (x, aux), aux summed over the blocks in the JAX package's
    order (each repeat's blocks summed, then added to the running sum).
    ``memory``: the encoder's output, for the cross-attending blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.prefix):
        x, a = block_apply(p["prefix"][i], cfg, spec, x, pos, memory=memory)
        aux = aux + a
    if cfg.pattern and cfg.n_repeats:
        for macro in _repeats(p, cfg):
            aux_t = torch.zeros_like(aux)
            for i, spec in enumerate(cfg.pattern):
                x, a = block_apply(macro[f"l{i}"], cfg, spec, x, pos,
                                   memory=memory)
                aux_t = aux_t + a
            aux = aux + aux_t
    for i, spec in enumerate(cfg.suffix):
        x, a = block_apply(p["suffix"][i], cfg, spec, x, pos, memory=memory)
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
