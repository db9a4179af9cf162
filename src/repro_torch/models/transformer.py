"""Block assembly for the ported models: prefix blocks, then the repeated
pattern (one shared parameter set applied ``n_repeats`` times, ALBERT's
cross-layer sharing), then suffix blocks.

Counterpart of ``repro.models.transformer`` for dense self-attention
blocks. The JAX package scans the pattern; here it is a Python loop.
"""
from __future__ import annotations

from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_init, norm_init


def _check_spec(spec):
    if spec.mixer != "attn_full" or spec.mlp != "dense" or spec.cross:
        raise NotImplementedError(
            f"block {spec} is not ported: only dense self-attention blocks "
            "(attn_full + dense MLP) exist in this slice")


def block_init(key, cfg, spec):
    _check_spec(spec)
    ks = prng.split(key, 4)
    return {
        "norm1": norm_init(cfg, key.device),
        "mixer": attn.gqa_init(ks[0], cfg, spec),
        "norm2": norm_init(cfg, key.device),
        "mlp": mlp_init(ks[1], cfg),
    }


def block_apply(p, cfg, spec, x):
    x = x + attn.gqa_apply(p["mixer"], cfg, spec, apply_norm(p["norm1"], cfg, x))
    return x + apply_mlp(p["mlp"], cfg, apply_norm(p["norm2"], cfg, x))


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

        if not cfg.share_pattern_params:
            raise NotImplementedError(
                "an unshared repeated pattern (stacked per-repeat weights) "
                "is not ported: only ALBERT's shared pattern is")
        p["pattern"] = one_macro(kq)
    if cfg.suffix:
        p["suffix"] = [block_init(prng.fold_in(ks, i), cfg, s)
                       for i, s in enumerate(cfg.suffix)]
    return p


def stack_apply(p, cfg, x):
    for i, spec in enumerate(cfg.prefix):
        x = block_apply(p["prefix"][i], cfg, spec, x)
    if cfg.pattern and cfg.n_repeats:
        for _ in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.pattern):
                x = block_apply(p["pattern"][f"l{i}"], cfg, spec, x)
    for i, spec in enumerate(cfg.suffix):
        x = block_apply(p["suffix"][i], cfg, spec, x)
    return x
