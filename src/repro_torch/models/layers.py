"""Shared building blocks of the ported models: LayerNorm/RMSNorm, the
QK-norm, the dense MLP, RoPE, embeddings with learned positions and the
gemma scale, the output projection, and the depthwise causal conv.

Counterpart of ``repro.models.layers`` in training mode (the conv's
decode step, ``causal_conv1d_step``, is ROADMAP item 13's step 5).
Parameters are nested dicts of tensors with the JAX package's names,
shapes and dtypes (``models.convert`` maps one onto the other). Weights
are drawn with the port's threefry generator (``core.prng``), so a seed
gives the JAX package's weights up to the last bit of ``normal``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng


def cdtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _init(key, shape, scale, dtype):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = float(np.float32(scale / np.sqrt(fan_in)))
    return (prng.normal(key, shape) * std).to(dtype)


def dense_init(key, d_in, d_out, dtype, scale=1.0):
    return _init(key, (d_in, d_out), scale, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_init(cfg, device, dim=None):
    dim = dim or cfg.d_model
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, cfg, x):
    """f32 LayerNorm (``norm_eps``, 1e-6 for ALBERT — not ``nn.LayerNorm``'s
    default) or RMSNorm, cast back to the input dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm" and "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps=1e-6):
    """QK-norm over the head dim, in float32, cast back. x: (..., head_dim)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def mlp_init(key, cfg, d_ff=None):
    """The MLP at ``d_ff`` (default ``cfg.d_ff``; the MoE's shared experts
    pass their own width)."""
    d_ff = d_ff or cfg.d_ff
    dt = cdtype(cfg)
    k1, k2, k3 = prng.split(key, 3)
    p = {
        "wi": dense_init(k1, cfg.d_model, d_ff, dt),
        "wdown": dense_init(k3, d_ff, cfg.d_model, dt),
    }
    if cfg.glu:
        p["wg"] = dense_init(k2, cfg.d_model, d_ff, dt)
    return p


def act_fn(cfg, x):
    if cfg.act == "gelu":
        # jax.nn.gelu(approximate=True): the tanh form, not torch's default
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def apply_mlp(p, cfg, x):
    h = x @ p["wi"]
    if "wg" in p:
        h = act_fn(cfg, x @ p["wg"]) * h
    else:
        h = act_fn(cfg, h)
    return h @ p["wdown"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(cfg, dim):
    """The (dim/2,) float32 inverse frequencies, in numpy as the JAX package
    computes them, so both packages rotate by the same bits."""
    half = dim // 2
    return 1.0 / (cfg.rope_theta
                  ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, pos, cfg, dim=None):
    """x: (..., seq, heads, head_dim) with pos (..., seq).

    cfg.rope == 'standard': rotate the full head dim (NeoX halves layout).
    cfg.rope == 'half':     GLM 2d-rope — rotate only the first half of the
                            head dim, pass through the second half.
    cfg.rope == 'none':     identity.
    Angles, cos and sin in float32; the result in x's dtype.
    """
    if cfg.rope == "none":
        return x
    hd = dim or x.shape[-1]
    rot = hd if cfg.rope == "standard" else hd // 2
    freqs = torch.from_numpy(rope_freqs(cfg, rot)).to(x.device)
    angles = pos[..., None].to(torch.float32) * freqs  # (..., seq, rot/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf1 = x_rot[..., :rot // 2].to(torch.float32)
    xf2 = x_rot[..., rot // 2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def embed_init(key, cfg):
    dt = cdtype(cfg)
    p = {"embed": _init(key, (cfg.vocab_size, cfg.d_model), 1.0, dt)}
    if cfg.learned_pos:
        p["pos_embed"] = _init(prng.fold_in(key, 1),
                               (cfg.max_position, cfg.d_model), 1.0, dt)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(prng.fold_in(key, 2), cfg.d_model,
                                  cfg.vocab_size, dt)
    return p


def embed_tokens(p, cfg, tokens, pos=None):
    """The tokens' rows of the embedding; the gemma names scale them by
    sqrt(d_model) rounded to the embedding's dtype first, as the JAX
    package's ``jnp.asarray(np.sqrt(d), x.dtype)`` does (in bf16,
    sqrt(5376) = 73.32 becomes 73.5)."""
    x = p["embed"][tokens.long()]
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * embed_scale(cfg, x.dtype, x.device)
    if cfg.learned_pos and pos is not None:
        x = x + p["pos_embed"][pos]
    return x


def embed_scale(cfg, dtype, device=None):
    """sqrt(d_model) as a 0-d tensor of ``dtype``, rounded from float32."""
    return torch.tensor(np.float32(np.sqrt(cfg.d_model)),
                        device=device).to(dtype)


def logits_out(p, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ p["embed"].T
    else:
        logits = x @ p["lm_head"]
    logits = logits.to(torch.float32)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Causal depthwise conv (the RG-LRU's front conv)
# ---------------------------------------------------------------------------
def conv1d_init(key, channels, width, dtype):
    return {
        "conv_w": _init(key, (width, channels), 1.0, dtype),
        "conv_b": torch.zeros((channels,), dtype=dtype, device=key.device),
    }


def causal_conv1d(p, x):
    """x: (B, S, C) -> (B, S, C): depthwise causal conv of width K. The K
    shifted products are added one at a time to zeros in x's dtype, then
    the bias, the JAX package's order (so bf16 rounds the same)."""
    w = p["conv_w"]  # (K, C)
    k, S = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], k - 1) + x.shape[2:]), x], 1)
    out = torch.zeros_like(x)
    for i in range(k):  # K is 4
        out = out + xp[:, i:i + S, :] * w[i]
    return out + p["conv_b"]
