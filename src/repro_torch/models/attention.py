"""Causal multi-head self-attention (GQA layout) for the ported models.

Counterpart of ``repro.models.attention``'s ``gqa_init``/``gqa_apply`` in
training mode: the optional QKV bias, the QK-norm over the head dim and
RoPE (``standard``, GLM's ``half``, or ``none`` for ALBERT's learned
positions) in the JAX package's order. Prefill, decode and the KV caches
are ROADMAP item 15's. Written with
matmul and softmax rather than a fused attention call, so that its
backward is deterministic; scores and softmax run in float32, as the JAX
package's ``preferred_element_type`` asks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.layers import (apply_rope, cdtype, dense_init,
                                      rms_head_norm)

NEG_INF = -2.0e38


def gqa_init(key, cfg, spec):
    dt = cdtype(cfg)
    ks = prng.split(key, 6)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = key.device
    p = {
        "wq": dense_init(ks[0], cfg.d_model, H * D, dt),
        "wk": dense_init(ks[1], cfg.d_model, Kv * D, dt),
        "wv": dense_init(ks[2], cfg.d_model, Kv * D, dt),
        "wo": dense_init(ks[3], H * D, cfg.d_model, dt),
    }
    if cfg.qkv_bias:
        p["wq_bias"] = torch.zeros((H * D,), dtype=dt, device=dev)
        p["wk_bias"] = torch.zeros((Kv * D,), dtype=dt, device=dev)
        p["wv_bias"] = torch.zeros((Kv * D,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((D,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((D,), dtype=torch.float32, device=dev)
    return p


def causal_attention(q, k, v):
    """q, k, v: (B, S, H, D) -> (B, S, H, D); softmax in float32."""
    D = q.shape[-1]
    S = q.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * float(np.float32(1.0 / np.sqrt(D)))
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def gqa_apply(p, cfg, spec, x, pos):
    """Causal self-attention of a block. x: (B, S, d) -> (B, S, d); pos:
    (S,) positions. q and k: projection, bias, heads, head norm, rope."""
    B, S, _ = x.shape
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "wq_bias" in p:
        q = q + p["wq_bias"]
        k = k + p["wk_bias"]
        v = v + p["wv_bias"]
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, Kv, D)
    v = v.reshape(B, S, Kv, D)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, pos[None, :], cfg)
    k = apply_rope(k, pos[None, :], cfg)
    if Kv < H:
        k = k.repeat_interleave(H // Kv, dim=2)
        v = v.repeat_interleave(H // Kv, dim=2)
    y = causal_attention(q, k, v).reshape(B, S, H * D)
    return y @ p["wo"]
