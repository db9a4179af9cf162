"""Causal multi-head self-attention for the ported models: GQA, global or
local (sliding-window), and DeepSeek's multi-head latent attention (MLA).

Counterpart of ``repro.models.attention``'s ``gqa_init``/``gqa_apply`` and
``mla_init``/``mla_apply`` in training mode: the optional QKV bias, the
QK-norm over the head dim and RoPE (``standard``, GLM's ``half``, or
``none`` for ALBERT's learned positions) in the JAX package's order; the
``attn_local`` mixer's window (a query sees itself and the window - 1 keys
before it), in query blocks once the sequence is longer than the window;
MLA's compressed KV (a low-rank latent, RMS-normed, expanded per head)
with a shared roped key. Prefill, decode and the KV caches (MLA's absorbed
decode among them) are ROADMAP item 15's. Written with
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
WINDOW_BLOCK = 1024  # query rows a block of the windowed form


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


def causal_attention(q, k, v, window=0):
    """q, k: (B, S, H, D); v: (B, S, H, Dv) -> (B, S, H, Dv); softmax in
    float32, scaled by 1/sqrt(D), q's head dim (MLA: D = 192, Dv = 128).
    ``window`` > 0: query i sees keys i - window + 1 .. i; past S = window
    the queries go in blocks of min(S, ``WINDOW_BLOCK``), each against its
    span of window + block keys, so the scores take S * (window + block)
    and not S * S (the JAX package's ``_windowed_attention``)."""
    S = q.shape[1]
    if window and S > window:
        bq = min(S, WINDOW_BLOCK)
        outs = []
        for qs in range(0, S, bq):
            qe, lo = min(S, qs + bq), max(0, qs - window)
            outs.append(_attend(q[:, qs:qe], k[:, lo:qe], v[:, lo:qe],
                                qs, lo, window))
        return torch.cat(outs, 1)
    return _attend(q, k, v, 0, 0, window)


def _attend(q, k, v, q0, k0, window):
    """Softmax attention of queries at positions q0.. over keys at k0..,
    causal, and within ``window`` where it is > 0."""
    D = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * float(np.float32(1.0 / np.sqrt(D)))
    qpos = torch.arange(q0, q0 + q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k0, k0 + k.shape[1], device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def gqa_apply(p, cfg, spec, x, pos):
    """Causal self-attention of a block, global (``attn_full``) or within
    ``cfg.window`` (``attn_local``). x: (B, S, d) -> (B, S, d); pos: (S,)
    positions. q and k: projection, bias, heads, head norm, rope."""
    B, S, _ = x.shape
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.window if spec.mixer == "attn_local" else 0
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
    y = causal_attention(q, k, v, window).reshape(B, S, H * D)
    return y @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_init(key, cfg, spec):
    dt = cdtype(cfg)
    ks = prng.split(key, 4)
    H = cfg.n_heads
    qd = cfg.nope_head_dim + cfg.rope_head_dim
    return {
        "wq": dense_init(ks[0], cfg.d_model, H * qd, dt),
        "kv_a": dense_init(ks[1], cfg.d_model,
                           cfg.kv_lora_rank + cfg.rope_head_dim, dt),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=torch.float32,
                              device=key.device),
        "kv_b": dense_init(ks[2], cfg.kv_lora_rank,
                           H * (cfg.nope_head_dim + cfg.v_head_dim), dt),
        "wo": dense_init(ks[3], H * cfg.v_head_dim, cfg.d_model, dt),
    }


def _mla_compress(p, cfg, x, pos):
    """Returns (c_kv normed, k_rope roped): (B, S, rank), (B, S, rope)."""
    a = x @ p["kv_a"]
    c_kv, k_rope = a[..., :cfg.kv_lora_rank], a[..., cfg.kv_lora_rank:]
    c_kv = rms_head_norm(p["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos[None, :], cfg)[:, :, 0, :]
    return c_kv, k_rope


def mla_apply(p, cfg, spec, x, pos):
    """MLA self-attention of a block in training mode: the latent expanded
    to H keys and values, each key the head's nope part and the shared
    roped part. x: (B, S, d) -> (B, S, d); pos: (S,) positions."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, pos[None, :], cfg)

    kv_b = p["kv_b"].reshape(cfg.kv_lora_rank, H, nd + vd)
    w_k, w_v = kv_b[..., :nd], kv_b[..., nd:]
    c_kv, k_rope = _mla_compress(p, cfg, x, pos)
    k_nope = torch.einsum("btr,rhn->bthn", c_kv, w_k)
    v = torch.einsum("btr,rhv->bthv", c_kv, w_v)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], -1)
    o = causal_attention(torch.cat([q_nope, q_rope], -1), k, v)
    return o.reshape(B, S, H * vd) @ p["wo"]
