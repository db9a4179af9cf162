"""Multi-head attention for the ported models: causal self-attention
(GQA, global or local (sliding-window), and DeepSeek's multi-head latent
attention (MLA)) and cross attention over an encoder's memory, in
training, prefill and decode, with their caches.

Counterpart of ``repro.models.attention``: the optional QKV bias, the
QK-norm over the head dim and RoPE (``standard``, GLM's ``half``, or
``none`` for learned positions) in the JAX package's order; the
``attn_local`` mixer's window (a query sees itself and the window - 1
keys before it), in query blocks once the sequence is longer than the
window; MLA's compressed KV (a low-rank latent, RMS-normed, expanded per
head) with a shared roped key; cross attention's own K and V projections
of the memory (``mem_wk``, ``mem_wv``), unmasked, either as the whole
mixer (``attn_cross``, gated by ``tanh(xgate)``: Llama-3.2-Vision) or as
a second sub-block after the self-attention (``cross=True``, with its own
``mem_wq``, ``mem_wo``: Whisper's decoder).

Serving: prefill runs the training form and writes the cache (the roped
K and V of ``Kv`` heads, grouped; MLA's normed latent and roped key; the
memory's ``mem_k``/``mem_v``); decode inserts one position a row into
the cache in place and attends over it with the query heads grouped by
their KV head, so the KV heads are never repeated (MLA attends in the
latent space, the key's up-projection absorbed into the query), and the
cross attention reads its ``mem_k``/``mem_v`` without a memory. Written
with matmul and softmax rather than a fused attention call, so that its
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
    """A GQA mixer's weights. ``attn_cross`` has no self K and V (nor
    their biases) and a float32 ``xgate``, zero; a ``cross`` block adds
    the cross attention's own ``mem_wq`` and ``mem_wo``. Both take the
    memory's K and V projections ``mem_wk``, ``mem_wv``."""
    dt = cdtype(cfg)
    ks = prng.split(key, 6)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = key.device
    cross_only = spec.mixer == "attn_cross"
    p = {
        "wq": dense_init(ks[0], cfg.d_model, H * D, dt),
        "wo": dense_init(ks[3], H * D, cfg.d_model, dt),
    }
    if not cross_only:
        p["wk"] = dense_init(ks[1], cfg.d_model, Kv * D, dt)
        p["wv"] = dense_init(ks[2], cfg.d_model, Kv * D, dt)
    if cfg.qkv_bias:
        p["wq_bias"] = torch.zeros((H * D,), dtype=dt, device=dev)
        if not cross_only:
            p["wk_bias"] = torch.zeros((Kv * D,), dtype=dt, device=dev)
            p["wv_bias"] = torch.zeros((Kv * D,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((D,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((D,), dtype=torch.float32, device=dev)
    if spec.cross or cross_only:
        p["mem_wk"] = dense_init(ks[4], cfg.d_model, Kv * D, dt)
        p["mem_wv"] = dense_init(ks[5], cfg.d_model, Kv * D, dt)
        if cross_only:
            p["xgate"] = torch.zeros((), dtype=torch.float32, device=dev)
        else:
            p["mem_wq"] = dense_init(prng.fold_in(ks[4], 7), cfg.d_model,
                                     H * D, dt)
            p["mem_wo"] = dense_init(prng.fold_in(ks[5], 7), H * D,
                                     cfg.d_model, dt)
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
    scores = _scores(q, k)
    qpos = torch.arange(q0, q0 + q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k0, k0 + k.shape[1], device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return _mix(scores.masked_fill(~mask, NEG_INF), v)


def full_attention(q, k, v):
    """Unmasked softmax attention (cross attention, the encoder): every
    query sees every key. q: (B, S, H, D); k: (B, T, H, D); v: (B, T, H,
    Dv) -> (B, S, H, Dv)."""
    return _mix(_scores(q, k), v)


def _scores(q, k):
    """float32 (B, H, S, T) scores scaled by 1/sqrt(D)."""
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32))
    return scores * float(np.float32(1.0 / np.sqrt(q.shape[-1])))


def _mix(scores, v):
    """The float32 softmax of the scores, cast to v's dtype, times v."""
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def project_qkv(p, cfg, x):
    """q (B, S, H, D), k and v (B, S, Kv, D) of a self-attention block:
    projection, bias, heads, head norm (no rope)."""
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
    return q, k, v


def expand_kv(cfg, k, v):
    """K and V of Kv heads repeated to the H query heads, each in turn."""
    g = cfg.n_heads // cfg.n_kv_heads
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return k, v


def gqa_apply(p, cfg, spec, x, pos, *, cache=None, mode="train"):
    """Causal self-attention of a block, global (``attn_full``) or within
    ``cfg.window`` (``attn_local``). x: (B, S, d) -> (B, S, d). q and k:
    projection, bias, heads, head norm, rope. "train" and "prefill": pos
    (S,) positions, and prefill writes the roped K and V into the cache's
    first S positions; "decode": pos (B,) each row's position, its K and
    V inserted there, the query attending over the cache."""
    B, S, _ = x.shape
    window = cfg.window if spec.mixer == "attn_local" else 0
    q, k, v = project_qkv(p, cfg, x)
    pos_b = pos[:, None] if mode == "decode" else pos[None, :]
    q = apply_rope(q, pos_b, cfg)
    k = apply_rope(k, pos_b, cfg)
    if mode == "decode":
        kc = cache_insert(cache["k"], k, pos)
        vc = cache_insert(cache["v"], v, pos)
        y = decode_attention(_grouped(cfg, q), kc, vc, pos, window)
        return y.reshape(B, S, -1) @ p["wo"]
    if cache is not None:
        cache_prefill(cache["k"], k)
        cache_prefill(cache["v"], v)
    k, v = expand_kv(cfg, k, v)
    y = causal_attention(q, k, v, window).reshape(B, S, -1)
    return y @ p["wo"]


def _grouped(cfg, q):
    """(B, 1, H, D) query heads -> (B, Kv, H/Kv, D), grouped by the KV
    head each reads (head h reads KV head h // (H/Kv), as ``expand_kv``
    repeats them)."""
    B, _, H, D = q.shape
    return q.reshape(B, cfg.n_kv_heads, H // cfg.n_kv_heads, D)


def decode_attention(q, k, v, pos=None, window=0):
    """One query position a row over a cache, the KV heads not repeated.
    q: (B, Kv, G, D); k: (B, T, Kv, D); v: (B, T, Kv, Dv) -> (B, Kv, G,
    Dv). ``pos`` (B,): a row sees the cache's positions <= pos (and >
    pos - window where ``window`` > 0); None: every position (the cross
    attention's memory). Softmax in float32, scaled by 1/sqrt(D)."""
    scores = torch.einsum("bkgd,btkd->bkgt", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    if pos is not None:
        scores = scores.masked_fill(
            ~_decode_mask(k.shape[1], pos, window)[:, None, None, :],
            NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", probs.to(v.dtype), v)


def _decode_mask(T, pos, window=0):
    """(B, T): the cache positions each row's query at ``pos`` sees."""
    t = torch.arange(T, device=pos.device)[None, :]
    mask = t <= pos[:, None]
    if window:
        mask &= t > pos[:, None] - window
    return mask


def cache_insert(cache, new, pos):
    """Write ``new`` (B, 1, ...) into ``cache`` (B, T, ...) at each row's
    ``pos`` (B,), in place, and return the cache. As
    ``jax.lax.dynamic_update_slice`` takes the JAX package's start index:
    a negative one counts from the end, then it is clamped into [0, T)."""
    T = cache.shape[1]
    idx = pos.to(torch.long)
    idx = torch.where(idx < 0, idx + T, idx).clamp(0, T - 1)
    cache[torch.arange(cache.shape[0], device=cache.device), idx] = \
        new[:, 0].to(cache.dtype)
    return cache


def cache_prefill(cache, full):
    """Write ``full`` (B, S, ...) into the cache's first S positions, in
    place."""
    cache[:, :full.shape[1]] = full.to(cache.dtype)


def cross_attn_apply(p, cfg, spec, x, memory, *, cache=None,
                     mode="train"):
    """Cross attention of a block's queries over the encoder's memory,
    unmasked. x: (B, S, d), memory: (B, M, d) -> (B, S, d). ``attn_cross``
    projects with ``wq`` (and its bias) and ``wo`` and gates the heads'
    output by ``tanh(xgate)``; a ``cross`` block with ``mem_wq`` and
    ``mem_wo``. The memory's K and V: ``mem_wk``, ``mem_wv``, no bias, no
    rope (the head norm where the block has one, as the JAX package's
    ``_project_kv``). "prefill" writes them into the cache's ``mem_k``
    and ``mem_v``; "decode" reads them from there and takes no memory."""
    B, S, _ = x.shape
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cross_only = spec.mixer == "attn_cross"
    wq, wo = ("wq", "wo") if cross_only else ("mem_wq", "mem_wo")
    q = x @ p[wq]
    if cross_only and "wq_bias" in p:
        q = q + p["wq_bias"]
    q = q.reshape(B, S, H, D)
    if mode == "decode":
        xa = decode_attention(_grouped(cfg, q), cache["mem_k"],
                              cache["mem_v"])
    else:
        if memory is None:
            raise ValueError(f"block {spec} attends to an encoder memory: "
                             "the batch needs its 'memory_raw'")
        M = memory.shape[1]
        k = (memory @ p["mem_wk"]).reshape(B, M, Kv, D)
        v = (memory @ p["mem_wv"]).reshape(B, M, Kv, D)
        if "k_norm" in p:
            k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
        if cache is not None:
            cache["mem_k"].copy_(k)
            cache["mem_v"].copy_(v)
        xa = full_attention(q, *expand_kv(cfg, k, v))
    xa = xa.reshape(B, S, H * D)
    if "xgate" in p:
        xa = xa * torch.tanh(p["xgate"]).to(xa.dtype)
    return xa @ p[wo]


def gqa_cache_shape(cfg, spec, batch, seq_len, has_memory):
    """The self-attention's K and V (Kv heads; not for ``attn_cross``) and,
    for a cross-attending block, the memory's ``mem_k``/``mem_v``."""
    dt = cdtype(cfg)
    kv = (batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    shapes = {}
    if spec.mixer != "attn_cross":
        shapes["k"], shapes["v"] = (kv, dt), (kv, dt)
    if spec.cross or spec.mixer == "attn_cross":
        mem = (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
        shapes["mem_k"], shapes["mem_v"] = (mem, dt), (mem, dt)
    return shapes


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


def _mla_compress(p, cfg, x, pos_b):
    """Returns (c_kv normed, k_rope roped): (B, S, rank), (B, S, rope);
    pos_b the positions broadcastable to (B, S)."""
    a = x @ p["kv_a"]
    c_kv, k_rope = a[..., :cfg.kv_lora_rank], a[..., cfg.kv_lora_rank:]
    c_kv = rms_head_norm(p["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos_b, cfg)[:, :, 0, :]
    return c_kv, k_rope


def mla_apply(p, cfg, spec, x, pos, *, cache=None, mode="train"):
    """MLA self-attention of a block. "train" and "prefill": the latent
    expanded to H keys and values, each key the head's nope part and the
    shared roped part; prefill writes the latent and the roped key into
    the cache. "decode": both inserted at each row's position, then the
    absorbed form: the query's nope part taken into the latent space
    through the key's up-projection, scores against the cached latent
    plus the roped parts', the output's latent through the value's
    up-projection. x: (B, S, d) -> (B, S, d); pos: (S,) or, in decode,
    (B,)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    pos_b = pos[:, None] if mode == "decode" else pos[None, :]
    q = (x @ p["wq"]).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, pos_b, cfg)

    kv_b = p["kv_b"].reshape(cfg.kv_lora_rank, H, nd + vd)
    w_k, w_v = kv_b[..., :nd], kv_b[..., nd:]
    c_kv, k_rope = _mla_compress(p, cfg, x, pos_b)
    if mode == "decode":
        c_kv = cache_insert(cache["c_kv"], c_kv, pos)
        k_rope = cache_insert(cache["k_rope"], k_rope, pos)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_k)
        scores = torch.einsum("bhr,btr->bht", q_lat.to(torch.float32),
                              c_kv.to(torch.float32)) \
            + torch.einsum("bhp,btp->bht", q_rope[:, 0].to(torch.float32),
                           k_rope.to(torch.float32))
        scores = (scores * float(np.float32(1.0 / np.sqrt(nd + rd))))\
            .masked_fill(~_decode_mask(c_kv.shape[1], pos)[:, None, :],
                         NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bht,btr->bhr", probs.to(c_kv.dtype), c_kv)
        o = torch.einsum("bhr,rhv->bhv", o_lat, w_v)
        return o.reshape(B, S, H * vd) @ p["wo"]
    if cache is not None:
        cache_prefill(cache["c_kv"], c_kv)
        cache_prefill(cache["k_rope"], k_rope)
    k_nope = torch.einsum("btr,rhn->bthn", c_kv, w_k)
    v = torch.einsum("btr,rhv->bthv", c_kv, w_v)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], -1)
    o = causal_attention(torch.cat([q_nope, q_rope], -1), k, v)
    return o.reshape(B, S, H * vd) @ p["wo"]


def mla_cache_shape(cfg, spec, batch, seq_len, has_memory):
    dt = cdtype(cfg)
    return {"c_kv": ((batch, seq_len, cfg.kv_lora_rank), dt),
            "k_rope": ((batch, seq_len, cfg.rope_head_dim), dt)}
