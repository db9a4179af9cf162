"""Mixture-of-Experts MLP with capacity-based dispatch, in training mode.

Counterpart of ``repro.models.moe``. Routing is per batch row: float32
router logits, softmax, top-k, renormalised top-p, the Switch
load-balance loss from each token's first expert, and k-major slots (a
cumsum over the token order, carried across k) into an (E, C) buffer of
each row; a token whose slot falls past the capacity C is dropped. The
experts run as three batched products over the (B, E, C, d) buffer, and
the kept tokens' outputs are combined with their top-p weights in
float32.

Every scatter writes each place once: the buffer takes only the kept
tokens, at their unique (row, expert, slot), and the combine places each
kept (row, k, token) once before summing over k in order, so no index
ever receives two nonzero terms, forward or backward, and the gradients
repeat bit for bit on the card without float atomics.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.layers import (act_fn, apply_mlp, cdtype, dense_init,
                                      mlp_init)


def moe_init(key, cfg):
    dt = cdtype(cfg)
    ks = prng.split(key, 5)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

    def experts(k, d_in, d_out):
        # jax.vmap(dense_init)(split(k, E)): expert e from key e
        return torch.stack([dense_init(ke, d_in, d_out, dt)
                            for ke in prng.split(k, E)])

    p = {
        "router": dense_init(ks[0], d, E, torch.float32),
        "experts_wi": experts(ks[1], d, f),
        "experts_wdown": experts(ks[3], f, d),
    }
    if cfg.glu:
        p["experts_wg"] = experts(ks[2], d, f)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(ks[4], cfg, cfg.n_shared_experts * f)
    return p


def capacity(cfg, n_tokens):
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


class Routing(NamedTuple):
    """Each row's routing. top_e, top_p: (B, S, K); slots, keeps: (B, K, S)
    (the JAX package's layouts); aux: (B,) load-balance loss."""

    top_e: torch.Tensor
    top_p: torch.Tensor
    slots: torch.Tensor
    keeps: torch.Tensor
    aux: torch.Tensor


def route(p, cfg, x):
    """x: (B, S, d) -> ``Routing``, each batch row on its own."""
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, x.shape[1])
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    # jax.lax.top_k puts the lower index first among equal values; a
    # stable descending sort does the same (torch.topk promises no order)
    top_e = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[..., :K]
    top_p = torch.gather(probs, -1, top_e)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux (Switch): E * sum_e f_e * p_e
    me = probs.mean(1)
    ce = F.one_hot(top_e[..., 0], E).to(torch.float32).mean(1)
    aux = E * (me * ce).sum(-1)

    # k-major slots: expert e's k-th choices queue behind all its earlier
    # choices (``base``), each in token order
    base = torch.zeros((x.shape[0], E), dtype=torch.int64, device=x.device)
    slots, keeps = [], []
    for k in range(K):
        oh = F.one_hot(top_e[..., k], E)  # (B, S, E)
        pos_in_e = oh.cumsum(1) - 1 + base[:, None, :]
        slot = torch.gather(pos_in_e, 2, top_e[..., k:k + 1])[..., 0]
        base = base + oh.sum(1)
        keep = slot < C
        slots.append(torch.where(keep, slot, C - 1))
        keeps.append(keep)
    return Routing(top_e, top_p, torch.stack(slots, 1), torch.stack(keeps, 1),
                   aux)


def moe_apply(p, cfg, x):
    """x: (B, S, d) -> (y, aux_loss), the batch rows' mean aux."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    r = route(p, cfg, x)
    # the kept (row, k, token) triples, and each one's (expert, slot)
    kb, kk, kt = r.keeps.nonzero(as_tuple=True)
    ke, ks = r.top_e[kb, kt, kk], r.slots[kb, kk, kt]
    xk = x[:, None].expand(B, K, S, d)  # a token once per k: unique reads
    buf = x.new_zeros((B, E, capacity(cfg, S), d)).index_put(
        (kb, ke, ks), xk[kb, kk, kt])

    h = torch.einsum("becd,edf->becf", buf, p["experts_wi"])
    if "experts_wg" in p:
        g = torch.einsum("becd,edf->becf", buf, p["experts_wg"])
        h = act_fn(cfg, g) * h
    else:
        h = act_fn(cfg, h)
    expert_out = torch.einsum("becf,efd->becd", h, p["experts_wdown"])

    w = r.top_p[kb, kt, kk]
    placed = x.new_zeros((B, K, S, d), dtype=torch.float32).index_put(
        (kb, kk, kt), w[:, None] * expert_out[kb, ke, ks].to(torch.float32))
    y = placed[:, 0]
    for k in range(1, K):  # the reference's order: k = 0, 1, ...
        y = y + placed[:, k]
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], cfg, x)
    return y, r.aux.mean()

