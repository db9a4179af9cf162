"""The RG-LRU recurrent mixer (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-dependent sigmoids.

Counterpart of ``repro.models.rglru`` in training mode: the input and gate
projections, the causal conv in front, the gates in float32 and the
recurrence as a log-depth scan, with ``jax.lax.associative_scan``'s
odd/even recursion so that its sums pair up as the JAX package's do (a
loop over the sequence would be S dependent steps on the card, forward
and backward). The scan is plain torch: the JAX package runs it as plain
XLA, with no Pallas kernel. Prefill carries the cache's ``h`` into the
scan and writes the last state and the conv's last inputs back; decode
steps ``h`` and the conv buffer (``causal_conv1d_step``) in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                      cdtype, conv1d_init, conv_tail,
                                      dense_init, softplus)

RGLRU_C = 8.0


def rglru_init(key, cfg, spec=None):
    dt = cdtype(cfg)
    w = cfg.rglru_width or cfg.d_model
    ks = prng.split(key, 6)
    # a ~ uniform decays in (0.9, 0.999): computed in float64 numpy and
    # rounded to float32, as the JAX package computes it
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, w)) / RGLRU_C))
    p = {
        "in_proj": dense_init(ks[0], cfg.d_model, w, dt),
        "gate_w": dense_init(ks[1], cfg.d_model, w, dt),
        "wa": dense_init(ks[2], w, w, dt),
        "wx": dense_init(ks[3], w, w, dt),
        "lam": torch.from_numpy(lam.astype(np.float32)).to(key.device),
        "out_proj": dense_init(ks[4], w, cfg.d_model, dt),
    }
    p.update(conv1d_init(ks[5], w, cfg.rglru_conv, dt))
    return p


def _gates(p, xc):
    """xc: (..., w) conv output -> (log_a, gated input), both float32."""
    r = torch.sigmoid((xc @ p["wa"]).to(torch.float32))
    i = torch.sigmoid((xc @ p["wx"]).to(torch.float32))
    log_a = -RGLRU_C * softplus(p["lam"]) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) \
        * (i * xc.to(torch.float32))
    return log_a, b


def rglru_apply(p, cfg, spec, x, pos=None, *, cache=None, mode="train"):
    """x: (B, S, d) -> (B, S, d); ``pos`` unused (the recurrence knows
    its positions). With a ``cache``, "prefill" starts the scan from its
    ``h`` and writes the last state and the conv's last K - 1 inputs
    into it; "decode" (S = 1) steps both in place."""
    xb = x @ p["in_proj"]
    gate = F.silu((x @ p["gate_w"]).to(torch.float32))
    if mode == "decode":
        conv_buf, xc = causal_conv1d_step(p, cache["conv"], xb[:, 0])
        log_a, b = _gates(p, xc)
        h = cache["h"].to(torch.float32) * torch.exp(log_a) + b  # (B, w)
        cache["conv"].copy_(conv_buf)
        cache["h"].copy_(h)
        h = h[:, None]
    else:
        log_a, b = _gates(p, causal_conv1d(p, xb))
        log_a_cum, h = linear_scan(log_a, b)
        if cache is not None:
            h = h + cache["h"].to(torch.float32)[:, None] \
                * torch.exp(log_a_cum)
            cache["h"].copy_(h[:, -1])
            cache["conv"].copy_(conv_tail(xb, cfg.rglru_conv))
    return (h * gate).to(x.dtype) @ p["out_proj"]


def rglru_cache_shape(cfg, spec, batch, seq_len, has_memory):
    dt = cdtype(cfg)
    w = cfg.rglru_width or cfg.d_model
    return {"h": ((batch, w), dt),
            "conv": ((batch, cfg.rglru_conv - 1, w), dt)}


def linear_scan(log_a, b):
    """(sum_{s<=t} log_a_s, h_t) over axis 1, h_t = e^{log_a_t} h_{t-1} +
    b_t from h = 0: ``jax.lax.associative_scan`` of ``_combine`` over
    (log_a, b), in its order. log_a, b: (B, S, w)."""
    return _scan((log_a, b))


def _combine(left, right):
    (al, bl), (ar, br) = left, right
    return al + ar, bl * torch.exp(ar) + br


def _scan(elems):
    """The odd/even recursion: scan the sums of adjacent pairs (the odd
    outputs), then combine each with the next even input. A module-level
    recursion, so no closure holds the activations in a cycle."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _scan(_combine(tuple(e[:, 0:n - 1:2] for e in elems),
                         tuple(e[:, 1::2] for e in elems)))
    head = odd if n % 2 else tuple(e[:, :-1] for e in odd)
    even = _combine(head, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even))
    return tuple(_interleave(a, o) for a, o in zip(even, odd))


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along axis 1; a is as long as b or one
    longer."""
    m = b.shape[1]
    ab = torch.stack([a[:, :m], b], 2).flatten(1, 2)
    return ab if a.shape[1] == m else torch.cat([ab, a[:, m:]], 1)
