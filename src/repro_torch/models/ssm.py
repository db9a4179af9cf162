"""The Mamba-2 SSD (state-space duality) mixer, in its chunked dual form
(arXiv:2405.21060 §6), with one B/C group shared by the heads.

Counterpart of ``repro.models.ssm``. Training and prefill run the chunked
algorithm: within a chunk a small masked, decaying attention-like product;
across chunks the chunk-final states combined in order (the JAX package
runs ``jax.lax.associative_scan`` over the chunks; here a loop over them,
a handful at the published chunk of 256). Decode carries the state and
the conv buffer in the cache and runs the one-step recurrence in float32.
The casts sit where the JAX package puts them, so bf16 rounds at the same
places. Plain torch: the JAX package runs the SSD as plain XLA, with no
Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                      cdtype, conv1d_init, conv_tail,
                                      dense_init, softplus)


def ssm_init(key, cfg, spec=None):
    dt = cdtype(cfg)
    ks = prng.split(key, 4)
    d_in, H, N = cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_state
    dev = key.device
    p = {
        "in_proj": dense_init(ks[0], cfg.d_model, 2 * d_in + 2 * N + H, dt),
        "out_proj": dense_init(ks[1], d_in, cfg.d_model, dt),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((d_in,), dtype=torch.float32, device=dev),
    }
    p.update(conv1d_init(ks[2], d_in + 2 * N, cfg.ssm_conv, dt))
    return p


def _split_proj(cfg, zxbcdt):
    """The in-projection's columns: z, x, B, C and dt."""
    d_in, N = cfg.ssm_inner, cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in, N, N, cfg.ssm_heads], dim=-1)


def _gated_norm(p, cfg, y, z):
    """y times silu(z), RMS-normed over the channels in float32, scaled by
    ``gate_norm``, in y's dtype."""
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    yf = y.to(torch.float32)
    yn = yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + cfg.norm_eps)
    return (yn * p["gate_norm"]).to(y.dtype)


def ssd_chunked(x, a_log, dt, Bm, Cm, chunk, init_state=None):
    """The chunked SSD.

    x: (B, S, H, P) the heads' inputs; a_log: (B, S, H) each step's log
    decay (dt * A, negative); dt: (B, S, H) the step sizes; Bm, Cm: (B, S,
    N) the shared input and output projections. Returns y (B, S, H, P) and
    the final float32 state (B, H, N, P). A ragged tail is padded with dt
    = 0 steps (decay 1, no input), which leave the state as it was;
    ``init_state`` (B, H, N, P) is the state entering the first chunk.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log, dt = (F.pad(t, (0, 0, 0, pad)) for t in (a_log, dt))
        Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
        S += pad
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    lcum = torch.cumsum(a_log.reshape(Bsz, nc, Q, H), dim=2)

    # within a chunk: L[i, j] = exp(lcum_i - lcum_j) for j <= i, masked to
    # -inf before the exp (above the diagonal lcum_i - lcum_j is large and
    # positive: its exp would overflow, and inf * 0 is NaN in the backward)
    seg = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    upper = torch.ones((Q, Q), dtype=torch.bool, device=x.device).triu(1)
    L = torch.exp(seg.masked_fill(upper[:, :, None], float("-inf")))
    G = torch.einsum("bcin,bcjn->bcij", Cc.to(torch.float32),
                     Bc.to(torch.float32))
    M = G[..., None] * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M.to(x.dtype), xc)

    # each chunk's final state from its own inputs
    decay_to_end = torch.exp(lcum[:, :, -1:, :] - lcum)  # (B,nc,Q,H)
    wB = Bc[:, :, :, None, :] * (dtc * decay_to_end)[..., None]
    S_local = torch.einsum("bcqhn,bcqhp->bchnp", wB.to(x.dtype), xc)

    # across chunks, in order: S_c = S_{c-1} * decay_c + S_local_c
    chunk_decay = torch.exp(lcum[:, :, -1, :])  # (B,nc,H)
    S_local = S_local.to(torch.float32)
    states, decays = [S_local[:, 0]], [chunk_decay[:, 0]]
    for c in range(1, nc):
        states.append(states[-1] * chunk_decay[:, c, :, None, None]
                      + S_local[:, c])
        decays.append(decays[-1] * chunk_decay[:, c])
    S_all = torch.stack(states, 1)  # (B,nc,H,N,P)
    if init_state is None:
        first = torch.zeros_like(S_all[:, :1])
    else:
        init = init_state.to(torch.float32)[:, None]
        S_all = S_all + torch.stack(decays, 1)[..., None, None] * init
        first = init
    S_in = torch.cat([first, S_all[:, :-1]], 1)  # the state entering c
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc, S_in.to(Cc.dtype)) \
        * torch.exp(lcum)[..., None].to(x.dtype)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S_orig]
    return y, S_all[:, -1]


def ssm_apply(p, cfg, spec, x, pos=None, *, cache=None, mode="train"):
    """x: (B, S, d) -> (B, S, d); ``pos`` unused. ``mode`` "train" or
    "prefill" runs ``ssd_chunked`` over the sequence (prefill also writes
    the final state and the conv's last K - 1 inputs into ``cache``,
    left-padded with zeros when S < K - 1); "decode" (S = 1) steps the
    conv buffer and the state in ``cache``, in place."""
    B = x.shape[0]
    d_in, N, H, P = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    A = -torch.exp(p["A_log"])  # (H,), negative
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    conv_in = torch.cat([xs, Bm, Cm], -1)
    if mode == "decode":
        conv_buf, conv_out = causal_conv1d_step(p, cache["conv"],
                                                conv_in[:, 0])
        conv_out = F.silu(conv_out)[:, None]
        cache["conv"].copy_(conv_buf)
    else:
        conv_out = F.silu(causal_conv1d(p, conv_in))
        if cache is not None:
            cache["conv"].copy_(conv_tail(conv_in, cfg.ssm_conv))
    xs = conv_out[..., :d_in].reshape(B, -1, H, P)
    Bm = conv_out[..., d_in:d_in + N]
    Cm = conv_out[..., d_in + N:]
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B,S,H)
    a_log = dt * A

    if mode == "decode":
        state = cache["state"].to(torch.float32)  # (B,H,N,P)
        x0 = xs[:, 0].to(torch.float32)
        inc = torch.einsum("bn,bhp->bhnp", Bm[:, 0].to(torch.float32),
                           dt[:, 0][..., None] * x0)
        state = state * torch.exp(a_log[:, 0])[..., None, None] + inc
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(torch.float32), state)
        y = (y + p["D"][:, None] * x0)[:, None].to(x.dtype)  # (B,1,H,P)
        cache["state"].copy_(state)
    else:
        y, final_state = ssd_chunked(xs, a_log, dt, Bm, Cm, cfg.ssm_chunk)
        y = y + (p["D"][:, None] * xs.to(torch.float32)).to(y.dtype)
        if cache is not None:
            cache["state"].copy_(final_state)
    y = _gated_norm(p, cfg, y.reshape(B, -1, d_in), z)
    return y @ p["out_proj"]


def ssm_cache_shape(cfg, spec, batch, seq_len, has_memory):
    dt = cdtype(cfg)
    return {
        "state": ((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                  dt),
        "conv": ((batch, cfg.ssm_conv - 1,
                  cfg.ssm_inner + 2 * cfg.ssm_state), dt),
    }
