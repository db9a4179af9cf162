"""Public model API of the port: ``init_params``, ``param_count``,
``loss_fn``, ``prefill``, ``decode_step`` and the cache.

Counterpart of ``repro.models.model.Model``. Batches:
  train:   {"tokens": (B, S+1) int, ["memory_raw": (B, M, encoder_dim)]}
  prefill: {"tokens": (B, S) int,   ["memory_raw"]}
  decode:  {"token": (B,) int, "pos": (B,) int} and the cache
``memory_raw`` (the stub frames or patches of the models that attend to
an encoder's memory) goes through the projector and, for Whisper, the
encoder. The loss is the next-token cross-entropy with the JAX package's
ceiling-chunked evaluation (never more than ``LOSS_CHUNK`` positions of
float32 logits at once), plus the MoE load-balance loss where the model
has experts. ``prefill`` and ``decode_step`` write the cache
(``init_cache``) in place and return it beside the float32 logits of the
last position.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.flatten import tree_leaves
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    apply_norm,
    cdtype,
    dense_init,
    embed_init,
    embed_tokens,
    logits_out,
    norm_init,
)

LOSS_CHUNK = 2048


class Model:
    def __init__(self, cfg):
        cfg.validate()
        self.cfg = cfg

    def init_params(self, key):
        """Parameters from a ``core.prng`` key; they live on its device.
        Where the memory's width is not d_model, a ``projector`` (from the
        third key); with an encoder, its layers, norm and ``enc_pos``
        (from the fourth)."""
        cfg = self.cfg
        ks = prng.split(key, 4)
        p = embed_init(ks[0], cfg)
        p.update(tfm.stack_init(ks[1], cfg))
        p["final_norm"] = norm_init(cfg, key.device)
        if cfg.has_encoder or cfg.family == "vlm":
            if cfg.encoder_dim and cfg.encoder_dim != cfg.d_model:
                p["projector"] = dense_init(ks[2], cfg.encoder_dim,
                                            cfg.d_model, cdtype(cfg))
            if cfg.has_encoder:
                p.update(tfm.encoder_init(ks[3], cfg))
        return p

    def param_count(self):
        """The parameters' count from their shapes alone: the init run on
        the meta device, which allocates nothing."""
        params = self.init_params(prng.key(0, device="meta"))
        return sum(t.numel() for t in tree_leaves(params))

    def active_param_count(self):
        """Parameters a token touches: the routed experts' leaves
        (``experts_*``) count top_k / n_experts of their size."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        params = self.init_params(prng.key(0, device="meta"))
        expert = sum(_expert_numel(params))
        return total - expert + expert * cfg.top_k / cfg.n_experts

    def _memory(self, params, batch):
        """The memory the cross-attending blocks read: ``memory_raw`` in
        the compute dtype, projected, then encoded; None without one."""
        if "memory_raw" not in batch:
            return None
        mem = batch["memory_raw"].to(cdtype(self.cfg))
        if "projector" in params:
            mem = mem @ params["projector"]
        if self.cfg.has_encoder:
            mem = tfm.encoder_apply(params, self.cfg, mem)
        return mem

    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy, plus ``router_aux_coef`` times the
        MoE load-balance loss where there are experts; returns (loss,
        {"loss": the cross-entropy, "aux_loss": the summed aux})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
        B, S = inputs.shape
        pos = torch.arange(S, device=tokens.device)
        x = embed_tokens(params, cfg, inputs,
                         pos=pos if cfg.learned_pos else None)
        x, aux = tfm.stack_apply(params, cfg, x, pos,
                                 memory=self._memory(params, batch))
        x = apply_norm(params["final_norm"], cfg, x)

        n_chunks = -(-S // LOSS_CHUNK)
        csz = -(-S // n_chunks)
        emb = {k: params[k] for k in ("embed", "lm_head") if k in params}

        def chunk_loss(x_sl, tgt_sl, *emb_leaves):
            logits = logits_out(dict(zip(emb, emb_leaves)), cfg, x_sl)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, tgt_sl[..., None])[..., 0]
            return (lse - tgt).sum()

        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(n_chunks):
            sl = slice(i * csz, min((i + 1) * csz, S))
            # recomputed in the backward, as the JAX package's jax.checkpoint
            total = total + checkpoint(chunk_loss, x[:, sl], targets[:, sl],
                                       *emb.values(), use_reentrant=False)
        loss = total / (B * S)
        metrics = {"loss": loss, "aux_loss": aux}
        if cfg.n_experts:
            loss = loss + cfg.router_aux_coef * aux
        return loss, metrics

    def prefill(self, params, batch, cache):
        """The prompts ``batch["tokens"]`` (B, S) through the stack,
        writing the cache's first S positions; returns the float32 logits
        of the last position (B, V), the final norm applied to it alone,
        and the cache."""
        cfg = self.cfg
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = embed_tokens(params, cfg, tokens,
                         pos=pos if cfg.learned_pos else None)
        x, _ = tfm.stack_apply(params, cfg, x, pos,
                               memory=self._memory(params, batch),
                               cache=cache, mode="prefill")
        x = apply_norm(params["final_norm"], cfg, x[:, -1:])
        return logits_out(params, cfg, x)[:, 0], cache

    def decode_step(self, params, batch, cache):
        """One token a row, ``batch["token"]`` (B,) at ``batch["pos"]``
        (B,), through the stack over the cache, which it updates; returns
        the float32 logits (B, V) and the cache."""
        cfg = self.cfg
        token, pos = batch["token"], batch["pos"].to(torch.long)
        x = embed_tokens(params, cfg, token[:, None],
                         pos=pos[:, None] if cfg.learned_pos else None)
        x, _ = tfm.stack_apply(params, cfg, x, pos, cache=cache,
                               mode="decode")
        x = apply_norm(params["final_norm"], cfg, x)
        return logits_out(params, cfg, x)[:, 0], cache

    def cache_shapes(self, batch_size, seq_len):
        """The cache's tree with ((shape), torch dtype) leaves."""
        return tfm.stack_cache_shapes(self.cfg, batch_size, seq_len)

    def init_cache(self, batch_size, seq_len, device=None):
        """A zero cache for ``batch_size`` rows of up to ``seq_len``
        positions, on ``device`` (the CUDA device unless told
        otherwise)."""
        device = resolve_device(device)
        return _zeros(self.cache_shapes(batch_size, seq_len), device)


def _zeros(shapes, device):
    if isinstance(shapes, dict):
        return {k: _zeros(v, device) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_zeros(v, device) for v in shapes]
    shape, dtype = shapes
    return torch.zeros(shape, dtype=dtype, device=device)


def _expert_numel(tree, routed=False):
    """The sizes of the leaves under an ``experts_*`` key."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _expert_numel(v, routed or k.startswith("experts_"))
    elif isinstance(tree, list):
        for v in tree:
            yield from _expert_numel(v, routed)
    elif routed:
        yield tree.numel()
