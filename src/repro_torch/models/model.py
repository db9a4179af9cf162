"""Public model API of the port: ``init_params``, ``param_count`` and
``loss_fn``.

Counterpart of ``repro.models.model.Model`` in training mode. A batch is
``{"tokens": (B, S+1) int}``, with ``"memory_raw": (B, M, encoder_dim)``
for the models that attend to an encoder's memory (the stub frames or
patches, through the projector and, for Whisper, the encoder); the loss
is the next-token cross-entropy with
the JAX package's ceiling-chunked evaluation (never more than
``LOSS_CHUNK`` positions of float32 logits at once), plus the MoE
load-balance loss where the model has experts.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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

