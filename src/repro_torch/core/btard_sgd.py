"""BTARD-SGD (paper Alg. 7): the trainer that simulates n peers on one
device and runs the protocol engine between SGD steps.

Counterpart of ``repro.core.btard_sgd``'s ``TrainerConfig`` and
``BTARDTrainer.run_scan``: per-peer gradients on PUBLIC minibatch seeds,
one ``engine.protocol_step`` per step, any ``optim`` optimizer applied to
the robust aggregate, and the same history records. Where the JAX package
runs the steps under one ``lax.scan``, this is a Python loop. The trainer
is an entry point: it runs on the CUDA device unless ``TrainerConfig.
device`` is "cpu".
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch import resolve_device
from repro_torch.core import engine as eng
from repro_torch.core.aggregators import resolve_spec
from repro_torch.core.flatten import FlatBoundary, tree_unflatten
from repro_torch.core.protocol import AttackConfig
from repro_torch.optim import apply_updates, sgd


@dataclass
class TrainerConfig:
    n_peers: int = 16
    byzantine: tuple = ()
    attack: AttackConfig = field(default_factory=AttackConfig)
    defense: str = "btard"  # btard | a registered AggregatorSpec name
    tau: float = 1.0
    clip_iters: int = 60
    m_validators: int = 1
    delta_max: float | None = None
    clip_lambda: float | None = None  # BTARD-Clipped-SGD
    seed: int = 0
    warm_start: bool = False
    adaptive_tol: float | None = None
    # explicit AggregatorSpec (or "name[:k=v,...]"); None resolves from
    # `defense`: "btard" -> the flagship ButterflyClip, any other name ->
    # that spec (non-verifiable baselines run without accusations or bans)
    aggregator: object = None
    device: object = None  # None = cuda


class BTARDTrainer:
    """loss_fn(params, batch) -> scalar; batch_fn(peer, step, flipped) ->
    batch. Master parameters are one flat f32 tensor on the device."""

    def __init__(self, loss_fn, params0, batch_fn, cfg: TrainerConfig,
                 optimizer=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.batch_fn = batch_fn
        self._loss = loss_fn
        self.boundary = FlatBoundary(params0)
        self.params = self.boundary.flatten(params0).to(self.device)
        self.d = self.boundary.d
        self.opt = optimizer or sgd(0.05, momentum=0.9, nesterov=True)
        self._opt_state = self.opt.init(self.params)
        agg = cfg.aggregator
        if agg is None and cfg.defense != "btard":
            agg = cfg.defense
        agg = resolve_spec(agg)  # validate early
        self.engine_config = eng.config_from_attack(
            cfg.n_peers, self.d, cfg.attack, tau=cfg.tau,
            clip_iters=cfg.clip_iters, m_validators=cfg.m_validators,
            delta_max=cfg.delta_max, clip_lambda=cfg.clip_lambda,
            warm_start=cfg.warm_start, adaptive_tol=cfg.adaptive_tol,
            aggregator=agg)
        self.byz_mask = torch.tensor(
            [1.0 if i in set(cfg.byzantine) else 0.0
             for i in range(cfg.n_peers)], device=self.device)
        self.state = eng.init_state(self.engine_config, seed=cfg.seed,
                                    device=self.device)
        self.banned: set = set()
        self.validators = _mask_to_list(self.state.validator)
        self.history: list = []
        self._step = 0

    def _grad(self, flat, batch):
        """Flat f32 gradient of the loss at the flat f32 params."""
        leaves = [t.detach().requires_grad_(True)
                  for t in self.boundary.unflatten_leaves(flat)]
        params = tree_unflatten(self.boundary.template, leaves)
        loss = self._loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return self.boundary.flatten_leaves(grads)

    def _grads_fn(self):
        return eng.device_data_grads_fn(
            self.cfg.n_peers, self.batch_fn, self._grad,
            label_flip=self.cfg.attack.kind == "label_flip")

    def run_scan(self, n_steps, log=None):
        """Run ``n_steps`` full BTARD rounds (grads -> protocol ->
        optimizer) and append one history record per step."""
        ecfg = self.engine_config
        grads_fn = self._grads_fn()
        for _ in range(n_steps):
            st = self.state
            flips = eng.flip_mask(ecfg, st, self.byz_mask)
            G, honest_G = grads_fn(self.params, st.step, flips)
            self.state, out = eng.protocol_step(ecfg, st, self.byz_mask, G,
                                                honest_G)
            del G, honest_G
            updates, self._opt_state = self.opt.update(
                out.g_hat, self._opt_state, self.params, st.step)
            self.params = apply_updates(self.params, updates)
            self._record(out, log)
        self.validators = _mask_to_list(self.state.validator)
        return self.history

    def _record(self, out, log):
        banned_now = out.banned_now.cpu()
        reasons = out.ban_reason_now.cpu()
        new = [(int(i), eng.BAN_REASON_NAMES[int(reasons[i])])
               for i in torch.nonzero(banned_now).flatten().tolist()]
        self.banned.update(p for p, _ in new)
        # accusation targets (columns of the accuser x target matrix) plus
        # the system (checksum / Delta_max) accusations, as the JAX trainer
        # lists them
        accused = (out.accuse_mat.any(dim=0) | out.sys_accuse).cpu()
        rec = {
            "step": self._step,
            "grad_norm": float(torch.linalg.vector_norm(out.g_hat)),
            "n_banned": len(self.banned),
            "banned_now": new,
            "accused_peers": torch.nonzero(accused).flatten().tolist(),
            "clip_iters_used": int(out.clip_iters_used),
        }
        self.history.append(rec)
        if log:
            log(rec)
        self._step += 1

    def unraveled_params(self):
        return self.boundary.unflatten(self.params)


def _mask_to_list(mask):
    return torch.nonzero(mask > 0).flatten().tolist()
