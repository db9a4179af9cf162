"""BTARD-SGD (paper Alg. 7) and its restarted variant (Alg. 8): the
trainer that simulates n peers on one device and runs the protocol engine
between SGD steps.

Counterpart of ``repro.core.btard_sgd``: per-peer gradients on PUBLIC
minibatch seeds, the protocol between steps, any ``optim`` optimizer
applied to the robust aggregate, and the same history records. Two entry
points, as in the JAX package:

* ``run`` — the host loop (``train_step``): a verifiable defense runs one
  ``engine.protocol_step`` on the active peers' gradients (the JAX package
  wraps the same step in ``BTARDProtocol.step``); a non-verifiable one
  (``mean``, ``krum``, ``geometric_median``, ``centered_clip``, ...) takes
  the trusted-parameter-server baseline step, no bans;
* ``run_scan`` — every defense through ``engine.protocol_step``, with the
  per-peer gradients of all n peers; where the JAX package runs the steps
  under one ``lax.scan``, this is a Python loop.

The trainer is an entry point: it runs on the CUDA device unless
``TrainerConfig.device`` is "cpu".
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch import resolve_device
from repro_torch.core import attacks as attacks_mod
from repro_torch.core import engine as eng
from repro_torch.core import prng
from repro_torch.core.aggregators import (AGGREGATORS, resolve_spec,
                                          with_byzantine_default)
from repro_torch.core.flatten import FlatBoundary, tree_unflatten
from repro_torch.core.norms import vector_norm
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
    # that spec, with krum's n_byzantine defaulting to len(byzantine)
    # (non-verifiable baselines run without accusations or bans)
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
            agg = with_byzantine_default(resolve_spec(cfg.defense),
                                         len(cfg.byzantine))
        agg = resolve_spec(agg)  # validate early
        # verifiable defenses run the accuse/ban protocol in both entry
        # points; only non-verifiable ones take the baseline host step
        self._protocol_defense = cfg.defense == "btard" or agg.verifiable
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
        self.accused_now: list = []  # the host loop's last accusations
        self.validators = _mask_to_list(self.state.validator)
        self.history: list = []
        self._step = 0

    def _grad(self, flat, batch, out=None):
        """Flat f32 gradient of the loss at the flat f32 params (written
        into ``out`` when given)."""
        leaves = [t.detach().requires_grad_(True)
                  for t in self.boundary.unflatten_leaves(flat)]
        params = tree_unflatten(self.boundary.template, leaves)
        loss = self._loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return self.boundary.flatten_leaves(grads, out=out)

    def _grads_fn(self):
        return eng.device_data_grads_fn(
            self.cfg.n_peers, self.batch_fn, self._grad,
            label_flip=self.cfg.attack.kind == "label_flip")

    # ------------------------------------------------------------------
    # The host loop
    # ------------------------------------------------------------------
    def _attack_window(self, t) -> bool:
        a = self.cfg.attack
        return a.start_step <= t < a.end_step

    def _protocol_step(self, t):
        """One BTARD round on the active peers' gradients (banned rows stay
        zero), as the JAX package's ``BTARDProtocol.step``. Returns (g_hat,
        the peers banned this step as (peer, reason) pairs); the step's
        accusation targets and system accusations go to ``accused_now``."""
        ecfg, st = self.engine_config, self.state
        if st.step != t:  # honour the caller's step index
            st = st._replace(step=t)
        flips = eng.flip_mask(ecfg, st, self.byz_mask)
        G = torch.zeros((self.cfg.n_peers, self.d), device=self.device)
        honest_G = G
        if bool(flips.any()):
            honest_G = G.clone()
        for i in range(self.cfg.n_peers):
            if i in self.banned:
                continue
            G[i] = self._grad(self.params, self.batch_fn(i, t, False))
            if bool(flips[i]):
                honest_G[i] = G[i]
                G[i] = self._grad(self.params, self.batch_fn(i, t, True))
            elif honest_G is not G:
                honest_G[i] = G[i]
        self.state, out = eng.protocol_step(ecfg, st, self.byz_mask, G,
                                            honest_G)
        reasons = out.ban_reason_now.cpu()
        new = [(i, eng.BAN_REASON_NAMES[int(reasons[i])])
               for i in torch.nonzero(out.banned_now.cpu()).flatten().tolist()
               if i not in self.banned]
        self.banned.update(p for p, _ in new)
        self.accused_now = _accused(out)
        self.validators = _mask_to_list(self.state.validator)
        return out.g_hat, new

    def _baseline_step(self, t):
        """The trusted-parameter-server defenses: every peer's gradient,
        the attack applied to the Byzantine rows, then the full-vector
        aggregator of ``AGGREGATORS`` (krum with the true Byzantine count,
        the trusted-server centered_clip with ``tau``). Returns (g, None)."""
        cfg, n = self.cfg, self.cfg.n_peers
        byz = self.byz_mask > 0
        a = cfg.attack
        flip = a.kind == "label_flip" and self._attack_window(t)
        G = torch.stack([
            self._grad(self.params,
                       self.batch_fn(i, t, flip and bool(byz[i])))
            for i in range(n)])
        if a.kind not in ("none", "label_flip") and self._attack_window(t):
            if a.kind == "delayed_gradient":
                raise ValueError("delayed_gradient needs the engine's delay "
                                 "buffer: use run_scan")
            G = attacks_mod.apply_attack(
                attacks_mod.attack_index(a.kind), G, byz,
                key=prng.key(t, device=self.device), lam=a.lam)
        fn = AGGREGATORS[cfg.defense]
        if cfg.defense == "krum":
            g = fn(G, n_byzantine=int(byz.sum()))
        elif cfg.defense == "centered_clip":
            g = fn(G, tau=cfg.tau)
        else:
            g = fn(G)
        return g, None

    def train_step(self):
        """One step of the host loop. Returns (g, banned_now or None)."""
        t = self._step
        if self._protocol_defense:
            g, info = self._protocol_step(t)
        else:
            g, info = self._baseline_step(t)
        updates, self._opt_state = self.opt.update(g, self._opt_state,
                                                   self.params, t)
        self.params = apply_updates(self.params, updates)
        self._step += 1
        return g, info

    def run(self, n_steps, eval_fn=None, eval_every=10, log=None):
        """``n_steps`` of the host loop, one history record each:
        step, grad_norm, n_banned, banned_now (protocol defenses) and,
        every ``eval_every`` steps, eval_fn(params tree). A protocol
        step's accusations are in ``accused_now``, as the JAX package's
        record has none."""
        for _ in range(n_steps):
            g, banned_now = self.train_step()
            rec = {
                "step": self._step - 1,
                "grad_norm": float(vector_norm(g)),
                "n_banned": len(self.banned),
            }
            if banned_now is not None:
                rec["banned_now"] = banned_now
            if eval_fn is not None and (self._step - 1) % eval_every == 0:
                rec["eval"] = float(eval_fn(self.unraveled_params()))
            self.history.append(rec)
            if log:
                log(rec)
        return self.history

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
                                                honest_G, donate=True)
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
        rec = {
            "step": self._step,
            "grad_norm": float(vector_norm(out.g_hat)),
            "n_banned": len(self.banned),
            "banned_now": new,
            "accused_peers": _accused(out),
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


def _accused(out):
    """A step's accusation targets (columns of the accuser x target
    matrix) plus its system (checksum / Delta_max) accusations, as the
    JAX trainer lists them."""
    return _mask_to_list(out.accuse_mat.any(dim=0) | out.sys_accuse)


def restarted_btard_sgd(make_trainer, n_restarts: int, steps_fn, lr_fn):
    """Paper Alg. 8: re-launch the trainer with per-restart budgets.
    make_trainer(lr, params0) -> BTARDTrainer (params0 None at the first
    restart); steps_fn(r) / lr_fn(r) give restart r's step count and
    learning rate (eq. (44)-(45): gamma_r ~ 2^{-r/2}, K_r ~ 2^r). Returns
    (final params tree, history with a "restart" key per record)."""
    params = None
    history = []
    for r in range(n_restarts):
        tr = make_trainer(lr_fn(r), params)
        tr.run(steps_fn(r))
        params = tr.unraveled_params()
        history.extend([{**h, "restart": r} for h in tr.history])
    return params, history
