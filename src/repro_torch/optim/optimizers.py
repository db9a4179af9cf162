"""Optimizers (SGD with momentum / Nesterov, Adam, LAMB) and learning-rate
schedules.

Counterpart of ``repro.optim.optimizers``, with the same optax-style
contract: ``opt.init(params) -> state``, ``opt.update(grads, state, params,
step) -> (updates, state)``; updates are ADDED to the params
(``apply_updates``). ``params`` is one tensor (one leaf: the trainer's flat
float32 master parameters) or a list, tuple or dict of tensors (one leaf
each); the state and the updates have the same structure. LAMB's trust
ratio is per leaf, as the JAX package's is per pytree leaf. The schedules,
the learning rate and the bias corrections are float32 scalars, as
``jnp`` makes them; non-float leaves (counters, ids) get no update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.norms import vector_norm


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _f32(x):
    """A float32 scalar tensor (on the CPU unless ``x`` is a tensor)."""
    return torch.as_tensor(x, dtype=torch.float32)


def constant_schedule(lr):
    return lambda step: _f32(lr)


def cosine_schedule(lr, total_steps, final_scale=0.0):
    def fn(step):
        frac = torch.clamp(_f32(step / max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_scale + (1 - final_scale) * cos)

    return fn


def warmup_cosine_schedule(lr, warmup_steps, total_steps, final_scale=0.0):
    cos = cosine_schedule(lr, max(1, total_steps - warmup_steps), final_scale)

    def fn(step):
        warm = _f32(lr * step / max(warmup_steps, 1))
        return torch.where(_f32(step) < warmup_steps, warm,
                           cos(step - warmup_steps))

    return fn


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map_n(fn, n, *trees):
    """``fn`` over the leaves of trees of one structure (a tensor, or
    nested lists, tuples and dicts of them), ``fn`` returning an n-tuple:
    the n trees of its results."""
    head = trees[0]
    if isinstance(head, dict):
        cols = {k: _map_n(fn, n, *(t[k] for t in trees)) for k in head}
        return tuple({k: c[i] for k, c in cols.items()} for i in range(n))
    if isinstance(head, (list, tuple)):
        cols = [_map_n(fn, n, *parts) for parts in zip(*trees)]
        return tuple(type(head)(c[i] for c in cols) for i in range(n))
    return fn(*trees)


def _map(fn, *trees):
    return _map_n(lambda *leaves: (fn(*leaves),), 1, *trees)[0]


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in _leaves(tree)))


def clip_by_global_norm(tree, max_norm):
    """(tree scaled to a global norm of at most ``max_norm``, its norm)."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-30), max=1.0)
    return _map(lambda leaf: (leaf * scale).to(leaf.dtype), tree), g


def _sched(lr):
    return lr if callable(lr) else constant_schedule(lr)


def _zeros(leaf):
    return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)


def _scalar(x, like):
    """A float32 scalar on ``like``'s device (rounded from float64 once,
    as jnp rounds a weakly typed Python float)."""
    return _f32(x).to(like.device)


def sgd(lr, momentum=0.0, nesterov=False, weight_decay=0.0):
    lr = _sched(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": _map(_zeros, params)}

    def update(grads, state, params, step):
        lr_t = lr(step)

        def upd(g, p, m=None):
            if not p.is_floating_point():
                # integer / bool leaves (counters, ids): no decay, no moment
                return _zeros(p), m
            neg_lr = -_scalar(lr_t, g)
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            if m is None:
                return neg_lr * g, None
            m_new = momentum * m + g
            d = g + momentum * m_new if nesterov else m_new
            return neg_lr * d, m_new

        if momentum == 0.0:
            return _map(lambda g, p: upd(g, p)[0], grads, params), state
        ups, m = _map_n(upd, 2, grads, params, state["m"])
        return ups, {"m": m}

    return Optimizer(init, update)


def _moments(g, m, v, b1, b2, t):
    """Adam's moments at step t (from 1) and their bias-corrected values:
    (m_new, v_new, mhat, vhat)."""
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    mhat = m_new / _scalar(1 - b1**t, g)
    vhat = v_new / _scalar(1 - b2**t, g)
    return m_new, v_new, mhat, vhat


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    lr = _sched(lr)

    def init(params):
        return {"m": _map(_zeros, params), "v": _map(_zeros, params)}

    def update(grads, state, params, step):
        lr_t = lr(step)
        t = int(step) + 1

        def upd(g, p, m, v):
            if not p.is_floating_point():
                return _zeros(p), m, v
            g = g.to(torch.float32)
            m_new, v_new, mhat, vhat = _moments(g, m, v, b1, b2, t)
            d = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                d = d + weight_decay * p.to(torch.float32)
            return -_scalar(lr_t, g) * d, m_new, v_new

        ups, m, v = _map_n(upd, 3, grads, params, state["m"], state["v"])
        return ups, {"m": m, "v": v}

    return Optimizer(init, update)


def lamb(lr, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01):
    """LAMB (You et al. 2020), the paper's ALBERT optimizer (§4.2): Adam's
    direction plus decay, scaled per leaf by ||p|| / ||u||."""
    lr = _sched(lr)

    def init(params):
        return {"m": _map(_zeros, params), "v": _map(_zeros, params)}

    def update(grads, state, params, step):
        lr_t = lr(step)
        t = int(step) + 1

        def upd(g, p, m, v):
            if not p.is_floating_point():
                return _zeros(p), m, v
            g = g.to(torch.float32)
            pf = p.to(torch.float32)
            m_new, v_new, mhat, vhat = _moments(g, m, v, b1, b2, t)
            u = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
            w_norm = vector_norm(pf.reshape(-1))
            u_norm = vector_norm(u.reshape(-1))
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / torch.clamp(u_norm, min=1e-30),
                                torch.ones_like(w_norm))
            return -_scalar(lr_t, g) * trust * u, m_new, v_new

        ups, m, v = _map_n(upd, 3, grads, params, state["m"], state["v"])
        return ups, {"m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    # non-float leaves pass through untouched: an int32 counter round-tripped
    # through f32 would lose bits above 2**24 even with a zero update
    return _map(lambda p, u: ((p.to(torch.float32) + u).to(p.dtype)
                              if p.is_floating_point() else p), params, updates)
