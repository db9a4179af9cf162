"""SGD with momentum / Nesterov over the flat float32 parameter vector.

Counterpart of ``repro.optim.optimizers.sgd`` and ``apply_updates``, with
the same optax-style contract: ``opt.init(params) -> state``,
``opt.update(grads, state, params, step) -> (updates, state)``; updates are
ADDED to the params. The trainer keeps its master parameters as one flat
f32 tensor, so the state is a dict of tensors of the same shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def constant_schedule(lr):
    return lambda step: lr


def sgd(lr, momentum=0.0, nesterov=False):
    lr = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": torch.zeros(params.shape, dtype=torch.float32,
                                 device=params.device)}

    def update(grads, state, params, step):
        # the learning rate is a float32 scalar, as jnp.asarray(lr, f32)
        neg_lr = -torch.tensor(lr(step), dtype=torch.float32,
                               device=grads.device)
        g = grads.to(torch.float32)
        if momentum == 0.0:
            return neg_lr * g, state
        m = momentum * state["m"] + g
        d = g + momentum * m if nesterov else m
        return neg_lr * d, {"m": m}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return (params.to(torch.float32) + updates).to(params.dtype)
