"""Real-model BTARD workloads: a zoo LM behind the trainer API.

Counterpart of ``repro.models.workload``. ``lm_setup(arch)`` packages a
model as the ``(loss_fn, params0, batch_fn, model)`` quadruple that
``BTARDTrainer`` consumes: per-peer batches from the public-seed
``TokenPipeline``, parameters from ``Model.init_params``. It is an entry
point: it runs on the CUDA device unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import _ARCH_MODULES, get_config, reduce_config
from repro_torch.core import prng
from repro_torch.data import TokenPipeline
from repro_torch.models.model import Model


def _normalize_arch(arch: str) -> str:
    """Accept CLI spellings like ``albert_large`` for ``albert-large``."""
    if arch in _ARCH_MODULES:
        return arch
    alt = arch.replace("_", "-")
    if alt in _ARCH_MODULES:
        return alt
    raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_ARCH_MODULES)}")


def lm_model(arch: str, *, reduced: bool = True, dtype: str | None = None):
    cfg = get_config(_normalize_arch(arch))
    if reduced:
        cfg = reduce_config(cfg)
    if dtype is not None and cfg.dtype != dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return Model(cfg)


def lm_setup(arch: str, *, seq_len: int = 32, batch_size: int = 2,
             reduced: bool = True, dtype: str | None = None,
             global_seed: int = 0, init_seed: int = 0, device=None):
    """(loss_fn, params0, batch_fn, model) for a zoo LM under BTARD.

    batch_fn(peer, step, flipped): the public-seed tokens of xi_peer^step;
    ``flipped`` (the label-flip attack) reverses the token stream.
    """
    device = resolve_device(device)
    model = lm_model(arch, reduced=reduced, dtype=dtype)
    pipe = TokenPipeline(model.cfg.vocab_size, seq_len, batch_size,
                         global_seed=global_seed, device=device)

    def loss_fn(params, batch):
        return model.loss_fn(params, batch)[0]

    def batch_fn(peer, step, flipped):
        batch = pipe.device_batch(step, peer)
        if flipped:
            batch = dict(batch, tokens=torch.flip(batch["tokens"], dims=[1]))
        return batch

    params0 = model.init_params(prng.key(init_seed, device=device))
    return loss_fn, params0, batch_fn, model
