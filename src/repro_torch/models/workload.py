"""BTARD workloads behind the trainer API.

Counterpart of ``repro.models.workload`` and of the JAX package's toy
``classification_setup`` (``benchmarks/common.py``, which imports jax, so
the port keeps its own copy here). ``lm_setup(arch)`` packages a zoo LM
(``model_setup(model)`` any ``Model``) as the ``(loss_fn, params0,
batch_fn, model)`` quadruple that ``BTARDTrainer`` consumes: per-peer
batches from the public-seed ``TokenPipeline``, parameters from
``Model.init_params``.
``classification_setup()`` is the paper's §4.1 controlled workload, a
linear softmax classifier on a gaussian mixture. Both are entry points:
they run on the CUDA device unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import _ARCH_MODULES, get_config, reduce_config
from repro_torch.core import prng
from repro_torch.data import TokenPipeline, classification_batch, peer_seed
from repro_torch.models.model import Model

DIM, CLASSES = 16, 4  # the toy classifier's default width


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
    return model_setup(lm_model(arch, reduced=reduced, dtype=dtype),
                       seq_len=seq_len, batch_size=batch_size,
                       global_seed=global_seed, init_seed=init_seed,
                       device=device)


def model_setup(model, *, seq_len: int = 32, batch_size: int = 2,
                global_seed: int = 0, init_seed: int = 0, device=None):
    """``lm_setup`` for a ``Model`` of any configuration (say, a zoo
    config with its depth cut)."""
    device = resolve_device(device)
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


def classification_setup(dim=DIM, classes=CLASSES, device=None):
    """The controlled §4.1 workload: (loss_fn, params0, batch_fn,
    accuracy). ``dim`` scales the gradient dimension; the class-mean
    margin shrinks with sqrt(DIM / dim) so the difficulty stays the same
    (at high dims the classes would separate so fast that the softmax
    saturates to zero gradients before the attack window opens). Each
    peer's batch is 16 samples of ``classification_batch`` at
    ``peer_seed(0, step, peer)``; ``accuracy(params)`` scores a fixed
    1024-sample eval batch (seed 10**7)."""
    device = resolve_device(device)
    margin = 2.0 * (DIM / dim) ** 0.5

    def batch_fn(peer, step, flipped):
        return classification_batch(peer_seed(0, step, peer), 16, dim,
                                    classes, flip_labels=flipped,
                                    margin=margin, device=device)

    def loss_fn(params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        logp = torch.log_softmax(logits, dim=1)
        return -torch.mean(torch.take_along_dim(logp, batch["y"][:, None],
                                                dim=1))

    params0 = {"w": torch.zeros((dim, classes), device=device),
               "b": torch.zeros((classes,), device=device)}
    eval_batch = classification_batch(10**7, 1024, dim, classes,
                                      margin=margin, device=device)

    def accuracy(params):
        logits = eval_batch["x"] @ params["w"] + params["b"]
        hits = torch.argmax(logits, dim=1) == eval_batch["y"]
        return float(hits.to(torch.float32).mean())

    return loss_fn, params0, batch_fn, accuracy
