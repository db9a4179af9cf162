"""Deterministic public-seed data pipeline.

Counterpart of ``repro.data.pipeline``'s ``peer_seed``, ``peer_key``,
``TokenPipeline.device_batch`` / ``batch`` (with the modality extras, the
stub frames or patches of the encoder models) and
``classification_batch``.
BTARD needs PUBLIC data: every peer's minibatch for step t is a pure
function of a public seed, so a validator recomputes anyone's gradient bit
for bit. The batches come from the port's threefry generator
(``core.prng``) along the JAX package's key chains, so the integer tokens
and labels equal the JAX pipeline's for the same seeds, and the gaussian
features and extras its float32 values.
"""
from __future__ import annotations

import zlib

import torch

from repro_torch.core import prng


def peer_seed(global_seed: int, step: int, peer: int) -> int:
    """xi_i^t as a host int, for the int-seeded ``classification_batch``."""
    return (global_seed * 1_000_003 + step * 4099 + peer) % (2**31 - 1)


def classification_batch(seed: int, batch: int, dim: int, n_classes: int,
                         flip_labels: bool = False, margin: float = 2.0,
                         device="cpu"):
    """Gaussian mixture with fixed class means (deterministic in seed):
    {"x": (batch, dim) f32, "y": (batch,) int64}. ``flip_labels`` is the
    paper's LABEL FLIPPING attack (l -> K-1-l)."""
    means = prng.normal(prng.key(12345, device=device),
                        (n_classes, dim)) * margin  # the fixed task
    k1, k2 = prng.split(prng.key(seed, device=device))
    y = prng.randint(k1, (batch,), 0, n_classes)
    x = means[y] + prng.normal(k2, (batch, dim))
    if flip_labels:
        y = n_classes - 1 - y
    return {"x": x, "y": y}


def peer_key(global_seed, step, peer, device=None):
    """xi_i^t as a key: fold_in(fold_in(key(seed), step), peer)."""
    key = (global_seed if isinstance(global_seed, torch.Tensor)
           else prng.key(global_seed, device=device))
    return prng.fold_in(prng.fold_in(key, step), peer)


def _stable_tag(name: str) -> int:
    """The key tag of an extras stream: a crc32 of its name, the same in
    every process (``hash()`` is salted per interpreter; public-seed data
    must not be)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


class TokenPipeline:
    """Synthetic LM stream: x_{t+1} = (a*x_t + c) mod V with prob (1-noise),
    else uniform. The keys and the tokens live on ``device``."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 a: int = 5, c: int = 7, noise: float = 0.2,
                 global_seed: int = 0, device="cpu"):
        self.V = int(vocab_size)
        self.S = seq_len
        self.B = batch_size
        a, c = int(a) % self.V, int(c) % self.V
        if a * (self.V - 1) + c >= 2**31:
            raise ValueError(
                f"affine token map a*x+c overflows int32 for a={a}, c={c}, "
                f"vocab={self.V}: max transition {a * (self.V - 1) + c} >= 2^31")
        self.a, self.c, self.noise = a, c, noise
        self.global_seed = global_seed
        self.device = torch.device(device)

    def _gen(self, key, batch):
        k0, k1, k2 = prng.split(key, 3)
        x = prng.randint(k0, (batch,), 0, self.V)
        noise_mask = prng.bernoulli(k1, self.noise, (batch, self.S))
        rand_tok = prng.randint(k2, (batch, self.S), 0, self.V)
        toks = [x]
        for s in range(self.S):
            x = torch.where(noise_mask[:, s], rand_tok[:, s],
                            (self.a * x + self.c) % self.V)
            toks.append(x)
        return torch.stack(toks, dim=1)  # (B, S+1)

    def device_batch(self, step, peer=0, *, batch_size=None, extras=None):
        """The batch of (step, peer): {"tokens": (B, S+1) int32}, plus one
        entry per ``extras`` item (name -> (shape tail, torch dtype)): 0.02
        times normals of shape (B,) + tail from the key folded with the
        name's tag, in that dtype (the encoder models' ``memory_raw``)."""
        b = batch_size or self.B
        key = peer_key(self.global_seed, step, peer, device=self.device)
        out = {"tokens": self._gen(key, b).to(torch.int32)}
        for name, (tail, dt) in (extras or {}).items():
            noise = prng.normal(prng.fold_in(key, _stable_tag(name)),
                                (b,) + tuple(tail))
            out[name] = (noise * 0.02).to(dt)
        return out

    def batch(self, step: int, peer: int = 0, *, batch_size=None,
              extras=None):
        """Host-loop entry point: the same bits as ``device_batch`` (it IS
        ``device_batch``, with concrete step and peer), generated on the
        pipeline's device."""
        return self.device_batch(step, peer, batch_size=batch_size,
                                 extras=extras)
