"""Threefry-2x32 counter PRNG with ``jax.random``'s bits, in torch.

The protocol's public randomness (the MPRNG seed, the unit directions z,
validator election and audit targets, the per-peer token batches) must be
the SAME numbers in this package and in the JAX reference, or ban sets and
ban steps stop being comparable across steps. So this module reimplements
the parts of ``jax.random`` the slice uses, following jax's own algorithms
in the partitionable threefry mode (``jax_threefry_partitionable=True``):

* a key is an int64 tensor of shape (2,) holding two uint32 words, on the
  caller's device (torch has no uint32 arithmetic, so every word lives in
  int64 and is masked back to 32 bits after each add and shift);
* ``bits``, ``fold_in``, ``split``, ``uniform``, ``randint`` and
  ``bernoulli`` equal jax's bit for bit;
* ``normal`` maps uniforms through XLA's single-precision ``erf_inv``
  polynomial (Giles 2010), so it matches jax to float32 rounding (the
  log1p inside may differ by an ulp between libraries).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors of uint32 words. Returns (y1, y2). On the
    meta device (shapes only: ``Model.param_count``) the rounds are
    skipped, as ``normal`` skips its draw there."""
    if x1.device.type == "meta":
        shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape,
                                       x2.shape)
        return (torch.empty(shape, dtype=torch.int64, device="meta"),
                torch.empty(shape, dtype=torch.int64, device="meta"))
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(1, 6):
        for r in _ROT[(i - 1) % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[i % 3]) & _M32
        x2 = (x2 + ks[(i + 1) % 3] + i) & _M32
    return x1, x2


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` / ``PRNGKey(seed)``: the words (0, seed mod
    2^32). ``seed`` may be a Python int or an integer tensor (e.g. the
    MPRNG seed, which stays on its device)."""
    if isinstance(seed, torch.Tensor):
        lo = seed.to(torch.int64).reshape(()) & _M32
        return torch.stack([torch.zeros_like(lo), lo])
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


PRNGKey = key


def _counts(n: int, device, offset: int = 0):
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the 32-bit ``data`` into the key."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=k.device, dtype=torch.int64).reshape(()) & _M32
    else:
        d = torch.tensor(int(data) & _M32, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([y1, y2])


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like partitionable form): (num, 2)."""
    hi, lo = _counts(num, k.device)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([y1, y2], dim=1)


def bits(k: torch.Tensor, shape=(), offset: int = 0) -> torch.Tensor:
    """32 random bits per element (uint32 values in an int64 tensor).
    ``offset`` starts the element counter there: the draw of a larger
    array whose flat elements [offset, offset + prod(shape)) these are, so
    a large array can be drawn in row blocks with the same bits."""
    shape = tuple(shape)
    hi, lo = _counts(math.prod(shape), k.device, offset)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return (y1 ^ y2).reshape(shape)


def uniform(k: torch.Tensor, shape=(), minval=0.0, maxval=1.0,
            offset: int = 0):
    """``jax.random.uniform`` in float32: 23 random mantissa bits in [1, 2)
    shifted to [0, 1), then scaled to [minval, maxval). ``offset`` as in
    :func:`bits`."""
    b = (bits(k, shape, offset) >> 9) | 0x3F800000
    floats = b.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _mulmod32(a, b):
    """(a * b) mod 2^32 for uint32 words held in int64, without overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(k: torch.Tensor, shape, minval: int, maxval: int):
    """``jax.random.randint`` for int32 output: two 32-bit draws combined
    as ``(hi mod span) * (2^32 mod span) + lo mod span`` in wrapping uint32
    arithmetic, exactly jax's bias-reduced construction. Returns int64."""
    shape = tuple(shape)
    i32 = np.iinfo(np.int32)
    out_of_range = maxval > i32.max
    minval = min(max(int(minval), i32.min), i32.max)
    maxval = min(max(int(maxval), i32.min), i32.max)
    k1, k2 = split(k)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & _M32
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    if span == 0:  # full 2^32 range: the remainders are no-ops
        offset = lower
    else:
        mult = (2**16) % span
        mult = ((mult * mult) & _M32) % span
        offset = (_mulmod32(higher % span, torch.full_like(higher, mult))
                  + lower % span) & _M32
        offset = offset % span
    # int32 wrap of minval + offset, as jax adds in the output dtype
    val = (minval + offset) & _M32
    return torch.where(val >= 2**31, val - 2**32, val)


def bernoulli(k: torch.Tensor, p: float, shape=()):
    """``jax.random.bernoulli`` (mode 'low'): uniform < p in float32."""
    u = uniform(k, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=k.device)


# XLA's ErfInv for float32 (Giles, "Approximating the erfinv function").
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _sqrt_rounded(w: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of ``w`` (>= 1), whatever path
    ``torch.sqrt`` takes: two Newton steps in float64 make any start within
    1e-4 exact before the one rounding to float32. (On the CPU, torch's
    float32 sqrt is off by an ulp for some inputs and, now and then on the
    first call in a process, by ~1e-4; erfinv's tail magnifies either.)"""
    w64 = w.double()
    y = torch.sqrt(w64)
    y = 0.5 * (y + w64 / y)
    y = 0.5 * (y + w64 / y)
    return y.to(w.dtype)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial form."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    # the sqrt branch is only taken where w >= 5; clamp the others
    w = torch.where(lt, w - 2.5,
                    _sqrt_rounded(torch.clamp(w, min=1.0)) - 3.0)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0], dtype=x.dtype,
                                     device=x.device),
                    torch.tensor(_ERFINV_GE5[0], dtype=x.dtype,
                                 device=x.device))
    w64 = w.double()
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.tensor(c_lt, dtype=x.dtype, device=x.device),
                        torch.tensor(c_ge, dtype=x.dtype, device=x.device))
        # one rounding per Horner step, as XLA's fused multiply-add gives
        p = (c.double() + p.double() * w64).to(x.dtype)
    big = torch.finfo(x.dtype).max
    return torch.where(x.abs() == 1.0, x * big, p * x)


# The most elements one eager draw of ``normal`` takes at once: its int64
# and float64 temporaries cost 8 bytes an element each (a 1.72e9-element z
# would hold several of 13.8 GB), so a larger array is drawn in blocks of
# this many flat elements, through ``offset``: the same bits. 2^25 keeps
# a block's temporaries near 6 GB together (larger blocks fragment the
# card's cache beside a Qwen3-1.7B stack) and draws a launch owner's z at
# ALBERT-large's width (19.6e6) in one piece.
NORMAL_BLOCK = 1 << 25


def normal(k: torch.Tensor, shape=(), offset: int = 0) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(U(-1, 1)).
    ``offset`` as in :func:`bits`. Above ``NORMAL_BLOCK`` elements the
    draw goes in blocks of flat elements written into the float32 result,
    the bits of one draw."""
    shape = tuple(shape)
    if k.device.type == "meta":  # shapes only (``Model.param_count``)
        return torch.empty(shape, dtype=torch.float32, device="meta")
    size = math.prod(shape)
    if size <= NORMAL_BLOCK:
        return _normal(k, shape, offset)
    out = torch.empty((size,), dtype=torch.float32, device=k.device)
    for start in range(0, size, NORMAL_BLOCK):
        m = min(NORMAL_BLOCK, size - start)
        out[start:start + m] = _normal(k, (m,), offset + start)
    return out.reshape(shape)


def _normal(k, shape, offset):
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0, offset)
    return torch.tensor(np.sqrt(2), dtype=torch.float32,
                        device=k.device) * erfinv(u)
