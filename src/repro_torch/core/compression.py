"""Wire compression of the butterfly payloads, with exact verification
(the ``compressed:<verifiable>`` AggregatorSpec wrappers).

Counterpart of ``repro.core.compression``. Each (peer, partition) payload
travels quantized:

* ``codec=int8``: one f32 sidecar scale ``max|x| / 127`` per payload,
  wire value ``clip(round(x / scale), -127, 127)`` as int8 (round half to
  even, as ``jnp.round``);
* ``codec=bf16``: a cast to bfloat16, scale 1.

Every Alg. 6 quantity (the aggregate, the digests, the V2 checksum) is
computed over the dequantized wire values ``f32(q) * scale``, never the raw
gradients, so owner, sender and validator recompute the same bits and an
honest peer can never be accused over rounding. The wire bits equal the
JAX package's: the formulas are exact f32 operations (IEEE division,
round half to even, one multiply).

On a CUDA tensor ``compressed:butterfly_clip`` (fixed budget) and
``compressed:verified:mean`` with tables read the int8/bf16 payloads
straight from device memory through the dequantizing kernels
(``kernels.ops.butterfly_clip_fused_dequant_op``,
``mean_digest_fused_dequant_op``); every other inner spec materializes the
f32 wire values once and delegates to ``core.verification``.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregators as agg_mod
from repro_torch.core import butterfly as bf
from repro_torch.kernels import ops

PREFIX = "compressed:"
DEFAULT_CODEC = "int8"
CODECS = ("int8", "bf16")
CODEC_BYTES = {"int8": 1, "bf16": 2}  # wire bytes per coordinate (f32: 4)


def _check_codec(codec: str) -> str:
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r} (supported: "
                         f"{', '.join(CODECS)})")
    return codec


# ---------------------------------------------------------------------------
# The codecs, over the LAST axis
# ---------------------------------------------------------------------------
def quantize(x, codec: str):
    """``x`` (..., part) -> (wire, scales (...)): one f32 scale per
    payload (1 for bf16). All-zero payloads get scale 0 and wire 0."""
    _check_codec(codec)
    x = x.to(torch.float32)
    if codec == "bf16":
        return (x.to(torch.bfloat16),
                torch.ones(x.shape[:-1], dtype=torch.float32,
                           device=x.device))
    scale = x.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize(wire, scales):
    """Wire bits -> the f32 values every digest is computed over: upcast,
    then one f32 multiply by the payload's scale."""
    return wire.to(torch.float32) * scales.to(torch.float32)[..., None]


def roundtrip(x, codec: str):
    """quantize then dequantize: the wire projection of ``x``."""
    return dequantize(*quantize(x, codec))


def quantize_grads(grads, codec: str, n_parts: int):
    """The butterfly payloads of ``grads (n, d)`` on the wire: peer i's
    slice of partition j is one payload with its own scale (the zero
    padding of the ragged last partition never raises its amax).
    Returns (q (n, d) int8/bf16, a view with the padded row stride,
    scales (n_parts, n) f32), the dequantizing kernels' input."""
    n, d = grads.shape
    q, scales = quantize(bf.split_parts(grads, n_parts), codec)
    return q.reshape(n, -1)[:, :d], scales.T


def wire_grads(grads, codec: str, n_parts: int):
    """``grads (n, d)`` projected through the per-(peer, partition) codec:
    what the commitment compares and the generic aggregation path
    consume, (n, d) f32."""
    n, d = grads.shape
    wire = roundtrip(bf.split_parts(grads, n_parts), codec)
    return wire.reshape(n, -1)[:, :d]


# ---------------------------------------------------------------------------
# Spec naming: compressed:<verifiable> wrappers
# ---------------------------------------------------------------------------
def is_wrapped(spec_or_name) -> bool:
    """True for ``compressed:<spec>`` specs/names."""
    name = (spec_or_name if isinstance(spec_or_name, str)
            else agg_mod.resolve_spec(spec_or_name).name)
    return name.startswith(PREFIX)


def inner_spec(spec) -> agg_mod.AggregatorSpec:
    """The wrapped verifiable spec (same params, ``codec`` stripped)."""
    spec = agg_mod.resolve_spec(spec)
    if not is_wrapped(spec):
        raise ValueError(f"not a {PREFIX}* wrapped spec: {spec.name!r}")
    params = tuple((k, v) for k, v in spec.params if k != "codec")
    return agg_mod.AggregatorSpec(spec.name[len(PREFIX):], params)


def codec_of(spec) -> str:
    return _check_codec(agg_mod.resolve_spec(spec).get("codec",
                                                       DEFAULT_CODEC))


def compressed(spec, codec: str | None = None) -> agg_mod.AggregatorSpec:
    """Wire-compress a verifiable spec's payloads: compressed specs come
    back unchanged (codec overridden when given); verifiable specs map to
    ``compressed:<name>`` with the same params plus ``codec``;
    non-verifiable coordinatewise specs are lifted through ``verified:``
    first; full-vector specs raise."""
    if codec is not None:
        _check_codec(codec)
    spec = agg_mod.resolve_spec(spec)
    if is_wrapped(spec):
        return spec if codec is None else spec.override(codec=codec)
    if not spec.verifiable:
        from repro_torch.core import verification

        spec = verification.verified(spec)
    params = dict(spec.params)
    if codec is not None:
        params["codec"] = codec
    wrapped = agg_mod.AggregatorSpec(PREFIX + spec.name,
                                     tuple(sorted(params.items())))
    wrapped.definition  # eager validation
    return wrapped


def parse_spec_text(text: str) -> agg_mod.AggregatorSpec:
    """Parse the tail of ``compressed:INNER[:k=v,...]``. The last segment
    is a param list iff it contains ``=``; ``codec`` binds to the wrapper
    and every other param to the inner spec, so
    ``compressed:verified:mean:codec=bf16`` and
    ``compressed:butterfly_clip:n_iters=20,codec=bf16`` both parse."""
    head, sep, tail = text.strip().rpartition(":")
    if not (sep and "=" in tail):
        return compressed(agg_mod.AggregatorSpec.parse(text))
    params = {}
    for item in tail.split(","):
        k, s2, v = item.partition("=")
        if not s2:
            raise ValueError(f"bad aggregator param {item!r} in "
                             f"{PREFIX}{text!r} (expected k=v)")
        params[k.strip()] = agg_mod._coerce(v.strip())
    codec = params.pop("codec", None)
    inner = agg_mod.AggregatorSpec.parse(head)
    if params:
        inner = inner.override(**params)
    return compressed(inner, codec=codec)


# ---------------------------------------------------------------------------
# The verifiable aggregation contract over wire values
# ---------------------------------------------------------------------------
def compressed_aggregate(spec, grads, z=None, weights=None, v0=None):
    """``verification.spec_aggregate`` for a compressed spec: quantize the
    butterfly payloads, then the inner spec's aggregation and tables over
    the dequantized wire values. Returns (agg, s, norms, iters)."""
    from repro_torch.core import verification

    spec = agg_mod.resolve_spec(spec)
    inner = inner_spec(spec)
    codec = codec_of(spec)
    n = grads.shape[0]
    if z is not None:
        if inner.name == "butterfly_clip" and inner.get("adaptive_tol") is None:
            p = inner.param_dict()
            q, scales = quantize_grads(grads, codec, n)
            agg, s, norms = ops.butterfly_clip_fused_dequant_op(
                q, scales, n, p["tau"], z, weights,
                v0=v0 if p["warm_start"] else None, n_iters=p["n_iters"])
            return agg, s, norms, p["n_iters"]
        if (verification.is_wrapped(inner)
                and verification.base_spec(inner).name == "mean"):
            q, scales = quantize_grads(grads, codec, n)
            agg, s, norms = ops.mean_digest_fused_dequant_op(q, scales, n, z,
                                                             weights)
            return agg, s, norms, 1
    return verification.spec_aggregate(inner, wire_grads(grads, codec, n),
                                       z=z, weights=weights, v0=v0)


# ---------------------------------------------------------------------------
# Registration: one compressed:<name> wrapper per verifiable spec
# ---------------------------------------------------------------------------
def _make_compressed(base_def: agg_mod.AggregatorDef):
    def make(n, d, codec=DEFAULT_CODEC, **params):
        _check_codec(codec)
        base_fn = base_def.make(n, d, **params)

        def fn(xs, weights=None, v0=None, key=None):
            return base_fn(wire_grads(xs, codec, n), weights, v0, key)

        return fn

    return make


def register_compressed_wrappers():
    """Register ``compressed:<name>`` for every verifiable spec: the inner
    spec's params plus ``codec``, its flags, except ``coordinatewise``
    (a payload's scale is a max over the whole partition, so a coordinate
    slice does not quantize as the full vector does). Idempotent."""
    for name, base_def in list(agg_mod.REGISTRY.items()):
        if name.startswith(PREFIX) or not base_def.verifiable:
            continue
        if PREFIX + name in agg_mod.REGISTRY:
            continue
        agg_mod.register(agg_mod.AggregatorDef(
            PREFIX + name, _make_compressed(base_def),
            defaults=base_def.defaults + (("codec", DEFAULT_CODEC),),
            verifiable=True, weighted=base_def.weighted,
            warm_startable=base_def.warm_startable, coordinatewise=False))


register_compressed_wrappers()
