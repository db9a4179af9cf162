"""The verifiable aggregation contract of the engine's aggregation phase.

Counterpart of ``repro.core.verification`` for the ``butterfly_clip``
flagship: ``spec_aggregate`` (aggregation with or without the Alg. 6
tables), ``spec_tables`` (tables against a given aggregate) and
``has_zero_checksum``. The ``verified:*`` digest wrappers and the
``compressed:*`` wire codecs wait for ROADMAP queue 1, items 8 and 9.
"""
from __future__ import annotations

from repro_torch.core import aggregators as agg_mod
from repro_torch.core import butterfly as bf


def _flagship_only(spec):
    if spec.name != "butterfly_clip":
        raise NotImplementedError(
            f"aggregator {spec.name!r}: only butterfly_clip is verifiable in "
            "repro_torch so far (verified:* is ROADMAP queue 1 item 8, "
            "compressed:* item 9)")


def has_zero_checksum(spec) -> bool:
    """Whether Verification 2's identity sum_i w_i s_i^j ~ 0 holds: true
    when the digest combines linearly into the aggregate — the CenteredClip
    fixed point here (and verified:mean, once item 8 ports it)."""
    return agg_mod.resolve_spec(spec).name == "butterfly_clip"


def spec_tables(spec, grads, agg, z):
    """The spec's broadcast tables against a GIVEN aggregate (e.g. a
    corrupted aggregator's value). Returns (s, norms), both (n, n_parts)."""
    spec = agg_mod.resolve_spec(spec)
    _flagship_only(spec)
    return bf.verification_tables(grads, agg, z, spec.get("tau", 1.0))


def spec_aggregate(spec, grads, z=None, weights=None, v0=None):
    """Aggregate ``grads (n, d)`` by a verifiable spec in the butterfly
    layout, with (``z`` given) or without the tables.

    Returns (agg (n_parts, part), s, norms, iters); s/norms are None when
    z is None."""
    spec = agg_mod.resolve_spec(spec)
    _flagship_only(spec)
    p = spec.param_dict()
    if not p.get("warm_start"):
        v0 = None
    return bf.clip_aggregate(grads, p["tau"], p["n_iters"], z=z,
                             adaptive_tol=p["adaptive_tol"], weights=weights,
                             v0=v0)
