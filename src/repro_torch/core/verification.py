"""The verifiable aggregation contract of the engine's aggregation phase,
and the ``verified:<base>`` wrappers that make the coordinatewise
baselines bannable.

Counterpart of ``repro.core.verification``. For ``butterfly_clip`` the
broadcast tables are the tau-clipped CenteredClip residuals; a
``verified:<base>`` spec (mean, trimmed_mean, coordinate_median) reports
the recomputable per-peer contribution digests instead

    s[i, j]    = <z_j, x_i^j - v_j>,      norm[i, j] = ||x_i^j - v_j||

(no tau), where x_i^j is peer i's slice of partition j and v_j the
partition's aggregate. Verification 2's zero checksum holds only where the
digest combines linearly into the aggregate (the CenteredClip fixed point
and the weighted mean, :func:`has_zero_checksum`); for the nonlinear bases
a lying aggregator is caught by the validators' partition recompute.

On a CUDA tensor ``verified:mean`` with tables runs the fused mean+digest
kernel (``kernels.ops.mean_digest_fused_op``); the other bases aggregate in
torch (sorts) and then run the one-pass digest kernel
(``kernels.ops.digest_tables_all_op``). ``compressed:*`` specs go to
``core.compression``, which runs the inner spec over the wire values. The
sampled-digest audits' tables (``digest_tables_rows``) run the rows kernel
(``kernels.ops.digest_tables_rows_op``) over the k sampled partitions.
On the launch path each partition owner aggregates its own received stack
(:func:`owner_aggregate`): the same kernels at one partition.
"""
from __future__ import annotations

from repro_torch.core import aggregators as agg_mod
from repro_torch.core import butterfly as bf
from repro_torch.kernels import ops

PREFIX = "verified:"


def is_wrapped(spec_or_name) -> bool:
    """True for ``verified:<base>`` specs/names."""
    name = (spec_or_name if isinstance(spec_or_name, str)
            else agg_mod.resolve_spec(spec_or_name).name)
    return name.startswith(PREFIX)


def base_spec(spec) -> agg_mod.AggregatorSpec:
    """The coordinatewise spec under a wrapped one (same params)."""
    spec = agg_mod.resolve_spec(spec)
    if not is_wrapped(spec):
        raise ValueError(f"not a {PREFIX}* wrapped spec: {spec.name!r}")
    return agg_mod.AggregatorSpec(spec.name[len(PREFIX):], spec.params)


def verified(spec) -> agg_mod.AggregatorSpec:
    """Lift a spec into its verifiable form: verifiable specs come back
    unchanged, coordinatewise ones map to ``verified:<name>`` with the same
    params, and full-vector ones raise."""
    spec = agg_mod.resolve_spec(spec)
    if spec.verifiable:
        return spec
    if not spec.coordinatewise:
        raise ValueError(
            f"aggregator {spec.name!r} is not coordinatewise: its partition "
            "contributions are not independently recomputable, so the "
            "verified: digest wrapper does not apply")
    wrapped = agg_mod.AggregatorSpec(PREFIX + spec.name, spec.params)
    wrapped.definition  # eager validation
    return wrapped


def has_zero_checksum(spec) -> bool:
    """Whether Verification 2's identity sum_i w_i s_i^j ~ 0 holds: the
    digest combines linearly into the aggregate — the CenteredClip fixed
    point and the weighted mean. ``compressed:*`` answers for its inner
    spec (the identity runs over the wire values)."""
    spec = agg_mod.resolve_spec(spec)
    if spec.name.startswith("compressed:"):
        from repro_torch.core import compression

        spec = compression.inner_spec(spec)
    return spec.name in ("butterfly_clip", PREFIX + "mean")


def digest_tables(grads, agg, z):
    """The contribution digests of every partition against ``agg``
    (n_parts, part): s[i, j] = <z_j, x_i^j - v_j>, norm[i, j] =
    ||x_i^j - v_j||. Returns (s, norms), both (n, n_parts)."""
    return ops.digest_tables_all_op(grads, grads.shape[0], agg, z)


def digest_tables_rows(spec, grads, agg, z, rows):
    """The sampled-column tables of the sampled-digest audit mode
    (``core.hierarchy``): (s, norm) of only the partitions ``rows`` (k,)
    against ``agg`` (n_parts, part), in one pass of those k partitions.
    butterfly_clip applies its tau clip weight, verified:* takes the plain
    digest, compressed:* answers for its inner spec (``grads`` must already
    be the wire values). Returns (s, norms), both (n, k); column j is
    partition rows[j]."""
    spec = agg_mod.resolve_spec(spec)
    if spec.name.startswith("compressed:"):
        from repro_torch.core import compression

        return digest_tables_rows(compression.inner_spec(spec), grads, agg,
                                  z, rows)
    if spec.name == "butterfly_clip":
        tau = float(spec.get("tau", 1.0))
    elif is_wrapped(spec):
        tau = 0.0
    else:
        raise ValueError(f"aggregator {spec.name!r} is not verifiable — it "
                         "has no digest tables to sample")
    return ops.digest_tables_rows_op(grads, grads.shape[0], agg, z, rows,
                                     tau)


def owner_aggregate(spec, stack, z, weights=None, key=None, wire=None):
    """ONE partition owner's work on the launch path: aggregate the
    all_to_all'd (n, part) stack with the BASE fn and digest against the
    result, the single-partition sibling of :func:`spec_aggregate`.

    ``verified:mean`` runs the fused mean+digest kernel (#5) at one
    partition, or with ``wire = (qs (n, part) int8/bf16, scales (n,) f32)``
    (the received compressed payloads) its dequantizing twin (#8); the
    other bases aggregate in torch and run the digest kernel (#6) at one
    partition. For compressed:* specs ``stack`` must already be the
    dequantized wire values. ``key`` is handed to the base fn (the ported
    bases draw nothing). Returns (agg (part,), s (n,), norms (n,), iters).
    """
    spec = agg_mod.resolve_spec(spec)
    if spec.name.startswith("compressed:"):
        from repro_torch.core import compression

        return owner_aggregate(compression.inner_spec(spec), stack, z,
                               weights=weights, key=key, wire=wire)
    base = base_spec(spec)
    n, part = stack.shape
    stack = stack.float()
    z = z.float()
    if base.name == "mean":
        if wire is not None:
            qs, scales = wire
            agg, s, norms = ops.mean_digest_fused_dequant_op(
                qs, scales[None], 1, z[None], weights)
        else:
            agg, s, norms = ops.mean_digest_fused_op(stack, 1, z[None],
                                                     weights)
        return agg[0], s[:, 0], norms[:, 0], 1
    agg, info = base.build(n, part)(
        stack, weights if base.weighted else None, None, key)
    agg = agg.float()
    s, norms = ops.digest_tables_all_op(stack, 1, agg[None], z[None])
    return agg, s[:, 0], norms[:, 0], info.iters


def spec_tables(spec, grads, agg, z):
    """A verifiable spec's broadcast tables against a GIVEN aggregate (e.g.
    a corrupted aggregator's value): clipped residuals for butterfly_clip,
    plain digests for verified:*. For compressed:* ``grads`` must already
    be the wire values. Returns (s, norms), both (n, n_parts)."""
    spec = agg_mod.resolve_spec(spec)
    if spec.name.startswith("compressed:"):
        from repro_torch.core import compression

        return spec_tables(compression.inner_spec(spec), grads, agg, z)
    if spec.name == "butterfly_clip":
        return bf.verification_tables(grads, agg, z, spec.get("tau", 1.0))
    if not is_wrapped(spec):
        raise ValueError(f"aggregator {spec.name!r} is not verifiable — it "
                         "has no broadcast tables")
    return digest_tables(grads, agg, z)


def spec_aggregate(spec, grads, z=None, weights=None, v0=None):
    """Aggregate ``grads (n, d)`` by a verifiable spec in the butterfly
    layout, with (``z`` given) or without the tables.

    Returns (agg (n_parts, part), s, norms, iters); s/norms are None when
    z is None. A wrapped base applied to the whole (n, d) matrix equals its
    per-partition application (it is coordinatewise), so it aggregates once
    and splits."""
    spec = agg_mod.resolve_spec(spec)
    n, d = grads.shape
    if spec.name.startswith("compressed:"):
        from repro_torch.core import compression

        return compression.compressed_aggregate(spec, grads, z=z,
                                                weights=weights, v0=v0)
    if spec.name == "butterfly_clip":
        p = spec.param_dict()
        if not p.get("warm_start"):
            v0 = None
        return bf.clip_aggregate(grads, p["tau"], p["n_iters"], z=z,
                                 adaptive_tol=p["adaptive_tol"],
                                 weights=weights, v0=v0)
    if not is_wrapped(spec):
        raise ValueError(
            f"aggregator {spec.name!r} is not verifiable — it produces no "
            "broadcast tables; run it through aggregate() and skip the "
            "verification phases")
    base = base_spec(spec)
    if base.name == "mean" and z is not None:
        agg, s, norms = ops.mean_digest_fused_op(grads, n, z, weights)
        return agg, s, norms, 1
    flat, info = base.build(n, d)(
        grads, weights if base.weighted else None, None, None)
    agg = bf.split_parts(flat.float()[None, :], n)[0]
    if z is None:
        return agg, None, None, info.iters
    s, norms = digest_tables(grads, agg, z)
    return agg, s, norms, info.iters


def register_verified_wrappers():
    """Register ``verified:<name>`` for every coordinatewise baseline:
    verifiable, not warm-startable, the other flags inherited; the flat
    maker is the base maker (the tables come from spec_aggregate /
    spec_tables). Idempotent."""
    for name, base_def in list(agg_mod.REGISTRY.items()):
        if base_def.verifiable or not base_def.coordinatewise:
            continue
        if PREFIX + name in agg_mod.REGISTRY:
            continue
        agg_mod.register(agg_mod.AggregatorDef(
            PREFIX + name, base_def.make, defaults=base_def.defaults,
            verifiable=True, weighted=base_def.weighted,
            warm_startable=False, coordinatewise=True))


register_verified_wrappers()

# the compressed:<verifiable> wrappers register on import, after the
# verified:* ones so that they wrap those too
import repro_torch.core.compression  # noqa: E402,F401
