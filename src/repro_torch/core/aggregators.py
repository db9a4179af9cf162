"""Robust aggregation: the coordinatewise baselines and the AggregatorSpec
registry.

Counterpart of ``repro.core.aggregators``. A spec is a registry name plus
static params (``NAME[:k=v,...]`` on the command line); ``parse`` ->
``canonical`` -> ``parse`` gives the JAX package's strings, including the
``verified:<base>`` (``core.verification``) and ``compressed:<spec>``
(``core.compression``) wrappers. A registered aggregator builds to the
uniform callable

    agg_fn(xs (n, d), weights (n,) | None, v0 (d,) | None, key)
        -> (agg (d,), AggInfo)

Registered here: the flagship ``butterfly_clip`` and the six baselines of
the paper's §4.1: the coordinatewise ``mean``, ``coordinate_median`` and
``trimmed_mean``, which the wrappers lift into verifiable specs, and the
full-vector ``geometric_median`` (Weiszfeld to eps), ``krum`` and the
trusted-server ``centered_clip`` (run to tolerance), which they do not.

Capability flags drive how the engine degrades (see the JAX module):
verifiable specs run the verification phases through
``core.verification.spec_aggregate``; the non-verifiable baselines run
without tables, accusations or bans.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.centered_clip import centered_clip_to_tol
from repro_torch.core.norms import vector_norm

_BIG = 1e30  # "infinite" pairwise distance for masked rows


class AggInfo(NamedTuple):
    """Per-call aggregator observables."""

    iters: int  # iterations the aggregator ran


# ---------------------------------------------------------------------------
# Baseline aggregators (paper §4.1)
# ---------------------------------------------------------------------------
def mean_agg(xs, weights=None):
    if weights is None:
        return xs.mean(0)
    w = weights / torch.clamp(weights.sum(), min=1e-30)
    return (w[:, None] * xs).sum(0)


def _active_sort(xs, weights):
    """Sort each coordinate over the rows with weight > 0; banned rows are
    keyed to +inf, so they land past the m active entries.
    Returns (sorted (n, d), m)."""
    active = weights > 0
    m = int(active.sum())
    s = torch.sort(torch.where(active[:, None], xs,
                               torch.full_like(xs, math.inf)), dim=0).values
    return s, m


def coordinate_median(xs, weights=None):
    """The per-coordinate median over the active rows (all rows when
    ``weights`` is None). With an even count it is the MEAN of the two
    middle values, as ``jnp.median`` / ``jnp.nanmedian`` compute it
    (``torch.median`` would return the lower one)."""
    if weights is None:
        s, m = torch.sort(xs, dim=0).values, xs.shape[0]
    else:
        s, m = _active_sort(xs, weights)
    return (s[(m - 1) // 2] + s[m // 2]) * 0.5


def trimmed_mean(xs, trim_ratio=0.2, weights=None):
    """Coordinate-wise trimmed mean over the ACTIVE rows only: banned rows
    (weight 0) sort past the active block and never enter the trim window;
    the trim count ``k = floor(m * trim_ratio)`` follows the active count m
    (in float32, as the JAX package computes it)."""
    n = xs.shape[0]
    if weights is None:
        k = int(n * trim_ratio)
        s = torch.sort(xs, dim=0).values
        if k:
            s = s[k:n - k]
        return s.mean(0)
    s, m = _active_sort(xs, weights)
    k = int(np.floor(np.float32(m) * np.float32(trim_ratio)))
    idx = torch.arange(n, device=xs.device)[:, None]
    keep = (idx >= k) & (idx < m - k)
    cnt = max(m - 2 * k, 1)
    return torch.where(keep, s, torch.zeros_like(s)).sum(0) / cnt


def geometric_median(xs, eps=1e-6, max_iters=200, weights=None,
                     return_iters=False):
    """Weiszfeld iterations from the weighted mean until ||v_new - v|| <=
    eps or ``max_iters``."""
    n = xs.shape[0]
    w0 = (torch.ones((n,), dtype=torch.float32, device=xs.device)
          if weights is None else weights)
    v = (w0[:, None] * xs).sum(0) / torch.clamp(w0.sum(), min=1e-30)
    eps32 = float(np.float32(eps))  # the reference compares in float32
    delta, iters = math.inf, 0
    while delta > eps32 and iters < max_iters:
        dist = vector_norm(xs - v[None], dim=1)
        inv = w0 / torch.clamp(dist, min=1e-12)
        v_new = (inv[:, None] * xs).sum(0) / torch.clamp(inv.sum(),
                                                         min=1e-30)
        delta = float(vector_norm(v_new - v))
        v, iters = v_new, iters + 1
    if return_iters:
        return v, iters
    return v


def pairwise_sq_dists(xs):
    """(n, n) squared distances, each entry the exact sum of (x_i - x_j)^2
    over the coordinates, one row at a time: an (n, d) temporary instead of
    the (n, n, d) differences (80 GB for 16 peers at d = 78,223,360). Not
    the Gram form ||x||^2 + ||y||^2 - 2<x, y>, which cancels
    catastrophically between near neighbours and can change Krum's pick."""
    return torch.stack([((xs[i][None, :] - xs) ** 2).sum(-1)
                        for i in range(xs.shape[0])])


def krum(xs, n_byzantine: int, weights=None):
    """Krum (Blanchard et al. 2017): the row with the smallest sum of
    squared distances to its n - b - 2 nearest neighbours. Banned rows
    (weight 0) are masked out of the PAIRWISE matrix, not just the scores:
    masked pairs sit at an "infinite" distance, so a banned colluder is no
    cheap neighbour for its accomplices."""
    n = xs.shape[0]
    d2 = pairwise_sq_dists(xs)
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * _BIG
    if weights is not None:
        banned = weights <= 0
        d2 = torch.where(banned[None, :] | banned[:, None],
                         torch.full_like(d2, _BIG), d2)
    k = max(1, n - n_byzantine - 2)
    scores = torch.sort(d2, dim=1).values[:, :k].sum(1)
    if weights is not None:
        scores = torch.where(weights > 0, scores,
                             torch.full_like(scores, math.inf))
    return xs[torch.argmin(scores)]


def ps_centered_clip(xs, tau, eps=1e-6, max_iters=200, weights=None, v0=None,
                     return_iters=False):
    """The original (trusted-parameter-server) CenteredClip baseline, run to
    tolerance."""
    v, iters = centered_clip_to_tol(xs, tau, eps=eps, max_iters=max_iters,
                                    weights=weights, v0=v0)
    if return_iters:
        return v, iters
    return v


# Legacy name -> fn map (host call sites that predate the spec registry).
AGGREGATORS = {
    "mean": mean_agg,
    "coordinate_median": coordinate_median,
    "trimmed_mean": trimmed_mean,
    "geometric_median": geometric_median,
    "krum": krum,
    "centered_clip": ps_centered_clip,
}


# ---------------------------------------------------------------------------
# The AggregatorSpec registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AggregatorDef:
    """One registered aggregator: maker + declared static params + flags.

    ``make(n, d, **params) -> agg_fn`` with the uniform signature of the
    module docstring."""

    name: str
    make: Callable[..., Callable]
    defaults: tuple = ()  # ((name, default), ...)
    verifiable: bool = False
    weighted: bool = True
    warm_startable: bool = False
    adaptive: bool = False
    coordinatewise: bool = False

    @property
    def param_names(self):
        return tuple(k for k, _ in self.defaults)


REGISTRY: dict[str, AggregatorDef] = {}


def register(defn: AggregatorDef):
    REGISTRY[defn.name] = defn
    return defn


def registered_aggregators():
    """Registered spec names, verifiable first."""
    return tuple(sorted(REGISTRY,
                        key=lambda k: (not REGISTRY[k].verifiable, k)))


def _coerce(text: str):
    """Parse a CLI param value: bool | int | float | 'none' | str."""
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


@dataclass(frozen=True)
class AggregatorSpec:
    """Declarative aggregator choice: registry name + static params
    (a sorted tuple of (name, value) pairs, so specs are hashable)."""

    name: str = "butterfly_clip"
    params: tuple = ()

    @property
    def definition(self) -> AggregatorDef:
        try:
            return REGISTRY[self.name]
        except KeyError:
            raise ValueError(
                f"unknown aggregator {self.name!r}; registered: "
                f"{', '.join(registered_aggregators())}") from None

    @property
    def verifiable(self) -> bool:
        return self.definition.verifiable

    @property
    def weighted(self) -> bool:
        return self.definition.weighted

    @property
    def warm_startable(self) -> bool:
        return self.definition.warm_startable

    @property
    def adaptive(self) -> bool:
        return self.definition.adaptive

    @property
    def coordinatewise(self) -> bool:
        return self.definition.coordinatewise

    def param_dict(self) -> dict:
        """Declared defaults overlaid with this spec's explicit params."""
        d = dict(self.definition.defaults)
        for k, v in self.params:
            if k not in d:
                raise ValueError(
                    f"aggregator {self.name!r} takes no param {k!r} "
                    f"(declared: {self.definition.param_names})")
            d[k] = v
        return d

    def get(self, key: str, default=None):
        return self.param_dict().get(key, default)

    def _replace_params(self, updates: dict) -> "AggregatorSpec":
        merged = dict(self.params)
        merged.update(updates)
        return AggregatorSpec(self.name, tuple(sorted(merged.items())))

    def with_defaults(self, **kw) -> "AggregatorSpec":
        """Fill declared params NOT already set (explicit params win);
        undeclared keys are ignored."""
        have = dict(self.params)
        accepted = set(self.definition.param_names)
        fill = {k: v for k, v in kw.items()
                if k in accepted and k not in have}
        return self._replace_params(fill) if fill else self

    def override(self, **kw) -> "AggregatorSpec":
        """Set declared params, overriding existing values."""
        accepted = set(self.definition.param_names)
        bad = [k for k in kw if k not in accepted]
        if bad:
            raise ValueError(
                f"aggregator {self.name!r} takes no param(s) {bad} "
                f"(declared: {self.definition.param_names})")
        return self._replace_params(kw)

    @classmethod
    def parse(cls, text: str) -> "AggregatorSpec":
        """Parse ``NAME[:k=v,...]`` (the ``--aggregator`` syntax);
        ``verified:BASE[:k=v,...]`` lifts the base spec through
        :func:`verified`, ``compressed:INNER[:k=v,...]`` through
        :func:`compressed` (``codec`` binds to the wrapper, every other
        param to the inner spec)."""
        text = text.strip()
        if text.startswith("verified:"):
            return verified(cls.parse(text[len("verified:"):]))
        if text.startswith("compressed:"):
            from repro_torch.core import compression

            return compression.parse_spec_text(text[len("compressed:"):])
        name, _, tail = text.partition(":")
        spec = cls(name.strip())
        spec.definition  # eager name validation
        params = {}
        if tail.strip():
            for item in tail.split(","):
                k, sep, v = item.partition("=")
                if not sep:
                    raise ValueError(f"bad aggregator param {item!r} in "
                                     f"{text!r} (expected k=v)")
                params[k.strip()] = _coerce(v.strip())
        return spec.override(**params) if params else spec

    def canonical(self) -> str:
        if not self.params:
            return self.name
        tail = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.name}:{tail}"

    def build(self, n: int, d: int) -> Callable:
        """Resolve to ``agg_fn(xs, weights, v0, key) -> (agg, AggInfo)``."""
        return self.definition.make(n, d, **self.param_dict())


def resolve_spec(spec) -> AggregatorSpec:
    """An AggregatorSpec, a ``NAME[:k=v,...]`` string, or None (-> the
    flagship ButterflyClip spec)."""
    if spec is None:
        return AggregatorSpec("butterfly_clip")
    if isinstance(spec, AggregatorSpec):
        spec.definition  # validate
        return spec
    if isinstance(spec, str):
        return AggregatorSpec.parse(spec)
    raise TypeError(f"not an aggregator spec: {spec!r}")


def verified(spec) -> AggregatorSpec:
    """Lift a coordinatewise spec into its ``verified:`` form
    (:func:`repro_torch.core.verification.verified`)."""
    from repro_torch.core import verification

    return verification.verified(spec)


def compressed(spec, codec: str | None = None) -> AggregatorSpec:
    """Wire-compress a verifiable spec's butterfly payloads
    (:func:`repro_torch.core.compression.compressed`)."""
    from repro_torch.core import compression

    return compression.compressed(spec, codec=codec)


def with_byzantine_default(spec: AggregatorSpec,
                           n_byzantine: int) -> AggregatorSpec:
    """Fill Krum's ``n_byzantine`` from the caller's known Byzantine count
    when the spec left it unset (the trainer, the CLI). A spec reaching the
    maker with it still unset falls back to the largest tolerable
    ``(n - 3) // 2``."""
    if spec.name == "krum" and spec.get("n_byzantine") is None:
        return spec.override(n_byzantine=int(n_byzantine))
    return spec


# ---------------------------------------------------------------------------
# Registered makers
# ---------------------------------------------------------------------------
def _make_mean(n, d):
    def fn(xs, weights=None, v0=None, key=None):
        return mean_agg(xs, weights), AggInfo(1)

    return fn


def _make_coordinate_median(n, d):
    def fn(xs, weights=None, v0=None, key=None):
        return coordinate_median(xs, weights), AggInfo(1)

    return fn


def _make_trimmed_mean(n, d, trim_ratio=0.2):
    def fn(xs, weights=None, v0=None, key=None):
        return trimmed_mean(xs, trim_ratio, weights), AggInfo(1)

    return fn


def _make_geometric_median(n, d, eps=1e-6, max_iters=200):
    def fn(xs, weights=None, v0=None, key=None):
        v, iters = geometric_median(xs, eps=eps, max_iters=max_iters,
                                    weights=weights, return_iters=True)
        return v, AggInfo(iters)

    return fn


def _make_krum(n, d, n_byzantine=None):
    if n_byzantine is None:
        # Krum's guarantee needs n >= 2b + 3: the largest tolerable b
        n_byzantine = max(0, (n - 3) // 2)
    b = int(n_byzantine)

    def fn(xs, weights=None, v0=None, key=None):
        return krum(xs, n_byzantine=b, weights=weights), AggInfo(1)

    return fn


def _make_ps_centered_clip(n, d, tau=1.0, eps=1e-6, max_iters=200,
                           warm_start=False):
    def fn(xs, weights=None, v0=None, key=None):
        v, iters = ps_centered_clip(
            xs, tau, eps=eps, max_iters=max_iters, weights=weights,
            v0=v0 if warm_start else None, return_iters=True)
        return v, AggInfo(iters)

    return fn


def _make_butterfly(n, d, tau=1.0, n_iters=60, adaptive_tol=None,
                    warm_start=False):
    """The flagship as a FLAT aggregator (no tables): per-partition
    CenteredClip, merged. The verifiable path with the tables is
    :func:`verified_aggregate` — same spec, same params."""
    from repro_torch.core import butterfly as bf

    def fn(xs, weights=None, v0=None, key=None):
        v0p = None
        if warm_start and v0 is not None:
            v0p = bf.split_parts(v0[None, :], n)[0]
        agg, _s, _n, iters = bf.clip_aggregate(
            xs, tau, n_iters, adaptive_tol=adaptive_tol, weights=weights,
            v0=v0p)
        return bf.merge_parts(agg, d), AggInfo(iters)

    return fn


register(AggregatorDef("mean", _make_mean, coordinatewise=True))
register(AggregatorDef("coordinate_median", _make_coordinate_median,
                       coordinatewise=True))
register(AggregatorDef("trimmed_mean", _make_trimmed_mean,
                       defaults=(("trim_ratio", 0.2),),
                       coordinatewise=True))
register(AggregatorDef("geometric_median", _make_geometric_median,
                       defaults=(("eps", 1e-6), ("max_iters", 200)),
                       adaptive=True))
register(AggregatorDef("krum", _make_krum,
                       defaults=(("n_byzantine", None),)))
register(AggregatorDef(
    "centered_clip", _make_ps_centered_clip,
    defaults=(("tau", 1.0), ("eps", 1e-6), ("max_iters", 200),
              ("warm_start", False)),
    warm_startable=True,
    adaptive=True,
))
register(AggregatorDef(
    "butterfly_clip", _make_butterfly,
    defaults=(("tau", 1.0), ("n_iters", 60), ("adaptive_tol", None),
              ("warm_start", False)),
    verifiable=True,
    warm_startable=True,
    adaptive=True,
))

# the verified:<base> and compressed:<spec> wrappers register themselves on
# import (core.verification, which imports core.compression last)
import repro_torch.core.verification  # noqa: E402,F401


# ---------------------------------------------------------------------------
# Spec-level entry points
# ---------------------------------------------------------------------------
def aggregate(spec, xs, weights=None, v0=None, key=None):
    """Run any registered aggregator by spec: (n, d) -> ((d,), AggInfo)."""
    spec = resolve_spec(spec)
    n, d = xs.shape
    return spec.build(n, d)(xs, weights, v0, key)


def verified_aggregate(spec, grads, z, weights=None, v0=None):
    """The verifiable aggregation contract: aggregation plus the Alg. 6
    tables in the butterfly layout -> (agg (n_parts, part), s (n, n_parts),
    norms (n, n_parts), iters). Raises for non-verifiable specs."""
    from repro_torch.core import verification

    return verification.spec_aggregate(resolve_spec(spec), grads, z=z,
                                       weights=weights, v0=v0)
