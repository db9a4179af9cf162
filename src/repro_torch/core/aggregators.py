"""The AggregatorSpec registry: robust aggregation as declarative config.

Counterpart of ``repro.core.aggregators``. A spec is a registry name plus
static params (``NAME[:k=v,...]`` on the command line); ``parse`` ->
``canonical`` -> ``parse`` gives the JAX package's strings. Only the
flagship ``butterfly_clip`` is registered in this slice: the baselines
(mean, coordinate_median, trimmed_mean, geometric_median, krum,
centered_clip) and the ``verified:*`` / ``compressed:*`` wrappers wait for
their queue items, and parsing them raises ``NotImplementedError``.

Capability flags drive how the engine degrades (see the JAX module): only
verifiable specs exist here, so the verification phases always run, through
``core.verification.spec_aggregate``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AggregatorDef:
    """One registered aggregator: declared static params + capability
    flags."""

    name: str
    defaults: tuple = ()  # ((name, default), ...)
    verifiable: bool = False
    warm_startable: bool = False

    @property
    def param_names(self):
        return tuple(k for k, _ in self.defaults)


REGISTRY: dict[str, AggregatorDef] = {}

# the registry entries of the JAX package that this slice does not port
_NOT_PORTED = {
    "mean", "coordinate_median", "trimmed_mean", "geometric_median",
    "krum", "centered_clip",
}


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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, {item})")


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
            if self.name in _NOT_PORTED:
                raise _not_ported(f"aggregator {self.name!r}",
                                  "item 4") from None
            raise ValueError(
                f"unknown aggregator {self.name!r}; registered: "
                f"{', '.join(registered_aggregators())}") from None

    @property
    def verifiable(self) -> bool:
        return self.definition.verifiable

    @property
    def warm_startable(self) -> bool:
        return self.definition.warm_startable

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
        """Parse ``NAME[:k=v,...]`` (the ``--aggregator`` syntax)."""
        text = text.strip()
        if text.startswith("verified:"):
            raise _not_ported("the verified:* wrapper", "item 8")
        if text.startswith("compressed:"):
            raise _not_ported("the compressed:* wire codecs", "item 9")
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


register(AggregatorDef(
    "butterfly_clip",
    defaults=(("tau", 1.0), ("n_iters", 60), ("adaptive_tol", None),
              ("warm_start", False)),
    verifiable=True,
    warm_startable=True,
))
