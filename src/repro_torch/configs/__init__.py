"""Architecture registry of the port: ``get_config(arch_id)``.

Only ALBERT-large is ported so far; the other families of the JAX
package's zoo wait for their slice.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LayerSpec,
    ModelConfig,
    reduce_config,
)

_ARCH_MODULES = {
    "albert-large": "albert_large",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def list_archs():
    return list(_ARCH_MODULES)
