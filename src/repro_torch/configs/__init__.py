"""Registry of the architectures the port can run (``--arch <id>``).

The JAX package's registry lists ten; the port lists those whose family
it has ported (ROADMAP queue 1 says which come next)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import (SHAPES, ArchConfig, ShapeConfig,
                                       applicable_shapes)

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["list_archs", "get_config", "get_shape", "SHAPES",
           "applicable_shapes", "ArchConfig", "ShapeConfig"]
