"""Registry of the architectures the port can run (``--arch <id>``).

The JAX package's registry lists ten, and so does the port."""
from __future__ import annotations

import importlib

from repro_torch.models.config import (SHAPES, ArchConfig, ShapeConfig,
                                       applicable_shapes)

_MODULES = {
    "whisper-medium": "whisper_medium",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama3.2-3b": "llama3_2_3b",
    "internlm2-20b": "internlm2_20b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "minitron-4b": "minitron_4b",
    "internvl2-26b": "internvl2_26b",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-2b": "recurrentgemma_2b",
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
