"""Model API: one set of entry points per family, chosen from ArchConfig.

The port has the dense decoder; the other families of the JAX package
(MoE, VLM, enc-dec, SSM, hybrid) raise until they are ported (ROADMAP
queue 1).  Training (``loss``) comes with ``train/``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class ModelFns:
    param_shapes: Callable[[ArchConfig], dict]
    init: Callable[..., dict]
    prefill: Callable[..., tuple]
    decode: Callable[..., tuple]
    cache_shapes: Callable[[ArchConfig, int, int], dict]


def get_model(cfg: ArchConfig) -> ModelFns:
    if cfg.family == "dense":
        return ModelFns(tfm.decoder_param_shapes, tfm.init_decoder_params,
                        tfm.decoder_prefill, tfm.decoder_decode_step,
                        tfm.decoder_cache_shapes)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1); the "
        f"port runs family 'dense'")
