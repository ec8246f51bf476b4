"""Model API: one set of entry points per family, chosen from ArchConfig.

The port has the decoder families ``dense``, ``moe`` (sliding window and
llama4's local chunk included) and ``vlm`` (the image-token prefix) on
the decoder's functions, and ``encdec`` (whisper) on the
encoder-decoder's; SSM and hybrid raise until they are ported (ROADMAP
queue 1, slice 8).  Training (``loss``) comes with ``train/``.
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
    if cfg.family in tfm.DECODER_FAMILIES:
        return ModelFns(tfm.decoder_param_shapes, tfm.init_decoder_params,
                        tfm.decoder_prefill, tfm.decoder_decode_step,
                        tfm.decoder_cache_shapes)
    if cfg.family == "encdec":
        return ModelFns(tfm.encdec_param_shapes, tfm.init_encdec_params,
                        tfm.encdec_prefill, tfm.encdec_decode_step,
                        tfm.encdec_cache_shapes)
    missing = {"ssm": "models/ssm.py", "hybrid": "models/hybrid.py"}
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: it needs "
        f"{missing.get(cfg.family, 'a model module')} (ROADMAP queue 1, "
        f"slice 8); the port runs families 'dense', 'moe', 'vlm' and "
        f"'encdec'")
