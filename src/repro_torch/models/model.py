"""Model API: one set of entry points per family, chosen from ArchConfig.

The port has every family of the JAX package: the decoder families
``dense``, ``moe`` (sliding window and llama4's local chunk included) and
``vlm`` (the image-token prefix) on the decoder's functions, ``encdec``
(whisper) on the encoder-decoder's, ``ssm`` (mamba2) on ``ssm.py``'s and
``hybrid`` (recurrentgemma) on ``hybrid.py``'s.  ``loss(params, batch,
cfg)`` is each family's training loss, the float32 scalar the reference's
``model.loss`` returns (``train/`` takes its gradient).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import hybrid, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class ModelFns:
    param_shapes: Callable[[ArchConfig], dict]
    init: Callable[..., dict]
    prefill: Callable[..., tuple]
    decode: Callable[..., tuple]
    cache_shapes: Callable[[ArchConfig, int, int], dict]
    loss: Callable[..., object]


def get_model(cfg: ArchConfig) -> ModelFns:
    if cfg.family in tfm.DECODER_FAMILIES:
        return ModelFns(tfm.decoder_param_shapes, tfm.init_decoder_params,
                        tfm.decoder_prefill, tfm.decoder_decode_step,
                        tfm.decoder_cache_shapes, tfm.decoder_loss)
    if cfg.family == "encdec":
        return ModelFns(tfm.encdec_param_shapes, tfm.init_encdec_params,
                        tfm.encdec_prefill, tfm.encdec_decode_step,
                        tfm.encdec_cache_shapes, tfm.encdec_loss)
    if cfg.family == "ssm":
        return ModelFns(ssm.ssm_param_shapes, ssm.init_ssm_params,
                        ssm.ssm_prefill, ssm.ssm_decode_step,
                        ssm.ssm_cache_shapes, ssm.ssm_loss)
    if cfg.family == "hybrid":
        return ModelFns(hybrid.hybrid_param_shapes, hybrid.init_hybrid_params,
                        hybrid.hybrid_prefill, hybrid.hybrid_decode_step,
                        hybrid.hybrid_cache_shapes, hybrid.hybrid_loss)
    raise NotImplementedError(f"unknown family {cfg.family!r}")
