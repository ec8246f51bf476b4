"""Model API: one set of entry points per family, chosen from ArchConfig.

The port has every family of the JAX package: the decoder families
``dense``, ``moe`` (sliding window and llama4's local chunk included) and
``vlm`` (the image-token prefix) on the decoder's functions, ``encdec``
(whisper) on the encoder-decoder's, ``ssm`` (mamba2) on ``ssm.py``'s and
``hybrid`` (recurrentgemma) on ``hybrid.py``'s.  ``loss(params, batch,
cfg, mctx=None, *, global_batch=None)`` is each family's training loss,
the float32 scalar the reference's ``model.loss`` returns (``train/``
takes its gradient).

Each family also gives its parameter and cache layouts on a mesh
(``param_specs``, ``cache_specs``: the reference's PartitionSpec trees),
and the abstract inputs below describe a step's inputs without allocating
them (``ShapeDtypeStruct`` trees, sharded when a mesh is given), for the
dry-run (``launch/dryrun.py``).  On a mesh over ranks every family's
``loss``, ``prefill`` and ``decode`` take and return this rank's blocks
under those trees, the batch under ``batch_specs`` (``drop_dp_axes``
where the data axes do not divide it; the caller names the global batch,
``global_batch=``, and a decode step the caches' ``n_slots=``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import hybrid, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.sharding import MeshCtx, P, ShapeDtypeStruct, \
    map_specs
from repro_torch.models.transformer import VIT_STUB_DIM


@dataclass(frozen=True)
class ModelFns:
    param_shapes: Callable[[ArchConfig], dict]
    param_specs: Callable[[ArchConfig, MeshCtx], dict]
    init: Callable[..., dict]
    loss: Callable[..., object]
    prefill: Callable[..., tuple]
    decode: Callable[..., tuple]
    cache_shapes: Callable[[ArchConfig, int, int], dict]
    cache_specs: Callable[..., dict]


def get_model(cfg: ArchConfig) -> ModelFns:
    if cfg.family in tfm.DECODER_FAMILIES:
        return ModelFns(tfm.decoder_param_shapes, tfm.decoder_param_specs,
                        tfm.init_decoder_params, tfm.decoder_loss,
                        tfm.decoder_prefill, tfm.decoder_decode_step,
                        tfm.decoder_cache_shapes, tfm.decoder_cache_specs)
    if cfg.family == "encdec":
        return ModelFns(tfm.encdec_param_shapes, tfm.encdec_param_specs,
                        tfm.init_encdec_params, tfm.encdec_loss,
                        tfm.encdec_prefill, tfm.encdec_decode_step,
                        tfm.encdec_cache_shapes, tfm.encdec_cache_specs)
    if cfg.family == "ssm":
        return ModelFns(ssm.ssm_param_shapes, ssm.ssm_param_specs,
                        ssm.init_ssm_params, ssm.ssm_loss, ssm.ssm_prefill,
                        ssm.ssm_decode_step, ssm.ssm_cache_shapes,
                        ssm.ssm_cache_specs)
    if cfg.family == "hybrid":
        return ModelFns(hybrid.hybrid_param_shapes, hybrid.hybrid_param_specs,
                        hybrid.init_hybrid_params, hybrid.hybrid_loss,
                        hybrid.hybrid_prefill, hybrid.hybrid_decode_step,
                        hybrid.hybrid_cache_shapes, hybrid.hybrid_cache_specs)
    raise NotImplementedError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Abstract inputs (ShapeDtypeStruct stand-ins — never allocated)
# ---------------------------------------------------------------------------

def _batch_axes(b: int, mctx: MeshCtx | None):
    if mctx is None:
        return None
    return mctx.dp if b % mctx.dp_size == 0 else None


def drop_dp_axes(specs, mctx: MeshCtx):
    """Replace data-parallel axes with None (for unshardable batch=1 cells)."""
    dpset = set(mctx.dp)

    def fix(p: P) -> P:
        ent = []
        for e in p:
            if e in dpset:
                ent.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a not in dpset)
                ent.append(kept if len(kept) > 1
                           else (kept[0] if kept else None))
            else:
                ent.append(e)
        return P(*ent)

    return map_specs(fix, specs)


def batch_shapes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Shapes and dtypes of the data-pipeline inputs of one step."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out: dict[str, Any] = {}
        if cfg.family == "vlm":
            out["tokens"] = ((b, s - cfg.img_tokens), torch.int32)
            out["img_emb"] = ((b, cfg.img_tokens, VIT_STUB_DIM),
                              torch.float32)
        elif cfg.family == "encdec":
            out["tokens"] = ((b, s), torch.int32)
            out["frames"] = ((b, cfg.enc_seq, VIT_STUB_DIM), torch.float32)
        else:
            out["tokens"] = ((b, s), torch.int32)
        return out
    return {"tokens": ((b, 1), torch.int32)}


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mctx: MeshCtx) -> dict:
    dp = _batch_axes(shape.global_batch, mctx)
    return {k: P(*((dp,) + (None,) * (len(v[0]) - 1)))
            for k, v in batch_shapes(cfg, shape).items()}


def _abstract(shapes, dtypes, specs, mctx: MeshCtx | None):
    """A ShapeDtypeStruct tree: shapes (nested dicts of tuples) with the
    dtype tree ``dtypes`` (or one dtype) and, given a mesh, ``specs``."""
    if isinstance(shapes, dict):
        return {k: _abstract(v, dtypes[k] if isinstance(dtypes, dict)
                             else dtypes,
                             None if specs is None else specs[k], mctx)
                for k, v in shapes.items()}
    return ShapeDtypeStruct(tuple(shapes), dtypes,
                            None if mctx is None else mctx.sharding(specs))


def abstract_batch(cfg: ArchConfig, shape: ShapeConfig,
                   mctx: MeshCtx | None = None) -> dict:
    shapes = batch_shapes(cfg, shape)
    specs = None if mctx is None else batch_specs(cfg, shape, mctx)
    return _abstract({k: v[0] for k, v in shapes.items()},
                     {k: v[1] for k, v in shapes.items()}, specs, mctx)


def _param_dtypes(shapes: dict, cfg: ArchConfig) -> dict:
    return {k: _param_dtypes(v, cfg) if isinstance(v, dict)
            else tfm.leaf_dtype(k, cfg) for k, v in shapes.items()}


def abstract_params(cfg: ArchConfig, mctx: MeshCtx | None = None) -> dict:
    """The parameter tree ``get_model(cfg).init(cfg, generator)`` makes,
    as ShapeDtypeStructs: each leaf's dtype by the init's own rule
    (``transformer.leaf_dtype``: the config's ``param_dtype``, the
    reference's tree)."""
    model = get_model(cfg)
    shapes = model.param_shapes(cfg)
    specs = None if mctx is None else model.param_specs(cfg, mctx)
    return _abstract(shapes, _param_dtypes(shapes, cfg), specs, mctx)


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig,
                   mctx: MeshCtx | None = None) -> dict:
    """The decode cache of ``shape`` in the compute dtype; a batch the
    data axes do not divide is replicated over them (``drop_dp_axes``)."""
    model = get_model(cfg)
    shapes = model.cache_shapes(cfg, shape.global_batch, shape.seq_len)
    specs = None
    if mctx is not None:
        specs = model.cache_specs(cfg, mctx, shape.seq_len)
        if shape.global_batch % mctx.dp_size != 0:
            specs = drop_dp_axes(specs, mctx)
    return _abstract(shapes, getattr(torch, cfg.compute_dtype), specs, mctx)
