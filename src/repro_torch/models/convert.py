"""Carry model parameters and KV caches from the JAX package to the port.

The two packages share the parameter tree (same keys, same stacked
``[L, ...]`` shapes) and the cache tree: a decoder's
``{"dense0": {"k", "v"}}`` of ``[L, B, Hk, S, Dh]``, an enc-dec's
``{"self": {"k", "v"}, "cross_k", "cross_v"}`` whose cross caches are
leaves, an SSM's ``{"conv", "state"}``, a hybrid's ``{"groups": {...},
"tail0_rec": ...}``; only the array type differs.  Any nesting of dicts carries over,
leaf for leaf.  The JAX side hands its trees over as numpy arrays
(``jax.tree.map(np.asarray, tree)``).

On a mesh over ranks each rank holds its blocks of a tree under a spec
tree (``blocks``: the parameters under ``param_specs``, the caches under
``cache_specs``, the batch under ``batch_specs``), so the same global
arrays feed both packages (every family's: the enc-dec's, SSM's and
hybrid's trees cut as the decoder's); ``shardings`` gives the same cut by
path for every family's ``init(..., blocks=)``, which draws only the
blocks.
``moe_blocks`` cuts the MoE leaves alone to the MoE block's ``in_specs``
(the layout ``moe.moe_ffn`` takes).  A tree of a config with head padding
(``pad_heads_to``: the reference's padded ``wq`` carries over as it is)
becomes the unpadded config's by ``unpad_heads``, which keeps ``wq``'s
real-head columns: the same function, the pad heads' outputs being
dropped before ``wo``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import (moe_in_specs, moe_param_shapes,
                                    moe_param_specs)
from repro_torch.models.sharding import MeshCtx, NamedSharding, P
from repro_torch.models.sharding import relayout


def _tree(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":        # ml_dtypes: torch cannot wrap it
        leaf = torch.tensor(arr.astype(np.float32),
                            device=device).to(torch.bfloat16)
    else:
        leaf = torch.tensor(arr, device=device)
    return leaf if dtype is None else leaf.to(dtype)


def params_from_numpy(tree, device, dtype=None):
    """numpy parameter tree -> the port's, on ``device``; each leaf keeps
    its dtype (the reference stores float32) unless ``dtype`` is given."""
    return _tree(tree, device, dtype)


def caches_from_numpy(tree, device, dtype=None):
    """numpy KV-cache tree -> the port's, on ``device``; a bfloat16 cache
    stays bfloat16 unless ``dtype`` is given."""
    return _tree(tree, device, dtype)


def moe_shardings(tree, cfg: ArchConfig, mctx: MeshCtx, batch: int
                  ) -> dict[tuple, NamedSharding]:
    """The sharding of every MoE leaf of ``tree`` by its path of keys,
    under the block's ``in_specs`` for a batch of ``batch`` rows
    (``moe.moe_in_specs``; a leading layer dim unsharded).  ``tree`` is
    one MoE block's parameters or a decoder's, given as arrays or as
    shape tuples (``decoder_param_shapes``)."""
    specs = moe_in_specs(cfg, mctx, batch)
    stacked = moe_param_shapes(cfg, 1)          # [1, *the block's leaf]
    if "router" in tree:
        blocks = [((), tree)]
    else:
        blocks = [(("layers", name, "moe"), group["moe"])
                  for name, group in sorted(tree["layers"].items())
                  if "moe" in group]
    out = {}
    for path, block in blocks:
        for key, leaf in block.items():
            ndim = len(leaf) if isinstance(leaf, tuple) else leaf.ndim
            lead = ndim - (len(stacked[key]) - 1)
            out[path + (key,)] = mctx.sharding(
                P(*(None,) * lead, *specs[key]))
    return out


def moe_blocks(tree, cfg: ArchConfig, mctx: MeshCtx, batch: int):
    """``tree`` (one MoE block's parameters or a decoder's; numpy arrays or
    tensors) with every MoE leaf cut to this rank's block of it
    (``moe_shardings``), a copy; every other leaf as it is."""
    shardings = moe_shardings(tree, cfg, mctx, batch)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path not in shardings:
            return node
        block = shardings[path].block(node)
        return block.copy() if isinstance(block, np.ndarray) \
            else block.contiguous().clone()

    return walk(tree, ())


def shardings(specs, mctx: MeshCtx, prefix: tuple = ()
              ) -> dict[tuple, NamedSharding]:
    """Every spec of the spec tree ``specs`` by its path of keys, as a
    ``NamedSharding`` on ``mctx`` (``init_decoder_params(..., blocks=)``
    takes it)."""
    if isinstance(specs, P):
        return {prefix: mctx.sharding(specs)}
    out: dict = {}
    for k, v in specs.items():
        out |= shardings(v, mctx, prefix + (k,))
    return out


def blocks(tree, specs, mctx: MeshCtx):
    """``tree`` (nested dicts of numpy arrays or tensors) cut to this
    rank's block of every leaf under the spec tree ``specs`` of its
    structure, each a copy (``NamedSharding.block``)."""
    if isinstance(tree, dict):
        return {k: blocks(v, specs[k], mctx) for k, v in tree.items()}
    block = mctx.sharding(specs).block(tree)
    return block.copy() if isinstance(block, np.ndarray) \
        else block.contiguous().clone()


def gathered(tree, specs, mctx: MeshCtx):
    """The global arrays of a tree of this rank's blocks under ``specs``:
    every leaf gathered over the axes its spec names
    (``sharding.relayout`` to a replicated layout; the same on every
    rank)."""
    if isinstance(tree, dict):
        return {k: gathered(v, specs[k], mctx) for k, v in tree.items()}
    return relayout(tree, specs, P(), mctx)


def moe_in_blocks(layer: dict, cfg: ArchConfig, mctx: MeshCtx, batch: int
                  ) -> dict:
    """One MoE layer's leaves as a rank holds them under
    ``moe_param_specs`` (FSDP storage; the layer dim dropped), relaid into
    the blocks ``moe.moe_ffn`` takes for a batch of ``batch`` rows
    (``moe_in_specs``; ``sharding.relayout``: the FSDP dims gathered)."""
    stored = moe_param_specs(cfg, mctx.dp if cfg.fsdp else None)
    want = moe_in_specs(cfg, mctx, batch)
    return {k: relayout(v, P(*stored[k][1:]), want[k], mctx)
            for k, v in layer.items()}


def unpad_heads(tree, cfg: ArchConfig):
    """``(tree, cfg)`` of a config with head padding (``pad_heads_to``)
    as the unpadded config's: every ``wq`` / ``x_wq`` leaf [..., d,
    padded_heads * Dh] cut to its real heads' columns (group-major
    padding: each KV group's first ``num_heads // Hk`` heads), a copy;
    every other leaf as it is.  Without padding, both as they are."""
    if cfg.padded_heads == cfg.num_heads:
        return tree, cfg
    kvh = max(cfg.num_kv_heads, 1)
    gp, gr = cfg.padded_heads // kvh, cfg.num_heads // kvh
    dh = cfg.head_dim
    cols = [g * gp * dh + j for g in range(kvh) for j in range(gr * dh)]

    def walk(node):
        if isinstance(node, dict):
            return {k: (walk(v) if isinstance(v, dict) else
                        _cut_cols(v, cols) if k in ("wq", "x_wq") else v)
                    for k, v in node.items()}
        return node

    return walk(tree), cfg.replace(pad_heads_to=0)


def _cut_cols(leaf, cols: list):
    if isinstance(leaf, np.ndarray):
        return leaf[..., cols].copy()
    return leaf.index_select(-1, torch.tensor(cols, device=leaf.device))
