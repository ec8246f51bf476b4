"""Carry model parameters and KV caches from the JAX package to the port.

The two packages share the parameter tree (same keys, same stacked
``[L, ...]`` shapes) and the cache tree: a decoder's
``{"dense0": {"k", "v"}}`` of ``[L, B, Hk, S, Dh]``, an enc-dec's
``{"self": {"k", "v"}, "cross_k", "cross_v"}`` whose cross caches are
leaves; only the array type differs.  Any nesting of dicts carries over,
leaf for leaf.  The JAX side hands its trees over as numpy arrays
(``jax.tree.map(np.asarray, tree)``).
"""
from __future__ import annotations

import numpy as np
import torch


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
