"""Carry state between the JAX package's numpy snapshots and the port.

``LSMStore.snapshot()`` (keys/vals/weights arrays plus memory_mb and
value_words) and ``StreamEngine.snapshot()`` (now, source_emitted and a
list of store snapshots per stateful operator) have the same layout in
both packages; only the array type differs.  These two functions walk a
snapshot and convert every array, so one state can be restored into both
packages and driven in lockstep.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"keys": torch.int64, "weights": torch.int64, "vals": torch.int32}


def snapshot_to_torch(snap, device):
    """numpy snapshot (store or engine) -> the port's, on ``device``."""
    if isinstance(snap, dict):
        out = {}
        for k, v in snap.items():
            if isinstance(v, np.ndarray):
                out[k] = torch.as_tensor(v, dtype=_DTYPES.get(k),
                                         device=device)
            else:
                out[k] = snapshot_to_torch(v, device)
        return out
    if isinstance(snap, list):
        return [snapshot_to_torch(s, device) for s in snap]
    return snap


def snapshot_to_numpy(snap):
    """The port's snapshot (store or engine) -> numpy arrays on the host."""
    if isinstance(snap, dict):
        return {k: snapshot_to_numpy(v) for k, v in snap.items()}
    if isinstance(snap, list):
        return [snapshot_to_numpy(s) for s in snap]
    if isinstance(snap, torch.Tensor):
        return snap.cpu().numpy()
    return snap
