"""Elastic mesh derivation: rebuild the largest usable (data, model) mesh
from whatever devices survive a failure, and restart from the latest
checkpoint (checkpoints store unsharded leaves, so restoring onto another
device count only lays the leaves out anew — see train/checkpoint.py).

Policy: keep the model axis at the largest power of two that still fits
(TP degree is dictated by model size, not device count), and give every
remaining device to the data axis.  Stragglers and partial pods therefore
cost data-parallel throughput, never correctness.  One H100 is the 1x1
mesh over ``cuda:0``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.sharding import Mesh, MeshCtx


def derive_mesh(n_devices: int, *, model_parallel: int = 16,
                devices=None) -> MeshCtx:
    """Largest (data, model) mesh from ``n_devices`` survivors: the
    ``devices`` given (all of them, as in the reference), or else the
    first ``n_devices`` of the card's ``cuda:i`` devices, which must then
    exist."""
    if devices is None:
        resolve_device()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())][:n_devices]
    devices = list(devices)
    tp = min(model_parallel, len(devices))
    while len(devices) % tp:
        tp //= 2
    dp = len(devices) // tp
    grid = np.empty((dp, tp), dtype=object)
    for i, dev in enumerate(devices[:dp * tp]):
        grid[divmod(i, tp)] = dev
    return MeshCtx(Mesh(grid, ("data", "model")))


def elastic_restart_plan(old_devices: int, surviving: int,
                         *, model_parallel: int = 16) -> dict:
    """What a controller does on failure: derive the new mesh, report the
    throughput hit, and point at the restore path."""
    tp = min(model_parallel, surviving)
    while surviving % tp:
        tp //= 2
    dp = surviving // tp
    used = dp * tp
    return {
        "surviving": surviving,
        "mesh": (dp, tp),
        "devices_used": used,
        "devices_idle": surviving - used,
        "throughput_fraction": used / old_devices,
        "action": "restore latest committed checkpoint with new in_shardings",
    }
