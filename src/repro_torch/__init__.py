"""PyTorch/CUDA port of the Justin autoscaling system.

Mirrors the layout of the JAX package ``repro`` module for module: the
streaming engine, the columnar LSM state store, the DS2/Justin policies
and the controller, with the store's two hot spots (sorted-run probes and
weight segment sums) served by hand-written CUDA kernels for Hopper
(``repro_torch/csrc``).

Device rule: every public entry point (``StreamEngine``, ``LSMStore``,
``AutoScaler`` through its engine) runs on ``cuda`` unless the caller
passes ``device="cpu"``.  With no device given and no CUDA present they
raise; nothing falls back to the CPU on its own.  On a CPU tensor each
kernel wrapper runs its plain PyTorch version, on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda`` — which must then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless device='cpu' is passed, "
                "and no CUDA device is available")
        return torch.device("cuda")
    return torch.device(device)
