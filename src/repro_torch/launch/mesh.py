"""Production mesh construction and the card's roofline figures.

``make_production_mesh`` gives the reference's 16x16 ``("data", "model")``
mesh, or 2x16x16 with a ``"pod"`` axis, as an abstract mesh: axis names
over device indices (``jax.sharding.AbstractMesh``), so the dry-run
reckons each device's share of a cell without 256 GPUs.  The card's own
mesh is ``launch.elastic.derive_mesh`` over its devices.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.models.sharding import Mesh, MeshCtx


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.arange(math.prod(shape)).reshape(shape), axes)


def production_mesh_ctx(*, multi_pod: bool = False) -> MeshCtx:
    return MeshCtx(make_production_mesh(multi_pod=multi_pod))


# --- NVIDIA H100 SXM (H100 80GB HBM3 at its 700 W power limit), NVIDIA's
# data sheet: dense rates, no sparsity -------------------------------------
PEAK_FLOPS_BF16 = 989e12          # FLOP/s per card, bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s per card
NVLINK_BW = 900e9                 # bytes/s per card, 18 NVLink 4 links,
                                  # both directions summed
