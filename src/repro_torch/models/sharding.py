"""Mesh context and partition-spec helpers (the JAX package's
``models/sharding.py``, without JAX).

A mesh is axis names over an array of devices: ``("data", "model")`` for
one pod, ``("pod", "data", "model")`` across pods, where the pod axis is
folded into every data-parallel spec.  The production meshes hold device
indices, not devices (``launch/mesh.py``: abstract, as
``jax.sharding.AbstractMesh`` is), so their layouts can be reckoned on one
card or none.  A spec (``P``) is the reference's ``PartitionSpec``: per
array dim an axis name, a tuple of axis names or None.  The port runs on
one card and creates no ``torch.distributed`` process group; a sharding
here only says what each device of the mesh would hold
(``NamedSharding.shard_shape``), which is what the dry-run reckons with.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


class P(tuple):
    """``PartitionSpec``: one entry per leading array dim (an axis name, a
    tuple of axis names or None; dims past the last entry are replicated).
    A one-name tuple is that name, as JAX normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Axis names over an array of devices (``torch.device``s, or device
    indices for an abstract mesh), one array dim per axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: P

    def shard_shape(self, global_shape: tuple[int, ...]) -> tuple[int, ...]:
        """Each device's block of an array of ``global_shape``: every dim
        divided by the product of its axes' sizes.  Raises ValueError for
        a dim those do not divide, as JAX does."""
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than "
                             f"{global_shape} has dims")
        sizes = self.mesh.shape
        out = []
        for i, dim in enumerate(global_shape):
            ent = self.spec[i] if i < len(self.spec) else None
            axes = () if ent is None else (
                ent if isinstance(ent, tuple) else (ent,))
            parts = math.prod(sizes[a] for a in axes)
            if dim % parts:
                raise ValueError(f"{self.spec} splits dim {i} of "
                                 f"{global_shape} {parts} ways")
            out.append(dim // parts)
        return tuple(out)


@dataclass(frozen=True)
class ShapeDtypeStruct:
    """An array that is never allocated: its shape, torch dtype and, where
    a mesh is given, its sharding (``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding | None = None

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def shard_nbytes(self) -> int:
        """Bytes one device holds: the whole array without a sharding."""
        if self.sharding is None:
            return self.nbytes
        return (math.prod(self.sharding.shard_shape(self.shape))
                * self.dtype.itemsize)


@dataclass(frozen=True)
class MeshCtx:
    mesh: Mesh

    @property
    def dp(self) -> tuple[str, ...]:
        """Data-parallel axis name(s) — includes the pod axis when present."""
        return ("pod", "data") if "pod" in self.mesh.axis_names \
            else ("data",)

    @property
    def tp(self) -> str:
        return "model"

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp)

    @property
    def tp_size(self) -> int:
        return self.mesh.shape["model"]

    def sharding(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)


def cpu_mesh_ctx() -> MeshCtx:
    """1x1 mesh over the CPU — used by tests and CPU runs."""
    return MeshCtx(Mesh([[torch.device("cpu")]], ("data", "model")))


def map_specs(fn, tree_specs):
    """``fn`` over every spec of a nested dict of specs."""
    if isinstance(tree_specs, P):
        return fn(tree_specs)
    return {k: map_specs(fn, v) for k, v in tree_specs.items()}


def logical_to_sharding(tree_specs, mctx: MeshCtx):
    return map_specs(mctx.sharding, tree_specs)
