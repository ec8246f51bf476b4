"""Mesh context and partition-spec helpers (the JAX package's
``models/sharding.py``, without JAX).

A mesh is axis names over an array of devices: ``("data", "model")`` for
one pod, ``("pod", "data", "model")`` across pods, where the pod axis is
folded into every data-parallel spec.  The production meshes hold device
indices, not devices (``launch/mesh.py``: abstract, as
``jax.sharding.AbstractMesh`` is), so their layouts can be reckoned on one
card or none.  A spec (``P``) is the reference's ``PartitionSpec``: per
array dim an axis name, a tuple of axis names or None.  A sharding says
what each device of the mesh holds (``NamedSharding.shard_shape``), which
is what the dry-run reckons with.

``Mesh.over_ranks`` lays a mesh over the ranks of an initialised
``torch.distributed`` process group (one process per mesh cell, rank r
at the row-major coordinates ``jax.make_mesh`` gives host device r): the
array then holds rank numbers, and the mesh gives what a ``shard_map``
body uses, by axis name — the rank's index along axes
(``axis_index``), a sum over axes (``psum``) and a tiled gather along
dim 0 (``all_gather``) — through plain ``torch.distributed`` calls on
groups made once per mesh, and this rank's block of a global array
under a spec (``NamedSharding.block``).  The collectives run on whatever
backend the caller initialised the group with; a collective over axes of
size 1 issues nothing.  Every mesh counts the collectives it issued
(``Mesh.collectives``: calls and the bytes this rank sent in).
"""
from __future__ import annotations

import itertools
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
    """Axis names over an array of devices (``torch.device``s, device
    indices for an abstract mesh, or ranks for a mesh built by
    ``over_ranks``), one array dim per axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.device_mesh = None      # the torch DeviceMesh of a rank mesh
        self.device = None           # this rank's device, on a rank mesh
        self.coords: dict[str, int] = {}
        self._groups: dict[frozenset, object] = {}
        self.collectives = {"calls": 0, "bytes": 0}

    @classmethod
    def over_ranks(cls, shape: tuple[int, ...], axis_names: tuple[str, ...],
                   device) -> "Mesh":
        """The mesh of ``shape`` over the ranks of the initialised default
        process group, whose size must be the mesh's; ``device`` is the
        device this rank computes on.  Every rank calls it with the same
        arguments: it makes the mesh's process groups, one per set of
        axes, collectively and in one order."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("Mesh.over_ranks needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a {shape} mesh over {world} ranks")
        device = torch.device(device)
        if device.type == "cuda":         # DeviceMesh keeps a device set
            torch.cuda.set_device(device)
        dm = init_device_mesh(device.type, tuple(shape),
                              mesh_dim_names=tuple(axis_names))
        mesh = cls(dm.mesh.numpy(), axis_names)
        mesh.device_mesh, mesh.device = dm, device
        rank = dist.get_rank()
        mesh.coords = mesh._coords(rank)
        for name in mesh.axis_names:
            mesh._groups[frozenset((name,))] = dm.get_group(name)
        mesh._groups[frozenset(mesh.axis_names)] = dist.group.WORLD
        for n in range(2, len(mesh.axis_names)):
            for axes in itertools.combinations(mesh.axis_names, n):
                for ranks in mesh._partition(axes):
                    group = dist.new_group(ranks)
                    if rank in ranks:
                        mesh._groups[frozenset(axes)] = group
        return mesh

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    # --- what a shard_map body uses, on a mesh over ranks ----------------

    def _coords(self, rank: int) -> dict[str, int]:
        return dict(zip(self.axis_names, (
            int(c) for c in np.argwhere(self.devices == rank)[0])))

    @staticmethod
    def _row(coords: dict[str, int], shape: dict[str, int],
             axes: tuple[str, ...]) -> int:
        row = 0
        for a in axes:
            row = row * shape[a] + coords[a]
        return row

    def _partition(self, axes: tuple[str, ...]) -> list[list[int]]:
        """The ranks grouped by their coordinates off ``axes``: one sorted
        list per group of ranks a collective over ``axes`` spans."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in dims]
        moved = np.moveaxis(self.devices, rest + dims,
                            range(len(self.axis_names)))
        flat = moved.reshape(-1, math.prod(self.devices.shape[i]
                                           for i in dims))
        return [sorted(int(r) for r in row) for row in flat]

    def _axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple of names) as the tuple of those whose
        size is above 1; raises off a mesh over ranks."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.device_mesh is None:
            raise RuntimeError(f"a collective over {axes} needs a mesh over "
                               f"the ranks of a process group "
                               f"(Mesh.over_ranks), not {self}")
        return tuple(a for a in axes if self.shape[a] > 1)

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major over them in the
        order given (``lax.axis_index``; over the pair ``("pod", "data")``,
        ``pod * |data| + data``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self._axes(axes)
        return self._row(self.coords, self.shape, axes)

    def _count(self, x: torch.Tensor) -> None:
        if x.device.type != self.device.type:
            raise ValueError(f"a {x.device} tensor on a mesh whose rank "
                             f"computes on {self.device}")
        self.collectives["calls"] += 1
        self.collectives["bytes"] += x.numel() * x.element_size()

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes`` (``lax.psum``),
        the same on each of them."""
        import torch.distributed as dist
        axes = self._axes(axes)
        if not axes:
            return x
        self._count(x)
        x = x.clone()
        dist.all_reduce(x, group=self._groups[frozenset(axes)])
        return x

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The ranks' ``x`` along ``axes`` concatenated on dim 0 in their
        ``axis_index`` order (``lax.all_gather(..., tiled=True)``)."""
        import torch.distributed as dist
        axes = self._axes(axes)
        if not axes:
            return x
        self._count(x)
        group = self._groups[frozenset(axes)]
        ranks = dist.get_process_group_ranks(group)      # in group order
        parts = [torch.empty_like(x) for _ in ranks]
        dist.all_gather(parts, x.contiguous(), group=group)
        order = [None] * len(ranks)
        for part, r in zip(parts, ranks):
            order[self._row(self._coords(r), self.shape, axes)] = part
        return torch.cat(order, dim=0)


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

    def index(self, global_shape: tuple[int, ...]) -> tuple[slice, ...]:
        """This rank's block of an array of ``global_shape`` as one slice
        per dim: the dim cut into ``shard_shape``'s blocks, the rank's
        ``axis_index`` over the dim's axes picking one."""
        block = self.shard_shape(global_shape)
        out = []
        for i, n in enumerate(block):
            ent = self.spec[i] if i < len(self.spec) else None
            axes = () if ent is None else (
                ent if isinstance(ent, tuple) else (ent,))
            start = self.mesh.axis_index(axes) * n if axes else 0
            out.append(slice(start, start + n))
        return tuple(out)

    def block(self, x):
        """This rank's block of the global array ``x`` (a tensor or a numpy
        array; a view)."""
        return x[self.index(tuple(x.shape))]


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
