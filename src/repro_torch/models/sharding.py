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
(``axis_index``), a sum over axes (``psum``), a tiled gather along any
dim (``all_gather``) and its transpose (``reduce_scatter``) — through plain ``torch.distributed`` calls on
groups made once per mesh, and this rank's block of a global array
under a spec (``NamedSharding.block``).  ``relayout`` turns a rank's
block under one spec into its block under another (the gathers GSPMD
inserts where a weight's storage layout is not the layout its product
takes).  The collectives run on whatever backend the caller initialised
the group with; a collective over axes of size 1 issues nothing.

``CountingMesh`` is a mesh's axis names and sizes seen from one rank's
coordinates, with no process group: its collectives return tensors of
the right shape (meta tensors too) and communicate nothing, so a step
run on it (on the meta device) counts what it would issue.

Every collective is differentiable: under autograd each is a
``torch.autograd.Function`` whose backward issues its transpose, so a
loss across ranks back-propagates through the collectives.  The
transposes follow one convention: the cotangent of a value that is the
same on every rank along an axis is the whole cotangent on each of them
(as the forward computes it there), and the cotangent of a value that
differs by rank is that rank's own.  So

* ``psum`` (partial sums made one replicated value) has the identity as
  its backward;
* ``pvary`` (the identity forward: a replicated value entering work that
  differs by rank, such as the input of a column-parallel product) sums
  the cotangents over the axes in its backward (JAX's ``pvary``);
* ``all_gather`` (a block per rank made one whole array, which the
  callers feed to work that differs by rank: an FSDP weight against this
  rank's rows) has ``reduce_scatter`` as its backward, and
  ``reduce_scatter`` ``all_gather``;
* ``all_gather_invariant`` (the same gather, its result used the same on
  every rank: the context-parallel attention's rows made the whole
  sequence again) has this rank's block of the cotangent as its backward,
  with no collective (JAX's ``all_gather_invariant``);
* ``relayout``'s local cut (``narrow``) pads its cotangent with zeros.

Every mesh counts the collectives it issued, the backward's too:
``Mesh.collectives``, the calls and the bytes this rank sent in, and
``Mesh.collective_log``, the calls and the bytes of their outputs per kind
(``"all-gather"``, ``"all-reduce"``, ``"reduce-scatter"``: the reference
dry-run's names of XLA's ops) and per axes; ``reset_collectives`` zeroes
both.
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
        self.collective_log: dict[tuple[str, tuple[str, ...]], dict] = {}

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
        size is above 1; raises on a mesh that is not one rank's view (over
        the ranks of a process group, or a counting mesh)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not self.coords:
            raise RuntimeError(f"a collective over {axes} needs a mesh over "
                               f"the ranks of a process group "
                               f"(Mesh.over_ranks) or a CountingMesh, not "
                               f"{self}")
        return tuple(a for a in axes if self.shape[a] > 1)

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major over them in the
        order given (``lax.axis_index``; over the pair ``("pod", "data")``,
        ``pod * |data| + data``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self._axes(axes)
        return self._row(self.coords, self.shape, axes)

    def _count(self, kind: str, axes: tuple[str, ...], x: torch.Tensor,
               out: torch.Tensor) -> None:
        if self.device is not None and x.device.type != self.device.type:
            raise ValueError(f"a {x.device} tensor on a mesh whose rank "
                             f"computes on {self.device}")
        self.collectives["calls"] += 1
        self.collectives["bytes"] += x.numel() * x.element_size()
        rec = self.collective_log.setdefault((kind, axes),
                                             {"calls": 0, "bytes": 0})
        rec["calls"] += 1
        rec["bytes"] += out.numel() * out.element_size()

    def reset_collectives(self) -> None:
        """Zero ``collectives`` and ``collective_log``."""
        self.collectives.update(calls=0, bytes=0)
        self.collective_log.clear()

    def collective_bytes(self) -> dict[str, int]:
        """The bytes of the issued collectives' outputs by kind (the keys
        of the reference dry-run's ``collective_bytes``)."""
        out: dict[str, int] = {}
        for (kind, _), rec in self.collective_log.items():
            out[kind] = out.get(kind, 0) + rec["bytes"]
        return out

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes`` (``lax.psum``),
        the same on each of them.  Backward: the identity (the sum is used
        replicated, so each rank's cotangent is the whole one)."""
        axes = self._axes(axes)
        if not axes:
            return x
        return _PSum.apply(x, self, axes)

    def pvary(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` itself, marked as entering work that differs by rank along
        ``axes`` (JAX's ``pvary``): no collective forward; backward, the
        ranks' cotangents summed over ``axes``."""
        axes = self._axes(axes)
        if not axes:
            return x
        return _PVary.apply(x, self, axes)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' ``x`` along ``axes`` concatenated on ``dim`` in their
        ``axis_index`` order (``lax.all_gather(..., axis=dim,
        tiled=True)``).  Backward: ``reduce_scatter`` over ``axes`` on
        ``dim``."""
        axes = self._axes(axes)
        if not axes:
            return x
        dim %= x.dim()
        return _Gather.apply(x, self, axes, dim)

    def all_gather_invariant(self, x: torch.Tensor, axes, dim: int = 0
                             ) -> torch.Tensor:
        """``all_gather`` whose result is used the same on every rank along
        ``axes``, so its cotangent is the whole one on each of them.
        Backward: this rank's block of the cotangent (a local slice, no
        collective)."""
        axes = self._axes(axes)
        if not axes:
            return x
        dim %= x.dim()
        return _GatherInvariant.apply(x, self, axes, dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes``, cut on ``dim``
        into as many blocks as they are, this rank keeping the block at
        its ``axis_index`` (``lax.psum_scatter(..., tiled=True)``; the
        transpose of ``all_gather``).  A float16 or bfloat16 ``x`` is
        summed in float32 and the block returned in its dtype, so a sum of
        many partial gradients rounds once.  Backward: ``all_gather``."""
        axes = self._axes(axes)
        if not axes:
            return x
        dim %= x.dim()
        return _Scatter.apply(x, self, axes, dim)

    # the counted collectives themselves
    def _issue_psum(self, x, axes):
        out = self._all_reduce(x, axes)
        self._count("all-reduce", axes, x, out)
        return out

    def _issue_gather(self, x, axes, dim):
        out = self._all_gather(x, axes, dim)
        self._count("all-gather", axes, x, out)
        return out

    def _issue_scatter(self, x, axes, dim):
        n = math.prod(self.shape[a] for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter over {axes} cuts dim {dim} of "
                             f"{tuple(x.shape)} {n} ways")
        wide = x.float() if x.dtype in (torch.float16, torch.bfloat16) \
            else x
        out = self._reduce_scatter(wide, axes, dim)
        self._count("reduce-scatter", axes, wide, out)
        return out.to(x.dtype)

    def _group_rows(self, axes):
        """The group over ``axes`` and each of its ranks' ``axis_index``
        over them, in the group's rank order."""
        import torch.distributed as dist
        group = self._groups[frozenset(axes)]
        ranks = dist.get_process_group_ranks(group)      # in group order
        return group, [self._row(self._coords(r), self.shape, axes)
                       for r in ranks]

    def _all_reduce(self, x: torch.Tensor, axes: tuple[str, ...]
                    ) -> torch.Tensor:
        import torch.distributed as dist
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=self._groups[frozenset(axes)])
        return x

    def _all_gather(self, x: torch.Tensor, axes: tuple[str, ...],
                    dim: int) -> torch.Tensor:
        import torch.distributed as dist
        group, rows = self._group_rows(axes)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in rows]
        dist.all_gather(parts, x.contiguous(), group=group)
        order = [None] * len(rows)
        for part, row in zip(parts, rows):
            order[row] = part
        return torch.cat(order, dim=dim)

    def _reduce_scatter(self, x: torch.Tensor, axes: tuple[str, ...],
                        dim: int) -> torch.Tensor:
        import torch.distributed as dist
        group, rows = self._group_rows(axes)
        blocks = x.chunk(len(rows), dim=dim)
        # the group's j-th rank receives the block at its axis_index
        send = torch.cat([blocks[row].reshape(-1) for row in rows])
        out = torch.empty(blocks[0].numel(), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, send, group=group)
        return out.view(blocks[0].shape)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh._issue_psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._issue_psum(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._issue_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._issue_scatter(g, ctx.axes, ctx.dim), None, None,
                None)


class _GatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.start = mesh.axis_index(axes) * x.shape[dim]
        ctx.n, ctx.dim = x.shape[dim], dim
        return mesh._issue_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._issue_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._issue_gather(g, ctx.axes, ctx.dim), None, None,
                None)


class CountingMesh(Mesh):
    """A mesh of ``shape`` seen from the rank at ``coords`` (every axis at 0
    unless given), with no process group.  Its collectives communicate
    nothing: ``psum`` returns a copy of ``x``, ``all_gather`` the
    concatenation of as many copies as the axes hold ranks and
    ``reduce_scatter`` a copy of this rank's block, so the shapes are
    right (on the meta device too), and all count as on a mesh over
    ranks, backward included.  The dry-run runs a cell's step on meta
    tensors on it to count the collectives one rank issues."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 coords: dict[str, int] | None = None):
        super().__init__(np.arange(math.prod(shape)).reshape(shape),
                         axis_names)
        self.coords = dict(coords) if coords is not None else {
            a: 0 for a in self.axis_names}
        if sorted(self.coords) != sorted(self.axis_names) or any(
                not 0 <= c < self.shape[a] for a, c in self.coords.items()):
            raise ValueError(f"coordinates {coords} off the mesh {self}")

    def _all_reduce(self, x, axes):
        return x.clone()

    def _all_gather(self, x, axes, dim):
        n = math.prod(self.shape[a] for a in axes)
        return torch.cat([x] * n, dim=dim)

    def _reduce_scatter(self, x, axes, dim):
        n = x.shape[dim] // math.prod(self.shape[a] for a in axes)
        return x.narrow(dim, self.axis_index(axes) * n, n).clone()


def _spec_axes(entry) -> tuple[str, ...]:
    """A spec entry's axes as a tuple (None: none)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: P) -> tuple[str, ...]:
    """The mesh axes ``spec`` shards its array over, in the order named."""
    return tuple(a for e in spec for a in _spec_axes(e))


def relayout(x: torch.Tensor, have: P, want: P,
             mctx: "MeshCtx") -> torch.Tensor:
    """``x``, this rank's block of an array laid out under ``have``, as its
    block under ``want``.  Every dim whose axes ``want`` does not keep is
    gathered over ``have``'s axes (one ``Mesh.all_gather`` a dim, in the
    reference's order), then cut to ``want``'s block where ``want`` splits
    it (a local slice: no collective); a dim whose axes agree is left as it
    is.  Identical layouts return ``x`` itself.  Under autograd it
    differentiates by itself: each gather's backward reduce-scatters the
    cotangent, each cut's pads it with zeros.  Raises where ``x`` is not a
    block under ``have`` or ``want`` does not divide a dim."""
    mesh = mctx.mesh
    if len(have) > x.dim() or len(want) > x.dim():
        raise ValueError(f"{have} -> {want} for a {x.dim()}-d block")
    sizes = mesh.shape
    for i in range(x.dim()):
        h = _spec_axes(have[i] if i < len(have) else None)
        w = _spec_axes(want[i] if i < len(want) else None)
        if h == w:
            continue
        if h:
            x = mesh.all_gather(x, h, dim=i)
        if w:
            parts = math.prod(sizes[a] for a in w)
            if x.shape[i] % parts:
                raise ValueError(f"{want} splits dim {i} of a block "
                                 f"{tuple(x.shape)} {parts} ways")
            n = x.shape[i] // parts
            x = x.narrow(i, mesh.axis_index(w) * n, n)
    return x


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
            axes = _spec_axes(self.spec[i] if i < len(self.spec) else None)
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
            axes = _spec_axes(self.spec[i] if i < len(self.spec) else None)
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
