"""Production mesh construction and the card's roofline figures.

``make_production_mesh`` gives the reference's 16x16 ``("data", "model")``
mesh, or 2x16x16 with a ``"pod"`` axis, as an abstract mesh: axis names
over device indices (``jax.sharding.AbstractMesh``), so the dry-run
reckons each device's share of a cell without 256 GPUs.  The card's own
mesh is ``launch.elastic.derive_mesh`` over its devices.

``rank_mesh_ctx`` lays a mesh over the ranks of the running
``torch.distributed`` process group (one process per mesh cell), which
``run_ranks`` starts: ``world`` spawned processes on one host, each
joining a group over ``tcp://localhost`` on the backend the caller
names, each running one function and handing its result back.  Inside
``with RankPool(world):`` the calls of ``run_ranks`` run on one set of
such processes, started once.
"""
from __future__ import annotations

import datetime
import math
import os
import socket
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.models.sharding import Mesh, MeshCtx


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.arange(math.prod(shape)).reshape(shape), axes)


def production_mesh_ctx(*, multi_pod: bool = False) -> MeshCtx:
    return MeshCtx(make_production_mesh(multi_pod=multi_pod))


def rank_mesh_ctx(shape: tuple[int, ...],
                  axis_names: tuple[str, ...] | None = None,
                  device=None) -> MeshCtx:
    """A mesh of ``shape`` over the ranks of the initialised process group
    (``Mesh.over_ranks``): axes ``("data", "model")``, or ``("pod",
    "data", "model")`` for three dims, unless named; this rank computes on
    ``device``, by default ``cuda:<local rank>`` (``LOCAL_RANK``, else the
    rank modulo the visible cards).  Every rank calls it alike."""
    import torch.distributed as dist
    if axis_names is None:
        axis_names = ("pod", "data", "model") if len(shape) == 3 \
            else ("data", "model")
    if device is None:
        if not dist.is_initialized():
            raise RuntimeError("rank_mesh_ctx needs an initialised "
                               "torch.distributed process group")
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else dist.get_rank()
                              % torch.cuda.device_count())
    return MeshCtx(Mesh.over_ranks(tuple(shape), tuple(axis_names), device))


def _rank_entry(rank: int, world: int, port: int, backend: str,
                timeout_s: float, call: str, results) -> None:
    import pickle

    import torch.distributed as dist
    with open(call, "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    # every rank's connections made before any rank can end and close its
    # own (a rank that returns at once would cut a peer still connecting)
    dist.barrier()
    try:
        results.put((rank, fn(rank, *args)))
    except BaseException:
        # every failing rank's own traceback: the caller's error names one
        # rank, often one that only lost its peer
        print(f"run_ranks: rank {rank} of {world} failed\n"
              f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def _pool_entry(rank: int, world: int, port: int, backend: str,
                timeout_s: float, tasks: list, results) -> None:
    import gc
    import pickle

    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    dist.barrier()
    try:
        while (call := tasks[rank].get()) is not None:
            with open(call, "rb") as f:
                sys.path[:] = pickle.load(f)
                fn, args = pickle.load(f)
            try:
                results.put((rank, True, fn(rank, *args)))
            except BaseException:
                tb = traceback.format_exc()
                print(f"run_ranks: rank {rank} of {world} failed\n{tb}",
                      file=sys.stderr, flush=True)
                results.put((rank, False, tb))
            del fn, args
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


_POOL = None


class RankPool:
    """``world`` spawned processes in one ``torch.distributed`` process
    group on ``backend``, kept for many calls: while the pool is open
    (``with RankPool(world):``) every ``run_ranks`` call of that world and
    backend runs on its ranks instead of spawning its own, so they start,
    import and first reach the device once (each fresh process pays its
    first meta-device trace and its CUDA context again).  A call reaches
    the ranks through a temporary file, as ``run_ranks``' does, with the
    caller's ``sys.path`` (which a spawned process takes at its start);
    after it each rank frees what the call left (``gc.collect``,
    ``torch.cuda.empty_cache``).  A call that fails on a rank or runs past
    its time ends every rank and closes the pool.  ``timeout_s`` is each
    collective's."""

    def __init__(self, world: int, backend: str = "gloo",
                 timeout_s: float = 1200.0):
        self.world, self.backend, self.timeout_s = world, backend, timeout_s
        self.procs = None

    def __enter__(self) -> "RankPool":
        global _POOL
        import torch.multiprocessing as mp
        if _POOL is not None:
            raise RuntimeError("a RankPool is already open")
        ctx = mp.get_context("spawn")
        self.tasks = [ctx.SimpleQueue() for _ in range(self.world)]
        self.results = ctx.SimpleQueue()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.procs = mp.spawn(_pool_entry, nprocs=self.world, join=False,
                              args=(self.world, port, self.backend,
                                    self.timeout_s, self.tasks,
                                    self.results))
        _POOL = self
        return self

    def __exit__(self, kind, *_) -> None:
        global _POOL
        _POOL = None
        if self.procs is None:
            return
        if kind is None:
            for q in self.tasks:
                q.put(None)
            deadline = time.monotonic() + 60
            while not self.procs.join(timeout=1.0) \
                    and time.monotonic() < deadline:
                pass
        for p in self.procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
        self.procs = None

    def run(self, fn, args: tuple, timeout_s: float) -> list:
        """``fn(rank, *args)`` on every rank; the results by rank."""
        import pickle
        import tempfile

        from torch.multiprocessing.spawn import ProcessException
        if self.procs is None:
            raise RuntimeError("the RankPool is closed")
        with tempfile.NamedTemporaryFile(prefix="run_ranks_", suffix=".pkl",
                                         delete=False) as call:
            pickle.dump(sys.path, call)
            pickle.dump((fn, args), call)
        got: dict = {}
        try:
            for q in self.tasks:
                q.put(call.name)
            deadline = time.monotonic() + timeout_s
            while len(got) < self.world:
                while not self.results.empty():
                    rank, ok, val = self.results.get()
                    if not ok:
                        raise RuntimeError(f"run_ranks({fn.__name__}): rank "
                                           f"{rank} failed\n{val}")
                    got[rank] = val
                if len(got) == self.world:
                    break
                if self.procs.join(timeout=0.2):
                    raise RuntimeError(f"run_ranks({fn.__name__}): the "
                                       f"pool's ranks ended")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_ranks({fn.__name__}): past "
                                       f"{timeout_s} s")
        except (RuntimeError, ProcessException) as e:
            self.__exit__(type(e))
            raise RuntimeError(str(e)) from None
        finally:
            os.unlink(call.name)
        return [got[r] for r in range(self.world)]


def run_ranks(fn, world: int, *args, backend: str = "gloo",
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes that form one
    ``torch.distributed`` process group on ``backend``; returns their
    results by rank.  ``fn`` and its arguments and results are pickled
    (``fn`` by import path).  A rank that fails, or a run past
    ``timeout_s`` (also each collective's timeout), raises here with the
    failing rank's traceback, and every process is ended.  The call
    reaches the ranks through a temporary file, not the spawn pipe: a
    spawned process reads its pipe as it unpickles, importing ``fn``'s
    modules first, so a call past the pipe's 64 KB buffer would start the
    ranks one after another (7-8 s apart on the card's host at 190 KB of
    arguments).  Inside an open ``RankPool`` of ``world`` ranks on
    ``backend`` the call runs on the pool's ranks."""
    import pickle
    import tempfile

    if _POOL is not None and (_POOL.world, _POOL.backend) == (world,
                                                              backend):
        return _POOL.run(fn, args, timeout_s)

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    results = mp.get_context("spawn").SimpleQueue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.NamedTemporaryFile(prefix="run_ranks_", suffix=".pkl",
                                     delete=False) as call:
        pickle.dump((fn, args), call)
    got: dict = {}
    try:
        procs = mp.spawn(_rank_entry, nprocs=world, join=False,
                         args=(world, port, backend, timeout_s, call.name,
                               results))
        deadline = time.monotonic() + timeout_s
        try:
            # drained as they come: a rank blocks in put() on a full pipe
            while True:
                while not results.empty():
                    rank, val = results.get()
                    got[rank] = val
                if procs.join(timeout=1.0):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_ranks({fn.__name__}): past "
                                       f"{timeout_s} s")
        except ProcessException as e:
            codes = {i: p.exitcode for i, p in enumerate(procs.processes)}
            raise RuntimeError(f"run_ranks({fn.__name__}): ranks "
                               f"[{e.error_index}] failed (exit codes by "
                               f"rank {codes}; a negative code is the "
                               f"signal that ended it)\n{e}") from None
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
    finally:
        os.unlink(call.name)
    while not results.empty():
        rank, val = results.get()
        got[rank] = val
    return [got[r] for r in range(world)]


# --- NVIDIA H100 SXM (H100 80GB HBM3 at its 700 W power limit), NVIDIA's
# data sheet: dense rates, no sparsity -------------------------------------
PEAK_FLOPS_BF16 = 989e12          # FLOP/s per card, bf16 tensor cores
HBM_BW = 3.35e12                  # bytes/s per card
NVLINK_BW = 900e9                 # bytes/s per card, 18 NVLink 4 links,
                                  # both directions summed
