"""Dry-run: lay every (architecture x input-shape) cell out on the
production meshes and count its step, with no array allocated.

The reference lowers and compiles each cell's jitted step on 256 or 512
forced host devices and reads XLA's analyses.  The port has no compiler
between it and the card, so here lowering a cell (``lower_cell``) is
(1) the step's abstract inputs and outputs, ShapeDtypeStruct trees
sharded on the mesh (``models.model.abstract_*``), and (2) a run of the
port's own step on the meta device under
``torch.utils.flop_counter.FlopCounterMode``.  It answers the two
questions the reference asks of ``compiled``:

* ``memory_analysis()``: per-device argument and output bytes, each
  leaf's ``NamedSharding.shard_shape``.  Arguments are the reference's
  trees: parameters, AdamW moments (``opt_dtype``) and the batch for a
  train cell; parameters and the batch for prefill; parameters, the
  decode cache and the tokens for decode (``t`` is a host int in the
  port: the reference's 4-byte scalar is not counted).  Outputs:
  parameters, moments and the two float32 metrics (train); the float32
  logits [B, padded vocab] and the caches the step returns (prefill:
  every position's slot; decode: the cache it was given).  A batch the
  data axes do not divide (``long_500k``'s 1) replicates the cache and
  the logits over them (``drop_dp_axes``).  Temp and peak bytes are None:
  no compiler states them (``chip_smoke.py`` phase 11 measures a step's
  peak on the card).
* ``cost_analysis()``: ``flops``, the GLOBAL count of the whole step (one
  device running it alone; split evenly, each device of a mesh does
  ``flops / n_devices``).  FlopCounterMode counts every product of the
  meta run.  Attention is counted from the mask's attended keys by the
  formulas of the operators the wrappers' meta branch calls
  (``kernels/flash_attn/ops.py``, ``kernels/decode_attn/ops.py``; the
  plain path would count a full S x S product, and the counter cannot
  see the card's ctypes launches).  The
  MoE expert block runs over its [E, cap, d] buffer whatever the
  routing, so it is counted at capacity (``cap = max(1, ceil(n * top_k *
  capacity_factor / E))`` slots per expert and layer call): from top-k
  and capacity, not from the routed tokens.  Elementwise work is not
  counted.
* Collective bytes: None.  On one card there are none; a 16x16 step's
  wait for the multi-GPU round (the reference parses them from XLA's HLO
  text, which PyTorch does not have).

The train step is the port's ``make_train_step``: autograd through the
attention wrapper's meta branch, ``torch.utils.checkpoint`` per layer
(``cfg.remat``) and the in-place AdamW, all on meta.  The decode step runs
at ``t = seq_len - 1`` (a full cache).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
      [--both-meshes]

``--all`` spreads its cells over worker processes (``sweep``), the meshes
of one cell in one worker, which traces the cell once.

``--execute`` (on the card) then runs each prefill or decode cell on the
card's 1x1 mesh (``execute_cell``): its arguments allocated from a seed
(parameters by the model's init, the cache drawn N(0, 1), token ids
uniform), held to the dry-run's argument bytes, a warm-up step and
``EXECUTE_STEPS`` timed steps, their peak and median wall time.  A cell
whose step does not fit fails with the card's out-of-memory error.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import multiprocessing
import os
import statistics
import time
import traceback
from dataclasses import dataclass

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (applicable_shapes, get_config, get_shape,
                                 list_archs)
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.launch.elastic import derive_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import hybrid
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.model import (abstract_batch, abstract_cache,
                                      abstract_params, drop_dp_axes,
                                      get_model)
from repro_torch.models.moe import cdiv
from repro_torch.models.sharding import MeshCtx, P, ShapeDtypeStruct
from repro_torch.train.optimizer import AdamWConfig, opt_state_specs
from repro_torch.train.train_step import (make_prefill_step, make_serve_step,
                                          make_train_step)
from repro_torch.train.tree import leaves, tree_map

MAX_WORKERS = 8
# timed steps of an executed cell, whose median is its wall time (a decode
# step is host-bound, and its host time varies from step to step)
EXECUTE_STEPS = 5
# the attention wrappers' meta operators, whose registered formulas count
# the mask's attended keys
ATTENTION_OPS = (torch.ops.repro_torch.attention_meta,
                 torch.ops.repro_torch.attention_meta_grad,
                 torch.ops.repro_torch.decode_meta)
_NOT_STATED = "no compiler states it; chip_smoke.py phase 11 measures it"


@dataclass(frozen=True)
class MemoryAnalysis:
    """Per-device bytes of a cell's arguments and outputs."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int | None = None
    peak_memory_in_bytes: int | None = None


def _sds(shape, dtype, mctx: MeshCtx | None, spec: P) -> ShapeDtypeStruct:
    return ShapeDtypeStruct(tuple(shape), dtype,
                            None if mctx is None else mctx.sharding(spec))


def _like(tree, dtype, mctx: MeshCtx | None, specs):
    """``tree``'s shapes in ``dtype`` with ``specs`` (a spec tree of its
    structure)."""
    if isinstance(tree, dict):
        return {k: _like(v, dtype, mctx, None if specs is None else specs[k])
                for k, v in tree.items()}
    return _sds(tree.shape if isinstance(tree, ShapeDtypeStruct) else tree,
                dtype, mctx, specs)


def prefill_cache_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The caches a prefill over ``seq_len`` positions returns: every
    position's slot, whatever the window or chunk (the reference's)."""
    if cfg.family in tfm.DECODER_FAMILIES:
        return tfm.kv_shapes(cfg, batch, seq_len)
    if cfg.family == "hybrid":
        return hybrid._cache_tree(cfg, batch, seq_len)
    return get_model(cfg).cache_shapes(cfg, batch, seq_len)


def _cell(cfg: ArchConfig, shape: ShapeConfig, mctx: MeshCtx | None):
    """(step name, step, arguments, outputs): the arguments and outputs
    as ShapeDtypeStruct trees (sharded on ``mctx`` when given), the step
    taking the arguments as tensors."""
    model = get_model(cfg)
    params = abstract_params(cfg, mctx)
    pspecs = None if mctx is None else model.param_specs(cfg, mctx)
    b = shape.global_batch
    dp_ok = mctx is None or b % mctx.dp_size == 0
    dp = mctx.dp if mctx is not None and dp_ok else None
    scalar = _sds((), torch.float32, mctx, P())

    if shape.kind == "train":
        ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
        ospecs = {"m": None, "v": None} if mctx is None \
            else opt_state_specs(pspecs)
        odt = getattr(torch, cfg.opt_dtype)
        opt = {"m": _like(params, odt, mctx, ospecs["m"]),
               "v": _like(params, odt, mctx, ospecs["v"]),
               "step": _sds((), torch.int32, mctx, P())}
        args = (params, opt, abstract_batch(cfg, shape, mctx))
        outs = (params, opt, {"grad_norm": scalar, "loss": scalar})
        return "train_step", make_train_step(cfg, ocfg), args, outs

    cdt = getattr(torch, cfg.compute_dtype)
    cspecs = None
    if mctx is not None:
        cspecs = model.cache_specs(cfg, mctx, shape.seq_len)
        if not dp_ok:
            cspecs = drop_dp_axes(cspecs, mctx)
    logits = _sds((b, cfg.padded_vocab), torch.float32, mctx,
                  P(dp, "model"))

    if shape.kind == "prefill":
        caches = _like(prefill_cache_shapes(cfg, b, shape.seq_len), cdt,
                       mctx, cspecs)
        args = (params, abstract_batch(cfg, shape, mctx))
        return "prefill_step", make_prefill_step(cfg), args, (logits, caches)

    caches = abstract_cache(cfg, shape, mctx)
    args = (params, caches, abstract_batch(cfg, shape, mctx)["tokens"])
    serve = make_serve_step(cfg)

    def serve_step(params, caches, tokens):
        return serve(params, caches, tokens, shape.seq_len - 1)

    return "serve_step", serve_step, args, (logits, caches)


def _bytes(tree) -> int:
    return sum(leaf.shard_nbytes for _, leaf in leaves(tree))


def _meta(tree):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def moe_capacity(cfg: ArchConfig, shape: ShapeConfig) -> int | None:
    """Slots per expert of one MoE layer call at ``shape``'s token count
    (the routing's capacity bound); None without experts."""
    if not cfg.num_experts:
        return None
    n = shape.global_batch * (1 if shape.kind == "decode"
                              else shape.seq_len)
    return max(1, cdiv(int(n * cfg.top_k * cfg.capacity_factor),
                       cfg.num_experts))


@functools.lru_cache(maxsize=2)
def _count(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Run the cell's step once on the meta device under FlopCounterMode
    and check its outputs against the abstract ones."""
    _, step, args, outs = _cell(cfg, shape, None)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        got = step(*_meta(args))
    want = [(p, s.shape, s.dtype) for p, s in leaves(outs)]
    have = [(p, tuple(t.shape), t.dtype) for p, t in leaves(got)]
    if have != want:
        raise AssertionError(f"{cfg.name} x {shape.name}: the step returned "
                             f"{have}, the abstract outputs say {want}")
    counts = counter.get_flop_counts()["Global"]
    attention = sum(counts.get(op, 0) for op in ATTENTION_OPS)
    return {"flops": float(counter.get_total_flops()),
            "attention_flops": float(attention),
            "trace_s": time.perf_counter() - t0}


class Lowered:
    """One cell's step (taking the arguments as tensors) and its abstract
    arguments and outputs on a mesh."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, mctx: MeshCtx):
        self.cfg, self.shape = cfg, shape
        self.step_name, self.step, self.args, self.outputs = _cell(
            cfg, shape, mctx)

    def memory_analysis(self) -> MemoryAnalysis:
        return MemoryAnalysis(_bytes(self.args), _bytes(self.outputs))

    def cost_analysis(self) -> dict:
        """{"flops", "attention_flops", "trace_s"}: global, from the meta
        run (once per cell and process)."""
        return dict(_count(self.cfg, self.shape))


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mctx: MeshCtx):
    """The cell's lowering and its step's name."""
    lowered = Lowered(cfg, shape, mctx)
    return lowered, lowered.step_name


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mctx = MeshCtx(mesh)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "step": None, "ok": False}
    t0 = time.time()
    try:
        lowered, step_name = lower_cell(cfg, shape, mctx)
        rec["step"] = step_name
        t1 = time.time()
        cost = lowered.cost_analysis()
        t2 = time.time()
        mem = lowered.memory_analysis()
        rec.update(
            ok=True,
            lower_s=round(t1 - t0, 1), compile_s=round(t2 - t1, 1),
            flops=cost["flops"], flops_scope="global",
            attention_flops=cost["attention_flops"],
            bytes_accessed=None,
            argument_bytes=mem.argument_size_in_bytes,
            output_bytes=mem.output_size_in_bytes,
            temp_bytes=None, peak_bytes_per_device=None,
            not_stated=_NOT_STATED,
            collective_bytes=None, collective_bytes_total=None,
            collectives="none on one card; a mesh's wait for the "
                        "multi-GPU round",
            n_devices=mesh.size,
        )
        if cfg.num_experts:
            rec["moe"] = {"experts": cfg.num_experts, "top_k": cfg.top_k,
                          "capacity": moe_capacity(cfg, shape),
                          "counted": "expert block at capacity, not "
                                     "routed tokens"}
        if verbose:
            print(f"[ok] {arch} x {shape_name} ({rec['mesh']}, {step_name}) "
                  f"lower={rec['lower_s']}s trace={rec['compile_s']}s")
            print(f"     memory_analysis: args={rec['argument_bytes']:,} "
                  f"out={rec['output_bytes']:,} (per device)")
            print(f"     cost_analysis: flops={rec['flops']:.3e} (global; "
                  f"attention {rec['attention_flops']:.3e})", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} ({rec['mesh']}): "
                  f"{rec['error'][:400]}")
            traceback.print_exc()
    return rec


def requested_bytes() -> int:
    """Bytes the caching allocator was asked for and holds now (before
    its rounding to blocks)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _draw(tree, gen: torch.Generator, device, vocab: int):
    """Tensors for a ShapeDtypeStruct tree: integer leaves uniform token
    ids, floating leaves N(0, 1)."""
    def one(s):
        if s.dtype.is_floating_point:
            return torch.randn(s.shape, dtype=s.dtype, device=device,
                               generator=gen)
        return torch.randint(0, vocab, s.shape, dtype=s.dtype,
                             device=device, generator=gen)
    return tree_map(one, tree)


def execute_cell(cfg: ArchConfig, shape: ShapeConfig, *,
                 seed: int = 0) -> dict:
    """Run one prefill or decode cell on the card's 1x1 mesh: the
    arguments allocated (the bytes asked of the allocator must equal the
    dry-run's argument bytes), then a warm-up step and ``EXECUTE_STEPS``
    timed steps on them (a decode step at ``t = seq_len - 1`` writes the same
    slot each time), finite logits, the same launches each step.  Returns
    the argument bytes (dry-run, requested, allocated), the timed steps'
    peak memory, their median wall ms (each step's and the warm-up's too)
    and one step's attention launches."""
    if shape.kind == "train":
        raise NotImplementedError("execute_cell runs prefill and decode "
                                  "cells")
    mctx = derive_mesh(1)
    device = mctx.mesh.devices[0, 0]
    lowered, step_name = lower_cell(cfg, shape, mctx)
    want = lowered.memory_analysis().argument_size_in_bytes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    req0, alloc0 = requested_bytes(), torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init(cfg, gen)
    args = (params, *_draw(lowered.args[1:], gen, device, cfg.vocab_size))
    torch.cuda.synchronize()
    got = [(p, tuple(t.shape), t.dtype) for p, t in leaves(args)]
    if got != [(p, s.shape, s.dtype) for p, s in leaves(lowered.args)]:
        raise AssertionError(f"{cfg.name} x {shape.name}: the allocated "
                             f"arguments are not the abstract ones")
    rec = {"arch": cfg.name, "shape": shape.name, "step": step_name,
           "argument_bytes": want,
           "requested_bytes": requested_bytes() - req0,
           "allocated_bytes": torch.cuda.memory_allocated() - alloc0}
    if rec["requested_bytes"] != want:
        raise AssertionError(f"{cfg.name} x {shape.name}: allocated "
                             f"{rec['requested_bytes']:,} bytes of "
                             f"arguments, the dry-run says {want:,}")
    walls, launches = [], []
    for i in range(1 + EXECUTE_STEPS):  # the first warms the libraries
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        before = (flash_ops.launches, decode_ops.launches)
        t0 = time.perf_counter()
        logits = lowered.step(*args)[0]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append({
            "flash_attention": flash_ops.launches - before[0],
            "decode_attention": decode_ops.launches - before[1]})
        if tuple(logits.shape) != (shape.global_batch, cfg.padded_vocab) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} x {shape.name}: logits of "
                                 f"shape {tuple(logits.shape)}, not all "
                                 f"finite")
        del logits
    if any(n != launches[0] for n in launches):
        raise AssertionError(f"{cfg.name} x {shape.name}: the steps "
                             f"launched {launches}")
    rec.update(first_step_ms=walls[0], wall_ms=statistics.median(walls[1:]),
               step_ms=walls[1:],
               peak_bytes=torch.cuda.max_memory_allocated(),
               launches=launches[0])
    del args, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _cell_records(arch: str, shape_name: str, multi_pods: tuple,
                  verbose: bool) -> list[dict]:
    return [run_cell(arch, shape_name, multi_pod=mp, verbose=verbose)
            for mp in multi_pods]


def _worker_init() -> None:
    torch.set_num_threads(1)


def sweep(cells: list[tuple[str, str]], multi_pods=(False,), *,
          verbose: bool = True, workers: int | None = None) -> list[dict]:
    """``run_cell`` for every (arch, shape) of ``cells`` on every mesh of
    ``multi_pods``, in that order; the cells spread over up to
    ``workers`` spawned processes (default: the CPUs, at most
    ``MAX_WORKERS``), train cells (the longest traces) first."""
    jobs = [(arch, sh, tuple(multi_pods), verbose) for arch, sh in cells]
    n = min(len(jobs), workers or min(os.cpu_count() or 1, MAX_WORKERS))
    if n <= 1:
        return [r for job in jobs for r in _cell_records(*job)]
    order = sorted(range(len(jobs)),
                   key=lambda i: get_shape(jobs[i][1]).kind != "train")
    with multiprocessing.get_context("spawn").Pool(
            n, initializer=_worker_init) as pool:
        done = pool.starmap(_cell_records, [jobs[i] for i in order],
                            chunksize=1)
    by_job = dict(zip(order, done))
    return [r for i in range(len(jobs)) for r in by_job[i]]


def all_cells() -> list[tuple[str, str]]:
    return [(arch, sh) for arch in list_archs()
            for sh in applicable_shapes(get_config(arch))]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--execute", action="store_true",
                    help="then run each prefill / decode cell on the card "
                         "(1x1 mesh): argument bytes, peak, wall ms")
    args = ap.parse_args()

    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    records = sweep(cells, meshes)
    n_ok = sum(r["ok"] for r in records)
    print(f"\n{n_ok}/{len(records)} cells passed")
    if args.execute:
        for arch, sh in cells:
            if get_shape(sh).kind != "train":
                rec = execute_cell(get_config(arch), get_shape(sh))
                print(json.dumps({"executed": rec}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    if n_ok != len(records):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
