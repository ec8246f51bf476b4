"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python chip_smoke.py                      # every phase, all 4 episodes
    python chip_smoke.py --profile            # also torch.profiler passes

Phases, each printing JSON lines:

1. device — the card, and ``nvidia-smi``'s name and power limit;
2. build  — compiles ``src/repro_torch/csrc/*.cu`` with nvcc and prints
   what ``ptxas -v`` reports per kernel (registers, shared memory, spills);
3. kernels — each hand-written kernel against its plain PyTorch version on
   the card over an edge-case sweep and at the main path's shapes (for
   the store kernels also at the median shapes of their call sites in a
   q8_justin episode: the ``sites`` list of their lines), with
   CUDA-event device times (L2 emptied first) of the kernel, the plain
   version and the one PyTorch library call that computes the same
   function, the kernel's time with its inputs in L2, the wrapper's cost
   per call on the host clock, the bound on this run's data (bytes, or
   tensor-core operations for prefill attention), the share of it the
   kernel reaches and its achieved TB/s or TFLOP/s;
4. episodes — the golden autoscaling episodes (q8/q11 x justin/ds2, seed
   3, max_level 2, the reference's full sizes) through the port on the
   card, compared decision for decision with
   ``tests/data/golden_autoscale.json``; kernel launch counts are reset
   just before each episode and read just after, and an episode that
   launched a kernel of its path no time fails;
5. serve — ``repro_torch.launch.serve.serve("llama3.2-3b", reduced=False)``
   on the card at full width: 8 requests of 2,048 prompt tokens, 128
   greedy decode steps; the attention kernels' launch counts are reset
   just before and must be 28 per prefill and 28 per decode step.  Then
   the decode step at position 2,048 is held against a prefill over the
   prompt plus that token (2 requests, max|diff|/max|ref| < 0.03);
6. scenarios — the reconfiguration-pricing, dynamic-scenario and
   shared-cluster layer on the card at the reference's sizes: (a) q8
   justin vs threshold under a savepoint cost model (3 vs 4 steps,
   threshold pays more downtime), (b) q11 under a load spike with a
   straggler and a killed task, traced, the trace passed through
   ``tools/check_trace.py``, (c) the ds2/justin q11 pair on one shared-TM
   cluster under preemption, (d) sampled fleets of 32 tenants x 6 windows
   and 128 x 20.  Each run is held exactly against
   ``tests/data/torch_scenarios.json`` (the reference's answers), (c) and
   (d) also scalar driver against vectorized; each prints its wall
   seconds, store-kernel launches (reset just before; none fails) and
   peak device memory.

Any mismatch or exception exits non-zero; only after every phase passed
are the kernel table, the ``nvidia-smi`` line and the final
``{"ok": true, ...}`` line printed.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden_autoscale.json"
OUT = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores (data sheet)
F32_TOL = dict(rtol=1e-5, atol=1e-4)   # atomic f32 sums, order varies
# attention, checked per output vector (one (b, head, query) row over D):
# max|got - want| <= rel * max|want| + atol.  f32 sums differ from the
# plain version's only in order.  bf16: both round the output to bf16 and
# the flash kernel rounds the probabilities to bf16 for the tensor-core
# product, so a vector may land up to two bf16 steps of its largest
# element (2^-6 of it) away; a vector that has lost or gained a few keys
# moves further (most vectors of the serve shapes even for one key)
ATTN_TOL = {"float32": dict(rel=0.0, atol=1e-5),
            "bfloat16": dict(rel=2.0 ** -6, atol=1e-6)}
ARCH = "llama3.2-3b"
SERVE = dict(requests=8, prompt_len=2048, decode=128)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


SECTOR = 32                        # bytes per L2 sector, the unit HBM serves
SPIN_CYCLES = 4_000_000            # ~2 ms of device spin, see device_ms


def device_ms(fn, cold: bool, reps: int = 30) -> float:
    """Device ms per call of ``fn``, between CUDA events, median of ``reps``.

    Every measurement starts with a spin kernel that keeps the card busy
    while the host queues the events and the calls, so the events bracket
    device work and not the host's launch rate.  ``cold``: one call per
    measurement, after a 256 MiB write that evicts the 50 MB L2, so the
    inputs come from HBM (the regime ``bound_ms`` assumes).  Otherwise 50
    back-to-back calls per measurement with the inputs left in L2.
    A ``fn`` that synchronises with the host is charged its idle gap."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    calls = 1 if cold else 50
    per = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / calls)
    return statistics.median(per)


def call_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """Host-clock ms per call of ``fn`` over back-to-back calls ending in a
    synchronise: what a caller pays per call, host work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(per)


def probe_bytes(table, q, pos) -> int:
    """Bytes the probe must move on this data: each query read, each
    position and flag written, and the table sectors that hold each
    query's neighbours table[pos-1] and table[pos] (a rank is not known
    without them)."""
    import torch
    t, n, w = len(table), len(q), table.element_size()
    p = pos.long()
    near = torch.cat([p[p > 0] - 1, p[p < t]])
    return n * (q.element_size() + 4 + 1) \
        + len(torch.unique(near * w // SECTOR)) * SECTOR


def add_rates(res: dict, amount: float, unit: str) -> dict:
    """Add the share of the bound that ``ms`` reaches and the rate it
    achieves: ``amount`` bytes (unit TB/s) or FLOP (TFLOP/s) per call."""
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["achieved"] = amount / res["ms"] * 1e3 / 1e12
    res["achieved_unit"] = unit
    return res


# ------------------------------------------------------------ sorted_probe
# the parts each step of a route cuts a range into: the cooperative
# route's 33, the indexed route's 513 (splitters + 1)
PROBE_PARTS = (33, 513)


def probe_cases(torch, dev):
    """(label, table, queries) covering the edge cases and the main path,
    and for the routes: tables of P^m +- 1 entries for the parts P a step
    of each route cuts its range into, batches smaller than a warp,
    unsorted queries with repeats against a small and a large table, and
    the dtype's min and max."""
    g = torch.Generator(device="cpu").manual_seed(11)
    cases = []
    for dt in (torch.int32, torch.int64):
        info = torch.iinfo(dt)
        lo, hi = info.min, info.max

        def t(x):
            return torch.as_tensor(x, dtype=dt).to(dev)

        base = torch.unique(torch.randint(0, 1 << 30, (100_003,),
                                          generator=g)).to(dt)
        q = torch.cat([base[torch.randint(0, len(base), (35_001,),
                                          generator=g)],
                       torch.randint(0, 1 << 30, (35_000,),
                                     generator=g).to(dt)])
        cases.append((f"{dt}:random T={len(base)} N={len(q)}",
                      base.to(dev), q.to(dev)))
        cases.append((f"{dt}:off-tile T=2049 N=513",
                      t(list(range(0, 2049 * 3, 3))),
                      t(torch.randint(0, 2049 * 3 + 5, (513,), generator=g))))
        cases.append((f"{dt}:dtype max absent", t([0, 17, 99]),
                      t([hi, 0, hi, 17, 100])))
        cases.append((f"{dt}:dtype max present", t([0, 17, hi]),
                      t([0, 1, hi, hi - 1])))
        cases.append((f"{dt}:dtype min and max present", t([lo, 0, hi]),
                      t([lo, lo + 1, hi, hi - 1, 0, -1])))
        cases.append((f"{dt}:dtype min and max absent", t([lo + 1, hi - 1]),
                      t([hi, lo, lo + 1, hi - 1, lo + 2])))
        cases.append((f"{dt}:empty table", t([]), t([1, 2, hi])))
        cases.append((f"{dt}:one entry", t([42]), t([41, 42, 43, hi])))
        cases.append((f"{dt}:duplicate queries", t(list(range(0, 1000, 7))),
                      t([700] * 2048 + [701] * 3)))
        cases.append((f"{dt}:duplicate table entries", t([5, 5, 5, 9, 9]),
                      t([5, 7, 9, 10])))
        cases.append((f"{dt}:exact tile multiple",
                      t(list(range(0, 2048 * 3, 3))),
                      t(list(range(1, 512 * 3, 3)))))
        # T = P^m +- 1: the steps end exactly on a boundary
        for parts in PROBE_PARTS:
            for m in (1, 2, 3):
                if parts ** m > 300_000:
                    continue
                for dlt in (-1, 0, 1):
                    size = parts ** m + dlt
                    tab = torch.sort(torch.randint(0, 4 * size, (size,),
                                                   generator=g)).values
                    qs = torch.cat([tab[torch.randint(0, size, (300,),
                                                      generator=g)],
                                    torch.randint(-2, 4 * size + 3, (300,),
                                                  generator=g)])
                    cases.append((f"{dt}:T={parts}^{m}{dlt:+d} N=600",
                                  tab.to(dt).to(dev), qs.to(dt).to(dev)))
        # fewer queries than a warp's lanes
        big = torch.unique(torch.randint(0, 1 << 30, (20_001,),
                                         generator=g)).to(dt)
        for nq in (1, 3, 7):
            cases.append((f"{dt}:N={nq} T={len(big)}", big.to(dev),
                          big[torch.randint(0, len(big), (nq,),
                                            generator=g)].to(dev)))
        # unsorted queries with repeats, against the inverse map's table
        # size (T=465) and a large one
        for size in (465, 60_000):
            tab = torch.unique(torch.randint(0, 1 << 29, (size,),
                                             generator=g)).to(dt)
            qs = torch.cat([tab[torch.randint(0, len(tab), (700,),
                                              generator=g)],
                            torch.randint(0, 1 << 29, (200,),
                                          generator=g).to(dt)])
            qs = qs[torch.randperm(len(qs), generator=g)]
            cases.append((f"{dt}:unsorted N={len(qs)} T={len(tab)}",
                          tab.to(dev), qs.to(dev)))
    # int64 only: high-bit keys and the packed (i << 45) | key memtable probe
    high = torch.unique(torch.randint(1 << 40, 1 << 62, (50_001,),
                                      generator=g) * 2 + 1)
    high = torch.cat([high, torch.tensor([(1 << 63) - 1])])
    hq = torch.cat([high[::3], high[::5] - 1,
                    torch.tensor([(1 << 63) - 2, (1 << 63) - 1, -(1 << 63)])])
    cases.append(("int64:high-bit keys", high.to(dev), hq.to(dev)))
    runs = [torch.unique(torch.randint(0, 1 << 45, (3_001 + 7 * i,),
                                       generator=g)) for i in range(9)]
    packed = torch.cat([(i << 45) + r for i, r in enumerate(runs)])
    uq = torch.unique(torch.cat([runs[0][:500], runs[8][-400:],
                                 torch.randint(0, 1 << 45, (900,),
                                               generator=g)]))
    qq = ((torch.arange(9)[:, None] << 45) + uq[None, :]).reshape(-1)
    cases.append(("int64:packed (i<<45)|key", packed.to(dev), qq.to(dev)))
    return cases


def probe_routes(table) -> list:
    """The routes (lanes per query) a table can take: the cooperative one,
    and the indexed one for a table of one entry or more."""
    return [32, 1] if len(table) else [32]


def probe_check(torch, table, q, got, label: str) -> None:
    """Raise unless (pos, found) ``got`` equals the plain version's."""
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref
    if len(table):
        rpos, rfound = sorted_probe_ref(table, q)
    else:
        rpos = torch.zeros(len(q), dtype=torch.int32, device=q.device)
        rfound = torch.zeros(len(q), dtype=torch.bool, device=q.device)
    pos, found = got
    if pos.dtype != torch.int32 or not (
            torch.equal(pos, rpos) and torch.equal(found, rfound)):
        raise AssertionError(f"sorted_probe mismatch on {label}")


def probe_sweep(torch, dev) -> int:
    """Every ``probe_cases`` case through the wrapper (the plan's route)
    and through the bare launch of each route that can take it, held
    exactly against the plain version; returns the runs made, raises on a
    mismatch."""
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe
    runs = 0
    for label, table, q in probe_cases(torch, dev):
        probe_check(torch, table, q, sorted_probe(table, q), label)
        runs += 1
        for lanes in probe_routes(table):
            launch, got, _ = probe_launch(torch, table, q, lanes)
            launch()
            probe_check(torch, table, q, got, f"{label}, lanes {lanes}")
            runs += 1
    torch.cuda.synchronize()
    return runs


def probe_main_shape(torch, dev):
    """A level probe at the largest size the store holds: 65,536 sorted
    unique int64 queries (half present) into a 2.4 M-entry run (q8's warmed
    state)."""
    g = torch.Generator(device="cpu").manual_seed(12)
    table = torch.unique(torch.randint(0, 1 << 40, (2_450_000,),
                                       generator=g))[:2_400_000]
    q = torch.unique(torch.cat([
        table[torch.randint(0, len(table), (32_768,), generator=g)],
        torch.randint(0, 1 << 40, (40_000,), generator=g)]))[:65_536]
    return table.to(dev), q.to(dev)


def _sorted_keys(torch, g, size: int, top: int):
    """``size`` sorted unique int64 keys below ``top``."""
    k = torch.unique(torch.randint(0, top, (size + size // 8 + 16,),
                                   generator=g))
    return k[torch.randperm(len(k), generator=g)[:size]].sort().values


def _some_present(torch, g, table, size: int, top: int):
    """``size`` sorted unique int64 queries, about half of them in
    ``table``."""
    both = torch.unique(torch.cat([
        table[torch.randint(0, len(table), (size // 2,), generator=g)],
        _sorted_keys(torch, g, size, top)]))
    return both[torch.randperm(len(both), generator=g)[:size]].sort().values


def probe_sites(torch, dev):
    """The store's five probe call sites at the median N and T a q8_justin
    episode gives them (4,313 probes, counted on the CPU, where the episode
    makes the same calls as on the card): (site, table, queries, sorted)."""
    g = torch.Generator(device="cpu").manual_seed(13)
    top = 1 << 45
    sites = []
    # get_batch's inverse map: the batch's keys (unsorted, repeated)
    # against their own sorted unique keys
    uq = _sorted_keys(torch, g, 465, top)
    keys = torch.cat([uq, uq[torch.randint(0, 465, (1,), generator=g)]])
    keys = keys[torch.randperm(len(keys), generator=g)]
    sites.append(("state/lsm.py:502 inverse map", uq, keys, False))
    # the packed source-major memtable probe: 3 runs, 943 keys each
    runs = [_sorted_keys(torch, g, n, top) for n in (13_709, 13_709, 13_708)]
    packed = torch.cat([(i << 45) + r for i, r in enumerate(runs)])
    uq = _some_present(torch, g, runs[0], 943, top)
    qq = ((torch.arange(3)[:, None] << 45) + uq[None, :]).reshape(-1)
    sites.append(("state/lsm.py:523 packed memtable probe", packed, qq,
                  True))
    run = _sorted_keys(torch, g, 266_800, top)
    sites.append(("state/lsm.py:305 _probe_run", run,
                  _some_present(torch, g, run, 276, top), True))
    newer = _sorted_keys(torch, g, 8_081, top)
    sites.append(("state/lsm.py:108 merge_delta_runs", newer,
                  _some_present(torch, g, newer, 12_504, top), True))
    # partition bounds: sorted partition ids of 60,000 rows, 4 edges
    part = torch.randint(0, 3, (60_000,), generator=g).sort().values
    sites.append(("streaming/engine.py:67 _partition_bounds", part,
                  torch.arange(4), True))
    return [(s, t.to(dev), q.to(dev), srt) for s, t, q, srt in sites]


def probe_launch(torch, table, q, lanes=None):
    """(the bare launch of the probe kernel into preallocated outputs, its
    outputs, its lanes per query); ``lanes`` None takes the plan's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sorted_probe.kernel import (probe_blocks,
                                                         probe_plan)
    n, t = len(q), len(table)
    if lanes is None:
        lanes = probe_plan(n, t)[0]
    pos = torch.empty(n, dtype=torch.int32, device=q.device)
    found = torch.empty(n, dtype=torch.bool, device=q.device)
    fn = getattr(_build.library(), "sorted_probe_i64"
                 if table.dtype == torch.int64 else "sorted_probe_i32")
    args = (table.data_ptr(), t, q.data_ptr(), n, pos.data_ptr(),
            found.data_ptr(), lanes, probe_blocks(n, lanes),
            torch.cuda.current_stream().cuda_stream)
    return (lambda: fn(*args)), (pos, found), lanes


def check_probe(torch, dev) -> dict:
    """The sweep, then at each census site and the main shape the
    wrapper's result held exactly against the plain version, and the bare
    launch of the plan's route timed."""
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref
    runs = probe_sweep(torch, dev)
    sites = []
    for site, table, q, srt in probe_sites(torch, dev):
        probe_check(torch, table, q, sorted_probe(table, q), site)
        launch, _, lanes = probe_launch(torch, table, q)
        lib_out = torch.empty(len(q), dtype=torch.int64, device=dev)
        sites.append({
            "site": site, "n": len(q), "t": len(table),
            "queries_sorted": srt, "lanes": lanes,
            "ms": device_ms(launch, cold=True),
            "warm_ms": device_ms(launch, cold=False),
            "library_ms": device_ms(
                lambda: torch.searchsorted(table, q, out=lib_out),
                cold=True)})
    table, q = probe_main_shape(torch, dev)
    got = sorted_probe(table, q)
    probe_check(torch, table, q, got, "the main shape")
    launch, _, lanes = probe_launch(torch, table, q)
    n, t = len(q), len(table)
    lib_out = torch.empty(n, dtype=torch.int64, device=dev)
    must = probe_bytes(table, q, got[0])
    res = {
        "name": "sorted_probe", "route": "cuda",
        "source": "src/repro_torch/csrc/sorted_probe.cu",
        "replaces": "src/repro/kernels/sorted_probe/kernel.py:56",
        "max_abs_err": 0, "sweep_runs": runs,
        "shape": f"T={t} int64, N={n} sorted queries, {lanes} lane(s) a "
                 f"query",
        "ms": device_ms(launch, cold=True),
        "warm_ms": device_ms(launch, cold=False),
        "wrapper_ms": call_ms(lambda: sorted_probe(table, q)),
        "plain_ms": device_ms(lambda: sorted_probe_ref(table, q), cold=True),
        "library_ms": device_ms(
            lambda: torch.searchsorted(table, q, out=lib_out), cold=True),
        "bound_bytes": must,
        "bound_ms": must / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "sites": sites,
    }
    add_rates(res, must, "TB/s")
    emit({"phase": "kernel", **res})
    return res


# -------------------------------------------------------------- window_agg
def _runs_to_ids(torch, lengths):
    """Sorted segment ids 0, 1, ... repeated by ``lengths``."""
    return torch.repeat_interleave(torch.arange(len(lengths)), lengths)


def agg_cases(torch, dev):
    """(label, seg_ids, values, S): f32 with V 1 and 4, int64 (the store's
    exact weights), int32 and int64 ids; runs that straddle the edges of a
    lane's 4 rows, a warp's 128 and a block's 1,024; one segment over all
    rows whose int64 sum wraps; unsorted ids in runs; ids of -1 and >= S,
    among them int64 ids past 2^32 that an int32 cast would alias."""
    g = torch.Generator(device="cpu").manual_seed(21)
    cases = []
    for v in (1, 4):
        seg = torch.randint(-1, 513, (1025,), generator=g, dtype=torch.int32)
        vals = torch.randn((1025, v), generator=g)
        cases.append((f"f32 V={v} N=1025 S=513 with -1 ids", seg.to(dev),
                      vals.to(dev), 513))
        seg = torch.sort(torch.randint(0, 40_000, (100_003,), generator=g,
                                       dtype=torch.int32)).values
        vals = torch.randn((100_003, v), generator=g)
        cases.append((f"f32 V={v} N=100003 sorted ids", seg.to(dev),
                      vals.to(dev), 40_000))
    seg = torch.randint(-1, 2000, (50_001,), generator=g, dtype=torch.int32)
    vals = torch.randint(-(1 << 40), 1 << 40, (50_001, 1), generator=g)
    cases.append(("int64 N=50001 S=2000 with -1 ids", seg.to(dev),
                  vals.to(dev), 2000))
    # run lengths around the lane (4 rows), warp (128) and block (1,024)
    edges = torch.tensor([1, 2, 3, 4, 5, 7, 8, 9, 127, 128, 129, 255, 256,
                          1023, 1024, 1025, 2047, 2049])
    lengths = edges[torch.randint(0, len(edges), (400,), generator=g)]
    for idt in (torch.int32, torch.int64):
        seg = _runs_to_ids(torch, lengths).to(idt)
        vals = torch.randint(-(1 << 50), 1 << 50, (len(seg), 1), generator=g)
        cases.append((f"int64 {idt} ids, runs across lane/warp/block edges "
                      f"N={len(seg)}", seg.to(dev), vals.to(dev),
                      len(lengths)))
        # whole numbers: f32 sums exact in any order, however long the run
        vals = torch.randint(-8, 9, (len(seg), 4), generator=g).float()
        cases.append((f"f32 V=4 {idt} ids, runs across edges", seg.to(dev),
                      vals.to(dev), len(lengths)))
    for n in (1, 3, 4, 5, 129, 1025, 100_003):
        vals = torch.full((n, 1), (1 << 62) + 12345, dtype=torch.int64)
        vals[::3] = -(1 << 61) - 7
        cases.append((f"int64 one segment over N={n}, sum wraps",
                      torch.zeros(n, dtype=torch.int64).to(dev),
                      vals.to(dev), 1))
    ids = torch.randint(0, 3000, (20_000,), generator=g)
    seg = torch.repeat_interleave(ids, torch.randint(1, 7, (20_000,),
                                                     generator=g))
    vals = torch.randint(-(1 << 40), 1 << 40, (len(seg), 1), generator=g)
    cases.append((f"int64 unsorted ids in runs N={len(seg)}", seg.to(dev),
                  vals.to(dev), 3000))
    seg = torch.randint(-3, 3003, (30_000,), generator=g)
    seg[::7] = (1 << 32) + torch.randint(0, 3000, (len(seg[::7]),),
                                         generator=g)
    seg[::11] = -(1 << 33)
    vals = torch.randint(-(1 << 40), 1 << 40, (30_000, 1), generator=g)
    cases.append(("int64 ids: -1, >= S and past 2^32 skipped", seg.to(dev),
                  vals.to(dev), 3000))
    cases.append(("int64 S=0, every id skipped",
                  torch.randint(-1, 5, (300,), generator=g).to(dev),
                  torch.randint(-9, 9, (300, 1), generator=g).to(dev), 0))
    cases.append(("int64 N=0", torch.zeros(0, dtype=torch.int32).to(dev),
                  torch.zeros((0, 1), dtype=torch.int64).to(dev), 16))
    cases.append(("f32 N=0", torch.zeros(0, dtype=torch.int32).to(dev),
                  torch.zeros((0, 2)).to(dev), 8))
    return cases


def agg_sweep(torch, dev) -> tuple[float, int]:
    """Every ``agg_cases`` case through the kernel and its plain version:
    int64 exact, f32 within ``F32_TOL`` (sums in another order), counts
    exact; (worst f32 max|diff|, cases run); raises on a mismatch."""
    from repro_torch.kernels.window_agg.kernel import window_agg
    from repro_torch.kernels.window_agg.ref import window_agg_ref
    worst = 0.0
    cases = agg_cases(torch, dev)
    for label, seg, vals, s in cases:
        sums, counts = window_agg(seg, vals, s)
        rsums, rcounts = window_agg_ref(seg, vals, s)
        if sums.shape != rsums.shape or counts.dtype != rcounts.dtype \
                or not torch.equal(counts, rcounts):
            raise AssertionError(f"window_agg counts mismatch on {label}")
        if vals.dtype == torch.int64:
            if not torch.equal(sums, rsums):
                raise AssertionError(f"window_agg int64 mismatch on {label}")
        else:
            torch.testing.assert_close(sums, rsums, **F32_TOL)
            if len(sums):
                worst = max(worst, float((sums - rsums).abs().max()))
    torch.cuda.synchronize()
    return worst, len(cases)


def _gids(torch, first):
    """The store's group ids: int64, ``cumsum`` of the first-of-key mask."""
    return torch.cumsum(first, 0) - 1


def agg_main_shape(torch, dev):
    """The consolidation/compaction segment sum at the size of q8's largest
    compaction: 1 M int64 weights over key-sorted int64 group ids (mostly
    1-2 per key)."""
    g = torch.Generator(device="cpu").manual_seed(22)
    keys = torch.sort(torch.randint(0, 700_000, (1_000_000,),
                                    generator=g)).values
    first = torch.ones(len(keys), dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    w = torch.randint(1, 1 << 20, (len(keys), 1), generator=g)
    return _gids(torch, first).to(dev), w.to(dev), int(first.sum())


def agg_site(torch, dev):
    """The segment sum a q8_justin episode makes at its median (174 calls,
    counted on the CPU): 6,667 int64 weights, 1.03 rows per segment."""
    g = torch.Generator(device="cpu").manual_seed(23)
    first = torch.rand(6_667, generator=g) >= 0.03
    first[0] = True
    w = torch.randint(1, 1 << 20, (6_667, 1), generator=g)
    return _gids(torch, first).to(dev), w.to(dev), int(first.sum())


def agg_launch(torch, gids, w, s):
    """The bare launch into preallocated sums and counts, which it
    zeroes, as the wrapper's."""
    from repro_torch.kernels import _build
    n, v = w.shape
    sums = torch.empty((s, v), dtype=w.dtype, device=w.device)
    counts = torch.empty(s, dtype=w.dtype, device=w.device)
    fn = _build.library().window_agg_i64
    args = (gids.data_ptr(), gids.element_size(), w.data_ptr(), n, v, s,
            sums.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*args)


def agg_bound_bytes(gids, w, s) -> int:
    """Ids and values read once, sums and counts written once."""
    n, v = w.shape
    return n * (gids.element_size() + w.element_size() * v) \
        + s * w.element_size() * (v + 1)


def check_agg(torch, dev) -> dict:
    from repro_torch.kernels.window_agg.kernel import window_agg
    from repro_torch.kernels.window_agg.ref import window_agg_ref
    worst, n_cases = agg_sweep(torch, dev)
    sites = []
    main_shape = agg_main_shape(torch, dev)
    for name, (gids, w, s) in (("state/lsm.py:382 _collapse (median)",
                                agg_site(torch, dev)),
                               ("main shape", main_shape)):
        sums, counts = window_agg(gids, w, s)
        rsums, rcounts = window_agg_ref(gids, w, s)
        if not (torch.equal(sums, rsums) and torch.equal(counts, rcounts)):
            raise AssertionError(f"window_agg mismatch at the {name}")
        launch = agg_launch(torch, gids, w, s)
        acc = torch.zeros_like(rsums)
        must = agg_bound_bytes(gids, w, s)
        sites.append({
            "site": name, "n": len(gids), "segments": s,
            "ms": device_ms(launch, cold=True),
            "warm_ms": device_ms(launch, cold=False),
            "library_ms": device_ms(lambda: acc.index_add_(0, gids, w),
                                    cold=True),
            "bound_bytes": must, "bound_ms": must / HBM_BYTES_PER_S * 1e3})
    main = sites.pop()
    gids, w, s = main_shape
    n, v = w.shape
    res = {
        "name": "window_agg", "route": "cuda",
        "source": "src/repro_torch/csrc/window_agg.cu",
        "replaces": "src/repro/kernels/window_agg/kernel.py:55",
        "max_abs_err": worst, "sweep_cases": n_cases,
        "shape": f"N={n} int64 weights, int64 ids, S={s} sorted segments, "
                 f"V={v}",
        "ms": main["ms"], "warm_ms": main["warm_ms"],
        "wrapper_ms": call_ms(lambda: window_agg(gids, w, s)),
        "plain_ms": device_ms(lambda: window_agg_ref(gids, w, s), cold=True),
        "library_ms": main["library_ms"],
        "bound_bytes": main["bound_bytes"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "sites": sites,
    }
    add_rates(res, main["bound_bytes"], "TB/s")
    emit({"phase": "kernel", **res})
    return res


# --------------------------------------------------------- flash_attention
def _randn(torch, g, shape, dev, dtype):
    return torch.randn(shape, generator=g).to(dev, dtype)


def attn_err(torch, got, want, dtype: str, label: str) -> tuple[float, float]:
    """(max|got - want|, the largest share of its vector's max|want| that
    a vector's max|got - want| takes); raises unless every output vector
    is within ATTN_TOL[dtype] (NaN is not)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    tol = ATTN_TOL[dtype]
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    bad = ~(diff <= tol["rel"] * scale + tol["atol"])
    if bool(bad.any()):
        raise AssertionError(
            f"{label}: {int(bad.sum())} of {bad.numel()} output vectors "
            f"off, worst max|diff| {float(diff.max())}")
    return float(diff.max()), float((diff / scale.clamp_min(1e-30)).max())


def flash_cases(torch, dev):
    """(label, dtype name, q, k, v, causal, window) over Sq/Skv 1, 7, 300,
    513, 2048 (and Sq < Skv, and Sq > Skv, where causal leaves the first
    rows no key), D 64/80/128, GQA 1/3/4, causal on and off, window None
    and 64, bf16 and f32."""
    g = torch.Generator(device="cpu").manual_seed(31)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for sq, skv in ((1, 1), (7, 7), (300, 300), (513, 513),
                        (2048, 2048), (7, 300), (1, 513), (513, 300)):
            for d in (64, 80, 128):
                for hq, hk in ((4, 4), (3, 1), (8, 2)):
                    b = 1 if sq == 2048 else 2
                    q = _randn(torch, g, (b, hq, sq, d), dev, dt)
                    k = _randn(torch, g, (b, hk, skv, d), dev, dt)
                    v = _randn(torch, g, (b, hk, skv, d), dev, dt)
                    for causal in (True, False):
                        for window in (None, 64):
                            yield (f"{name} Sq={sq} Skv={skv} D={d} "
                                   f"{hq}:{hk} causal={causal} "
                                   f"window={window}",
                                   name, q, k, v, causal, window)


def flash_layout_cases(torch, dev):
    """bf16 operands in the layouts the tensor maps must take: q as a
    [B, S, H, D] buffer seen as [B, H, S, D] (the serve path's view, read
    in place) at Sq 300 and 2048, D 80 and 128; and q, k, v whose seq
    stride is 68 elements (136 bytes, not a multiple of 16), which the
    wrapper copies first."""
    g = torch.Generator(device="cpu").manual_seed(33)
    dt = torch.bfloat16
    for s in (300, 2048):
        for d in (80, 128):
            b, hq, hk = 2, 6, 2
            q = _randn(torch, g, (b, s, hq, d), dev, dt).transpose(1, 2)
            k = _randn(torch, g, (b, hk, s, d), dev, dt)
            v = _randn(torch, g, (b, hk, s, d), dev, dt)
            for causal in (True, False):
                yield (f"bfloat16 [B,S,H,D] view Sq=Skv={s} D={d} 6:2 "
                       f"causal={causal}", "bfloat16", q, k, v, causal, None)
    q, k, v = (_randn(torch, g, (2, h, 300, 68), dev, dt)[..., :64]
               for h in (4, 2, 2))
    yield ("bfloat16 seq stride 136 B (copied) Sq=Skv=300 D=64 4:2 causal",
           "bfloat16", q, k, v, True, None)


def flash_main_shape(torch, dev):
    """Prefill attention as the serve path calls it: q a [B, S, Hq, D]
    projection seen as [B, Hq, S, D], k/v the [B, Hk, S, D] cache."""
    g = torch.Generator(device="cpu").manual_seed(32)
    b, s, hq, hk, d = SERVE["requests"], SERVE["prompt_len"], 24, 8, 128
    q = _randn(torch, g, (b, s, hq, d), dev, torch.bfloat16).transpose(1, 2)
    k = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    v = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    return q, k, v


def flash_sweep(torch, dev) -> tuple[dict, int]:
    """Every ``flash_cases`` case through the kernel and its plain version:
    (worst max|diff| per dtype, cases run); raises on a mismatch."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for label, name, q, k, v, causal, window in itertools.chain(
            flash_cases(torch, dev), flash_layout_cases(torch, dev)):
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        worst[name] = max(worst[name],
                          attn_err(torch, got, want, name, label)[0])
        n_cases += 1
    torch.cuda.synchronize()
    return worst, n_cases


def check_flash(torch, dev) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn.kernel import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    worst, n_cases = flash_sweep(torch, dev)
    q, k, v = flash_main_shape(torch, dev)
    out = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    err, rel = attn_err(torch, out, want, "bfloat16", "flash main-path shape")
    typical = float(want.float().abs().median())
    del want
    b, hq, s, d = q.shape
    hk = k.shape[1]
    # the bare launch into a preallocated output, as the library call
    import ctypes
    fn = _build.library().flash_attn_bf16
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hk, s, s, d, strides, 1, 0,
            torch.cuda.current_stream().cuda_stream)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4 * b * hq * d * s * (s + 1) // 2      # causal pairs only
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    res = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:102",
        "max_abs_err": err, "max_rel_err": rel, "median_abs_ref": typical,
        "sweep_cases": n_cases, "sweep_max_abs_err": worst,
        "shape": f"q [{b}, {hq}, {s}, {d}] bf16 (a [B, S, H, D] buffer), "
                 f"k/v [{b}, {hk}, {s}, {d}], causal",
        "ms": device_ms(lambda: fn(*args), cold=True),
        "warm_ms": device_ms(lambda: fn(*args), cold=False, reps=10),
        "wrapper_ms": call_ms(lambda: flash_attention(q, k, v, causal=True),
                              reps=10),
        "plain_ms": device_ms(
            lambda: flash_attention_ref(q, k, v, causal=True), cold=True,
            reps=5),
        "library_ms": device_ms(
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
            cold=True),
        "bound_flop": flops, "bound_bytes": nbytes,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
    }
    add_rates(res, flops, "TFLOP/s")
    emit({"phase": "kernel", **res})
    return res


# -------------------------------------------------------- decode_attention
def decode_cases(torch, dev):
    """(label, dtype name, q, k, v, valid_len) over S 1, 7, 300, 513, 2048,
    D 64/80/128, GQA 1/3/4, valid_len 0, 1, S and ragged, bf16 and f32."""
    g = torch.Generator(device="cpu").manual_seed(41)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        for s in (1, 7, 300, 513, 2048):
            for d in (64, 80, 128):
                for hq, hk in ((4, 4), (3, 1), (8, 2)):
                    q = _randn(torch, g, (4, hq, d), dev, dt)
                    k = _randn(torch, g, (4, hk, s, d), dev, dt)
                    v = _randn(torch, g, (4, hk, s, d), dev, dt)
                    for lens in ([0, 1, s, s],
                                 [s, max(1, s // 3), 0, min(s, 5)]):
                        vl = torch.tensor(lens, dtype=torch.int32,
                                          device=dev)
                        yield (f"{name} S={s} D={d} {hq}:{hk} "
                               f"valid_len={lens}", name, q, k, v, vl)


def decode_layout_cases(torch, dev):
    """Caches in the layouts the kernel's copies must take: slots that are
    not contiguous (a [B, S, Hk, D] buffer seen as [B, Hk, S, D]: one
    16-byte copy per row chunk), and a slot stride of 68 elements (in bf16
    136 bytes, not a multiple of 16, which the wrapper copies first; in
    f32 272 bytes, read row by row)."""
    g = torch.Generator(device="cpu").manual_seed(43)
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        s, d = 513, 128
        q = _randn(torch, g, (4, 6, d), dev, dt)
        k = _randn(torch, g, (4, s, 2, d), dev, dt).transpose(1, 2)
        v = _randn(torch, g, (4, s, 2, d), dev, dt).transpose(1, 2)
        vl = torch.tensor([s, 300, 0, 65], dtype=torch.int32, device=dev)
        yield (f"{name} [B,S,Hk,D] view S={s} D={d} 6:2", name, q, k, v, vl)
        q = _randn(torch, g, (4, 4, 64), dev, dt)
        k, v = (_randn(torch, g, (4, 2, 300, 68), dev, dt)[..., :64]
                for _ in range(2))
        vl = torch.tensor([300, 1, 129, 0], dtype=torch.int32, device=dev)
        copied = " (copied)" if dt == torch.bfloat16 else ""
        yield (f"{name} slot stride 68{copied} S=300 D=64 4:2", name, q, k,
               v, vl)


def decode_main_shape(torch, dev):
    """Decode attention as the serve path calls it: q [8, 24, 128] bf16
    against one layer's [8, 8, 2176, 128] cache, valid_len 2049..2176 (the
    range the 128 decode steps run through, one per request here)."""
    g = torch.Generator(device="cpu").manual_seed(42)
    b, hq, hk, d = SERVE["requests"], 24, 8, 128
    s = SERVE["prompt_len"] + SERVE["decode"]
    q = _randn(torch, g, (b, 1, hq, d), dev, torch.bfloat16)[:, 0]
    k = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    v = _randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
    vl = torch.linspace(SERVE["prompt_len"] + 1, s, b).round().to(
        dev, torch.int32)
    return q, k, v, vl


def decode_sweep(torch, dev) -> tuple[dict, int]:
    """Every ``decode_cases`` case through the kernel and its plain
    version, again on the same inputs (bit-identical: the splits' ticket
    counter was left zeroed) and again with garbage past valid_len:
    (worst max|diff| per dtype, cases run); raises on a mismatch."""
    from repro_torch.kernels.decode_attn.kernel import decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for label, name, q, k, v, vl in itertools.chain(
            decode_cases(torch, dev), decode_layout_cases(torch, dev)):
        got = decode_attention(q, k, v, vl)
        want = decode_attention_ref(q, k, v, vl)
        worst[name] = max(worst[name],
                          attn_err(torch, got, want, name, label)[0])
        if not torch.equal(decode_attention(q, k, v, vl), got):
            raise AssertionError(f"decode_attention not repeatable: {label}")
        # garbage past valid_len (NaN values included) changes nothing
        past = (torch.arange(k.shape[2], device=dev)[None, :]
                >= vl[:, None].long())[:, None, :, None]
        again = decode_attention(q, k.masked_fill(past, 999.0),
                                 v.masked_fill(past, float("nan")), vl)
        if not torch.equal(again, got):
            raise AssertionError(f"decode_attention read past valid_len: "
                                 f"{label}")
        n_cases += 1
    torch.cuda.synchronize()
    return worst, n_cases


def check_decode(torch, dev) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn.kernel import (_sm_count,
                                                        decode_attention,
                                                        split_plan, tickets)
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    worst, n_cases = decode_sweep(torch, dev)
    q, k, v, vl = decode_main_shape(torch, dev)
    out = decode_attention(q, k, v, vl)
    want = decode_attention_ref(q, k, v, vl)
    err, rel = attn_err(torch, out, want, "bfloat16",
                        "decode main-path shape")
    typical = float(want.float().abs().median())
    b, hq, d = q.shape
    _, hk, s, _ = k.shape
    import ctypes
    fn = _build.library().decode_attn_bf16
    chunk, n_splits = split_plan(b, hk, s, _sm_count(out.device.index))
    part_ml = torch.empty((2, b, hq, n_splits), device=dev)
    part_acc = torch.empty((b, hq, n_splits, d), device=dev)
    strides = (ctypes.c_int64 * 10)(*q.stride()[:2], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:2])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(),
            out.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
            part_acc.data_ptr(), tickets(out.device, b * hk).data_ptr(), b,
            hq, hk, s, d, strides, chunk, n_splits,
            torch.cuda.current_stream().cuda_stream)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(s, device=dev)[None, :] < vl[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None]
    total = int(vl.long().sum())
    nbytes = 2 * total * hk * d * 2 + 2 * 2 * q.numel() + 4 * b
    flops = 4 * hq * d * total
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    res = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/kernel.py:81",
        "max_abs_err": err, "max_rel_err": rel, "median_abs_ref": typical,
        "sweep_cases": n_cases, "sweep_max_abs_err": worst,
        "shape": f"q [{b}, {hq}, {d}] bf16, caches [{b}, {hk}, {s}, {d}], "
                 f"valid_len {vl.tolist()}",
        "splits": n_splits, "chunk": chunk,
        "ms": device_ms(lambda: fn(*args), cold=True),
        "warm_ms": device_ms(lambda: fn(*args), cold=False),
        "wrapper_ms": call_ms(lambda: decode_attention(q, k, v, vl)),
        "plain_ms": device_ms(lambda: decode_attention_ref(q, k, v, vl),
                              cold=True),
        "library_ms": device_ms(
            lambda: sdpa(q4, k, v, attn_mask=mask, enable_gqa=True),
            cold=True),
        "bound_bytes": nbytes, "bound_flop": flops,
        "bound_ms": max(byte_ms, flop_ms),
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
    }
    add_rates(res, nbytes, "TB/s")
    emit({"phase": "kernel", **res})
    return res


# ---------------------------------------------------------------- episodes
def run_episode(key: str, golden: dict, dev: str) -> dict:
    """One golden episode through the port, compared as the reference's
    ``tests/test_golden_trace.py:assert_matches_golden`` compares."""
    from repro_torch.core.controller import AutoScaler, ControllerConfig
    from repro_torch.core.justin import JustinParams
    from repro_torch.core.policy import make_policy
    from repro_torch.data.nexmark import QUERIES, TARGET_RATES
    from repro_torch.streaming.engine import StreamEngine
    qname, policy = key.split("_")
    meta = golden["_meta"]
    eng = StreamEngine(QUERIES[qname](), seed=meta["seed"], device=dev)
    cfg = ControllerConfig(policy=policy,
                           justin=JustinParams(max_level=meta["max_level"]))
    ctl = AutoScaler(eng, TARGET_RATES[qname], cfg,
                     policy=make_policy(policy, cfg))
    hist = ctl.run()
    got = {
        "steps": ctl.steps,
        "configs": [[(op, list(pc)) for op, pc in
                     sorted((op, list(pc)) for op, pc in h.config.items())]
                    for h in hist],
        "triggered": [h.triggered for h in hist],
        "cpu_cores": hist[-1].cpu_cores,
        "memory_mb": hist[-1].memory_mb,
        "final_rate_ok": hist[-1].achieved_rate
        >= 0.97 * TARGET_RATES[qname],
    }
    want = golden[key]
    want_cfg = [[(op, list(pc)) for op, pc in w] for w in want["configs"]]
    checks = {
        "steps": got["steps"] == want["steps"],
        "triggered": got["triggered"] == want["triggered"],
        "configs": got["configs"] == want_cfg,
        "cpu_cores": got["cpu_cores"] == want["cpu_cores"],
        "memory_mb": got["memory_mb"] == want["memory_mb"],
        "final_rate_ok": bool(got["final_rate_ok"] and want["final_rate_ok"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"{key} differs from the golden trace: "
                             f"{checks} got={got}")
    return {"steps": got["steps"], "windows": len(hist),
            "cpu_cores": got["cpu_cores"], "memory_mb": got["memory_mb"],
            "achieved_rate": hist[-1].achieved_rate}


# profiler names of the store kernels' device work, by kernel
STORE_KERNELS = {"sorted_probe": ("::probe_warps<", "::probe_indexed<"),
                 "window_agg": ("::window_agg_kernel<",
                                "::window_agg_zero<")}


def profile_run(label: str, fn, wall_unprofiled: float | None,
                **extra) -> None:
    """``fn`` under torch.profiler: device time by kernel, written to
    chiprun_out/, and the device's busy share of the run's unprofiled
    wall time (the profiler slows the host, not the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    (OUT / f"profile_{label}.txt").write_text(
        avgs.table(sort_by="self_device_time_total", row_limit=60))
    # device-side entries only (kernels, copies): op rows repeat the time
    # of the kernels they launch
    on_dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    # the store kernels' device time, every instantiation summed
    store = {}
    for name, marks in STORE_KERNELS.items():
        rows = [e for e in on_dev if any(m in e.key for m in marks)]
        store[name] = {"calls": sum(e.count for e in rows),
                       "device_ms": sum(e.self_device_time_total
                                        for e in rows) / 1e3}
    emit({"phase": "profile", **extra, "wall_s_profiled": wall,
          "store_kernels": store,
          "wall_s_unprofiled": wall_unprofiled, "device_s": dev_s,
          "device_events": sum(e.count for e in on_dev),
          "device_busy_share": dev_s / wall_unprofiled
          if wall_unprofiled else None,
          "top": [{"name": e.key[:70], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in on_dev[:15]]})


# ------------------------------------------------------------------- serve
def run_serve(torch, dev: str) -> dict:
    """The serving path at full width through the user's entry point; the
    attention kernels' launch counts are reset just before and read just
    after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch.serve import serve
    cfg = get_config(ARCH)
    flash_ops.launches = 0
    decode_ops.launches = 0
    res = serve(ARCH, reduced=False, verbose=False, device=dev, **SERVE)
    launches = {"flash_attention": flash_ops.launches,
                "decode_attention": decode_ops.launches}
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * SERVE["decode"]}
    if launches != want or res["launches"] != want:
        raise AssertionError(f"serve launched {launches} "
                             f"(reported {res['launches']}), want {want}")
    if res["generated"] != SERVE["decode"] + 1 or not all(
            0 <= t < cfg.vocab_size for t in res["sample"]):
        raise AssertionError(f"serve output malformed: {res}")
    emit({"phase": "serve", "reduced": False, **SERVE, **res})
    return launches


def check_decode_matches_prefill(torch, dev: str) -> dict:
    """Full width: the decode step at position S == the last logits of a
    prefill over S + 1 tokens (the reference's
    tests/test_models.py::test_decode_matches_prefill, 2 requests)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.transformer import cast_params
    cfg = get_config(ARCH)
    model = get_model(cfg)
    params = cast_params(model.init(cfg, torch.Generator(dev).manual_seed(1)),
                         cfg)
    b, s = 2, SERVE["prompt_len"]
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + 1)), device=dev)
    _, caches = model.prefill(params, {"tokens": toks[:, :s]}, cfg)
    caches = {n: {kv: F.pad(c, (0, 0, 0, 1)) for kv, c in g.items()}
              for n, g in caches.items()}
    got, _ = model.decode(params, caches, toks[:, s:], s, cfg)
    ref, _ = model.prefill(params, {"tokens": toks}, cfg)
    if got.shape != (b, cfg.padded_vocab) or not bool(
            torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError("decode/prefill logits malformed")
    rel = float((got - ref).abs().max() / ref.abs().max())
    res = {"phase": "decode_vs_prefill", "arch": ARCH, "requests": b,
           "position": s, "max_abs_ref": float(ref.abs().max()),
           "rel_err": rel, "limit": 0.03,
           "argmax_equal": bool(torch.equal(got.argmax(-1),
                                            ref.argmax(-1)))}
    emit(res)
    if not rel < 0.03:
        raise AssertionError(f"decode differs from prefill: {rel}")
    return res


def profile_serve(torch) -> None:
    """Prefill and 8 decode steps at full width under torch.profiler:
    device time by kernel and CUDA kernels launched per decode step,
    written to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve
    OUT.mkdir(exist_ok=True)
    steps = 8
    kw = dict(SERVE, decode=steps)
    serve(ARCH, reduced=False, verbose=False, **kw)       # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = serve(ARCH, reduced=False, verbose=False, **kw)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    (OUT / "profile_serve.txt").write_text(
        avgs.table(sort_by="self_device_time_total", row_limit=60))
    on_dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    emit({"phase": "profile_serve", "decode_steps": steps,
          "wall_s_profiled": res["wall_s"],
          "device_ms": sum(e.self_device_time_total for e in on_dev) / 1e3,
          "device_events": sum(e.count for e in on_dev),
          "top": [{"name": e.key[:70], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in on_dev[:20]]})


# --------------------------------------------------------------- scenarios
# Phase 6 drives the reconfiguration-pricing, dynamic-scenario and
# shared-cluster layer and holds each run exactly against the reference's
# answers, pinned in tests/data/torch_scenarios.json (written from the
# reference package by ``tests/test_torch_pins.py --write``, which runs
# these same functions over the reference's modules).  Every run function
# takes ``api``, a namespace of one package's entry points
# (:func:`port_api` here), and ``dev``, the keyword arguments that place
# its engines (``{"device": "cuda"}`` for the port, ``{}`` for the
# reference).
PINS = ROOT / "tests" / "data" / "torch_scenarios.json"
ROW_FIELDS = ("t", "step", "achieved_rate", "cpu_cores", "memory_mb",
              "config", "triggered", "target", "backlog", "denied",
              "preempted", "amortized_mb", "reconfig_downtime", "moved_mb",
              "reason")
SAVEPOINT_MB_PER_S = 6.0
FLEETS = {"d_fleet_32": dict(tenants=32, windows=6, admission="fair_share",
                             drivers=("vectorized", "scalar")),
          "d_fleet_128": dict(tenants=128, windows=20,
                              admission="preemption",
                              drivers=("vectorized",))}
# the reference's own fleet bench runs 1,000 tenants x 100 windows
FLEET_FULL = dict(tenants=1000, windows=100)


def port_api():
    """The port's entry points that phase 6 drives."""
    from types import SimpleNamespace

    from repro_torch.core.controller import AutoScaler, ControllerConfig
    from repro_torch.core.justin import JustinParams
    from repro_torch.core.policy import make_policy
    from repro_torch.data.nexmark import QUERIES, TARGET_RATES
    from repro_torch.migration import CostModel, MigrationRuntime
    from repro_torch.obs import Tracer, write_jsonl
    from repro_torch.scenarios import (KillTask, SetStraggler, fleet_stats,
                                       run_colocation, run_fleet,
                                       run_scenario)
    from repro_torch.scenarios import cluster
    from repro_torch.scenarios.runner import scenario_horizon_s
    from repro_torch.streaming.engine import StreamEngine
    return SimpleNamespace(**locals())


def _jsonable(obj):
    """The record as it reads back from JSON (tuples become lists), so a
    fresh record compares with ``==`` against the pinned one."""
    return json.loads(json.dumps(obj))


def history_rows(history) -> list:
    """Every field of every ``HistoryRow``, in ``ROW_FIELDS`` order."""
    return [[sorted([op, list(pc)] for op, pc in h.config.items())
             if f == "config" else getattr(h, f) for f in ROW_FIELDS]
            for h in history]


def _fault(f) -> list:
    import dataclasses
    return [type(f).__name__, *dataclasses.astuple(f)]


def colocated_record(res) -> dict:
    """A co-located run's decisions: the usage series and, per tenant, its
    admission outcomes and full history."""
    return _jsonable({
        "usage": res.usage,
        "migration": [res.cluster.migration_total().tasks_moved,
                      res.cluster.migration_total().state_mb],
        "tenants": {t.name: {
            "policy": t.spec.policy, "query": t.spec.query,
            "steps": t.scaler.steps, "denials": t.denials,
            "deferrals": t.deferrals, "preemptions": t.preemptions,
            "shrinks": t.scaler.preemptions,
            "first_pending": t.first_pending,
            "faults_fired": [_fault(f) for f in t.faults_fired],
            "history": history_rows(t.history)} for t in res.tenants}})


def run_savepoint(api, dev: dict) -> dict:
    """(a) q8 under a savepoint cost model, justin and threshold, 6 windows
    (the reference's tests/test_migration.py::
    test_q8_savepoint_threshold_pays_more_downtime_than_justin)."""
    cm = api.CostModel(mechanism="savepoint",
                       savepoint_mb_per_s=SAVEPOINT_MB_PER_S)
    out = {}
    for pol in ("justin", "threshold"):
        cfg = api.ControllerConfig(policy=pol,
                                   justin=api.JustinParams(max_level=2))
        ctl = api.AutoScaler(
            api.StreamEngine(api.QUERIES["q8"](), seed=3, **dev),
            api.TARGET_RATES["q8"], cfg, policy=api.make_policy(pol, cfg),
            migration=api.MigrationRuntime(cm))
        hist = ctl.run(max_windows=6)
        out[pol] = {"steps": ctl.steps, "history": history_rows(hist),
                    "totals": ctl.migration.totals()}
    return _jsonable(out)


def check_savepoint(rec: dict) -> dict:
    """The acceptance pin's own claims: justin converges in 3 steps,
    threshold in 4, both recover, threshold pays more downtime windows
    and more downtime seconds."""
    i_rate, i_target = ROW_FIELDS.index("achieved_rate"), \
        ROW_FIELDS.index("target")
    i_down = ROW_FIELDS.index("reconfig_downtime")
    got = {}
    for pol, r in rec.items():
        down = [row[i_down] for row in r["history"]]
        last = r["history"][-1]
        got[pol] = {"steps": r["steps"],
                    "downtime_windows": sum(1 for d in down if d > 0),
                    "downtime_s": sum(down),
                    "recovered": last[i_rate] >= 0.97 * last[i_target]}
    j, t = got["justin"], got["threshold"]
    if not (j["recovered"] and t["recovered"] and j["steps"] == 3
            and t["steps"] == 4
            and t["downtime_windows"] > j["downtime_windows"]
            and t["downtime_s"] > j["downtime_s"]):
        raise AssertionError(f"savepoint headline does not hold: {got}")
    return got


def run_faults(api, dev: dict, trace_path=None) -> dict:
    """(b) q11 under a load spike with a straggler (and its recovery) and a
    killed task, reconfigurations priced as handoffs, a tracer attached;
    the fault times lie inside the scenario's horizon."""
    cfg = api.ControllerConfig(policy="justin",
                               justin=api.JustinParams(max_level=2))
    horizon = api.scenario_horizon_s(cfg, 8)
    faults = [api.SetStraggler(0.2 * horizon, "user_sessions", 0, 8.0,
                               duration_s=0.2 * horizon),
              api.KillTask(0.6 * horizon, "user_sessions", 1)]
    tracer = api.Tracer(enabled=True)
    res = api.run_scenario("justin", "q11", "spike", windows=8, cfg=cfg,
                           reconfig_cost="handoff", faults=faults,
                           tracer=tracer, **dev)
    if trace_path is not None:
        api.write_jsonl(tracer.spans, str(trace_path),
                        meta={"run": "b_faults"})
    return _jsonable({"steps": res.steps,
                      "history": history_rows(res.history),
                      "faults_fired": [_fault(f) for f in res.faults_fired],
                      "slo": res.slo().to_dict(),
                      "spans": len(tracer.spans),
                      "trace_summary": tracer.summary()})


def run_colocation_pair(api, dev: dict, driver: str) -> dict:
    """(c) the ds2/justin pair on one shared-TM cluster under preemption
    (``run_colocation(["q11"], "preemption", windows=5)``).  The cell
    reports counts; the decisions behind them are read from the
    ``run_colocated`` result it makes, caught on its way out."""
    caught = []
    inner = api.cluster.run_colocated

    def catching(*a, **kw):
        caught.append(inner(*a, **kw))
        return caught[-1]

    api.cluster.run_colocated = catching
    try:
        cells = api.run_colocation(["q11"], "preemption", windows=5,
                                   verbose=False, driver=driver, **dev)
    finally:
        api.cluster.run_colocated = inner
    return _jsonable({"cells": cells, **colocated_record(caught[0])})


def run_fleet_case(api, dev: dict, key: str, driver: str) -> tuple:
    """(d) a sampled fleet on its auto-sized private cluster: (record,
    ``fleet_stats``)."""
    f = FLEETS[key]
    res = api.run_fleet(f["tenants"], f["windows"],
                        admission=f["admission"], seed=0, driver=driver,
                        **dev)
    return colocated_record(res), api.fleet_stats(res)


def first_diff(got, want, path: str = "") -> str | None:
    """Where two JSON values first differ (None when equal)."""
    if isinstance(got, dict) and isinstance(want, dict):
        for k in sorted(set(got) | set(want), key=str):
            if k not in got or k not in want:
                return f"{path}/{k}: only in {'got' if k in got else 'pin'}"
            d = first_diff(got[k], want[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(got, list) and isinstance(want, list):
        if len(got) != len(want):
            return f"{path}: length {len(got)} != {len(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            d = first_diff(a, b, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if got == want else f"{path}: {got!r} != {want!r}"


def hold(label: str, got, want) -> None:
    d = first_diff(got, want)
    if d:
        raise AssertionError(f"{label} differs: {d}")


def scenario_phase(torch, dev: str) -> dict:
    """Phase 6: every scenario run on the card at the reference's sizes,
    each held exactly against the pin (and (c), (d) against their other
    driver); per run one line with its wall seconds, store-kernel
    launches and peak device memory.  Returns the launch totals and the
    walls by run."""
    from repro_torch.kernels.sorted_probe import ops as probe_ops
    from repro_torch.kernels.window_agg import ops as agg_ops
    api = port_api()
    pins = json.loads(PINS.read_text())
    d = {"device": dev}
    OUT.mkdir(exist_ok=True)
    trace = OUT / "scenario_b_trace.jsonl"
    totals = {"sorted_probe": 0, "window_agg": 0}
    walls = {}
    t_phase = time.perf_counter()

    def timed(label: str, fn, **extra):
        gc.collect()         # the last run's engines, before the reset
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        probe_ops.launches = 0
        agg_ops.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"sorted_probe": probe_ops.launches,
                    "window_agg": agg_ops.launches}
        for k, n in launches.items():
            if n == 0:
                raise AssertionError(f"scenario run {label} never "
                                     f"launched {k}")
            totals[k] += n
        walls[label] = wall
        line = {"phase": "scenario", "run": label, "wall_s": wall,
                "launches": launches,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                **extra}
        return out, line

    # (a) priced reconfiguration
    rec, line = timed("a_savepoint", lambda: run_savepoint(api, d))
    hold("a_savepoint", rec, pins["a_savepoint"])
    emit({**line, "pin_equal": True, "headline": check_savepoint(rec)})

    # (b) dynamic load with faults, traced
    rec, line = timed("b_faults", lambda: run_faults(api, d, trace))
    hold("b_faults", rec, pins["b_faults"])
    chk = subprocess.run([sys.executable,
                          str(ROOT / "tools" / "check_trace.py"),
                          str(trace)], capture_output=True, text=True,
                         timeout=120)
    if chk.returncode != 0:
        raise AssertionError(f"check_trace refused the trace: "
                             f"{chk.stdout}{chk.stderr}")
    emit({**line, "pin_equal": True, "spans": rec["spans"],
          "check_trace": chk.stdout.strip()})

    # (c) shared-cluster co-location, both drivers
    recs = {}
    for driver in ("vectorized", "scalar"):
        recs[driver], line = timed(
            f"c_colocation_{driver}",
            lambda: run_colocation_pair(api, d, driver))
        hold(f"c_colocation ({driver})", recs[driver], pins["c_colocation"])
        emit({**line, "pin_equal": True, "driver": driver})
    hold("c_colocation scalar vs vectorized", recs["scalar"],
         recs["vectorized"])

    # (d) fleets; depth cut from the reference's 1,000 x 100 bench
    for key, f in FLEETS.items():
        recs = {}
        for driver in f["drivers"]:
            (recs[driver], stats), line = timed(
                f"{key}_{driver}",
                lambda: run_fleet_case(api, d, key, driver))
            hold(f"{key} ({driver})", recs[driver], pins[key])
            stats.update(seconds=line["wall_s"],
                         tenant_windows_per_s=stats["tenant_windows"]
                         / line["wall_s"])
            emit({**line, "pin_equal": True, "driver": driver,
                  "fleet_stats": stats,
                  "reduced": {"tenants": [f["tenants"],
                                          FLEET_FULL["tenants"]],
                              "windows": [f["windows"],
                                          FLEET_FULL["windows"]]}})
        if len(recs) == 2:
            hold(f"{key} scalar vs vectorized", recs["scalar"],
                 recs["vectorized"])
    emit({"phase": "scenarios_done",
          "seconds": time.perf_counter() - t_phase, "launches": totals})
    return totals, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile q8_justin, the serve path and the "
                         "128-tenant fleet into chiprun_out/")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # float32 products in full f32 (the plain versions and the logits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = json.loads(GOLDEN.read_text())
    t_start = time.perf_counter()

    # 1. device
    name_power = smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": name_power, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    dev = "cuda"

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          **_build.build_info})

    # 3. kernels against their plain versions
    rows = [check_probe(torch, dev), check_agg(torch, dev),
            check_flash(torch, dev), check_decode(torch, dev)]
    torch.cuda.empty_cache()
    emit({"kernels": [r["name"] for r in rows]})

    # 4. golden episodes on the card
    from repro_torch.kernels.sorted_probe import ops as probe_ops
    from repro_torch.kernels.window_agg import ops as agg_ops
    totals = {"sorted_probe": 0, "window_agg": 0}
    walls = {}
    for key in ("q11_justin", "q8_justin", "q11_ds2", "q8_ds2"):
        probe_ops.launches = 0
        agg_ops.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_episode(key, golden, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls[key] = wall
        launches = {"sorted_probe": probe_ops.launches,
                    "window_agg": agg_ops.launches}
        emit({"phase": "episode", "episode": key, "wall_s": wall,
              "decisions_match_golden": True, "launches": launches, **res})
        for k, n in launches.items():
            if n == 0:
                raise AssertionError(f"{key} never launched {k}")
            totals[k] += n
    if args.profile:
        profile_run("q8_justin", lambda: run_episode("q8_justin", golden,
                                                     dev),
                    walls.get("q8_justin"), episode="q8_justin")

    # 5. serve at full width
    totals.update(run_serve(torch, dev))
    torch.cuda.empty_cache()
    check_decode_matches_prefill(torch, dev)
    torch.cuda.empty_cache()
    if args.profile:
        profile_serve(torch)

    # 6. scenarios: priced reconfiguration, faults, co-location, fleets
    launches, walls = scenario_phase(torch, dev)
    for k, n in launches.items():
        totals[k] += n
    torch.cuda.empty_cache()
    if args.profile:
        profile_run("d_fleet_128", lambda: run_fleet_case(
            port_api(), {"device": dev}, "d_fleet_128", "vectorized"),
            walls["d_fleet_128_vectorized"], run="d_fleet_128_vectorized")

    for row in rows:
        row["launches"] = totals[row["name"]]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bound_share", "achieved", "achieved_unit", "warm_ms", "wrapper_ms")}
        for r in rows]})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
