"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python chip_smoke.py                      # every phase, all 4 episodes
    python chip_smoke.py --profile            # also a torch.profiler pass

Phases, each printing one JSON line:

1. device — the card, and ``nvidia-smi``'s name and power limit;
2. build  — compiles ``src/repro_torch/csrc/*.cu`` with nvcc;
3. kernels — each hand-written kernel against its plain PyTorch version on
   the card over an edge-case sweep and at the main path's shapes, with
   CUDA-event device times (L2 emptied first) of the kernel, the plain
   version and the one PyTorch library call that computes the same
   function, the kernel's time with its inputs in L2, the wrapper's cost
   per call on the host clock, and the byte bound on this run's data;
4. episodes — the golden autoscaling episodes (q8/q11 x justin/ds2, seed
   3, max_level 2, the reference's full sizes) through the port on the
   card, compared decision for decision with
   ``tests/data/golden_autoscale.json``; kernel launch counts are reset
   just before each episode and read just after, and an episode that
   launched a kernel of its path no time fails.

Any mismatch or exception exits non-zero; only after every phase passed
are the kernel table, the ``nvidia-smi`` line and the final
``{"ok": true, ...}`` line printed.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import argparse
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
F32_TOL = dict(rtol=1e-5, atol=1e-4)   # atomic f32 sums, order varies


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


def probe_bytes(torch, table, q, pos) -> tuple[int, int]:
    """(bytes the probe must move, bytes a bisection moves) on this data.

    Must: each query read, each position and flag written, and the table
    sectors that hold each query's neighbours table[pos-1] and table[pos]
    (a rank is not known without them).  Bisection: the same, with the
    distinct sectors of every entry the kernel's lower-bound search reads
    in place of the neighbours."""
    t, n, w = len(table), len(q), table.element_size()
    io = n * (q.element_size() + 4 + 1)
    p = pos.long()
    near = torch.cat([p[p > 0] - 1, p[p < t]])
    must = io + len(torch.unique(near * w // SECTOR)) * SECTOR
    lo = torch.zeros(n, dtype=torch.long, device=q.device)
    hi = torch.full_like(lo, t)
    read = []
    while True:
        act = lo < hi
        if not bool(act.any()):
            break
        mid = lo + (hi - lo) // 2
        read.append(mid[act])
        less = table[mid.clamp(max=t - 1)] < q
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    assert torch.equal(lo, p), "bisection model disagrees with the kernel"
    read.append(lo[lo < t])                    # the found check's read
    bisect = io + len(torch.unique(torch.cat(read) * w // SECTOR)) * SECTOR
    return must, bisect


# ------------------------------------------------------------ sorted_probe
def probe_cases(torch, dev):
    """(label, table, queries) covering the edge cases and the main path."""
    g = torch.Generator(device="cpu").manual_seed(11)
    cases = []
    for dt in (torch.int32, torch.int64):
        info = torch.iinfo(dt)
        hi = info.max

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
        cases.append((f"{dt}:empty table", t([]), t([1, 2, hi])))
        cases.append((f"{dt}:one entry", t([42]), t([41, 42, 43, hi])))
        cases.append((f"{dt}:duplicate queries", t(list(range(0, 1000, 7))),
                      t([700] * 2048 + [701] * 3)))
        cases.append((f"{dt}:duplicate table entries", t([5, 5, 5, 9, 9]),
                      t([5, 7, 9, 10])))
        cases.append((f"{dt}:exact tile multiple",
                      t(list(range(0, 2048 * 3, 3))),
                      t(list(range(1, 512 * 3, 3)))))
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


def probe_main_shape(torch, dev):
    """A level probe at the main path's size: 65,536 sorted unique int64
    queries (half present) into a 2.4 M-entry run (q8's warmed state)."""
    g = torch.Generator(device="cpu").manual_seed(12)
    table = torch.unique(torch.randint(0, 1 << 40, (2_450_000,),
                                       generator=g))[:2_400_000]
    q = torch.unique(torch.cat([
        table[torch.randint(0, len(table), (32_768,), generator=g)],
        torch.randint(0, 1 << 40, (40_000,), generator=g)]))[:65_536]
    return table.to(dev), q.to(dev)


def check_probe(torch, dev) -> dict:
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref
    worst = 0
    for label, table, q in probe_cases(torch, dev):
        pos, found = sorted_probe(table, q)
        if len(table):
            rpos, rfound = sorted_probe_ref(table, q)
        else:
            rpos = torch.zeros(len(q), dtype=torch.int32, device=dev)
            rfound = torch.zeros(len(q), dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        err = int((pos.long() - rpos.long()).abs().max()) if len(q) else 0
        if err or not torch.equal(found, rfound) or pos.dtype != torch.int32:
            raise AssertionError(f"sorted_probe mismatch on {label}: "
                                 f"pos err {err}")
        worst = max(worst, err)
    table, q = probe_main_shape(torch, dev)
    pos, found = sorted_probe(table, q)
    rpos, rfound = sorted_probe_ref(table, q)
    torch.cuda.synchronize()
    if not (torch.equal(pos, rpos) and torch.equal(found, rfound)):
        raise AssertionError("sorted_probe mismatch at the main-path shape")
    n, t = len(q), len(table)
    # the bare launch and the library call write into preallocated
    # outputs; the wrapper also allocates its outputs and crosses ctypes
    from repro_torch.kernels import _build
    fn = _build.library().sorted_probe_i64
    stream = torch.cuda.current_stream().cuda_stream
    args = (table.data_ptr(), t, q.data_ptr(), n, pos.data_ptr(),
            found.data_ptr(), stream)
    lib_out = torch.empty(n, dtype=torch.int64, device=dev)
    must, bisect = probe_bytes(torch, table, q, pos)
    res = {
        "name": "sorted_probe", "route": "cuda",
        "source": "src/repro_torch/csrc/sorted_probe.cu",
        "replaces": "src/repro/kernels/sorted_probe/kernel.py:56",
        "max_abs_err": worst,
        "shape": f"T={t} int64, N={n} sorted queries",
        "ms": device_ms(lambda: fn(*args), cold=True),
        "warm_ms": device_ms(lambda: fn(*args), cold=False),
        "wrapper_ms": call_ms(lambda: sorted_probe(table, q)),
        "plain_ms": device_ms(lambda: sorted_probe_ref(table, q), cold=True),
        "library_ms": device_ms(
            lambda: torch.searchsorted(table, q, out=lib_out), cold=True),
        "bound_bytes": must, "bisect_bytes": bisect,
        "bound_ms": must / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    emit({"phase": "kernel", **res})
    return res


# -------------------------------------------------------------- window_agg
def agg_cases(torch, dev):
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
    cases.append(("int64 N=0", torch.zeros(0, dtype=torch.int32).to(dev),
                  torch.zeros((0, 1), dtype=torch.int64).to(dev), 16))
    cases.append(("f32 N=0", torch.zeros(0, dtype=torch.int32).to(dev),
                  torch.zeros((0, 2)).to(dev), 8))
    return cases


def agg_main_shape(torch, dev):
    """The consolidation/compaction segment sum at the main path's size:
    1 M int64 weights over key-sorted group ids (mostly 1-2 per key)."""
    g = torch.Generator(device="cpu").manual_seed(22)
    keys = torch.sort(torch.randint(0, 700_000, (1_000_000,),
                                    generator=g)).values
    first = torch.ones(len(keys), dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    gids = torch.cumsum(first, 0) - 1
    w = torch.randint(1, 1 << 20, (len(keys), 1), generator=g)
    return gids.to(dev), w.to(dev), int(first.sum())


def check_agg(torch, dev) -> dict:
    from repro_torch.kernels.window_agg.kernel import window_agg
    from repro_torch.kernels.window_agg.ref import window_agg_ref
    worst = 0.0
    for label, seg, vals, s in agg_cases(torch, dev):
        sums, counts = window_agg(seg, vals, s)
        rsums, rcounts = window_agg_ref(seg, vals, s)
        torch.cuda.synchronize()
        if not torch.equal(counts.to(rcounts.dtype), rcounts):
            raise AssertionError(f"window_agg counts mismatch on {label}")
        if vals.dtype == torch.int64:
            if not torch.equal(sums, rsums):
                raise AssertionError(f"window_agg int64 mismatch on {label}")
        else:
            torch.testing.assert_close(sums, rsums, **F32_TOL)
            if len(sums):
                worst = max(worst, float((sums - rsums).abs().max()))
    gids, w, s = agg_main_shape(torch, dev)
    sums, counts = window_agg(gids, w, s)
    rsums, rcounts = window_agg_ref(gids, w, s)
    torch.cuda.synchronize()
    if not (torch.equal(sums, rsums) and torch.equal(counts, rcounts)):
        raise AssertionError("window_agg mismatch at the main-path shape")
    n, v = w.shape
    acc = torch.zeros((s, v), dtype=w.dtype, device=dev)
    # the bare launch into preallocated sums/counts (they accumulate
    # across the timed launches; only the time is read)
    from repro_torch.kernels import _build
    fn = _build.library().window_agg_i64
    seg32 = gids.to(torch.int32)
    cnt = torch.zeros(s, dtype=w.dtype, device=dev)
    args = (seg32.data_ptr(), w.data_ptr(), n, v, s, acc.data_ptr(),
            cnt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    must = n * (4 + 8 * v) + s * (8 * v + 8)
    res = {
        "name": "window_agg", "route": "cuda",
        "source": "src/repro_torch/csrc/window_agg.cu",
        "replaces": "src/repro/kernels/window_agg/kernel.py:55",
        "max_abs_err": worst,
        "shape": f"N={n} int64 weights, S={s} sorted segments, V={v}",
        "ms": device_ms(lambda: fn(*args), cold=True),
        "warm_ms": device_ms(lambda: fn(*args), cold=False),
        "wrapper_ms": call_ms(lambda: window_agg(gids, w, s)),
        "plain_ms": device_ms(lambda: window_agg_ref(gids, w, s), cold=True),
        "library_ms": device_ms(lambda: acc.index_add_(0, gids, w),
                                cold=True),
        "bound_bytes": must,
        "bound_ms": must / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
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


def profile_episode(key: str, golden: dict, dev: str,
                    wall_unprofiled: float | None) -> None:
    """One episode under torch.profiler: device time by kernel, written to
    chiprun_out/, and the device's busy share of the episode's
    unprofiled wall time (the profiler slows the host, not the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_episode(key, golden, dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    (OUT / f"profile_{key}.txt").write_text(
        avgs.table(sort_by="self_device_time_total", row_limit=60))
    # device-side entries only (kernels, copies): op rows repeat the time
    # of the kernels they launch
    on_dev = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    emit({"phase": "profile", "episode": key, "wall_s_profiled": wall,
          "wall_s_unprofiled": wall_unprofiled, "device_s": dev_s,
          "device_busy_share": dev_s / wall_unprofiled
          if wall_unprofiled else None,
          "top": [{"name": e.key[:70], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in on_dev[:15]]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile q8_justin into chiprun_out/")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    rows = [check_probe(torch, dev), check_agg(torch, dev)]
    emit({"kernels": ["sorted_probe", "window_agg"]})

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
        profile_episode("q8_justin", golden, dev, walls.get("q8_justin"))

    for row in rows:
        row["launches"] = totals[row["name"]]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "warm_ms", "wrapper_ms")}
        for r in rows]})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
