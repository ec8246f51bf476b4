"""Census of the store kernels' calls in one golden episode, by call site.

    PYTHONPATH=src python store_census.py q8_justin
    PYTHONPATH=src python store_census.py q8_justin --store legacy
    PYTHONPATH=src python store_census.py q11_justin --out census.json

Runs the episode through ``repro_torch`` on the CPU, where it makes the
same store calls as on the card (the episodes are decision-identical on
both), and counts every call of the ``sorted_probe`` and ``window_agg``
wrappers (``kernels/*/ops.py``) that would launch its kernel on a CUDA
tensor: the degenerate shapes the wrappers short-circuit are not counted,
as they launch nothing.  Each call is filed under the line that called
the wrapper; per site it prints the calls and the median and largest N
(queries or rows) and T (table entries or segments).  The totals equal
``chip_smoke.py``'s launch counts of the same episode on the card.  Needs
no card and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def _site(frame) -> str:
    path = pathlib.Path(frame.f_code.co_filename)
    try:
        path = path.relative_to(ROOT / "src" / "repro_torch")
    except ValueError:
        pass
    return f"{path}:{frame.f_lineno} {frame.f_code.co_name}"


def census(key: str, store: str = "columnar") -> dict:
    """{kernel: {site: [(n, t), ...]}} and the wall seconds of ``key``
    under ``store`` on the CPU."""
    import torch

    from repro_torch.kernels.sorted_probe import ops as probe_ops
    from repro_torch.kernels.window_agg import ops as agg_ops
    from repro_torch.state import lsm

    calls: dict = {"sorted_probe": collections.defaultdict(list),
                   "window_agg": collections.defaultdict(list)}
    probe_ref, agg_ref = probe_ops.sorted_probe_ref, agg_ops.window_agg_ref

    def count_probe(table, queries):
        # this frame <- ops.probe <- the store's call site
        calls["sorted_probe"][_site(sys._getframe(2))].append(
            (int(queries.shape[0]), int(table.shape[0])))
        return probe_ref(table, queries)

    def count_agg(seg_ids, values, n_segments):
        calls["window_agg"][_site(sys._getframe(2))].append(
            (int(values.shape[0]), int(n_segments)))
        return agg_ref(seg_ids, values, n_segments)

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    golden = json.loads(chip_smoke.GOLDEN.read_text())
    torch.set_num_threads(1)
    probe_ops.sorted_probe_ref = count_probe
    agg_ops.window_agg_ref = count_agg
    lsm.set_store_impl(store)
    try:
        t0 = time.perf_counter()
        chip_smoke.run_episode(key, golden, "cpu")
        wall = time.perf_counter() - t0
    finally:
        lsm.set_store_impl("columnar")
        probe_ops.sorted_probe_ref = probe_ref
        agg_ops.window_agg_ref = agg_ref
    return calls, wall


def summary(calls: dict) -> dict:
    out = {}
    for kernel, sites in calls.items():
        rows = []
        for site, shapes in sorted(sites.items(), key=lambda kv: -len(kv[1])):
            ns = [n for n, _ in shapes]
            ts = [t for _, t in shapes]
            rows.append({"site": site, "calls": len(shapes),
                         "n_median": statistics.median(ns),
                         "n_max": max(ns),
                         "t_median": statistics.median(ts),
                         "t_max": max(ts)})
        out[kernel] = {"calls": sum(r["calls"] for r in rows),
                       "sites": rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("episode", help="a golden episode, e.g. q8_justin")
    ap.add_argument("--store", choices=("columnar", "legacy"),
                    default="columnar")
    ap.add_argument("--out", help="also write the summary here as JSON")
    args = ap.parse_args(argv)
    calls, wall = census(args.episode, args.store)
    res = {"episode": args.episode, "store": args.store,
           "device": "cpu", "wall_s": wall, **summary(calls)}
    for kernel in ("sorted_probe", "window_agg"):
        print(f"{kernel}: {res[kernel]['calls']} calls")
        for r in res[kernel]["sites"]:
            print(f"  {r['calls']:>6}  {r['site']:<48} N median "
                  f"{r['n_median']:g} max {r['n_max']}, T median "
                  f"{r['t_median']:g} max {r['t_max']}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({k: res[k] for k in ("episode", "store", "wall_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
