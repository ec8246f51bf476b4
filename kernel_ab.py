"""A/B timing of the port's state-store and attention kernels against
another commit's.

Loads the kernel wrappers ``sorted_probe(table, queries)``,
``window_agg(seg_ids, values, n_segments)``, ``flash_attention(q, k,
v, causal=, window=)`` and ``decode_attention(q, k_cache, v_cache,
valid_len, lo, span)`` of this checkout and of a baseline tree (the
``src/repro_torch`` of another commit) into one process, each bound to
its own tree's kernel build, and times them in turns (baseline, current,
current, baseline) on one card, cold and warm, at ``chip_smoke.py``'s
main shapes and the store's call-site shapes, and (attention, cold) at
the prefill and decode shapes of llama3.2-3b, h2o-danube-1.8b and
mixtral-8x7b, where both prefill builds must give the same bits and both
decode builds must agree with the plain version (their bits are
reported).  A
wrapper's time is all the device work of one call: for a segment sum
that zeroes its outputs and casts its ids apart from the kernel, those
launches too.  The current probe's two routes are also timed by their
bare launches, so the plan's choice can be read off.  Every result is
first held exactly against this checkout's plain PyTorch versions.

    mkdir -p build/ab/base
    git archive <commit> src/repro_torch | tar -x -C build/ab/base
    python kernel_ab.py --base build/ab/base

Prints one JSON line per measurement and writes them all to
``chiprun_out/kernel_ab.json``.  Needs a CUDA card; imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import statistics
import sys

import numpy as np

import chip_smoke as cs

PACKAGE = "repro_torch"


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == PACKAGE or k.startswith(PACKAGE + ".")}


def load_wrappers(src: pathlib.Path | None = None) -> dict:
    """{kernel: wrapper} of the package under ``src``, or of this
    checkout's when None.  A tree other than this one is imported afresh
    with this checkout's modules set aside and put back after, so its
    wrappers keep their own ``_build`` and library."""
    def load() -> dict:
        return {k: getattr(importlib.import_module(
            f"{PACKAGE}.kernels.{mod}.kernel"), k)
            for k, mod in (("sorted_probe", "sorted_probe"),
                           ("window_agg", "window_agg"),
                           ("flash_attention", "flash_attn"),
                           ("decode_attention", "decode_attn"))}

    if src is None:
        return load()
    saved = _package_modules()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(src))
    try:
        wrappers = load()
    finally:
        sys.path.remove(str(src))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    return wrappers


def in_turns(variants: dict, cold: bool, rounds: int = 1) -> dict:
    """Every run's device ms of each variant, timed in turns A, B, B, A,
    ``rounds`` times."""
    names = list(variants)
    runs = {k: [] for k in names}
    for _ in range(rounds):
        for order in (names, names[::-1]):
            for k in order:
                runs[k].append(cs.device_ms(variants[k], cold=cold))
    return runs


def medians(runs: dict) -> dict:
    return {k: statistics.median(v) for k, v in runs.items()}


def probe_rows(torch, base, cur, dev) -> list:
    from repro_torch.kernels.sorted_probe.kernel import probe_plan
    shapes = [("main shape", *cs.probe_main_shape(torch, dev), True)]
    shapes += cs.probe_sites(torch, dev)
    # the inverse map at the largest batch of the census (4,900 keys)
    g = torch.Generator(device="cpu").manual_seed(14)
    uq = torch.unique(torch.randint(0, 1 << 45, (4_800,), generator=g))
    keys = uq[torch.randint(0, len(uq), (4_900,), generator=g)]
    shapes.append(("state/lsm.py:502 inverse map, largest", uq.to(dev),
                   keys.to(dev), False))
    rows = []
    for label, table, q, srt in shapes:
        variants = {"base": lambda t=table, x=q: base(t, x),
                    "current": lambda t=table, x=q: cur(t, x)}
        for name, fn in variants.items():
            cs.probe_check(torch, table, q, fn(), f"{name} at {label}")
        for lanes in cs.probe_routes(table):
            launch, got, _ = cs.probe_launch(torch, table, q, lanes)
            launch()
            cs.probe_check(torch, table, q, got, f"lanes {lanes} at {label}")
            variants[f"lanes {lanes}"] = launch
        for cold in (True, False):
            ms = medians(in_turns(variants, cold))
            rows.append({"kernel": "sorted_probe", "shape": label,
                         "n": len(q), "t": len(table), "queries_sorted": srt,
                         "plan_lanes": probe_plan(len(q), len(table))[0],
                         "cold": cold, "ms": ms,
                         "speedup": ms["base"] / ms["current"]})
            cs.emit(rows[-1])
    return rows


def agg_rows(torch, base, cur, dev) -> list:
    from repro_torch.kernels.window_agg.ref import window_agg_ref
    rows = []
    for label, (gids, w, s) in (("main shape", cs.agg_main_shape(torch, dev)),
                                ("state/lsm.py:382 _collapse (median)",
                                 cs.agg_site(torch, dev))):
        want = window_agg_ref(gids, w, s)
        variants = {"base": lambda a=(gids, w, s): base(*a),
                    "current": lambda a=(gids, w, s): cur(*a)}
        for name, fn in variants.items():
            got = fn()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} window_agg differs from the "
                                     f"plain version at {label}")
        for cold in (True, False):
            ms = medians(in_turns(variants, cold))
            rows.append({"kernel": "window_agg", "shape": label,
                         "n": len(gids), "segments": s, "cold": cold,
                         "ms": ms, "speedup": ms["base"] / ms["current"],
                         "bound_ms": cs.agg_bound_bytes(gids, w, s)
                         / cs.HBM_BYTES_PER_S * 1e3})
            cs.emit(rows[-1])
    return rows


# the served models whose attention shapes both builds run: (arch, serve
# sizes, flash seed, decode seed), the seeds of chip_smoke's phase 3 rows
SERVED = ((cs.ARCH, cs.SERVE, 32, 42),
          ("h2o-danube-1.8b", cs.SERVE_7["h2o-danube-1.8b"], 35, 44),
          ("mixtral-8x7b", cs.SERVE_7["mixtral-8x7b"], 36, 45))


def turns_row(variants: dict, **row) -> dict:
    """``variants`` timed cold in turns, ten runs each (five rounds of A,
    B, B, A): the row with every run, the medians and the spread of each
    variant's runs (the distance between their quartiles)."""
    runs = in_turns(variants, cold=True, rounds=5)
    ms = medians(runs)
    spread = {name: float(np.subtract(*np.percentile(r, [75, 25])))
              for name, r in runs.items()}
    row.update(cold=True, ms=ms, spread=spread, runs=runs,
               current_wins=sum(c < b for b, c in zip(runs["base"],
                                                      runs["current"])),
               speedup=ms["base"] / ms["current"])
    cs.emit(row)
    return row


def flash_rows(torch, base, cur, dev) -> list:
    """The prefill kernel at the served models' shapes without a chunk:
    both builds' outputs bit for bit equal, then timed in turns."""
    from repro_torch.configs import get_config
    rows = []
    for arch, sv, seed, _ in SERVED:
        q, k, v, window = cs.flash_shape(torch, dev, get_config(arch), sv,
                                         seed)
        variants = {"base": lambda a=(q, k, v), w=window: base(
                        *a, causal=True, window=w),
                    "current": lambda a=(q, k, v), w=window: cur(
                        *a, causal=True, window=w)}
        if not torch.equal(variants["base"](), variants["current"]()):
            raise AssertionError(f"flash_attention differs from the base "
                                 f"build at {arch}'s shape")
        rows.append(turns_row(variants, kernel="flash_attention",
                              shape=f"{arch} prefill", q=list(q.shape),
                              kv=list(k.shape), window=window))
        del q, k, v, variants
        torch.cuda.empty_cache()
    return rows


def decode_rows(torch, base, cur, dev) -> list:
    """The decode kernel at the served models' decode shapes, launched as
    the serve path launches it (one slot range on every row, bounds from
    ``layers.slot_bounds``, the plan cut over the span): each build held
    against the plain version, whether their bits agree reported, then
    timed in turns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    from repro_torch.models.layers import slot_bounds
    rows = []
    for arch, sv, _, seed in SERVED:
        q, k, v, lo, hi = cs.decode_shape(torch, dev, get_config(arch), sv,
                                          seed)
        bounds = slot_bounds(q.device, q.shape[0], lo, hi)
        args = (q, k, v, bounds[1], bounds[0], hi - lo)
        variants = {"base": lambda: base(*args),
                    "current": lambda: cur(*args)}
        want = decode_attention_ref(q, k, v, hi, lo)
        outs = {name: fn() for name, fn in variants.items()}
        for name, out in outs.items():
            cs.attn_err(torch, out, want, "bfloat16",
                        f"{name} decode_attention at {arch}'s shape")
        rows.append(turns_row(variants, kernel="decode_attention",
                              shape=f"{arch} decode", q=list(q.shape),
                              kv=list(k.shape), slots=[lo, hi],
                              bit_equal=torch.equal(outs["base"],
                                                    outs["current"])))
        del q, k, v, variants, outs
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path, required=True,
                    help="a tree holding another commit's src/repro_torch")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    cur = load_wrappers()
    base = load_wrappers(args.base.resolve() / "src")
    dev = "cuda"
    cs.emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
             "nvidia_smi": cs.smi()})
    rows = probe_rows(torch, base["sorted_probe"], cur["sorted_probe"], dev)
    rows += agg_rows(torch, base["window_agg"], cur["window_agg"], dev)
    rows += flash_rows(torch, base["flash_attention"],
                       cur["flash_attention"], dev)
    rows += decode_rows(torch, base["decode_attention"],
                        cur["decode_attention"], dev)
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "kernel_ab.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
