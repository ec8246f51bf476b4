"""A/B timing of the port's state-store and attention kernels against
another commit's.

Loads the kernel wrappers ``sorted_probe(table, queries)``,
``window_agg(seg_ids, values, n_segments)``, ``flash_attention(q, k,
v, causal=, window=)``, ``flash_attention_bwd(q, k, v, o, do, lse,
causal=, window=, chunk_attn=)`` and ``decode_attention(q, k_cache,
v_cache, valid_len, lo, span)`` of this checkout and of a baseline tree (the
``src/repro_torch`` of another commit) into one process, each bound to
its own tree's kernel build, and times them in turns (baseline, current,
current, baseline) on one card, cold and warm, at ``chip_smoke.py``'s
main shapes and the store's call-site shapes, and (attention, cold) at
the prefill and decode shapes of llama3.2-3b, h2o-danube-1.8b and
mixtral-8x7b, where both prefill builds must give the same bits and both
decode builds must agree with the plain version (their bits are
reported), and (the flash backward, cold) at the training shapes of
llama3.2-3b and recurrentgemma-2b, where each build must agree with the
plain version and repeat bit for bit.  Without ``--base`` (and with it,
last) this checkout's backward alone is timed in turns at the shapes
where ``bwd_plan`` may cut a group into shares, once for each cut (the
wrapper's ``shares``), each held against the plain version.  A
wrapper's time is all the device work of one call: for a segment sum
that zeroes its outputs and casts its ids apart from the kernel, those
launches too.  The current probe's two routes are also timed by their
bare launches, so the plan's choice can be read off.  Every result is
first held exactly against this checkout's plain PyTorch versions.

    mkdir -p build/ab/base
    git archive <commit> src/repro_torch | tar -x -C build/ab/base
    python kernel_ab.py --base build/ab/base
    python kernel_ab.py                 # the backward's cuts alone

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
                           ("flash_attention_bwd", "flash_attn"),
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
    shapes.append(("lsm.get_batch inverse map, largest", uq.to(dev),
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
                                ("lsm._collapse (median)",
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


# the training shapes both backward builds run: (arch, batch, tokens,
# seed), chip_smoke's phase 10 (a) rows
TRAINED = ((cs.ARCH, cs.TRAIN["batch"], cs.TRAIN["seq"], 63),
           (cs.HYBRID, 1, 4096, 64))


def flash_bwd_rows(torch, base, cur, dev) -> list:
    """The backward at llama3.2-3b's and recurrentgemma-2b's training
    shapes (``chip_smoke.train_attn_shape``'s [B, S, H, D] views, the
    config's window): this checkout's forward gives the output and
    log-sum-exp both builds take; each build's gradients held against
    ``flash_attention_bwd_ref`` at ``BWD_TOL`` and a second call equal bit
    for bit (the builds sum in different orders, so their bits may
    differ: reported), then timed in turns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.kernel import (bwd_plan,
                                                       flash_attention)
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for arch, b, s, seed in TRAINED:
        cfg = get_config(arch)
        q, k, v = cs.train_attn_shape(torch, dev, cfg, b, s, seed)
        kw = dict(causal=True, window=cfg.window, chunk_attn=None)
        out, lse = flash_attention(q, k, v, lse=True, **kw)
        g = torch.Generator(device="cpu").manual_seed(62)
        do = cs._randn(torch, g, tuple(out.shape), dev, out.dtype)
        args = (q, k, v, out, do, lse)
        variants = {"base": lambda: base(*args, **kw),
                    "current": lambda: cur(*args, **kw)}
        want = flash_attention_bwd_ref(*args, **kw)
        outs = {}
        for name, fn in variants.items():
            outs[name] = fn()
            cs.bwd_err(torch, outs[name], want, "bfloat16",
                       f"{name} flash_attention_bwd at {arch}'s shape")
            if not all(torch.equal(x, y) for x, y in zip(outs[name], fn())):
                raise AssertionError(f"{name} flash_attention_bwd not "
                                     f"repeatable at {arch}'s shape")
        del want
        plan = bwd_plan(b, cfg.num_heads, cfg.num_kv_heads, s, s,
                        cfg.head_dim, q.dtype, sms, window=cfg.window)
        rows.append(turns_row(
            variants, kernel="flash_attention_bwd",
            shape=f"{arch} training", q=list(q.shape), kv=list(k.shape),
            window=cfg.window, route=plan.route, shares=plan.shares,
            launches_per_call=plan.launches,
            bit_equal=all(torch.equal(x, y) for x, y in zip(
                outs["base"], outs["current"]))))
        del q, k, v, out, lse, do, args, variants, outs
        torch.cuda.empty_cache()
    return rows


# (b, hq, hk, s, d, causal) bf16 shapes: llama3.2-3b's heads at batch 1
# (8 x 16 = 128 dK/dV blocks) with and without the causal mask and at its
# training batch of 2, the sweep's MQA (8 blocks) and its groups of 3 over
# 128 blocks, and an MQA over 4,096 keys
SHARED = ((1, 24, 8, 2048, 128, True), (1, 24, 8, 2048, 128, False),
          (2, 24, 8, 2048, 128, True), (1, 10, 1, 1024, 128, True),
          (2, 24, 8, 1024, 128, True), (1, 10, 1, 4096, 128, True))


def bwd_shares_rows(torch, cur, dev) -> list:
    """This checkout's backward at each ``SHARED`` shape once for each cut
    of a group into s shares (1, 2, the plan's, and the counts that make
    the shares of one size), each held against ``flash_attention_bwd_ref``
    at ``BWD_TOL`` and repeating bit for bit, timed cold in turns (five
    rounds): the medians, quartile spreads, the plan's pick and the dK/dV
    time its model gives each cut (``bwd_plan``)."""
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    g = torch.Generator(device="cpu").manual_seed(65)
    for b, hq, hk, s, d, causal in SHARED:
        q = cs._randn(torch, g, (b, hq, s, d), dev, torch.bfloat16)
        k, v = (cs._randn(torch, g, (b, hk, s, d), dev, torch.bfloat16)
                for _ in range(2))
        out, lse = fk.flash_attention(q, k, v, causal=causal, lse=True)
        do = cs._randn(torch, g, tuple(out.shape), dev, out.dtype)
        args = (q, k, v, out, do, lse)
        group = hq // hk
        plan = fk.bwd_plan(b, hq, hk, s, s, d, q.dtype, sms, causal=causal)
        cuts = sorted({1, min(2, group), plan.shares} | {
            n for n in range(2, group + 1) if group % n == 0})
        variants = {f"shares {n}": (lambda n=n: cur(*args, causal=causal,
                                                   shares=n))
                    for n in cuts}
        want = flash_attention_bwd_ref(*args, causal=causal)
        walks = fk.dkdv_walks(s, s, causal)
        shape = (b, hq, hk, s, d, causal)
        for name, fn in variants.items():
            got = fn()
            cs.bwd_err(torch, got, want, "bfloat16",
                       f"flash_attention_bwd {name} at {shape}")
            if not all(torch.equal(x, y) for x, y in zip(got, fn())):
                raise AssertionError(f"flash_attention_bwd {name} not "
                                     f"repeatable at {shape}")
        del want
        runs = in_turns(variants, cold=True, rounds=5)
        ms = medians(runs)
        rows.append({
            "kernel": "flash_attention_bwd", "shape": "shares",
            "q": list(q.shape), "kv": list(k.shape), "causal": causal,
            "sms": sms, "dkdv_blocks": b * hk * -(-s // 128),
            "plan_shares": plan.shares, "fastest": min(ms, key=ms.get),
            "model_dkdv_us": {f"shares {n}": 1e6 * (
                fk.dkdv_span(b, hk, group, n, walks, sms) * fk.BWD_STEP_S
                * d / 128 + (16 * n * b * hk * s * d if n > 1 else 0)
                / fk.BWD_PART_BYTES_PER_S) for n in cuts},
            "cold": True, "ms": ms,
            "spread": {name: float(np.subtract(*np.percentile(
                r, [75, 25]))) for name, r in runs.items()},
            "runs": runs})
        cs.emit(rows[-1])
        del q, k, v, out, lse, do, args, variants
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path,
                    help="a tree holding another commit's src/repro_torch "
                    "(without it only the backward's cuts are timed)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    cur = load_wrappers()
    dev = "cuda"
    cs.emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
             "nvidia_smi": cs.smi()})
    rows = []
    if args.base is not None:
        base = load_wrappers(args.base.resolve() / "src")
        rows += probe_rows(torch, base["sorted_probe"], cur["sorted_probe"],
                           dev)
        rows += agg_rows(torch, base["window_agg"], cur["window_agg"], dev)
        rows += flash_rows(torch, base["flash_attention"],
                           cur["flash_attention"], dev)
        rows += decode_rows(torch, base["decode_attention"],
                            cur["decode_attention"], dev)
        rows += flash_bwd_rows(torch, base["flash_attention_bwd"],
                               cur["flash_attention_bwd"], dev)
    rows += bwd_shares_rows(torch, cur["flash_attention_bwd"], dev)
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "kernel_ab.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
