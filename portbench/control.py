"""The readings a cell's limits are set from, on the chip, at the cell's
own size: the program's numbers on each of ``--seeds`` (the lower
readings), the float8 reference's put in the program's place on
``--control-seeds`` (the control, which must fail), and the program with
a fault planted (``--faults``) on ``--fault-seeds``.  One JSON line a run,
to standard output and appended to ``--out``.  The benchmark's own runs
never run this.

  python3 -m portbench.control --workload danube-train-4x8k \
      --seeds 11,12,13 --control-seeds 11,12,13 --faults half_batch \
      --fault-seeds 11,12,13 --seconds 2 --out readings.jsonl
"""
from __future__ import annotations

import argparse
import gc
import json
import time


def ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main() -> None:
    import torch
    from portbench import run
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=ints, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    plan = [(s, None) for s in dict.fromkeys(args.seeds + args.control_seeds)]
    plan += [(s, f) for f in args.faults.split(",") if f
             for s in args.fault_seeds]
    for seed, fault in plan:
        t = time.perf_counter()
        res, parts = run.run_cell(args.workload, seed, args.seconds, False,
                                  fault=fault,
                                  readings=True,
                                  control=fault is None
                                  and seed in args.control_seeds)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "program": res.get("readings") or {
                    k: v[0] for k, v in res["compared"].items()},
                "fp8": res.get("fp8"), "correct": res["correct"],
                "metrics": res["metrics"], "parts": parts,
                "peak": res["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del res
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
