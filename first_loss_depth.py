"""The first training loss and gradient norm of phase 15 (b)'s llama at
full width, by depth, on one card.

For each depth in ``--layers`` and each init in ``--norms``,
``chip_smoke.py`` phase 15 (b)'s float32 tree (``TRAIN_RANKS``: the
architecture, the seed) is drawn as that phase draws it
(``train_ranks_init``): its layers' RMS norm scales ``ln1``/``ln2`` as the
reference draws them ("drawn": every leaf of two or more dimensions
N(0, 0.02), the stacked scales included) or at ones ("ones": llama's own
initialisation of them, what the phase trains).  The loss and global
gradient norm of the phase's first two global batches
(``train_ranks_batch``) are taken on one device in bf16 and in float32
compute, beside ``ln V + 0.02^2 d / 2`` (``init_loss``: the first loss of
a final state uncorrelated with the tied embedding).

    python3 first_loss_depth.py [--layers 4,8,16,28] [--norms drawn,ones]

Needs a card (the attention runs through the port's kernels).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="4,8,16,28")
    ap.add_argument("--norms", default="drawn,ones")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("first_loss_depth.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    print(cs.smi(), flush=True)
    for norms in args.norms.split(","):
        for n_layers in (int(x) for x in args.layers.split(",")):
            t0 = time.perf_counter()
            sv = dict(cs.TRAIN_RANKS, layers=n_layers, norms=norms)
            cfg = cs.mesh_cfg(sv)
            params = cs.train_ranks_init(torch, cfg, sv, "cuda")
            line = {"arch": cfg.name, "layers": n_layers, "norms": norms,
                    "init_loss": cs.init_loss(cfg)}
            for i in range(2):
                data = cs.train_ranks_batch(torch, cfg, sv, i, "cuda")
                for dt in ("bfloat16", "float32"):
                    loss, grads = value_and_grad(make_loss_fn(
                        cfg.replace(compute_dtype=dt)), params, data)
                    line[f"batch{i}_{dt}"] = {
                        "loss": float(loss),
                        "grad_norm": float(global_norm(grads))}
                    del grads
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            del params
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
