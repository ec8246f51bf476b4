"""The first training loss and gradient norm of a model that
``chip_smoke.py`` trains across ranks, at full width, by depth, on one
card.

For each depth in ``--layers`` and each init in ``--norms``, the float32
tree of ``--arch`` is drawn as ``chip_smoke.py`` draws it
(``train_ranks_init``; phase 15 (b)'s ``TRAIN_RANKS`` for llama3.2-3b,
phase 17 (b)'s ``TRAIN_FAMILIES`` entry for whisper-medium, mamba2-130m
and recurrentgemma-2b: the seed, the batch and the sequence length): its
layers' RMS norm scales (``ln1``/``ln2``, an SSM layer's ``ln``/``ssm_ln``)
as the reference draws them ("drawn": every leaf of two or more
dimensions N(0, 0.02), the stacked scales included) or at ones ("ones":
the models' own initialisation of them, what the phases train).  The
loss and global gradient norm of the phase's first two global batches
(``train_ranks_batch``) are taken on one device in bf16 and in float32
compute, beside ``ln V + 0.02^2 d / 2`` (``init_loss``: the first loss of
a final state uncorrelated with the output embedding).  An enc-dec's
depth is its encoder's and its decoder's each.

    python3 first_loss_depth.py [--arch llama3.2-3b] [--layers 4,8,16,28]
                                [--norms drawn,ones]

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


# the depths measured by default: llama's phase 15 (b) cut and its whole
# stack; the families' phase 17 (b) depths and their neighbours
DEPTHS = {"llama3.2-3b": "4,8,16,28", "whisper-medium": "6,24",
          "mamba2-130m": "4,24", "recurrentgemma-2b": "4,26"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=("llama3.2-3b", "whisper-medium", "mamba2-130m",
                             "recurrentgemma-2b"))
    ap.add_argument("--layers", default=None,
                    help="comma-separated depths (default: the arch's "
                         "DEPTHS)")
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
    base = next((sv for sv in (cs.TRAIN_RANKS, *cs.TRAIN_FAMILIES.values())
                 if sv["arch"] == args.arch))
    layers = args.layers or DEPTHS[args.arch]
    for norms in args.norms.split(","):
        for n_layers in (int(x) for x in layers.split(",")):
            t0 = time.perf_counter()
            sv = dict(base, layers=n_layers, norms=norms)
            if "enc_layers" in base:
                sv["enc_layers"] = n_layers
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
