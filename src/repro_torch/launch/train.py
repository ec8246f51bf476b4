"""Training driver: any architecture of ``repro_torch.configs``, with
checkpoint/restart fault tolerance (the reference's ``repro.launch.train``
on one device: no mesh).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 20 --ckpt-dir /tmp/ckpt [--resume auto] [--fail-at 10] \
      [--device cpu]

``--fail-at N`` injects a simulated preemption at step N (the process
keeps running, and the restart path runs in-process: restore from the
last committed checkpoint, or start again from the initialisation, and
continue).  ``--microbatch`` splits each batch for gradient accumulation,
``--compress-grads`` applies int8 compression with error feedback to the
gradients.  ``--full`` trains the published width and depth (on the card
only: llama3.2-3b's float32 parameters, gradients and AdamW moments take
51.4 GB, which fits one 80 GB card with ``remat="full"``).

Every attention goes through ``kernels/flash_attn``: on the card the
hand-written forward kernel and, for the gradient, the hand-written
backward kernel; on the CPU their plain versions.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.transformer import VIT_STUB_DIM
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.grad_compress import (compress_with_feedback,
                                             dequantize_int8, init_error_buf)
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_loss_fn, value_and_grad
from repro_torch.train.tree import tree_map


def synth_batch(cfg, batch: int, seq: int, generator: torch.Generator,
                device) -> dict:
    """Synthetic LM data from ``generator`` (on the CPU): ``tokens`` [B,
    seq] uniform over the vocabulary (a VLM's ``seq - img_tokens``, with
    ``img_emb`` [B, img_tokens, 1024] normal; an enc-dec's ``frames``
    [B, enc_seq, 1024] normal), moved to ``device``.  The reference draws
    with ``jax.random``, whose bits this cannot repeat."""
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=generator)}
    if cfg.family == "vlm":
        out["tokens"] = out["tokens"][:, :seq - cfg.img_tokens]
        out["img_emb"] = torch.randn((batch, cfg.img_tokens, VIT_STUB_DIM),
                                     generator=generator)
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.enc_seq, VIT_STUB_DIM),
                                    generator=generator)
    return {k: v.to(device) for k, v in out.items()}


def _init(model, cfg, dev: torch.device, seed: int) -> dict:
    """The reference's float32 initialisation, drawn from a generator
    seeded with ``seed`` on ``dev``."""
    return model.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                      device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(arch: str, *, reduced: bool = True, steps: int = 20,
          batch: int = 2, seq: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 10, resume: str = "no",
          fail_at: int | None = None, microbatch: int = 1,
          compress_grads: bool = False, lr: float = 1e-3,
          verbose: bool = True, device=None, seed: int = 0,
          repeat_batch: bool = False) -> dict:
    """Train ``arch`` (its reduced config unless ``reduced=False``) for
    ``steps`` steps on ``batch`` x ``seq`` synthetic tokens, step i's
    batch drawn by ``synth_batch`` from a generator seeded with
    ``seed + 1000 + i`` (with ``repeat_batch`` every step takes step 0's
    batch: the loss must then fall as the model learns it).
    ``device=None`` means ``cuda``, which must exist.  The result has the
    reference's keys plus ``losses`` (every step's, restarts included)
    and ``grad_norms``, and on the card
    ``step_s`` (the mean wall seconds of the steps after the first, each
    ending in a synchronise; the first alone when there is one),
    ``tokens_per_s`` (batch x seq over it) and ``peak_mem_gb``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    ocfg = AdamWConfig(lr=lr, opt_dtype=cfg.opt_dtype)
    loss_fn = make_loss_fn(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    params = _init(model, cfg, dev, seed)
    opt_state = init_opt_state(params, ocfg)
    err_buf = init_error_buf(params) if compress_grads else None
    start = 0

    if resume == "auto" and ckpt_dir \
            and ckpt_lib.latest_step(ckpt_dir) is not None:
        (params, opt_state), start = ckpt_lib.restore(
            ckpt_dir, (params, opt_state), cfg=cfg)
        if verbose:
            print(f"[train] resumed from step {start}")

    def step_fn(params, opt_state, data, err):
        loss, grads = value_and_grad(loss_fn, params, data, microbatch)
        if err is not None:      # int8 compression + error feedback
            qs, ss, err = compress_with_feedback(grads, err)
            grads = tree_map(dequantize_int8, qs, ss)
        params, opt_state, m = adamw_update(params, grads, opt_state, ocfg)
        return params, opt_state, m, err, loss

    losses, gnorms, step_walls = [], [], []
    restarts = 0
    i = start
    t0 = time.perf_counter()
    while i < steps:
        try:
            if fail_at is not None and i == fail_at:
                fail_at = None          # fail exactly once
                raise RuntimeError("injected node failure")
            data = synth_batch(cfg, batch, seq, torch.Generator()
                               .manual_seed(seed + 1000
                                            + (0 if repeat_batch else i)),
                               dev)
            _sync(dev)
            ts = time.perf_counter()
            params, opt_state, metrics, err_buf, loss = step_fn(
                params, opt_state, data, err_buf)
            losses.append(float(loss))
            gnorms.append(float(metrics["grad_norm"]))
            _sync(dev)
            step_walls.append(time.perf_counter() - ts)
            i += 1
            if ckpt_dir and i % ckpt_every == 0:
                ckpt_lib.save(ckpt_dir, i, (params, opt_state), cfg=cfg)
            if verbose and i % max(1, steps // 10) == 0:
                print(f"[train] step {i}: loss={losses[-1]:.4f} "
                      f"gnorm={gnorms[-1]:.3f}")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
            restarts += 1
            if verbose:
                print(f"[train] {e} at step {i} — restarting from checkpoint")
            if ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
                (params, opt_state), i = ckpt_lib.restore(
                    ckpt_dir, (params, opt_state), cfg=cfg)
            else:                        # no checkpoint yet: cold restart
                params = _init(model, cfg, dev, seed)
                opt_state = init_opt_state(params, ocfg)
                i = 0
    wall = time.perf_counter() - t0
    result = {"arch": arch, "steps": steps, "final_loss": losses[-1],
              "first_loss": losses[0], "restarts": restarts,
              "wall_s": round(wall, 1), "losses": losses,
              "grad_norms": gnorms}
    if dev.type == "cuda":
        timed = step_walls[1:] or step_walls
        result["step_s"] = statistics.mean(timed)
        result["tokens_per_s"] = batch * seq / result["step_s"]
        result["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if verbose:
        print(f"[train] done: {result}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat-batch", action="store_true",
                    help="every step takes step 0's batch")
    args = ap.parse_args()
    train(args.arch, reduced=args.reduced, steps=args.steps,
          batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, resume=args.resume,
          fail_at=args.fail_at, microbatch=args.microbatch,
          compress_grads=args.compress_grads, lr=args.lr,
          device=args.device, seed=args.seed,
          repeat_batch=args.repeat_batch)


if __name__ == "__main__":
    main()
