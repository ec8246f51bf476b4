"""Serving entry point: prefill a batch of prompts, then greedy decode
against a KV cache, on the card (or on the CPU when asked, at a reduced
config).  Any architecture of ``repro_torch.configs``: dense, sliding
window (h2o-danube-1.8b) and mixture of experts (mixtral-8x7b).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 4 --prompt-len 32 --decode 16

Every attention goes through ``kernels/flash_attn`` (prefill) and
``kernels/decode_attn`` (decode): the hand-written CUDA kernels on the
card, their plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import get_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, requests: int = 4, prompt_len: int = 32,
          decode: int = 16, reduced: bool = True, verbose: bool = True,
          device=None, seed: int = 0) -> dict:
    """Answer ``requests`` prompts of ``prompt_len`` random tokens with
    ``decode + 1`` greedy tokens each (the first is the prefill's argmax).

    Weights are the reference's random initialisation drawn from a
    ``torch.Generator`` seeded with ``seed`` on the run's device, the layer
    matrices straight into the compute dtype; prompts come from
    ``numpy.random.default_rng(seed)``.  ``device=None`` means ``cuda``,
    which must exist.  The result has the reference's keys plus
    ``prefill_s``, ``decode_ms_per_step``, ``peak_mem_gb`` (card only) and
    the kernel ``launches`` of this call."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    result = _serve(cfg, requests=requests, prompt_len=prompt_len,
                    decode=decode, dev=dev, seed=seed)
    result["arch"] = arch
    if verbose:
        print(f"[serve] {result}")
    return result


def init_params(cfg, dev: torch.device, seed: int) -> dict:
    """The serving tree: drawn in the sorted-path order from a generator
    seeded with ``seed``, the layer matrices straight into the compute
    dtype (the float32 tree of a model at mixtral's size would not fit the
    card before its cast)."""
    gen = torch.Generator(dev).manual_seed(seed)
    return get_model(cfg).init(cfg, gen,
                               dtype=getattr(torch, cfg.compute_dtype))


def _serve(cfg, *, requests: int, prompt_len: int, decode: int,
           dev: torch.device, seed: int) -> dict:
    """``serve``'s body for one ``ArchConfig`` on ``dev``."""
    model = get_model(cfg)
    params = init_params(cfg, dev, seed)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (requests, prompt_len))
    tokens = torch.as_tensor(toks, device=dev)
    launches0 = (flash_ops.launches, decode_ops.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": tokens}, cfg)
    _sync(dev)
    t1 = time.perf_counter()
    # grow the caches so decode can append (prefill returns exactly S slots)
    caches = {name: {kv: F.pad(c, (0, 0, 0, decode)) for kv, c in
                     group.items()} for name, group in caches.items()}
    _sync(dev)
    t_dec = time.perf_counter()
    out_tokens = [logits.argmax(-1)]
    for i in range(decode):
        logits, caches = model.decode(params, caches, out_tokens[-1][:, None],
                                      prompt_len + i, cfg)
        out_tokens.append(logits.argmax(-1))
    _sync(dev)
    t2 = time.perf_counter()
    gen_tokens = torch.stack(out_tokens, 1).cpu()
    wall = t2 - t0
    return {
        "arch": cfg.name, "requests": requests, "generated": decode + 1,
        "tokens_per_s": requests * (decode + 1) / wall,
        "wall_s": wall,
        "sample": [int(x) for x in gen_tokens[0][:8]],
        "prefill_s": t1 - t0,
        "decode_ms_per_step": (t2 - t_dec) * 1e3 / max(decode, 1),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        "launches": {"flash_attention": flash_ops.launches - launches0[0],
                     "decode_attention": decode_ops.launches - launches0[1]},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode", type=int, default=16)
    args = ap.parse_args()
    serve(args.arch, requests=args.requests, prompt_len=args.prompt_len,
          decode=args.decode)


if __name__ == "__main__":
    main()
