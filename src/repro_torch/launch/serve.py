"""Serving entry point: prefill a batch of prompts, then greedy decode
against a KV cache, on the card (or on the CPU when asked, at a reduced
config).  Any architecture of ``repro_torch.configs``: dense, sliding
window (h2o-danube-1.8b), mixture of experts (mixtral-8x7b) with
llama4's chunked local attention (llama4-maverick-400b-a17b), the VLM
with its image-embedding prefix (internvl2-26b), the encoder-decoder
(whisper-medium, over a batch of audio frames), the state-space model
(mamba2-130m) and the RG-LRU / local-attention hybrid
(recurrentgemma-2b).  A VLM decodes from the position where its prefill
stopped, after the image tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --requests 4 --prompt-len 32 --decode 16

Every attention goes through ``kernels/flash_attn`` (prefill) and
``kernels/decode_attn`` (decode): the hand-written CUDA kernels on the
card, their plain versions on the CPU.  mamba2 has no attention, and
recurrentgemma's recurrent layers none: their recurrent states (the
cache leaves ``conv``, ``state`` and ``h``) are constant in the context
and pass ``pad_kv`` untouched.
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
from repro_torch.models.transformer import VIT_STUB_DIM


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
    matrices straight into the compute dtype; prompts, and a VLM's image
    embeddings or an enc-dec's frames, come from
    ``numpy.random.default_rng(seed)`` (``make_batch``).  ``device=None``
    means ``cuda``,
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


def make_batch(cfg, tokens: torch.Tensor, seed: int) -> dict:
    """The prefill batch for ``tokens`` [B, S]: a VLM's ``img_emb``
    [B, img_tokens, 1024] or an enc-dec's ``frames`` [B, enc_seq, 1024]
    drawn N(0, 1) in float32 from ``numpy.random.default_rng(seed)``
    (the same for every prompt length), on the tokens' device."""
    batch = {"tokens": tokens}
    extra = {"vlm": ("img_emb", cfg.img_tokens),
             "encdec": ("frames", cfg.enc_seq)}.get(cfg.family)
    if extra is not None:
        name, n = extra
        arr = np.random.default_rng(seed).standard_normal(
            (tokens.shape[0], n, VIT_STUB_DIM), dtype=np.float32)
        batch[name] = torch.as_tensor(arr, device=tokens.device)
    return batch


def prefix_len(cfg) -> int:
    """Positions a prefill fills before the prompt: a VLM's image
    tokens, else none.  A decode step after a prompt of S tokens is at
    ``prefix_len(cfg) + S``."""
    return cfg.img_tokens if cfg.family == "vlm" else 0


def pad_kv(caches: dict, n: int) -> dict:
    """Grow the self-attention caches by ``n`` slots so decode can
    append: every leaf keyed "k" or "v" (the reference's ``pad_kv``); an
    enc-dec's ``cross_k``/``cross_v`` stay as they are."""
    return {key: pad_kv(val, n) if isinstance(val, dict)
            else F.pad(val, (0, 0, 0, n)) if key in ("k", "v") else val
            for key, val in caches.items()}


def _serve(cfg, *, requests: int, prompt_len: int, decode: int,
           dev: torch.device, seed: int) -> dict:
    """``serve``'s body for one ``ArchConfig`` on ``dev``."""
    model = get_model(cfg)
    params = init_params(cfg, dev, seed)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (requests, prompt_len))
    batch = make_batch(cfg, torch.as_tensor(toks, device=dev), seed)
    t0_pos = prefix_len(cfg) + prompt_len
    launches0 = (flash_ops.launches, decode_ops.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, cfg)
    _sync(dev)
    t1 = time.perf_counter()
    # grow the caches so decode can append (prefill returns exactly S slots)
    caches = pad_kv(caches, decode)
    _sync(dev)
    t_dec = time.perf_counter()
    out_tokens = [logits.argmax(-1)]
    for i in range(decode):
        logits, caches = model.decode(params, caches, out_tokens[-1][:, None],
                                      t0_pos + i, cfg)
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
