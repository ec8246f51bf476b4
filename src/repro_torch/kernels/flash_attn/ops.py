"""Public wrapper for flash attention.

CUDA tensors go through the hand-written kernel, CPU tensors through the
plain PyTorch version; there is no other path and no fallback.
``launches`` counts kernel launches (reset it to 0 to count a run)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.kernel import flash_attention
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

launches = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None
              ) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k, v [B, Hk, Skv, D], GQA when Hk < Hq (KV heads
    indexed, never repeated on the card).  Returns [B, Hq, Sq, D] in q's
    dtype.  Degenerate shapes short-circuit: no query gives an empty
    result, no key gives zeros."""
    global launches
    if q.numel() == 0:
        return torch.empty_like(q)
    if k.shape[2] == 0:
        return torch.zeros_like(q)
    if q.is_cuda:
        out = flash_attention(q, k, v, causal=causal, window=window)
        launches += 1
        return out
    return flash_attention_ref(q, k, v, causal=causal, window=window)
