"""Public wrapper for decode attention.

CUDA tensors go through the hand-written kernel, CPU tensors through the
plain PyTorch version; there is no other path and no fallback.
``launches`` counts kernel launches (reset it to 0 to count a run)."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.kernel import decode_attention
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

launches = 0


def decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           valid_len) -> torch.Tensor:
    """q [B, Hq, D]; caches [B, Hk, S, D], GQA when Hk < Hq (KV heads
    indexed, never repeated on the card); valid_len an int or [B] ints:
    slots >= valid_len[b] are masked, valid_len 0 gives zeros.  Returns
    [B, Hq, D] in q's dtype.  Degenerate shapes short-circuit: no query
    gives an empty result, an empty cache gives zeros."""
    global launches
    if q.numel() == 0:
        return torch.empty_like(q)
    if k_cache.shape[2] == 0:
        return torch.zeros_like(q)
    if q.is_cuda:
        valid = torch.as_tensor(valid_len, dtype=torch.int32,
                                device=q.device).reshape(-1)
        out = decode_attention(q, k_cache, v_cache,
                               valid.expand(q.shape[0]).contiguous())
        launches += 1
        return out
    return decode_attention_ref(q, k_cache, v_cache, valid_len)
