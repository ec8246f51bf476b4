"""Public wrapper for decode attention.

CUDA tensors go through the hand-written kernel, CPU tensors through the
plain PyTorch version; there is no other path and no fallback.
``launches`` counts kernel launches (reset it to 0 to count a run).  A
meta-device call (the dry-run's trace) runs nothing: it goes through the
operator ``repro_torch::decode_meta``, which gives the output's shape and
whose formula, registered with ``torch.utils.flop_counter``, counts the
operations of its ``span`` slots a row (2 products, 2 operations a
multiply-add)."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.decode_attn.kernel import decode_attention
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

launches = 0

torch.library.define("repro_torch::decode_meta",
                     "(Tensor q, Tensor k_cache, Tensor v_cache, int span) "
                     "-> Tensor")


@torch.library.impl("repro_torch::decode_meta", "Meta")
def decode_meta(q, k_cache, v_cache, span):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.decode_meta)
def _decode_flops(q_shape, k_shape, v_shape, span, *args, **kwargs) -> int:
    b, hq, d = q_shape
    return 4 * b * hq * d * span


def decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           valid_len, lo=None, span: int | None = None) -> torch.Tensor:
    """q [B, Hq, D]; caches [B, Hk, S, D], GQA when Hk < Hq (KV heads
    indexed, never repeated on the card); row b attends to the slots
    [lo[b], valid_len[b]) (``lo`` None: 0); an empty span gives zeros.  On
    the card each bound is an int32 [B] tensor on q's device and ``span``
    the longest span the caller knows of, which the kernel's split plan
    cuts (``kernel.decode_attention``); on the CPU a bound may also be an
    int.  Returns [B, Hq, D] in q's dtype.  Degenerate shapes
    short-circuit: no query gives an empty result, an empty cache gives
    zeros."""
    global launches
    if q.numel() == 0:
        return torch.empty_like(q)
    if k_cache.shape[2] == 0:
        return torch.zeros_like(q)
    if q.is_cuda:
        out = decode_attention(q, k_cache, v_cache, valid_len, lo, span)
        launches += 1
        return out
    if q.is_meta:
        if span is None:
            raise ValueError("a meta-device call counts its span: pass it")
        return torch.ops.repro_torch.decode_meta(q, k_cache, v_cache,
                                                 span)
    return decode_attention_ref(q, k_cache, v_cache, valid_len,
                                0 if lo is None else lo)
