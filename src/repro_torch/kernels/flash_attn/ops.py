"""Public wrapper for flash attention.

CUDA tensors go through the hand-written kernels, CPU tensors through the
plain PyTorch version; there is no other path and no fallback.  On the
card a call that must carry a gradient (grad enabled and q, k or v
requiring it) goes through ``FlashAttention``: the forward kernel with
the rows' log-sum-exp, and the backward kernel (``csrc/flash_attn_bwd.cu``)
for its gradient.  A serving call (no gradient) launches the forward
alone.  On the CPU the plain version is differentiable as it is.
``launches`` counts forward launches and ``bwd_launches`` backward
launches (reset them to 0 to count a run).

A meta-device call (the dry-run's trace, ``launch/dryrun.py``) runs
nothing: it goes through the operator ``repro_torch::attention_meta``
(and ``attention_meta_grad`` for its gradient), which gives the shapes.
Their formulas, registered with ``torch.utils.flop_counter``, count the
operations the mask's attended keys need (``ref.attended_keys``; 2
operations a multiply-add): 2 products forward (QK^T, PV) and 5 for the
gradient (S again, dP, dV, dK, dQ)."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attn.kernel import (flash_attention,
                                                   flash_attention_bwd)
from repro_torch.kernels.flash_attn.ref import (attended_keys,
                                                flash_attention_ref)

launches = 0
bwd_launches = 0


class FlashAttention(torch.autograd.Function):
    """The forward kernel (with its log-sum-exp, saved with q, k, v and
    the output) and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk_attn):
        global launches
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   chunk_attn=chunk_attn, lse=True)
        launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, chunk_attn=chunk_attn)
        return out

    @staticmethod
    def backward(ctx, dout):
        global bwd_launches
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.mask)
        bwd_launches += 1
        return dq, dk, dv, None, None, None


_MASK_ARGS = "bool causal, int? window, int? chunk_attn"
torch.library.define("repro_torch::attention_meta",
                     f"(Tensor q, Tensor k, Tensor v, {_MASK_ARGS}) -> Tensor")
torch.library.define("repro_torch::attention_meta_grad",
                     f"(Tensor q, Tensor k, Tensor v, {_MASK_ARGS}) -> "
                     f"(Tensor, Tensor, Tensor)")


@torch.library.impl("repro_torch::attention_meta", "Meta")
def attention_meta(q, k, v, causal, window, chunk_attn):
    return torch.empty_like(q)


@torch.library.impl("repro_torch::attention_meta_grad", "Meta")
def attention_meta_grad(q, k, v, causal, window, chunk_attn):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _meta_save(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:3])
    ctx.mask = inputs[3:]


def _meta_backward(ctx, dout):
    return (*torch.ops.repro_torch.attention_meta_grad(*ctx.saved_tensors,
                                                       *ctx.mask),
            None, None, None)


torch.library.register_autograd("repro_torch::attention_meta",
                                _meta_backward, setup_context=_meta_save)


def _product(q_shape, kv_len: int, causal, window, chunk_attn) -> int:
    """Operations of one [Sq x attended keys] product over q's heads."""
    b, hq, sq, d = q_shape
    return 2 * b * hq * d * attended_keys(sq, kv_len, causal=causal,
                                          window=window,
                                          chunk_attn=chunk_attn)


@register_flop_formula(torch.ops.repro_torch.attention_meta)
def _attention_flops(q_shape, k_shape, v_shape, causal, window, chunk_attn,
                     *args, **kwargs) -> int:
    return 2 * _product(q_shape, k_shape[2], causal, window, chunk_attn)


@register_flop_formula(torch.ops.repro_torch.attention_meta_grad)
def _attention_grad_flops(q_shape, k_shape, v_shape, causal, window,
                          chunk_attn, *args, **kwargs) -> int:
    return 5 * _product(q_shape, k_shape[2], causal, window, chunk_attn)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              chunk_attn: int | None = None) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k, v [B, Hk, Skv, D], GQA when Hk < Hq (KV heads
    indexed, never repeated on the card); query row i at position
    i + Skv - Sq, masked as ``flash_attention_ref`` says (causal, sliding
    ``window``, local chunk of ``chunk_attn`` positions).  Returns
    [B, Hq, Sq, D] in q's dtype, differentiable in q, k and v on either
    device.  Degenerate shapes short-circuit: no query gives an empty
    result, no key gives zeros."""
    global launches
    if chunk_attn is not None and chunk_attn <= 0:
        raise ValueError(f"chunk_attn must be positive, got {chunk_attn}")
    if q.numel() == 0:
        return torch.empty_like(q)
    if k.shape[2] == 0:
        return torch.zeros_like(q)
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, chunk_attn)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              chunk_attn=chunk_attn)
        launches += 1
        return out
    if q.is_meta:
        return torch.ops.repro_torch.attention_meta(q, k, v, causal,
                                                   window, chunk_attn)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               chunk_attn=chunk_attn)
