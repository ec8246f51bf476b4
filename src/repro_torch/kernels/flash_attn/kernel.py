"""ctypes binding of the CUDA flash-attention kernel (csrc/flash_attn.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.bfloat16: "flash_attn_bf16", torch.float32: "flash_attn_f32"}
MAX_D = 256
TMA_ALIGN = 16         # bytes: TMA's base and stride alignment


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 route's tensor maps can read ``t`` [B, H, S, D] in
    place: a 16-byte aligned base and (batch, head, seq) strides that are
    positive multiples of 16 bytes (the last dimension is contiguous)."""
    size = t.element_size()
    return t.data_ptr() % TMA_ALIGN == 0 and all(
        st > 0 and st * size % TMA_ALIGN == 0 for st in t.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    chunk_attn: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q [B, Hq, Sq, D], k/v [B, Hk, Skv,
    D] (Hq % Hk == 0: KV heads are indexed, never repeated).  ``window``
    keeps keys within it of each row's position, ``chunk_attn`` keys in
    the row's chunk of that many positions (floor division).  Any strides
    with a contiguous last dimension; the output has q's layout.  The bf16
    route reads operands through TMA tensor maps, which need 16-byte
    aligned bases and strides: an operand that breaks that (see
    ``tma_ready``) is first copied to a contiguous tensor, and the output
    then has the copy's layout.  The serve path never takes that copy.
    Raises on anything the kernel does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _FN:
        raise ValueError(f"flash_attention takes bfloat16 or float32 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B, Hq, Sq, D] and k, v "
                         f"[B, Hk, Skv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hk == 0 or hq % hk:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d % 16 or d > MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_D}")
    if max(sq, skv) >= 2**31:
        raise ValueError("sequence too long for int32 positions")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if chunk_attn is not None and chunk_attn <= 0:
        raise ValueError(f"chunk_attn must be positive, got {chunk_attn}")
    if max(sq, skv) + (chunk_attn or 0) >= 2**31:
        raise ValueError("chunk too long for int32 positions")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous last dimension")
    if q.dtype == torch.bfloat16:
        q, k, v = (t if tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    name = _FN[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hk, sq, skv, d, strides, int(causal), window or 0,
            chunk_attn or 0, stream)
    _build.check(err, name)
    return out
