"""ctypes bindings of the CUDA flash-attention kernels: the forward
(csrc/flash_attn.cu), optionally with the rows' log-sum-exp, and its
backward (csrc/flash_attn_bwd.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_FN = {torch.bfloat16: "flash_attn_bf16", torch.float32: "flash_attn_f32"}
_BWD = {torch.bfloat16: "flash_attn_bwd_bf16",
        torch.float32: "flash_attn_bwd_f32"}
MAX_D = 256
TMA_ALIGN = 16         # bytes: TMA's base and stride alignment


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 route's tensor maps can read ``t`` [B, H, S, D] in
    place: a 16-byte aligned base and (batch, head, seq) strides that are
    positive multiples of 16 bytes (the last dimension is contiguous)."""
    size = t.element_size()
    return t.data_ptr() % TMA_ALIGN == 0 and all(
        st > 0 and st * size % TMA_ALIGN == 0 for st in t.stride()[:3])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, chunk_attn: int | None,
           more: tuple = ()) -> None:
    """Raise on anything the kernels do not take: q [B, Hq, Sq, D], k/v
    [B, Hk, Skv, D] (and ``more`` tensors of q's shape) on one CUDA
    device in one of their dtypes, D a multiple of 16 up to MAX_D,
    Hq % Hk == 0, a contiguous last dimension, positive window and chunk,
    int32 positions."""
    ts = (q, k, v, *more)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention operands on different devices")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _FN:
        raise ValueError(f"flash_attention takes bfloat16 or float32 "
                         f"operands of one dtype, got "
                         f"{[str(t.dtype) for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or any(
            t.shape != q.shape for t in more):
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
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention needs a contiguous last dimension")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    chunk_attn: int | None = None, lse: bool = False):
    """Launch the kernel on CUDA tensors q [B, Hq, Sq, D], k/v [B, Hk, Skv,
    D] (Hq % Hk == 0: KV heads are indexed, never repeated).  ``window``
    keeps keys within it of each row's position, ``chunk_attn`` keys in
    the row's chunk of that many positions (floor division).  Any strides
    with a contiguous last dimension; the output has q's layout.  The bf16
    route reads operands through TMA tensor maps, which need 16-byte
    aligned bases and strides: an operand that breaks that (see
    ``tma_ready``) is first copied to a contiguous tensor, and the output
    then has the copy's layout.  The serve path never takes that copy.
    With ``lse`` the kernel also writes each row's log-sum-exp of its
    scaled scores, float32 [B, Hq, Sq] (+inf for a row with no key), and
    (out, lse) is returned.  Raises on anything the kernel does not
    take."""
    _check(q, k, v, window, chunk_attn)
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        q, k, v = (t if tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    lse_out = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
               if lse else None)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    name = _FN[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_out.data_ptr() if lse else None, b, hq, hk, sq, skv, d,
            strides, int(causal), window or 0, chunk_attn or 0, stream)
    _build.check(err, name)
    return (out, lse_out) if lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        chunk_attn: int | None = None):
    """Launch the backward on CUDA tensors: q, o (the forward's output), do
    (its gradient) [B, Hq, Sq, D], k/v [B, Hk, Skv, D] of one dtype, lse
    float32 [B, Hq, Sq] from ``flash_attention(..., lse=True)`` with the
    same mask.  Any strides with a contiguous last dimension.  Returns
    (dq, dk, dv), each with its operand's shape and dtype (dk and dv
    summed over each KV head's group); deterministic, no atomics.  Raises
    on anything the kernel does not take."""
    _check(q, k, v, window, chunk_attn, more=(o, do))
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or lse.shape != (b, hq, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 {(b, hq, sq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    # each q-head's float32 share of dk and dv, summed over its group
    part = (torch.empty((2, b, hq, skv, d), dtype=torch.float32,
                        device=q.device) if hq != hk else None)
    strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, o, do, dq, dk, dv)
                                      for st in t.stride()[:3]))
    name = _BWD[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), b, hq, hk, sq, skv, d,
            strides, int(causal), window or 0, chunk_attn or 0, stream)
    _build.check(err, name)
    return dq, dk, dv
