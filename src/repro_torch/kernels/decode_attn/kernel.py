"""ctypes binding of the CUDA decode-attention kernel (csrc/decode_attn.cu)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_FN = {torch.bfloat16: "decode_attn_bf16", torch.float32: "decode_attn_f32"}
MAX_D = 128
MAX_GROUP = 8          # q-heads per KV head one block serves
TILE = 64              # cache slots per tile (a split is a multiple)
# resident blocks per SM: a block holds a 3-stage ring of 32 KB K/V tiles
# (96 KB of the SM's 227 KB of shared memory) and 288 threads (up to 4
# q-heads per KV head; a larger group needs the registers of two blocks)
BLOCKS_PER_SM = 2


def split_plan(batch: int, kv_heads: int, slots: int, sms: int
               ) -> tuple[int, int]:
    """(chunk, n_splits): the cache is cut along S into n_splits chunks of
    ``chunk`` slots (a multiple of TILE) so that the batch * kv_heads *
    n_splits blocks fit on the card at once, BLOCKS_PER_SM on each SM: a
    second wave of blocks would stream its bytes after the first one's
    tail, and the last block of each (b, KV head) merges the splits."""
    want = min(max(1, BLOCKS_PER_SM * sms // (batch * kv_heads)),
               _cdiv(slots, TILE))
    chunk = _cdiv(_cdiv(slots, want), TILE) * TILE
    return chunk, _cdiv(slots, chunk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor
                     ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q [B, Hq, D], caches [B, Hk, S, D]
    (Hq % Hk == 0, Hq / Hk <= 8: KV heads are indexed, never repeated) and
    valid_len [B] int32.  Any strides with a contiguous last dimension; the
    kernel copies cache rows 16 bytes at a time, so a cache whose base or
    strides are not 16-byte aligned is first copied to a contiguous tensor
    (the serve path's caches never are).  Returns [B, Hq, D].

    One launch: the splits' last block merges them, found by an atomic
    ticket in a per-device int32 buffer that the kernel leaves zeroed.
    Calls on two streams at once must not share that buffer: run them on
    one stream.  Raises on anything the kernel does not take."""
    ts = (q, k_cache, v_cache, valid_len)
    if not all(t.is_cuda for t in ts):
        raise ValueError("decode_attention kernel needs CUDA tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("decode_attention inputs on different devices")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _FN:
        raise ValueError(f"decode_attention takes bfloat16 or float32 q and "
                         f"caches of one dtype, got {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention takes q [B, Hq, D] and caches "
                         f"[B, Hk, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, hq, d = q.shape
    _, hk, s, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hk == 0 \
            or hq % hk or hq // hk > MAX_GROUP:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)} (at most {MAX_GROUP} q-heads "
                         f"per KV head)")
    if d % 16 or d > MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_D}")
    if s >= 2**31:
        raise ValueError("cache too long for int32 slots")
    if valid_len.dtype != torch.int32 or tuple(valid_len.shape) != (b,):
        raise ValueError(f"valid_len must be int32 [{b}], got "
                         f"{valid_len.dtype} {tuple(valid_len.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention needs a contiguous last dimension")
    valid_len = valid_len.contiguous()
    k_cache, v_cache = (c if rows_aligned(c) else c.clone(
        memory_format=torch.contiguous_format) for c in (k_cache, v_cache))
    dev = q.device
    chunk, n_splits = split_plan(b, hk, s, _sm_count(dev.index))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    part_ml = torch.empty((2, b, hq, n_splits), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((b, hq, n_splits, d), dtype=torch.float32,
                           device=dev)
    strides = (ctypes.c_int64 * 10)(*q.stride()[:2], *k_cache.stride()[:3],
                                    *v_cache.stride()[:3], *out.stride()[:2])
    name = _FN[q.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), name)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_len.data_ptr(), out.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), part_acc.data_ptr(),
            tickets(dev, b * hk).data_ptr(), b, hq, hk, s, d, strides, chunk,
            n_splits, stream)
    _build.check(err, name)
    return out


def rows_aligned(cache: torch.Tensor) -> bool:
    """Whether the kernel's 16-byte copies can read ``cache`` [B, Hk, S, D]
    in place: a 16-byte aligned base and (batch, head, slot) strides that
    are multiples of 16 bytes."""
    size = cache.element_size()
    return cache.data_ptr() % 16 == 0 and all(
        st * size % 16 == 0 for st in cache.stride()[:3])


_tickets: dict[torch.device, torch.Tensor] = {}


def tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The device's int32 ticket buffer, at least ``n`` long, allocated
    zeroed once (and again only to grow); every launch leaves it zeroed."""
    buf = _tickets.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=dev)
        _tickets[dev] = buf
    return buf


@functools.cache
def _sm_count(index: int | None) -> int:
    if index is None:
        index = torch.cuda.current_device()
    return torch.cuda.get_device_properties(index).multi_processor_count
