"""ctypes binding of the CUDA decode-attention kernel (csrc/decode_attn.cu)."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.kernel import tma_ready

_FN = {torch.bfloat16: "decode_attn_bf16", torch.float32: "decode_attn_f32"}
MAX_D = 256
TILE = 64              # cache slots per tile (a split is a multiple)
# bf16, the tensor cores: the q-heads a block serves (the 16 rows of
# mma.m16n8k16), and the blocks of 160 threads an SM holds of the
# instantiation for D <= 64, 128 and 256 (48, 96 and 192 KB rings)
MMA_HEADS = 16
MMA_BLOCKS_PER_SM = {64: 4, 128: 2, 256: 1}
# the most splits of each instantiation: the last block stages a head's
# partials and the splits' (m, l) in its ring
MMA_MAX_SPLITS = {64: 64, 128: 128, 256: 128}
# the fewest slots a split of the tensor cores' route walks while the span
# has them: below 4 tiles a block's set-up, its partial and the merge cost
# more than the walk it saves (kernel_ab.py --breakdown's split sweep)
MMA_MIN_CHUNK = 4 * TILE
# where the (b, KV head, sub-group) blocks fill a quarter of the SMs or
# more, the span is cut only so that no block walks more than
# MMA_MAX_WALK bytes of K and V: at the served batches of 8 one split was
# the fastest up to llama's 1.08 MB a block, two at h2o-danube's 1.31 MB
# (kernel_ab.py --breakdown's split sweep on an H100, PERF.md §6)
MMA_FILL = 4
MMA_MAX_WALK = 1_200_000
# float32, the CUDA cores: resident blocks per SM; a block holds a 3-stage
# ring of 32 KB K/V tiles (96 KB of the SM's 227 KB of shared memory) and
# 288 threads (up to 4 q-heads at D <= 128, 2 at D 256; a block of more
# heads takes the registers of two)
BLOCKS_PER_SM = 2


class DecodePlan(NamedTuple):
    """How ``decode_attention`` launches: ``route`` "mma" (bf16: the tensor
    cores, a whole group of up to 16 q-heads a block) or "cuda_core"
    (float32); ``heads`` q-heads a block, ``n_sub`` blocks (sub-groups) a
    KV head's group takes, ``row_tiles`` 16-row mma tiles a block's heads
    fill (0 on the CUDA cores), ``tile`` slots a tile, ``blocks_per_sm``
    that the instantiation gets, and the span cut into ``n_splits`` chunks
    of ``chunk`` slots."""
    route: str
    heads: int
    n_sub: int
    row_tiles: int
    tile: int
    blocks_per_sm: int
    chunk: int
    n_splits: int


@functools.lru_cache(maxsize=4096)
def decode_plan(dtype: torch.dtype, batch: int, hq: int, hk: int, d: int,
                span: int, sms: int) -> DecodePlan:
    """The launch of q [batch, hq, d] against caches of ``hk`` KV heads
    whose longest attended span is ``span`` slots, on ``sms`` SMs.

    bf16: one block per (b, KV head, split) serves the whole group (a
    group above 16 in ceil(G / 16) sub-groups), and the span is cut so
    that the blocks fill the card once at ``MMA_BLOCKS_PER_SM`` each
    (``cut``), into splits of at least ``MMA_MIN_CHUNK`` slots and at most
    ``MMA_MAX_SPLITS`` of them; where the blocks alone fill a
    ``1 / MMA_FILL`` share of the SMs, into as few as keep a block's walk
    within ``MMA_MAX_WALK`` bytes.  float32: ``sub_groups`` and
    ``split_plan``."""
    group = hq // hk
    if dtype == torch.bfloat16:
        n_sub = _cdiv(group, MMA_HEADS)
        width = min(w for w in MMA_BLOCKS_PER_SM if d <= w)
        bps = MMA_BLOCKS_PER_SM[width]
        blocks = batch * hk * n_sub
        most = min(MMA_MAX_SPLITS[width], _cdiv(max(span, 1), MMA_MIN_CHUNK))
        if blocks * MMA_FILL >= sms:
            most = min(most, _cdiv(max(span, 1) * d * 4, MMA_MAX_WALK))
        chunk, n_splits = cut(blocks, span, bps * sms, most)
        return DecodePlan("mma", _cdiv(group, n_sub), n_sub, 1, TILE, bps,
                          chunk, n_splits)
    n_sub = sub_groups(group, d)
    chunk, n_splits = split_plan(batch, hk, span, sms, n_sub)
    return DecodePlan("cuda_core", _cdiv(group, n_sub), n_sub, 0,
                      32 * 128 // (128 if d <= 128 else 256), BLOCKS_PER_SM,
                      chunk, n_splits)


def cut(blocks: int, slots: int, resident: int,
        most: int | None = None) -> tuple[int, int]:
    """(chunk, n_splits): ``slots`` slots (at least 1) cut into n_splits
    chunks of ``chunk`` slots (a multiple of TILE), at most ``most`` of
    them, so that ``blocks`` blocks a split fit in the card's ``resident``
    blocks at once, unless the blocks alone do not: a second wave would
    stream its bytes after the first one's tail."""
    slots = max(slots, 1)
    want = min(max(1, resident // blocks), _cdiv(slots, TILE),
               most or slots)
    chunk = _cdiv(_cdiv(slots, want), TILE) * TILE
    return chunk, _cdiv(slots, chunk)


def max_heads(d: int) -> int:
    """The most q-heads one block of the float32 route serves at head dim
    ``d``: its per-head registers grow with d."""
    return 8 if d <= 128 else 4


def sub_groups(group: int, d: int) -> int:
    """The blocks the float32 route cuts each KV head's group of ``group``
    q-heads into at head dim ``d``: ceil(group / n) heads each, at most
    ``max_heads(d)`` (a group of 10 at D 256: 3, of 4, 4 and 2 heads)."""
    return _cdiv(group, max_heads(d))


def split_plan(batch: int, kv_heads: int, slots: int, sms: int,
               n_sub: int = 1) -> tuple[int, int]:
    """The float32 route's (chunk, n_splits): the attended span of
    ``slots`` slots (``valid_len - lo``, at least 1) cut so that the batch
    * kv_heads * n_sub * n_splits blocks (``n_sub``: the sub-groups of
    each KV head's q-heads, ``sub_groups``) fit on the card at once,
    BLOCKS_PER_SM on each SM (``cut``); the last block of each (b, KV
    head, sub-group) merges the splits."""
    return cut(batch * kv_heads * n_sub, slots, BLOCKS_PER_SM * sms)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor,
                     lo: torch.Tensor | None = None,
                     span: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q [B, Hq, D] and caches
    [B, Hk, S, D] (Hq % Hk == 0, any group: KV heads are indexed, never
    repeated).  Row b attends to the slots [lo[b], valid_len[b]), each an
    int32 [B] tensor on q's device (``lo`` None: 0).  ``span``, the
    longest ``valid_len - lo`` of any row as the caller knows it (the
    serve path from its ints), is what ``decode_plan`` cuts, so the plan
    needs nothing from the card; None plans over S.  A span shorter than
    a row's only makes that row's last split longer.  Any strides with a
    contiguous last dimension; a cache the kernel's copies cannot read in
    place (bf16: ``tma_ready``; float32: ``rows_aligned``) is first copied
    to a contiguous tensor (the serve path's caches never are).  Returns
    [B, Hq, D].

    One launch: the splits' last block merges them, found by an atomic
    ticket per (b, KV head, sub-group) in a per-device int32 buffer that
    the kernel leaves zeroed.  Calls on two streams at once must not
    share that buffer: run them on one stream.  Raises on anything the
    kernel does not take."""
    ts = (q, k_cache, v_cache, valid_len) + (() if lo is None else (lo,))
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in ts):
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
            or hq % hk:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if d % 16 or d > MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 "
                         f"up to {MAX_D}")
    if s >= 2**31:
        raise ValueError("cache too long for int32 slots")
    if lo is None:
        lo = torch.zeros_like(valid_len)
    for name, x in (("valid_len", valid_len), ("lo", lo)):
        if x.dtype != torch.int32 or tuple(x.shape) != (b,):
            raise ValueError(f"{name} must be int32 [{b}], got {x.dtype} "
                             f"{tuple(x.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention needs a contiguous last dimension")
    if q.dtype == torch.bfloat16:
        # the tensor maps read the caches, 16-byte loads q's rows
        k_cache, v_cache = (c if tma_ready(c) else c.clone(
            memory_format=torch.contiguous_format) for c in (k_cache,
                                                             v_cache))
        if q.data_ptr() % 16 or q.stride(0) % 8 or q.stride(1) % 8:
            q = q.clone(memory_format=torch.contiguous_format)
    else:
        k_cache, v_cache = (c if rows_aligned(c) else c.clone(
            memory_format=torch.contiguous_format) for c in (k_cache,
                                                             v_cache))
    plan = decode_plan(q.dtype, b, hq, hk, d,
                       s if span is None else min(span, s),
                       _sm_count(q.device.index))
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    name = _FN[q.dtype]
    with torch.cuda.device(q.device):
        args, _scratch = launch_args(q, k_cache, v_cache,
                                     valid_len.contiguous(), lo.contiguous(),
                                     out, plan)
        err = getattr(_build.library(), name)(*args)
    _build.check(err, name)
    return out


def launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid_len: torch.Tensor, lo: torch.Tensor, out: torch.Tensor,
                plan: DecodePlan) -> tuple[tuple, torch.Tensor]:
    """(the C entry point's arguments for checked operands, the splits'
    float32 scratch they point into, which the caller keeps alive while
    it launches): part_acc [B, Hq, n_splits, D], then part_m and part_l
    [B, Hq, n_splits], in one allocation; the device's tickets, the
    current stream."""
    b, hq, d = q.shape
    _, hk, s, _ = k.shape
    rows = b * hq * plan.n_splits
    scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                          device=q.device)
    acc = scratch.data_ptr()
    strides = (ctypes.c_int64 * 10)(*q.stride()[:2], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:2])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
            lo.data_ptr(), out.data_ptr(), acc + 4 * rows * d,
            acc + 4 * rows * (d + 1), acc,
            tickets(q.device, b * hk * plan.n_sub).data_ptr(), b, hq, hk, s,
            d, strides, plan.chunk, plan.n_splits, plan.n_sub,
            torch._C._cuda_getCurrentRawStream(q.device.index)), scratch


def blocks_per_sm(d: int) -> int:
    """The blocks of the bf16 kernel for head dim ``d`` that an SM of the
    current card holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    what ``MMA_BLOCKS_PER_SM`` must say."""
    n = ctypes.c_int(0)
    _build.check(_build.library().decode_attn_bf16_blocks_per_sm(
        d, ctypes.byref(n)), "decode_attn_bf16_blocks_per_sm")
    return n.value


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
