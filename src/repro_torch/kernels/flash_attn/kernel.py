"""ctypes bindings of the CUDA flash-attention kernels: the forward
(csrc/flash_attn.cu), optionally with the rows' log-sum-exp, and its
backward (csrc/flash_attn_bwd.cu) with the plan that picks its route,
shares and scratch (``bwd_plan``)."""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_FN = {torch.bfloat16: "flash_attn_bf16", torch.float32: "flash_attn_f32"}
_BWD = {torch.bfloat16: "flash_attn_bwd_bf16",
        torch.float32: "flash_attn_bwd_f32"}
MAX_D = 256
TMA_ALIGN = 16         # bytes: TMA's base and stride alignment
NARROW_D = 128         # the wgmma backward's narrow kernels' largest D
# The wgmma backward's cost on an H100, fitted to kernel_ab.py's rows that
# time each cut of a group into shares (PERF.md section 6): one step of a
# dK/dV block on one SM (64 query rows of one q-head against its 128 keys
# at D 128, scaled by D below; above D 128, against its 64 keys at any D,
# which runs as 256), above D 128 one 32-key tile of a 128-row dQ block
# (the same launch runs them), and the rate at which the shares' float32
# partials are written and read back by the group sum
BWD_STEP_S = 1.7e-6
BWD_STEP_WIDE_S = 2.25e-6
BWD_DQ_STEP_WIDE_S = 1.45e-6
BWD_PART_BYTES_PER_S = 2.5e12
ROUTE_ID = {"mma_sync": 0, "wgmma": 1}   # the C entry point's route codes


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


class BwdPlan(NamedTuple):
    """How ``flash_attention_bwd`` runs a shape: its route, the tiles of
    its dK/dV and dQ blocks, how many shares each group of q-heads is cut
    into (each writing float32 partials that one more launch adds in share
    order), its float32 scratch and its kernel launches."""
    route: str          # "wgmma" (bf16) or "mma_sync" (float32)
    key_tile: int       # keys of a dK/dV block
    row_tile: int       # query rows of a dQ block
    shares: int         # parts of each group summed by the group-sum launch
    delta_elems: int    # float32: Delta (wgmma: and lse * log2 e), padded
    part_elems: int     # float32: the shares' dK/dV partials, or 0
    scratch_bytes: int
    launches: int


def dkdv_walks(sq: int, skv: int, causal: bool = True,
               window: int | None = None, chunk: int | None = None,
               keys: int = 128) -> list[int]:
    """The 64-row query tiles a wgmma dK/dV block walks for each q-head,
    one count per tile of ``keys`` keys (the block's: 128 up to D 128, 64
    above): the rows whose masks can keep one of the tile's keys, bounded
    as the kernel bounds them (flash_attn_bwd.cu: pos_range; row i at
    position i + skv - sq)."""
    def rows(kp):           # query positions [lo, hi) that can keep key kp
        lo, hi = (kp if causal else -(1 << 62)), 1 << 62
        if window:
            hi = min(hi, kp + window)
        if chunk:
            c = kp // chunk * chunk
            lo, hi = max(lo, c), min(hi, c + chunk)
        return lo, hi
    shift = skv - sq
    walks = []
    for k0 in range(0, skv, keys):
        r_lo = max(rows(k0)[0] - shift, 0)
        r_hi = min(rows(min(k0 + keys, skv) - 1)[1] - shift, sq)
        walks.append(-(-r_hi // 64) - r_lo // 64 if r_hi > r_lo else 0)
    return walks


def dq_walks(sq: int, skv: int, causal: bool = True,
             window: int | None = None, chunk: int | None = None,
             keys: int = 32) -> list[int]:
    """The tiles of ``keys`` keys a 128-row wgmma dQ block walks, one count
    per query tile in dispatch order (the last tile first): from the
    first tile a row of the block keeps to the last, bounded as the kernel
    bounds them (attn_wgmma.cuh: tile_range; row i at position
    i + skv - sq)."""
    def keys_of(pos):           # the keys [lo, hi) position pos keeps
        lo, hi = 0, skv
        if causal:
            hi = min(hi, pos + 1)
        if window:
            lo = max(lo, pos - window + 1)
        if chunk:
            c = pos // chunk * chunk
            lo, hi = max(lo, c), min(hi, c + chunk)
        return lo, hi
    shift = skv - sq
    walks = []
    for q0 in reversed(range(0, sq, 128)):
        first = keys_of(q0 + shift)
        last = keys_of(min(q0 + 128, sq) - 1 + shift)
        walks.append(-(-last[1] // keys) - first[0] // keys
                     if last[1] > first[0] else 0)
    return walks


def dkdv_span(b: int, hk: int, group: int, shares: int, walks: list[int],
              sms: int, tail=()) -> float:
    """Steps until the last wgmma dK/dV block ends when each group is cut
    into ``shares``: the blocks, each walking its share's q-heads over its
    key tile's ``walks``, dispatched in grid order (key tile slowest, then
    (b, KV head), then share) each to the SM that frees first; then the
    blocks whose costs in steps ``tail`` lists, which the same launch runs
    after them (above D 128, the dQ blocks)."""
    heads = [(i + 1) * group // shares - i * group // shares
             for i in range(shares)]
    free = [0] * sms
    for w in walks:
        for _ in range(b * hk):
            for h in heads:
                heapq.heapreplace(free, free[0] + h * w)
    for c in tail:
        heapq.heapreplace(free, free[0] + c)
    return max(free)


def bwd_step_s(d: int) -> float:
    """The modelled seconds of one step of a wgmma dK/dV block at D."""
    return BWD_STEP_S * d / 128 if d <= NARROW_D else BWD_STEP_WIDE_S


def cut_model(b: int, hq: int, hk: int, sq: int, skv: int, d: int,
              causal: bool = True, window: int | None = None,
              chunk: int | None = None) -> tuple:
    """What the plan's model of a cut needs: the dK/dV blocks' walks (one
    per key tile), the costs in dK/dV steps of the blocks the same launch
    runs after them (above D 128 the dQ blocks, ``BWD_DQ_STEP_WIDE_S`` a
    tile, b * hq for each query tile; none below), and the step's
    seconds."""
    if d <= NARROW_D:
        return dkdv_walks(sq, skv, causal, window, chunk), [], bwd_step_s(d)
    tail = [w * BWD_DQ_STEP_WIDE_S / BWD_STEP_WIDE_S
            for w in dq_walks(sq, skv, causal, window, chunk)
            for _ in range(b * hq)]
    return (dkdv_walks(sq, skv, causal, window, chunk, 64), tail,
            bwd_step_s(d))


def part_s(shares: int, b: int, hk: int, skv: int, d: int) -> float:
    """The modelled seconds of writing and summing ``shares``' float32
    dK/dV partials (none for one share)."""
    return 16 * shares * b * hk * skv * d / BWD_PART_BYTES_PER_S \
        if shares > 1 else 0.0


def _fastest_cut(b: int, hk: int, group: int, skv: int, d: int, sms: int,
                 walks: list[int], tail: list, step: float) -> int:
    """The cut of each group into shares with the least modelled time
    (``bwd_plan``), the fewest shares among equals.  A cut whose
    partials alone, over the span no cut can beat (every step spread
    evenly over the SMs), already take longer than the best so far is not
    simulated, nor is any larger one (its partials are larger still)."""
    floor = (b * hk * group * sum(walks) + sum(tail)) / sms * step
    best, best_s = float("inf"), 1
    for s in range(1, group + 1):
        part = part_s(s, b, hk, skv, d)
        if floor + part >= best:
            break
        t = dkdv_span(b, hk, group, s, walks, sms, tail) * step + part
        if t < best:
            best, best_s = t, s
    return best_s


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, hq: int, hk: int, sq: int, skv: int, d: int,
             dtype, sms: int, *, causal: bool = True,
             window: int | None = None, chunk: int | None = None,
             shares: int | None = None) -> BwdPlan:
    """The backward's plan for q [b, hq, sq, d] and k/v [b, hk, skv, d]
    under the mask on a card of ``sms`` streaming multiprocessors.

    bf16 takes the wgmma route: a dK/dV block (an SM holds one) per (b,
    KV head, share of its group, 128 keys up to D 128, 64 above) walks its
    share's q-heads in registers.  ``shares`` None picks the cut s whose
    modelled time is least: the span of the blocks' walks on the card
    (``dkdv_span``, ``bwd_step_s`` a step; above D 128 with the dQ blocks
    the same launch runs after them: ``cut_model``) plus, for s > 1, the
    float32 partials [s, 2, b, hk, skv, d] written and summed
    (``part_s``); the fewest shares among equals.  A grid
    that fills the card keeps each group whole (no scratch); an MQA, or a
    causal grid whose short walks leave SMs idle, is cut, and one more
    launch sums the partials in share order.  The prep launch writes lse
    * log2 e and Delta to [2, b * hq, sq_pad], sq_pad = sq rounded up to
    128.  Launches: prep, dK/dV, dQ (above D 128 one launch runs both
    walks), and the sum where shares > 1.
    float32 takes the mma_sync route: a block per q-head (64 keys or rows;
    32 above D 128), each q-head's float32 share of a group to [group, 2,
    b, hk, skv, d], summed by a fourth launch; ``shares`` must then be
    None."""
    group = hq // hk
    if dtype == torch.bfloat16:
        keys = 128 if d <= NARROW_D else 64
        if shares is None:
            shares = _fastest_cut(b, hk, group, skv, d, sms, *cut_model(
                b, hq, hk, sq, skv, d, causal, window, chunk))
        elif not 1 <= shares <= group:
            raise ValueError(f"shares {shares}: a group of {group} q-heads "
                             f"is cut into 1 to {group}")
        delta = 2 * b * hq * (-(-sq // 128) * 128)
        part = shares * 2 * b * hk * skv * d if shares > 1 else 0
        return BwdPlan("wgmma", keys, 128, shares, delta, part,
                       4 * (delta + part),
                       (3 if d <= NARROW_D else 2) + (shares > 1))
    if shares is not None:
        raise ValueError(f"shares is the wgmma route's (bf16): {dtype} "
                         f"is not")
    tile = 32 if d > 128 else 64
    delta = b * hq * sq
    part = 2 * b * hq * skv * d if group > 1 else 0
    return BwdPlan("mma_sync", tile, tile, group, delta, part,
                   4 * (delta + part), 3 + (group > 1))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        chunk_attn: int | None = None,
                        shares: int | None = None):
    """Launch the backward on CUDA tensors: q, o (the forward's output), do
    (its gradient) [B, Hq, Sq, D], k/v [B, Hk, Skv, D] of one dtype, lse
    float32 [B, Hq, Sq] from ``flash_attention(..., lse=True)`` with the
    same mask.  Any strides with a contiguous last dimension.  Returns
    (dq, dk, dv), each with its operand's shape and dtype (dk and dv
    summed over each KV head's group); deterministic, no atomics.  The
    launches, route and scratch follow ``bwd_plan`` for the card q is on
    (``shares`` overrides its cut of a group on the wgmma route, for
    timing one cut against another); the wgmma route reads
    q, k, v and do through TMA tensor maps and o and do 16 bytes at a
    time, so an operand that is not ``tma_ready`` is first copied to a
    contiguous tensor (its gradient then has the copy's layout).  Raises
    on anything the kernel does not take."""
    _check(q, k, v, window, chunk_attn, more=(o, do))
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or lse.shape != (b, hq, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous float32 {(b, hq, sq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    plan = bwd_plan(b, hq, hk, sq, skv, d, q.dtype,
                    torch.cuda.get_device_properties(
                        q.device).multi_processor_count, causal=bool(causal),
                    window=window, chunk=chunk_attn, shares=shares)
    if plan.route == "wgmma":
        q, k, v, o, do = (t if tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format) for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(plan.delta_elems, dtype=torch.float32,
                        device=q.device)
    part = (torch.empty(plan.part_elems, dtype=torch.float32,
                        device=q.device) if plan.part_elems else None)
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
            strides, int(causal), window or 0, chunk_attn or 0,
            ROUTE_ID[plan.route], plan.shares, plan.delta_elems,
            plan.part_elems, stream)
    _build.check(err, name)
    return dq, dk, dv
