"""Building blocks shared by the model families.

Attention has two entry points, the counterparts of the JAX package's
``chunked_attention`` and ``decode_attention`` (the pure-jnp oracles of
its Pallas kernels):

* ``chunked_attention`` — prefill, encoder and cross attention, through
  ``kernels.flash_attn.ops.attention`` (causal or not, sliding window,
  llama4's local chunk);
* ``decode_attention`` — one new token against a KV cache, through
  ``kernels.decode_attn.ops.decode``, masked by absolute position as the
  reference masks it (causal, sliding window, chunk).

On a CUDA tensor both run the hand-written Hopper kernels; on a CPU
tensor prefill runs the flash kernel's plain version and decode computes
the reference's full position mask.  All softmax and normalisation
statistics are computed in float32 whatever the compute dtype.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim, statistics in float32 (the biased
    variance, as ``jnp.var``)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved), angles in float32.
    x: [..., S, H, Dh]; positions: [..., S]."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq               # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position table [seq, dim] in float32:
    sines then cosines of ``pos * 10000**(-i / (dim / 2 - 1))``."""
    half = dim // 2
    freq = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half - 1, 1))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      chunk_attn: int | None = None,
                      f32_stats: bool = True) -> torch.Tensor:
    """q: [B, Hq, Sq, Dh]; k, v: [B, Hk, Skv, Dh] with Hq % Hk == 0.  Query
    row i sits at position i + Skv - Sq (suffix alignment); with
    ``chunk_attn`` a query attends only keys of its own chunk of that many
    positions (``k // c == q // c``).  ``f32_stats`` False (the config's
    ``attn_f32_scores``) takes the probabilities into the P V product in
    the compute dtype, as the reference does (``ops.attention``).  Returns
    [B, Hq, Sq, Dh] in q's dtype (with q's layout on the card)."""
    return flash_ops.attention(q, k, v, causal=causal, window=window,
                               chunk_attn=chunk_attn, f32_stats=f32_stats)


def ring_positions(t: int, n_slots: int, device=None) -> torch.Tensor:
    """Absolute position held by each slot of a ring cache of ``n_slots``
    at time ``t`` (-1 if unwritten): the reference's ``_ring_positions``.
    For ``t < n_slots`` a slot holds its own index (or nothing yet)."""
    j = torch.arange(n_slots, device=device)
    pos = t - torch.remainder(t - j, n_slots)
    return torch.where(pos >= 0, pos, -1)


def decode_slot_range(t: int, n_slots: int, window: int | None,
                      chunk_attn: int | None) -> tuple[int, int]:
    """The slots [lo, hi) that the decode mask of a ring cache leaves at
    time ``t``, when they are one contiguous range: slots hold their own
    positions (``t < n_slots``), or a full ring fits inside the window
    and the chunk.  Raises for a wrapped ring the window or chunk cuts
    (no entry point reaches one)."""
    if t < n_slots:
        lo = 0
        if window is not None:
            lo = max(lo, t - window + 1)
        if chunk_attn is not None:
            lo = max(lo, t // chunk_attn * chunk_attn)
        return lo, t + 1
    if (window is None or n_slots <= window) and (
            chunk_attn is None
            or (t - n_slots + 1) // chunk_attn == t // chunk_attn):
        return 0, n_slots
    raise NotImplementedError(
        f"decode at t={t} over a wrapped ring of {n_slots} slots cut by "
        f"window={window} / chunk_attn={chunk_attn}: the mask is not one "
        f"slot range, which is all the kernel takes")


@functools.lru_cache(maxsize=4)
def slot_bounds(device: torch.device, batch: int, lo: int, hi: int
                ) -> torch.Tensor:
    """int32 [2, batch] on ``device``: every row's first slot ``lo`` and
    end ``hi``, the decode kernel's per-row bounds.  Made by two fills on
    the device (no host copy, no sync) and kept for the next calls with
    the same range, so a decode step's layers share one."""
    bounds = torch.empty((2, batch), dtype=torch.int32, device=device)
    bounds[0].fill_(lo)
    bounds[1].fill_(hi)
    return bounds


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions, t, *,
                     window: int | None = None,
                     chunk_attn: int | None = None) -> torch.Tensor:
    """Grouped decode attention with the reference's position mask.

    q: [B, Hq, 1, Dh]; caches: [B, Hk, S, Dh]; kv_positions: [B, S]
    absolute position held by each slot (-1 = empty), or None for the
    ring positions of the cache at ``t`` (``ring_positions``, what the
    decoder passes); t: the current position, an int or [B].  A slot is
    attended when ``0 <= pos <= t``, ``pos > t - window`` and ``pos //
    chunk_attn == t // chunk_attn`` (each where set).  Returns
    [B, Hq, 1, Dh].

    On a CPU tensor the mask is computed in full (the plain path).  On a
    CUDA tensor the mask must be one slot range per row, known from ints
    (``kv_positions`` None, ``t`` an int; ``decode_slot_range``), and the
    kernel reads only that range (``slot_bounds``, its split plan cut from
    the ints); anything else raises there.  A meta tensor (the dry-run's
    trace) takes the card's route."""
    if q.is_cuda or q.is_meta:
        if kv_positions is not None or not isinstance(t, int):
            raise NotImplementedError(
                "decode_attention on the card takes the ring cache's own "
                "positions (kv_positions=None) at an int t")
        lo, hi = decode_slot_range(t, k_cache.shape[2], window, chunk_attn)
        bounds = slot_bounds(q.device, q.shape[0], lo, hi)
        o = decode_ops.decode(q[:, :, 0], k_cache, v_cache, bounds[1],
                              bounds[0], span=hi - lo)
        return o[:, :, None]
    b, hq, _, dh = q.shape
    hk, s = k_cache.shape[1], k_cache.shape[2]
    if kv_positions is None:
        kv_positions = ring_positions(t, s, q.device)[None].expand(b, s)
    qg = q.reshape(b, hk, hq // hk, dh).float() * dh ** -0.5
    sc = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    tb = torch.as_tensor(t, device=q.device).reshape(-1).expand(b)[:, None]
    mask = (kv_positions >= 0) & (kv_positions <= tb)
    if window is not None:
        mask &= kv_positions > tb - window
    if chunk_attn is not None:
        mask &= (torch.div(kv_positions, chunk_attn, rounding_mode="floor")
                 == torch.div(tb, chunk_attn, rounding_mode="floor"))
    sc = sc.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.reshape(b, hq, 1, dh).to(q.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ wg.to(dt)
    u = x @ wu.to(dt)
    return (F.silu(g) * u) @ wo.to(dt)


def gelu_mlp(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
             wo: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    """Two-layer MLP with the tanh-approximated GELU (``jax.nn.gelu``'s
    default)."""
    dt = x.dtype
    h = F.gelu(x @ wi.to(dt) + bi.to(dt), approximate="tanh")
    return h @ wo.to(dt) + bo.to(dt)


# ---------------------------------------------------------------------------
# Causal depthwise conv (mamba2 / RG-LRU blocks)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, S, C]; w: [C, W] depthwise causal filter; returns [B, S, C]
    in x's dtype, the sum taken in float32 (the reference's)."""
    width = w.shape[-1]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    w32 = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):                       # width is tiny (4): unroll
        out = out + xp[:, i:i + s].float() * w32[:, i]
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  x_t: [B, C]; conv_state: [B, W-1, C] (the raw
    inputs of the last W-1 positions).  Returns (y [B, C] in x_t's dtype,
    the new state [B, W-1, C])."""
    width = w.shape[-1]
    hist = torch.cat([conv_state, x_t[:, None, :]], dim=1)    # [B, W, C]
    y = torch.sum(hist.float() * w.T.float()[None], dim=1)
    if b is not None:
        y = y + b.float()
    new_state = hist[:, 1:] if width > 1 else conv_state
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never holds the full [N, V] logits for backward)
# ---------------------------------------------------------------------------

def _xent_chunk(h_c: torch.Tensor, unembed: torch.Tensor, y_c: torch.Tensor,
                w_c: torch.Tensor, mesh=None) -> torch.Tensor:
    logits = (h_c @ unembed.to(h_c.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    if mesh is None:
        gold = logits.gather(-1, y_c[:, None])[:, 0]
        return torch.sum((lse - gold) * w_c)
    # vocab-parallel: this rank's columns start at its index over "model"
    n = logits.shape[1]
    local = y_c - mesh.axis_index("model") * n
    mine = (local >= 0) & (local < n)
    gold = logits.gather(-1, torch.where(mine, local, 0)[:, None])[:, 0]
    # the ranks' log-sum-exps combined about their maximum (gathered
    # without a gradient: any constant gives the same value and gradient),
    # and the gold logit from the rank holding the label (a sum of zeros
    # and one value): one psum over "model" for both
    top = mesh.all_gather(lse.detach()[None], "model").amax(0)
    both = mesh.psum(torch.stack([torch.exp(lse - top),
                                  gold.masked_fill(~mine, 0)]), "model")
    return torch.sum((top + torch.log(both[0]) - both[1]) * w_c)


def chunked_softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, weights: torch.Tensor,
                         chunk: int, mesh=None) -> torch.Tensor:
    """h: [N, D] final hidden states; unembed: [D, V]; labels/weights: [N].

    Returns the float32 sum of weighted token NLLs (the caller divides by
    the weight sum), the reference's ``chunked_softmax_xent``: N padded to
    a multiple of ``chunk`` (zero weights), each chunk's logits taken as
    ``h_c @ unembed`` in h's dtype and cast to float32, logsumexp minus
    the gold logit.  Each chunk runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``), so its logits are recomputed in the
    backward pass, not kept (and, across ranks, its collectives issued
    again).  With ``mesh`` (a mesh over ranks) ``unembed`` is this rank's
    block of vocabulary columns [D, V / |model|] (the block at its index
    over ``"model"``), ``h`` the same on every rank along ``"model"``, and
    the log-sum-exp and the gold logit are combined over ``"model"``."""
    n = h.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        weights = F.pad(weights, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n + pad, chunk):
        args = (h[i:i + chunk], unembed, labels[i:i + chunk],
                weights[i:i + chunk], mesh)
        if torch.is_grad_enabled():
            total = total + checkpoint(_xent_chunk, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _xent_chunk(*args)
    return total
