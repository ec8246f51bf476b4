"""Building blocks of the dense decoder.

Attention has two entry points, the counterparts of the JAX package's
``chunked_attention`` and ``decode_attention`` (the pure-jnp oracles of
its Pallas kernels):

* ``chunked_attention`` — prefill attention, through
  ``kernels.flash_attn.ops.attention``;
* ``decode_attention`` — one new token against a KV cache, through
  ``kernels.decode_attn.ops.decode``.

On a CUDA tensor both run the hand-written Hopper kernels, on a CPU
tensor their plain PyTorch versions.  All softmax and normalisation
statistics are computed in float32 whatever the compute dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None
                      ) -> torch.Tensor:
    """q: [B, Hq, Sq, Dh]; k, v: [B, Hk, Skv, Dh] with Hq % Hk == 0.  Query
    row i sits at position i + Skv - Sq (suffix alignment).  Returns
    [B, Hq, Sq, Dh] in q's dtype (with q's layout on the card)."""
    return flash_ops.attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """Grouped decode attention, KV heads never repeated on the card.

    q: [B, Hq, 1, Dh]; caches: [B, Hk, S, Dh]; valid_len: an int or [B]
    ints, the cache slots [0, valid_len) each row attends to (the JAX
    layer's ``kv_positions = arange(S)`` with ``t = valid_len - 1``).
    Returns [B, Hq, 1, Dh]."""
    o = decode_ops.decode(q[:, :, 0], k_cache, v_cache, valid_len)
    return o[:, :, None]


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = x @ wg.to(dt)
    u = x @ wu.to(dt)
    return (F.silu(g) * u) @ wo.to(dt)
