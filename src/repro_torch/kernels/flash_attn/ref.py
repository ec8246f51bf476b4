"""Plain PyTorch version of flash attention (full-materialisation softmax)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None
                        ) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k, v [B, Hk, Skv, D] with Hq % Hk == 0 (KV heads
    are repeated here).  Scores in float32 scaled by D**-0.5; query row i
    sits at position i + Skv - Sq.  A row that the mask leaves no key (causal
    with Sq > Skv) gives zeros, as the CUDA kernel does; the Pallas kernel
    does so only where it skips the row's whole query block.  Returns [B, Hq, Sq, D] in q's dtype."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if k.shape[1] != hq:
        rep = hq // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = d ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1) * mask.any(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
