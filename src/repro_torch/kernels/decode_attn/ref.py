"""Plain PyTorch version of decode attention (one token vs. a KV cache)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """q [B, Hq, D]; caches [B, Hk, S, D] with Hq % Hk == 0 (KV heads are
    repeated here); valid_len an int or [B] ints, clamped to [0, S].

    Slots >= valid_len are masked out; valid_len 0 gives zeros, as the
    kernel does.  Returns [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    s = k_cache.shape[2]
    if k_cache.shape[1] != hq:
        rep = hq // k_cache.shape[1]
        k_cache = k_cache.repeat_interleave(rep, dim=1)
        v_cache = v_cache.repeat_interleave(rep, dim=1)
    scale = d ** -0.5
    scores = torch.einsum("bhd,bhsd->bhs", q.float() * scale,
                          k_cache.float())
    valid = torch.as_tensor(valid_len, device=q.device).reshape(-1)
    valid = valid.expand(b).clamp(0, s)
    mask = torch.arange(s, device=q.device)[None, :] < valid[:, None]
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1) * (valid > 0)[:, None, None]
    return torch.einsum("bhs,bhsd->bhd", p, v_cache.float()).to(q.dtype)
