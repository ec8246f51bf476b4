"""Plain PyTorch versions of flash attention: the forward (full-
materialisation softmax, with its log-sum-exp) and the step-by-step
backward the CUDA backward kernel computes."""
from __future__ import annotations

import torch

NEG_INF = -1e30
# the log-sum-exp of a row the mask leaves no key: exp(s - LSE_EMPTY) is
# exactly 0 for every finite score s, so such a row's P is 0
LSE_EMPTY = float("inf")


def attention_mask(sq: int, skv: int, device, *, causal: bool = True,
                   window: int | None = None,
                   chunk_attn: int | None = None) -> torch.Tensor:
    """bool [Sq, Skv]: which keys each query row keeps, row i at position
    i + Skv - Sq (see ``flash_attention_ref``)."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if chunk_attn is not None:
        mask &= (torch.div(kpos, chunk_attn, rounding_mode="floor")
                 == torch.div(qpos, chunk_attn, rounding_mode="floor"))
    return mask


def attended_keys(sq: int, skv: int, *, causal: bool = True,
                  window: int | None = None,
                  chunk_attn: int | None = None) -> int:
    """The keys ``attention_mask`` keeps, summed over its rows, without
    building it: the count an attention call's operations scale with."""
    qpos = torch.arange(skv - sq, skv)
    lo = torch.zeros_like(qpos)
    hi = torch.full_like(qpos, skv)
    if causal:
        hi = torch.minimum(hi, qpos + 1)
    if window is not None:
        lo = torch.maximum(lo, qpos - window + 1)
    if chunk_attn is not None:
        start = torch.div(qpos, chunk_attn, rounding_mode="floor") \
            * chunk_attn
        lo = torch.maximum(lo, start)
        hi = torch.minimum(hi, start + chunk_attn)
    return int((hi - lo).clamp_min(0).sum())


def _repeat_kv(t: torch.Tensor, hq: int) -> torch.Tensor:
    hk = t.shape[1]
    return t if hk == hq else t.repeat_interleave(hq // hk, dim=1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        chunk_attn: int | None = None,
                        return_lse: bool = False):
    """q [B, Hq, Sq, D]; k, v [B, Hk, Skv, D] with Hq % Hk == 0 (KV heads
    are repeated here).  Scores in float32 scaled by D**-0.5; query row i
    sits at position i + Skv - Sq.  Key k is kept for position p where
    ``k <= p`` (causal), ``k > p - window`` and ``k // chunk_attn == p //
    chunk_attn`` (floor division; the JAX model layer's
    ``chunked_attention`` mask), each where set.  A row that the mask
    leaves no key (causal with Sq > Skv) gives zeros, as the CUDA kernel
    does; the Pallas kernel does so only where it skips the row's whole
    query block.  Returns [B, Hq, Sq, D] in q's dtype, and with
    ``return_lse`` also the float32 log-sum-exp of each row's scaled
    scores [B, Hq, Sq] (``LSE_EMPTY`` for a row with no key)."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[2]
    k, v = _repeat_kv(k, hq), _repeat_kv(v, hq)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * d ** -0.5,
                          k.float())
    mask = attention_mask(sq, skv, q.device, causal=causal, window=window,
                          chunk_attn=chunk_attn)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1) * mask.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(scores, dim=-1)
    lse = lse.masked_fill(~mask.any(-1), LSE_EMPTY)
    return out, lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True, window: int | None = None,
                            chunk_attn: int | None = None):
    """The backward of ``flash_attention_ref``, step by step as the CUDA
    backward computes it, in float32: P = exp(S * scale - lse) (0 where
    masked, and on a row with no key, whose lse is ``LSE_EMPTY``),
    dV = P^T dO, dP = dO V^T, Delta = rowsum(dO * O), dS = P (dP - Delta),
    dQ = dS K * scale, dK = dS^T Q * scale; dK and dV summed over each KV
    head's group of q-heads.  q, o, do [B, Hq, Sq, D]; k, v [B, Hk, Skv,
    D]; lse float32 [B, Hq, Sq].  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kf, vf = _repeat_kv(k, hq).float(), _repeat_kv(v, hq).float()
    mask = attention_mask(sq, skv, q.device, causal=causal, window=window,
                          chunk_attn=chunk_attn)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~mask, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    g = hq // hk
    dk = dk.reshape(b, hk, g, skv, d).sum(2)
    dv = dv.reshape(b, hk, g, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
