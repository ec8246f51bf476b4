"""Plain float32 mixture-of-experts decoder (the ``moe`` family, Mixtral):
the dense family's blocks (``reference.dense``) with the FFN replaced by
top-k routing over SwiGLU experts under a capacity bound.

Routing, as the port's configuration states it: router logits and
softmax in float32, the ``top_k`` experts of each token (the lower index
first among equal probabilities), the gates renormalised to sum to one;
each expert takes at most ``max(1, ceil(int(n * top_k *
capacity_factor) / E))`` assignments of the ``n`` tokens routed
together, ranked in token order (token by token, a token's choices in
order of probability), and an assignment past that is dropped.  Which
tokens are routed together is the caller's: all the tokens of one
prefill call, or the batch of one decode step."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.dense import mm


def route(h: torch.Tensor, router: torch.Tensor, a: dict):
    """h [G, N, d]: G groups of N tokens routed together.  Returns
    (experts [G, N, k], gates [G, N, k], keep [G, N, k])."""
    g, n, _ = h.shape
    k, e = a["top_k"], a["num_experts"]
    probs = torch.softmax(h @ router, dim=-1)
    vals, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, sel = vals[..., :k], sel[..., :k]
    gates = vals / vals.sum(-1, keepdim=True)
    cap = max(1, math.ceil(int(n * k * a["capacity_factor"]) / e))
    onehot = F.one_hot(sel.reshape(g, n * k), e)            # token order
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).reshape(g, n, k)
    return sel, gates, rank < cap


def ffn(h: torch.Tensor, w: dict, a: dict, groups: str | None = None,
        quant: str | None = None) -> torch.Tensor:
    """The gated sum of each token's kept experts.  ``groups``: "call"
    routes all of h [B, S, d] together (row by row), "step" routes each
    position's B tokens together (a decode step's batch)."""
    b, s, d = h.shape
    hg = h.reshape(1, b * s, d) if groups == "call" \
        else h.transpose(0, 1).contiguous()                 # [S, B, d]
    moe = w["moe"]
    sel, gates, keep = route(hg, moe["router"], a)
    flat = hg.reshape(-1, d)
    out = torch.zeros_like(flat)
    for e in range(a["num_experts"]):
        hit = (sel == e) & keep                             # [G, N, k]
        weight = (gates * hit).sum(-1).reshape(-1)
        rows = torch.nonzero(weight, as_tuple=True)[0]
        if rows.numel() == 0:
            continue
        x = flat[rows]
        y = mm(F.silu(mm(x, moe["wg"][e], quant)) * mm(x, moe["wu"][e], quant),
               moe["wo"][e], quant)
        out.index_add_(0, rows, y * weight[rows, None])
    out = out.reshape(hg.shape)
    return out.reshape(b, s, d) if groups == "call" else out.transpose(0, 1)
