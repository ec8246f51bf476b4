"""Mixture-of-Experts FFN with capacity-bounded routing, on one device.

Port of ``repro.models.moe``.  The reference runs the block under
``shard_map``: experts sharded over the mesh's ``model`` axis
(``moe_shard="expert"``), or every expert on every shard with its hidden
dim split (``"ffn"``), or both over two axes (``"2d"``, ``moe_ffn_2d``),
each combined with a ``psum``.  On one device every mode computes the same
function, so the port has one body; ``moe_param_specs`` gives each mode's
layout, and ``moe_ffn_2d`` waits for a mesh of more than one card.

Routing is the reference's, step for step: router logits and softmax in
float32, the top ``k`` experts per token (the lower expert index first on
a tie, as ``lax.top_k``), gates renormalised, a capacity of
``max(1, cdiv(int(n * k * capacity_factor), E))`` slots per expert, each
(token, choice) ranked within its expert by an exclusive cumsum in token
order, and assignments past the capacity dropped to the buffer's last
row, which the combine reads as zeros.  The expert products are batched
matrix products over the ``[E, cap, d]`` buffer (the reference leaves
them to XLA; no hand-written kernel is on this path).

``dropped``: set it to a 0-d int64 tensor on the run's device and every
routing adds the assignments it dropped to it, on the device (no host
sync); None (the default) counts nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import P

dropped: torch.Tensor | None = None


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of each row, largest
    first and the lower index first among equal values (``lax.top_k``'s
    order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_local(x: torch.Tensor, router: torch.Tensor, n_local_experts: int,
                 expert_offset: int, cfg: ArchConfig):
    """Token -> local-expert assignment with capacity bound.

    x: [N, D]; returns (buf [E_loc*C+1, D], flat_pos [N, K], gates [N, K]
    in x's dtype, C).  The last buffer row is the drop bin."""
    global dropped
    n, d = x.shape
    k = cfg.top_k
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, sel = top_k(probs, k)                           # [N, K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = max(1, cdiv(int(n * k * cfg.capacity_factor), cfg.num_experts))
    local = sel - expert_offset                            # [N, K]
    mine = (local >= 0) & (local < n_local_experts)
    local_c = torch.where(mine, local, 0)

    # rank of each (token, k) assignment within its expert, in token order
    onehot = (F.one_hot(local_c, n_local_experts).to(torch.int32)
              * mine[..., None].to(torch.int32))           # [N, K, E_loc]
    flat_oh = onehot.reshape(n * k, n_local_experts)
    ranks = torch.cumsum(flat_oh, dim=0) - flat_oh          # exclusive
    rank = (ranks * flat_oh).sum(-1).reshape(n, k)

    keep = mine & (rank < cap)
    drop_row = n_local_experts * cap
    flat_pos = torch.where(keep, local_c * cap + rank, drop_row)
    if dropped is not None:
        dropped += (flat_pos == drop_row).sum()

    buf = torch.zeros((drop_row + 1, d), dtype=x.dtype, device=x.device)
    xk = x[:, None].expand(n, k, d).reshape(n * k, d)
    buf.index_add_(0, flat_pos.reshape(-1), xk)
    return buf, flat_pos, gates.to(x.dtype), cap


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, D]; returns the same shape: the gated sum of each token's
    kept experts' SwiGLU outputs, plus the shared expert's when the config
    has one.  Weights are cast to x's dtype per use (a no-op on a tree
    from ``cast_params``)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    xf = x.reshape(n, d)
    buf, flat_pos, gates, cap = _route_local(xf, params["router"], e, 0, cfg)
    buf_e = buf[:-1].reshape(e, cap, d)
    h = torch.bmm(buf_e, params["wg"].to(dt))
    u = torch.bmm(buf_e, params["wu"].to(dt))
    out_e = torch.bmm(F.silu(h) * u, params["wo"].to(dt))
    out_flat = torch.cat([out_e.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=dt, device=x.device)])
    gathered = out_flat[flat_pos.reshape(-1)].reshape(n, k, d)
    y = (gathered * gates[..., None]).sum(1)
    if cfg.shared_expert:
        g = xf @ params["sh_wg"].to(dt)
        uu = xf @ params["sh_wu"].to(dt)
        y = y + (F.silu(g) * uu) @ params["sh_wo"].to(dt)
    return y.reshape(b, s, d)


def moe_param_shapes(cfg: ArchConfig, n_layers: int) -> dict:
    """Shapes for one stacked MoE-FFN group ([L, ...] leaves)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {
        "router": (n_layers, d, e),
        "wg": (n_layers, e, d, f),
        "wu": (n_layers, e, d, f),
        "wo": (n_layers, e, f, d),
    }
    if cfg.shared_expert:
        shapes |= {"sh_wg": (n_layers, d, f), "sh_wu": (n_layers, d, f),
                   "sh_wo": (n_layers, f, d)}
    return shapes


def moe_param_specs(cfg: ArchConfig, dp=("data",)) -> dict:
    """PartitionSpecs for stacked MoE params (leading layer dim unsharded).

    EP mode shards experts over ``model`` and FSDP-shards the d_model dim
    over ``dp``; "ffn" splits the hidden dim over ``model``; "2d" puts the
    experts over ``model`` and the hidden dim over ``dp`` (the
    reference's layouts)."""
    if cfg.moe_shard == "2d":
        w = P(None, "model", None, dp)
        wo = P(None, "model", dp, None)
    elif cfg.moe_shard == "expert":
        w = P(None, "model", dp, None)
        wo = P(None, "model", None, dp)
    else:
        w = P(None, None, dp, "model")
        wo = P(None, None, "model", dp)
    specs = {"router": P(None, None, None), "wg": w, "wu": w, "wo": wo}
    if cfg.shared_expert:
        specs |= {"sh_wg": P(None, dp, "model"),
                  "sh_wu": P(None, dp, "model"),
                  "sh_wo": P(None, "model", dp)}
    return specs
