"""Mixture-of-Experts FFN with capacity-bounded routing, on one device or
across the ranks of a mesh.

Port of ``repro.models.moe``.  The reference runs the block under
``shard_map`` with the tokens split over the data-parallel axes (dp:
``"data"``, or ``("pod", "data")``) and one of three layouts of the
expert weights over ``model``:

* ``moe_shard="expert"``: the experts split over ``model``; each cell
  routes its dp shard's tokens to its ``e_loc`` experts, at offset
  ``axis_index(model) * e_loc``;
* ``"ffn"``: every expert on every cell, the hidden dim split over
  ``model``;

each followed by a ``psum`` over ``model`` (the shared expert, its hidden
dim split over ``model``, added before it); and

* ``"2d"`` (``moe_ffn_2d``): the tokens all-gathered over dp, the experts
  over ``model`` and their hidden dim over dp, one ``psum`` over
  ``(model, *dp)``; taken when dp divides the batch on a mesh of more than
  one device.

On one device the three compute the same function, which the port runs
with ``mctx=None`` (or a 1x1 mesh) as one body.  On a mesh they do not:
in ``"expert"`` and ``"ffn"`` each dp shard routes only its own tokens
under a capacity reckoned from its own token count, so more assignments
are dropped than on one device; ``"2d"`` routes every token under the
global capacity and gives the one-device answer.  On a mesh over ranks
(``Mesh.over_ranks``, or a ``CountingMesh``) the port runs the
reference's bodies rank by rank: ``moe_ffn`` takes this rank's block of
the input under ``P(dp, None, None)`` (the whole input where dp does not
divide the global batch, which the caller names) and the rank's weight
blocks (``moe_in_specs``: exactly what the block's ``in_specs`` give it;
``convert.moe_blocks`` cuts them, the decoder gathers them from its FSDP
storage), and returns this rank's block of the output (the
``out_specs``).  ``"2d"`` all-gathers the tokens over dp first and keeps
its own rows of the psum's output, as the reference does.  When dp does
not divide the batch, ``"2d"`` falls through to the ``"ffn"`` body, as in
the reference.

Routing is the reference's, step for step: router logits and softmax in
float32, the top ``k`` experts per token (the lower expert index first on
a tie, as ``lax.top_k``), gates renormalised, a capacity of
``max(1, cdiv(int(n * k * capacity_factor), E))`` slots per expert (``n``
the tokens this cell routes), each (token, choice) ranked within its
expert by an exclusive cumsum in token order, and assignments past the
capacity dropped to the buffer's last row, which the combine reads as
zeros.  The expert products are batched matrix products over the
``[E_loc, cap, d]`` buffer (the reference leaves them to XLA; no
hand-written kernel is on this path).

``dropped``: set it to a 0-d int64 tensor on the run's device and every
routing adds the assignments it dropped past the capacity of its own
experts to it, on the device (no host sync); None (the default) counts
nothing.  Across ranks each cell counts its own experts' drops: summed
over the ranks, ``"ffn"`` counts each drop once per ``model`` rank and
``"2d"`` once per dp rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import MeshCtx, P

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
    if dropped is not None:            # this cell's experts' overflow only
        dropped += (mine & ~keep).sum()

    buf = torch.zeros((drop_row + 1, d), dtype=x.dtype, device=x.device)
    xk = x[:, None].expand(n, k, d).reshape(n * k, d)
    buf.index_add_(0, flat_pos.reshape(-1), xk)
    return buf, flat_pos, gates.to(x.dtype), cap


def _experts(xf: torch.Tensor, p: dict, e_loc: int, off: int,
             cfg: ArchConfig) -> torch.Tensor:
    """The gated sum of each token's kept SwiGLU experts among the
    ``e_loc`` at offset ``off`` whose weights ``p`` holds (in its hidden
    dim's share): xf [N, d] -> [N, d]."""
    n, d = xf.shape
    dt = xf.dtype
    buf, flat_pos, gates, cap = _route_local(xf, p["router"], e_loc, off,
                                             cfg)
    buf_e = buf[:-1].reshape(e_loc, cap, d)
    h = torch.bmm(buf_e, p["wg"].to(dt))
    u = torch.bmm(buf_e, p["wu"].to(dt))
    out_e = torch.bmm(F.silu(h) * u, p["wo"].to(dt))
    out_flat = torch.cat([out_e.reshape(e_loc * cap, d),
                          torch.zeros((1, d), dtype=dt, device=xf.device)])
    gathered = out_flat[flat_pos.reshape(-1)].reshape(n, cfg.top_k, d)
    return (gathered * gates[..., None]).sum(1)


def _shared(xf: torch.Tensor, p: dict) -> torch.Tensor:
    dt = xf.dtype
    g = xf @ p["sh_wg"].to(dt)
    uu = xf @ p["sh_wu"].to(dt)
    return (F.silu(g) * uu) @ p["sh_wo"].to(dt)


def _global_shapes(cfg: ArchConfig) -> dict:
    return {k: v[1:] for k, v in moe_param_shapes(cfg, 1).items()}


def _body(cfg: ArchConfig, mctx: MeshCtx, batch: int) -> str:
    """The body the block runs for a batch of ``batch`` rows, as the
    reference chooses it: ``"2d"`` where dp divides the batch on a mesh of
    more than one device, else ``"expert"``, or ``"ffn"`` (for ``"ffn"``
    and ``"2d"``'s fall-through)."""
    if cfg.moe_shard == "2d" and batch % mctx.dp_size == 0 \
            and mctx.mesh.size > 1:
        return "2d"
    return "expert" if cfg.moe_shard == "expert" else "ffn"


def moe_in_specs(cfg: ArchConfig, mctx: MeshCtx, batch: int) -> dict:
    """The specs of the weights the block's ``shard_map`` takes for a
    batch of ``batch`` rows (the reference's ``in_specs``): each rank
    holds its block of every leaf under them.  ``"2d"`` where it runs
    (dp divides the batch on a mesh of more than one device): the experts
    over ``model`` and their hidden dim over dp, the shared expert's
    d_model over dp; else experts over ``model`` (``"expert"``) or every
    expert with its hidden dim over ``model``."""
    tp, dp = mctx.tp, mctx.dp
    body = _body(cfg, mctx, batch)
    if body == "2d":
        specs = {"wg": P(tp, None, dp), "wu": P(tp, None, dp),
                 "wo": P(tp, dp, None)}
        shared = {"sh_wg": P(dp, tp), "sh_wu": P(dp, tp),
                  "sh_wo": P(tp, None)}
    else:
        ep = body == "expert"
        w = P(tp, None, None) if ep else P(None, None, tp)
        specs = {"wg": w, "wu": w,
                 "wo": P(tp, None, None) if ep else P(None, tp, None)}
        shared = {"sh_wg": P(None, tp), "sh_wu": P(None, tp),
                  "sh_wo": P(tp, None)}
    specs = {"router": P(None, None), **specs}
    return specs | shared if cfg.shared_expert else specs


def _check_blocks(params: dict, cfg: ArchConfig, mctx: MeshCtx,
                  batch: int) -> None:
    shapes = _global_shapes(cfg)
    for k, spec in moe_in_specs(cfg, mctx, batch).items():
        want = mctx.sharding(spec).shard_shape(shapes[k])
        if tuple(params[k].shape) != want:
            raise ValueError(
                f"moe_ffn on a {mctx.mesh} mesh takes this rank's blocks "
                f"(convert.moe_blocks): {k} {tuple(params[k].shape)}, "
                f"not {want}")


def _rank_mesh(mctx: MeshCtx):
    mesh = mctx.mesh
    if not mesh.coords:
        raise RuntimeError(f"moe_ffn on a {mesh} mesh runs on the ranks of "
                           f"a process group (Mesh.over_ranks) or on a "
                           f"CountingMesh")
    return mesh


def _routed_here(params: dict, mesh, tp) -> dict:
    """``params`` with the router through ``pvary`` over tp: every rank
    routes alike, but the gates weigh this rank's experts (or hidden
    columns), so the router's cotangents are summed over tp."""
    return {**params, "router": mesh.pvary(params["router"], tp)}


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig,
            mctx: MeshCtx | None = None, *,
            global_batch: int | None = None) -> torch.Tensor:
    """x: [B, S, D]; returns the same shape: the gated sum of each token's
    kept experts' SwiGLU outputs, plus the shared expert's when the config
    has one.  Weights are cast to x's dtype per use (a no-op on a tree
    from ``cast_params``).  With ``mctx`` a mesh of more than one device
    over ranks, ``global_batch`` is the batch's global row count, ``x``
    this rank's block of it (``P(dp, None, None)``; the whole where dp
    does not divide it), ``params`` this rank's blocks
    (``moe_in_specs``), and this rank's block of the output is
    returned."""
    b, s, d = x.shape
    if mctx is None or mctx.mesh.size == 1:
        xf = x.reshape(b * s, d)
        y = _experts(xf, params, cfg.num_experts, 0, cfg)
        if cfg.shared_expert:
            y = y + _shared(xf, params)
        return y.reshape(b, s, d)
    mesh = _rank_mesh(mctx)
    if global_batch is None:
        raise ValueError(f"moe_ffn on a {mesh} mesh over ranks takes the "
                         f"global batch (global_batch=): x is this rank's "
                         f"block of it")
    split = global_batch % mctx.dp_size == 0
    if b != (global_batch // mctx.dp_size if split else global_batch):
        raise ValueError(f"moe_ffn: {b} rows on this rank for a batch of "
                         f"{global_batch} on {mesh}")
    body = _body(cfg, mctx, global_batch)
    if body == "2d":
        return moe_ffn_2d(params, x, cfg, mctx)
    _check_blocks(params, cfg, mctx, global_batch)
    tp = mctx.tp
    # the input enters this rank's experts (or hidden columns): its
    # cotangents are summed over tp
    xf = mesh.pvary(x.reshape(-1, d), tp)
    if body == "expert":
        e_loc = params["wg"].shape[0]
        off = mesh.axis_index(tp) * e_loc
    else:
        e_loc, off = cfg.num_experts, 0
    y = _experts(xf, _routed_here(params, mesh, tp), e_loc, off, cfg)
    if cfg.shared_expert:
        y = y + _shared(xf, params)
    return mesh.psum(y, tp).reshape(x.shape)


def moe_ffn_2d(params: dict, x: torch.Tensor, cfg: ArchConfig,
               mctx: MeshCtx) -> torch.Tensor:
    """The expert weights fully sharded (E over ``model`` x F over dp),
    tokens moved instead of weights: the reference's body on this rank.
    x: this rank's block [B / dp, S, D] of the batch (dp divides it).
    Every rank all-gathers the tokens over dp, routes the whole batch
    under the global capacity to its ``e_loc`` experts, runs its
    ``(E_loc, F_loc)`` blocks, and one ``psum`` over ``(model, *dp)``
    completes both partial dims; it returns its own rows of the sum.

    Backward: the tokens and the router enter this rank's experts through
    ``pvary`` over tp, the gather's reduce-scatter sums the tokens'
    cotangents over dp, the shared expert's dp sums enter the dp-varying
    ``y_sh / dp`` through ``pvary`` over dp, and the psum's output before
    the rows are cut through ``pvary`` over dp (each dp rank's rows'
    cotangents summed into the whole batch's).  The router's cotangent
    stays this dp rank's share: the caller sums the replicated leaves'
    gradients over dp."""
    b_loc, s, d = x.shape
    mesh = _rank_mesh(mctx)
    tp, dp, dp_size = mctx.tp, mctx.dp, mctx.dp_size
    _check_blocks(params, cfg, mctx, b_loc * dp_size)
    x_all = mesh.all_gather(mesh.pvary(x, tp), dp, dim=0)   # [B, S, D]
    n = x_all.shape[0] * s
    xf = x_all.reshape(n, d)
    e_loc = params["wg"].shape[0]
    y = _experts(xf, _routed_here(params, mesh, tp), e_loc,
                 mesh.axis_index(tp) * e_loc, cfg)
    if cfg.shared_expert:
        # shared expert: D sharded over dp, F over tp; finish the dp
        # partial sums before the nonlinearity, then pre-scale by 1/dp so
        # the joint (tp, dp) psum below stays exact
        dt = xf.dtype
        d_loc = params["sh_wg"].shape[0]
        row = mesh.axis_index(dp)
        xs = xf[:, row * d_loc:(row + 1) * d_loc]
        g = mesh.pvary(mesh.psum(xs @ params["sh_wg"].to(dt), dp), dp)
        uu = mesh.pvary(mesh.psum(xs @ params["sh_wu"].to(dt), dp), dp)
        y_sh = (F.silu(g) * uu) @ params["sh_wo"].to(dt)
        y = y + y_sh / dp_size
    y = mesh.pvary(mesh.psum(y, (tp, *dp)), dp).reshape(-1, s, d)
    row = mesh.axis_index(dp)
    return y[row * b_loc:(row + 1) * b_loc]


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
