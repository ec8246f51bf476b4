"""The train / prefill / serve steps for every architecture (the
reference's ``repro.train.train_step``).  Each runs on one device, and
also across ranks (``mctx`` over the ranks of a process group: every
argument and result is this rank's block under the spec trees,
``models.transformer``), for every family.  There the steps take the
global batch (``global_batch=``) and a decode step the caches' global
slot count (``n_slots=``).

``make_train_step`` returns train_step(params, opt_state, batch) ->
(params, opt_state, metrics): the loss and its gradient by autograd,
then the AdamW update, which writes the parameters and the moments in
place (``optimizer.adamw_update``).  With ``microbatch`` > 1 the batch is
split along its first axis, each part's gradient summed in float32 and
the sums divided, as the reference's ``fori_loop`` does.

Across ranks the loss is the global batch's on every rank, and autograd
runs back through the collectives (``models.sharding``): each FSDP
gather's backward reduce-scatters a weight's gradient into this rank's
block.  A leaf that the data axes do not shard (the norm scales, the
router, the embedding, a VLM's ``img_proj``, whisper's ``frame_proj``,
mamba2's ``A_log``, ``D``, ``dt_bias`` and conv filters, the RG-LRU's
gates and decays) gets only this data rank's share of its gradient that
way, so ``value_and_grad`` sums those over the data axes its spec leaves
out, one psum per set of axes.  ``microbatch``
> 1 splits this rank's rows (the reference splits the global batch; every
part weighs as many tokens, so the mean is the same up to order).  The
update runs on the blocks (``adamw_update(..., mctx=, specs=)``).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import get_model
from repro_torch.models.sharding import MeshCtx, spec_axes
from repro_torch.models.transformer import on_ranks
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         spec_leaves)
from repro_torch.train.tree import leaves, unflatten


def make_loss_fn(cfg: ArchConfig, mctx: MeshCtx | None = None):
    """loss_fn(params, batch, **layout): the model's loss on ``mctx``
    (across ranks ``layout`` names the global batch)."""
    model = get_model(cfg)

    def loss_fn(params, batch, **layout):
        return model.loss(params, batch, cfg, mctx, **layout)

    return loss_fn


def _sum_over_data(grads: list, mctx: MeshCtx, specs) -> None:
    """Sum, in place, each gradient over the data axes its leaf's spec
    does not shard it on (one psum a set of axes over the leaves'
    concatenation)."""
    groups: dict[tuple[str, ...], list[int]] = {}
    for i, sp in enumerate(spec_leaves(specs)):
        axes = tuple(a for a in mctx.dp if a not in spec_axes(sp))
        groups.setdefault(axes, []).append(i)
    for axes, idx in sorted(groups.items()):
        if not axes:
            continue
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        flat = mctx.mesh.psum(flat, axes)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            grads[i] = part.view_as(grads[i])


def value_and_grad(loss_fn, params, batch: dict, microbatch: int = 1, *,
                   mctx: MeshCtx | None = None, specs=None,
                   global_batch: int | None = None):
    """(loss float32 0-d, gradients: a tree like ``params``).  The leaves
    are differentiated through detached views of ``params`` (no copy).
    One batch: each gradient in its parameter's dtype; ``microbatch`` > 1:
    the float32 sums over the parts divided by their count.  Across ranks
    (``mctx`` over ranks, ``specs`` the parameters' spec tree) the trees
    and the batch are this rank's blocks of ``global_batch`` rows, and
    the gradients are summed over the data axes their specs leave out."""
    flat = leaves(params)
    ranked = on_ranks(mctx)
    layout = {"global_batch": global_batch and global_batch // microbatch
              } if ranked else {}

    def one(part):
        views = [p.detach().requires_grad_(True) for _, p in flat]
        loss = loss_fn(unflatten(params, views), part, **layout)
        grads = torch.autograd.grad(loss, views, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    if microbatch == 1:
        loss, grads = one(batch)
    else:
        loss = torch.zeros((), dtype=torch.float32, device=flat[0][1].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for _, p in flat]
        for i in range(microbatch):
            part = {k: v.reshape(microbatch, -1, *v.shape[1:])[i]
                    for k, v in batch.items()}
            l, grads = one(part)
            loss = loss + l
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
        loss = loss / microbatch
        grads = [a / microbatch for a in acc]
    if ranked:
        _sum_over_data(grads, mctx, specs)
    return loss, unflatten(params, grads)


def make_train_step(cfg: ArchConfig, ocfg: AdamWConfig | None = None,
                    microbatch: int = 1, mctx: MeshCtx | None = None):
    """Returns train_step(params, opt_state, batch, **layout) -> (params,
    opt_state, {"loss", "grad_norm"}); params and the moments are updated
    in place.  On a mesh over ranks the trees are this rank's blocks
    under ``param_specs`` / ``opt_state_specs`` and the batch its block
    of ``global_batch=`` rows, for every family."""
    ocfg = ocfg or AdamWConfig(opt_dtype=cfg.opt_dtype)
    loss_fn = make_loss_fn(cfg, mctx)
    ranked = on_ranks(mctx)
    specs = get_model(cfg).param_specs(cfg, mctx) if ranked else None
    dist = {"mctx": mctx, "specs": specs} if ranked else {}

    def train_step(params, opt_state, batch, *, global_batch=None):
        loss, grads = value_and_grad(loss_fn, params, batch, microbatch,
                                     global_batch=global_batch, **dist)
        params, opt_state, om = adamw_update(params, grads, opt_state, ocfg,
                                             **dist)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ArchConfig, mctx: MeshCtx | None = None):
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch, **layout):
        return model.prefill(params, batch, cfg, mctx, **layout)

    return prefill_step


def make_serve_step(cfg: ArchConfig, mctx: MeshCtx | None = None):
    """One decode step: new token against the KV/state cache."""
    model = get_model(cfg)

    @torch.no_grad()
    def serve_step(params, caches, tokens, t, **layout):
        return model.decode(params, caches, tokens, t, cfg, mctx, **layout)

    return serve_step
