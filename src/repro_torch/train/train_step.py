"""The train / prefill / serve steps for every architecture (the
reference's ``repro.train.train_step``).  Training runs on one device;
the prefill and serve steps also run across ranks for the decoder
families (``mctx`` over the ranks of a process group: every argument and
result is this rank's block, ``models.transformer``), where they take
the global batch (``global_batch=``) and a decode step the caches' global
slot count (``n_slots=``).

``make_train_step`` returns train_step(params, opt_state, batch) ->
(params, opt_state, metrics): the loss and its gradient by autograd,
then the AdamW update, which writes the parameters and the moments in
place (``optimizer.adamw_update``).  With ``microbatch`` > 1 the batch is
split along its first axis, each part's gradient summed in float32 and
the sums divided, as the reference's ``fori_loop`` does.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import get_model
from repro_torch.models.sharding import MeshCtx
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.tree import leaves, unflatten


def make_loss_fn(cfg: ArchConfig):
    model = get_model(cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch, cfg)

    return loss_fn


def value_and_grad(loss_fn, params, batch: dict, microbatch: int = 1):
    """(loss float32 0-d, gradients: a tree like ``params``).  The leaves
    are differentiated through detached views of ``params`` (no copy).
    One batch: each gradient in its parameter's dtype; ``microbatch`` > 1:
    the float32 sums over the parts divided by their count."""
    flat = leaves(params)

    def one(part):
        views = [p.detach().requires_grad_(True) for _, p in flat]
        loss = loss_fn(unflatten(params, views), part)
        grads = torch.autograd.grad(loss, views, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    if microbatch == 1:
        loss, grads = one(batch)
        return loss, unflatten(params, list(grads))
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
    return loss / microbatch, unflatten(params,
                                        [a / microbatch for a in acc])


def make_train_step(cfg: ArchConfig, ocfg: AdamWConfig | None = None,
                    microbatch: int = 1, mctx: MeshCtx | None = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}); params and the moments are updated in
    place.  On one device: a mesh of more than one raises."""
    if mctx is not None and mctx.mesh.size > 1:
        raise NotImplementedError(
            f"{cfg.name}: training across ranks (a {mctx.mesh} mesh) is not "
            f"ported yet; the prefill and serve steps run across ranks")
    ocfg = ocfg or AdamWConfig(opt_dtype=cfg.opt_dtype)
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch, microbatch)
        params, opt_state, om = adamw_update(params, grads, opt_state, ocfg)
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
