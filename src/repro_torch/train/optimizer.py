"""AdamW with dtype-configurable states (the reference's
``repro.train.optimizer``, on one device).

The arithmetic is the reference's, in float32: global-norm clipping to
``grad_clip``, bias-corrected moments, weight decay on every leaf of two
or more dimensions (by that rule the stacked per-layer norm scales [L, d]
decay too, as in the reference), the new parameter cast back to its
dtype and the moments stored in ``opt_dtype``.  JAX returns new arrays;
here the parameters and the moments are updated in place (at
llama3.2-3b's 3.2 B parameters a second copy of them and their float32
moments would not fit the card), in slices of at most ``SLICE`` elements
so that the float32 temporaries stay small.  The elementwise arithmetic
is the same whatever the slicing, so on the meta device (the dry-run's
trace, which holds no memory) a leaf is one slice: in ``SLICE`` slices
the trace of llama4-maverick's ``train_4k`` cell took 36.0 s on one CPU
thread against 9.8 s, and the whole sweep must stay near a minute
(``launch/dryrun.py``).  The moments are
sharded as their parameters are (``opt_state_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.sharding import P
from repro_torch.train.tree import leaves, tree_map

SLICE = 1 << 26          # elements updated at once (256 MB of float32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    opt_dtype: str = "float32"


def init_opt_state(params, ocfg: AdamWConfig) -> dict:
    """{"m", "v": zeros of each parameter's shape in ``opt_dtype``,
    "step": int32 0} on the parameters' device."""
    dt = getattr(torch, ocfg.opt_dtype)
    dev = leaves(params)[0][1].device
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs) -> dict:
    return {"m": param_specs, "v": param_specs, "step": P()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's sum of squares, in float32."""
    total = None
    for _, x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update(p, g, m, v, clip, step_f, ocfg: AdamWConfig, decay: bool):
    """One slice of one leaf: the reference's ``upd``, written back into
    p, m and v."""
    g32 = g.float() * clip
    m32 = ocfg.b1 * m.float() + (1 - ocfg.b1) * g32
    v32 = ocfg.b2 * v.float() + (1 - ocfg.b2) * g32 * g32
    mhat = m32 / (1 - ocfg.b1 ** step_f)
    vhat = v32 / (1 - ocfg.b2 ** step_f)
    delta = mhat / (torch.sqrt(vhat) + ocfg.eps)
    if decay:
        delta = delta + ocfg.weight_decay * p.float()
    p.copy_(p.float() - ocfg.lr * delta)
    m.copy_(m32)
    v.copy_(v32)


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, ocfg: AdamWConfig):
    """One AdamW step.  Updates ``params`` and ``opt_state``'s moments in
    place and returns (params, opt_state, {"grad_norm": the gradients'
    global norm before clipping}); ``opt_state["step"]`` is a new 0-d
    int32 tensor, one more."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    step_f = step.float()
    flat_g = dict(leaves(grads))
    flat_m = dict(leaves(opt_state["m"]))
    flat_v = dict(leaves(opt_state["v"]))
    for path, p in leaves(params):
        g, m, v = flat_g[path], flat_m[path], flat_v[path]
        pf, gf, mf, vf = (t.reshape(-1) for t in (p, g, m, v))
        if any(t.data_ptr() != u.data_ptr() for t, u in
               ((pf, p), (mf, m), (vf, v))):
            raise ValueError(f"{path}: parameters and moments are updated "
                             f"in place and must be contiguous")
        n = pf.numel() if p.is_meta else SLICE
        for i in range(0, pf.numel(), n):
            s = slice(i, i + n)
            _update(pf[s], gf[s], mf[s], vf[s], clip, step_f, ocfg,
                    p.dim() >= 2)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm}
