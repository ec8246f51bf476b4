"""Training traffic: optimizer steps of ``batch`` x ``seq`` uniform tokens,
accumulated over ``microbatch`` parts, through the port's training entry
points (``train_step.make_loss_fn`` + ``value_and_grad``, then
``optimizer.adamw_update``), as ``launch/train.py`` calls them.

Set-up makes the float32 parameters and AdamW state and runs the first
``checked_steps`` steps through the window's own step: their losses, the
first clipped gradient's norm of every layer's slice of every leaf (read
from the moments after step 1) and the norm of each slice's change after
the last checked step are what the plain reference is held to.  The
window then runs steps until ``--seconds`` have passed; every step draws
new rows from the seed."""
from __future__ import annotations

import time

import torch

from portbench import compare, weights
from portbench.stats import window_rate
from portbench.trace import span


def _slices(tree: dict, a: dict):
    """(key, tensor) of every layer's slice of every leaf, and the top
    leaves."""
    group = tree["layers"][weights.group_name(a)]
    for path in weights.layer_paths(a):
        leaf = group
        for key in path:
            leaf = leaf[key]
        for i in range(a["num_layers"]):
            yield ("/".join(path), i), leaf[i]
    for name in weights.top_shapes(a):
        yield (name, -1), tree[name]


def _initial(a: dict, seed: int, key: tuple, dev) -> torch.Tensor:
    path, layer = key
    if layer < 0:
        return weights.top_leaf(a, seed, path, dev, torch.float32)
    return weights.layer_slice(a, seed, layer, tuple(path.split("/")), dev,
                               torch.float32)


def _change_norms(tree: dict, a: dict, seed: int) -> dict:
    out = {}
    for key, p in _slices(tree, a):
        p0 = _initial(a, seed, key, p.device)
        out[key] = float(torch.linalg.vector_norm(p.float() - p0))
        del p0
    return out


class Session:
    """The training object the window drives: model, optimizer state and
    the step that draws its rows."""

    def __init__(self, ctx):
        from repro_torch.train.optimizer import AdamWConfig, init_opt_state
        from repro_torch.train.train_step import make_loss_fn
        self.ctx, a, tp = ctx, ctx.arch, ctx.tp
        self.ocfg = AdamWConfig(lr=tp["lr"], opt_dtype=a["opt_dtype"])
        self.loss_fn = make_loss_fn(ctx.cfg)
        with ctx.part("weights"):
            self.params = weights.make_params(a, ctx.seed, ctx.dev,
                                              serve=False)
            self.opt = init_opt_state(self.params, self.ocfg)
        ctx.same_tree(self.params)
        self.steps = 0

    def step(self) -> torch.Tensor:
        from repro_torch.train import optimizer, train_step
        a, tp = self.ctx.arch, self.ctx.tp
        with span("draw_inputs"):
            toks = weights.tokens(self.ctx.seed, self.ctx.dev,
                                  a["vocab_size"], (tp["batch"], tp["seq"]),
                                  "train", self.steps)
        with span("loss_and_grad"):
            loss, grads = train_step.value_and_grad(
                self.loss_fn, self.params, {"tokens": toks},
                tp["microbatch"])
        with span("adamw"):
            self.params, self.opt, _ = optimizer.adamw_update(
                self.params, grads, self.opt, self.ocfg)
        del grads
        self.steps += 1
        return loss


def setup(ctx):
    s = Session(ctx)
    a, n = ctx.arch, ctx.tp["checked_steps"]
    losses = []
    with ctx.part("warmup"):
        for i in range(n):
            losses.append(float(s.step()))
            if i == 0:
                b1 = s.ocfg.b1
                grad_norms = {k: float(torch.linalg.vector_norm(m.float()))
                              / (1 - b1)
                              for k, m in _slices(s.opt["m"], a)}
        s.readings = {"losses": losses, "grad_norms": grad_norms,
                      "change_norms": _change_norms(s.params, a, ctx.seed)}
    return s


def window(ctx, s, seconds: float) -> dict:
    """Steps until ``seconds`` have passed, each ending when its loss
    reaches the host; traced, the first ``trace_steps`` are profiled."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    ends, losses, traced = [], [], {}
    n0 = flash_ops.bwd_launches
    t0 = time.perf_counter()
    ctx.tracer.start()
    while True:
        losses.append(float(s.step()))
        ends.append(time.perf_counter() - t0)
        if len(ends) == ctx.tp["trace_steps"] and ctx.trace:
            ctx.tracer.stop()
            traced = {"steps": len(ends),
                      "flash_bwd_launches": flash_ops.bwd_launches - n0}
        if ends[-1] >= seconds and (traced or not ctx.trace):
            break
    return {"ends": ends, "losses": losses, "traced": traced}


def end_to_end(ctx, samples: dict) -> dict:
    tp = ctx.tp
    return {"train_tokens_per_s": window_rate(
        len(samples["ends"]) * tp["batch"] * tp["seq"], samples["ends"][-1])}


def attempted(samples: dict) -> tuple[int, int]:
    bad = sum(1 for x in samples["losses"] if not x == x)
    return len(samples["losses"]), bad


def layer_info(ctx, samples: dict) -> dict:
    from portbench import counts
    a, tp = ctx.arch, ctx.tp
    steps = samples["traced"]["steps"]
    mb = tp["microbatch"]
    rows = tp["batch"] // mb
    per = counts.flash_bwd(rows, a["num_heads"], a["num_kv_heads"], tp["seq"],
                           a["head_dim"], a.get("window"))
    calls = steps * mb * a["num_layers"]
    return {"steps": steps,
            "train_flops": steps * counts.train_step_flops(a, tp["batch"],
                                                           tp["seq"]),
            "flash_bwd_bound_s": calls * counts.bound_s(*per),
            "flash_bwd_calls": calls,
            "flash_bwd_launches": samples["traced"]["flash_bwd_launches"]}


def reference(ctx, quant=None) -> dict:
    """The plain reference's readings over the checked steps: the same
    initial weights and rows, float32 (or the control's precision)."""
    from portbench.reference import dense as ref
    a, tp, dev, seed = ctx.arch, ctx.tp, ctx.dev, ctx.seed
    ref.exact_matmul()
    top = {n: weights.top_leaf(a, seed, n, dev, torch.float32)
           .requires_grad_(True) for n in weights.top_shapes(a)}
    paths = weights.layer_paths(a)
    layers = []
    for i in range(a["num_layers"]):
        w: dict = {}
        for path in paths:
            t = weights.layer_slice(a, seed, i, path, dev, torch.float32)
            node = w
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t.requires_grad_(True)
        layers.append(w)
    keys, leaves, decay = [], [], []
    for path in paths:
        for i, w in enumerate(layers):
            t = w
            for key in path:
                t = t[key]
            keys.append(("/".join(path), i))
            leaves.append(t)
            decay.append(True)          # stacked leaves have >= 2 dims
    for name, t in top.items():
        keys.append((name, -1))
        leaves.append(t)
        decay.append(t.dim() >= 2)
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, grad_norms = [], None
    count = tp["batch"] * (tp["seq"] - 1)
    for step in range(tp["checked_steps"]):
        toks = weights.tokens(seed, dev, a["vocab_size"],
                              (tp["batch"], tp["seq"]), "train", step)
        total = 0.0
        for r in range(tp["batch"]):
            loss = ref.loss_sum(top, layers, toks[r:r + 1], a, quant) / count
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = [t.grad for t in leaves]
        _, clipped = ref.adamw(leaves, grads, m, v, step + 1, decay,
                               tp["lr"])
        if step == 0:
            grad_norms = dict(zip(keys, clipped))
        for t in leaves:
            t.grad = None
    change = {}
    for key, t in zip(keys, leaves):
        t0 = _initial(a, seed, key, dev)
        change[key] = float(torch.linalg.vector_norm(t.detach() - t0))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def check(ctx, s, samples: dict, control: bool = False) -> dict:
    """The program's readings from set-up against the reference's
    ({"program": numbers}; with ``control``, also the numbers of the
    reference in float8 put in the program's place, under "fp8")."""
    prog = s.readings
    s.params = s.opt = None
    ctx.free()
    with span("reference"):
        ref = reference(ctx)
        out = {"program": compare.train_numbers(prog, ref)}
        if control:
            out["fp8"] = compare.train_numbers(reference(ctx, "fp8"), ref)
    return out
