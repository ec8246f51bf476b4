"""Prefill-pool traffic: a closed loop of waves, each ``rows`` prompts of
one length handed to the port's ``prefill`` together (it takes one
length a batch), returning the first token.  The lengths are a fixed
cycle of ``cycle`` values spread log-uniformly over [``min_len``,
``max_len``] (the quantiles at (j + 0.5) / cycle), each cycle in an order
drawn from the seed, so every seed does the same work.  A request's time
to first token runs from its wave's hand-off to the first token on the
host; a wave's prompts are drawn before its hand-off.

The check runs the plain reference over the longest finished wave and
``check_waves - 1`` more drawn from the seed, and compares the last
token's logits."""
from __future__ import annotations

import time

import torch

from portbench import compare, weights
from portbench.stats import percentile
from portbench.trace import span


def lengths(tp: dict) -> list[int]:
    lo, hi, n = tp["min_len"], tp["max_len"], tp["cycle"]
    return [round(lo * (hi / lo) ** ((j + 0.5) / n)) for j in range(n)]


def order(seed: int, tp: dict, cycle: int) -> list[int]:
    g = torch.Generator().manual_seed(weights.derive(seed, "order", cycle))
    base = lengths(tp)
    return [base[j] for j in torch.randperm(len(base), generator=g)]


class Session:
    def __init__(self, ctx):
        from repro_torch.models import get_model
        self.ctx = ctx
        self.model = get_model(ctx.cfg)
        with ctx.part("weights"):
            self.params = weights.make_params(ctx.arch, ctx.seed, ctx.dev,
                                              serve=True)
        ctx.same_tree(self.params)
        self.waves = []             # (length, logits [rows, V]) a wave

    def prompts(self, w: int, length: int) -> torch.Tensor:
        with span("draw_inputs"):
            return weights.tokens(self.ctx.seed, self.ctx.dev,
                                  self.ctx.arch["vocab_size"],
                                  (self.ctx.tp["rows"], length), "wave", w)

    @torch.no_grad()
    def prefill(self, toks: torch.Tensor) -> torch.Tensor:
        with span("prefill"):
            logits, caches = self.model.prefill(self.params,
                                                {"tokens": toks},
                                                self.ctx.cfg)
            logits.argmax(-1).cpu()
        del caches
        return logits


def setup(ctx):
    s = Session(ctx)
    with ctx.part("warmup"):
        for length in lengths(ctx.tp):
            s.prefill(s.prompts(-1, length))
        ctx.sync()
    return s


def window(ctx, s, seconds: float) -> dict:
    from repro_torch.kernels.flash_attn import ops as flash_ops
    tp = ctx.tp
    ttft, ends, traced = [], [], {}
    n0 = flash_ops.launches
    t0 = time.perf_counter()
    ctx.tracer.start()
    w = 0
    while True:
        length = order(ctx.seed, tp, w // tp["cycle"])[w % tp["cycle"]]
        toks = s.prompts(w, length)
        handoff = time.perf_counter()
        logits = s.prefill(toks)
        done = time.perf_counter()
        ttft += [done - handoff] * tp["rows"]
        ends.append(done - t0)
        s.waves.append((length, logits))
        w += 1
        if w == tp["trace_steps"] and ctx.trace:
            ctx.tracer.stop()
            traced = {"waves": w, "lengths": [n for n, _ in s.waves],
                      "flash_launches": flash_ops.launches - n0}
        if ends[-1] >= seconds and (traced or not ctx.trace):
            break
    return {"ttft": ttft, "ends": ends, "traced": traced}


def end_to_end(ctx, samples: dict) -> dict:
    return {"ttft_p95_ms": 1e3 * percentile(samples["ttft"], 95)}


def attempted(samples: dict) -> tuple[int, int]:
    return len(samples["ttft"]), 0


def layer_info(ctx, samples: dict) -> dict:
    from portbench import counts
    a, tp = ctx.arch, ctx.tp
    lens = samples["traced"]["lengths"]
    fwd = sum(counts.bound_s(*counts.flash_fwd(
        tp["rows"], a["num_heads"], a["num_kv_heads"], n, n, a["head_dim"],
        a.get("window"))) for n in lens) * a["num_layers"]
    return {"waves": len(lens),
            "prefill_flops": sum(counts.prefill_flops(a, tp["rows"], n)
                                 for n in lens),
            "flash_fwd_bound_s": fwd,
            "flash_fwd_calls": len(lens) * a["num_layers"],
            "flash_fwd_launches": samples["traced"]["flash_launches"]}


def sample(ctx, s) -> list[int]:
    """The waves checked: the longest, and more drawn from the seed."""
    n = len(s.waves)
    longest = max(range(n), key=lambda w: s.waves[w][0])
    g = torch.Generator().manual_seed(weights.derive(ctx.seed, "sample"))
    rest = [w for w in torch.randperm(n, generator=g).tolist()
            if w != longest]
    return [longest] + rest[:ctx.tp["check_waves"] - 1]


@torch.no_grad()
def ref_logits(ctx, params, toks, quant=None) -> torch.Tensor:
    """The plain reference's last-token logits of one wave."""
    from portbench.reference import dense
    from portbench.traffic.decode_pool import layer_weights, top_weights
    a = ctx.arch
    top = top_weights(params, a)
    x = dense.rnd(top["embed"][toks], quant)
    pos = torch.arange(toks.shape[1], device=toks.device)
    for i in range(a["num_layers"]):
        x, _ = dense.block(x, layer_weights(params, a, i), pos, a,
                           dense.ffn, quant=quant)
    return dense.logits(x[:, -1], top, a)


def numbers(ctx, s, waves: list, control: bool = False) -> dict:
    """logits: the worst checked wave's max |logit - reference| over the
    largest reference logit ({"program": ...}; with ``control``, the
    reference in float8 in the program's place under "fp8")."""
    worst = {"program": 0.0} | ({"fp8": 0.0} if control else {})
    for w in waves:
        length, got = s.waves[w]
        toks = s.prompts(w, length)
        want = ref_logits(ctx, s.params, toks)
        found = {"program": got}
        if control:
            found["fp8"] = ref_logits(ctx, s.params, toks, "fp8")
        for k, lg in found.items():
            worst[k] = max(worst[k], compare.logit_err(lg, want))
    return {k: {"logits": v} for k, v in worst.items()}


def check(ctx, s, samples: dict, control: bool = False) -> dict:
    from portbench.reference import dense
    dense.exact_matmul()
    waves = sample(ctx, s)
    ctx.free()
    with span("reference"):
        return numbers(ctx, s, waves, control)
