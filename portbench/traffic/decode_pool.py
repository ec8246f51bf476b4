"""Decode-pool traffic: ``batch`` sessions whose prompts of ``prompt_len``
tokens are prefilled in set-up, ``prefill_group`` at a time, through the
port's ``prefill``, into caches of ``prompt_len + wave_tokens`` slots;
the window then decodes them together through the port's ``decode`` in
waves of ``wave_tokens`` greedy tokens.  Every wave starts again at
position ``prompt_len`` from new first tokens drawn from the seed, so the
prompts' slots stay as the prefill wrote them, each step attends
``prompt_len + i + 1`` slots, and the slots past the prompt hold the
keys and values of the wave in progress.  A step ends when its tokens
reach the host, as a server streaming them would.

The check finishes the wave in progress (untimed) and takes that last
wave, all its sessions (the experts' capacity couples a step's batch):
the plain reference runs over it, teacher-forced on the served tokens,
from the prompts' keys and values in the program's caches (a full
reference prefill of every session would take minutes at float32), and
the program's keys and values of the wave's slots are held against the
reference's.  The stage that skips, the prefill, is checked by itself on
one group drawn from the seed: its keys and values against the
reference's prefill of the same prompts."""
from __future__ import annotations

import time

import torch

from portbench import compare, weights
from portbench.stats import percentile, window_rate
from portbench.trace import span


class Session:
    def __init__(self, ctx):
        from repro_torch.models import get_model
        a, tp, dev = ctx.arch, ctx.tp, ctx.dev
        self.ctx = ctx
        self.model = get_model(ctx.cfg)
        b, p, w = tp["batch"], tp["prompt_len"], tp["wave_tokens"]
        with ctx.part("weights"):
            self.params = weights.make_params(a, ctx.seed, dev, serve=True)
        ctx.same_tree(self.params)
        dt = getattr(torch, a["compute_dtype"])
        shape = (a["num_layers"], b, a["num_kv_heads"], p + w,
                 a["head_dim"])
        g = weights.group_name(a)
        self.caches = {g: {"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)}}
        self.prompts = weights.tokens(ctx.seed, dev, a["vocab_size"], (b, p),
                                      "prompt")
        self.first = weights.tokens(ctx.seed, dev, a["vocab_size"],
                                    (tp["max_waves"], b), "first")
        self.out = torch.zeros((b, w), dtype=torch.long, device=dev)
        with ctx.part("prefill"), torch.no_grad():
            gs = tp["prefill_group"]
            for r in range(0, b, gs):
                with span("prefill"):
                    _, c = self.model.prefill(
                        self.params, {"tokens": self.prompts[r:r + gs]},
                        ctx.cfg)
                for kv in ("k", "v"):
                    self.caches[g][kv][:, r:r + gs, :, :p] = c[g][kv]
                del c
        self.wave, self.i = 0, 0
        self.tok = self.first[0]

    @torch.no_grad()
    def step(self) -> None:
        tp = self.ctx.tp
        with span("decode_step"):
            logits, self.caches = self.model.decode(
                self.params, self.caches, self.tok[:, None],
                tp["prompt_len"] + self.i, self.ctx.cfg)
            nxt = logits.argmax(-1)
            self.out[:, self.i] = nxt
            nxt.cpu()
        self.i += 1
        if self.i == tp["wave_tokens"]:
            self.wave, self.i = self.wave + 1, 0
            self.tok = self.first[self.wave % len(self.first)]
        else:
            self.tok = nxt


def setup(ctx):
    s = Session(ctx)
    with ctx.part("warmup"):
        for _ in range(ctx.tp["warmup_steps"]):
            s.step()
        ctx.sync()
        s.wave, s.i, s.tok = 0, 0, s.first[0]
    return s


def window(ctx, s, seconds: float) -> dict:
    """Steps until ``seconds`` have passed; traced, the first
    ``trace_steps`` are profiled, and ``seconds`` of untraced steps
    follow the trace's reduction (``resumed``)."""
    from repro_torch.kernels.decode_attn import ops as decode_ops
    ends, traced = [], {}
    n0 = decode_ops.launches
    t0 = time.perf_counter()
    ctx.tracer.start()
    while True:
        s.step()
        ends.append(time.perf_counter() - t0)
        if len(ends) == ctx.tp["trace_steps"] and ctx.trace:
            ctx.tracer.stop()
            traced = {"steps": len(ends),
                      "decode_launches": decode_ops.launches - n0,
                      "resumed": time.perf_counter() - t0}
        if ends[-1] - traced.get("resumed", 0.0) >= seconds \
                and (traced or not ctx.trace):
            break
    return {"ends": ends, "traced": traced}


def end_to_end(ctx, samples: dict) -> dict:
    ends = samples["ends"]
    gaps = [e - s for s, e in zip([0.0] + ends[:-1], ends)]
    return {"tpot_p95_ms": 1e3 * percentile(gaps, 95),
            "gen_tokens_per_s": window_rate(len(ends) * ctx.tp["batch"],
                                            ends[-1])}


def attempted(samples: dict) -> tuple[int, int]:
    return len(samples["ends"]), 0


def layer_info(ctx, samples: dict) -> dict:
    """The traced steps' decode-attention launches and bounds, and the
    untraced steps that follow the trace's reduction: their time and the
    sum of their steps' least times, the profiler's cost on this
    host-paced step being left out of the step's share."""
    from portbench import counts
    a, tp = ctx.arch, ctx.tp
    ends, traced = samples["ends"], samples["traced"]
    steps = traced["steps"]
    b, p = tp["batch"], tp["prompt_len"]

    def slots(i):
        return p + i % tp["wave_tokens"] + 1
    attn = sum(a["num_layers"] * counts.bound_s(*counts.decode_attn(
        b, a["num_heads"], a["num_kv_heads"], slots(i), a["head_dim"]))
        for i in range(steps))
    untraced = range(steps, len(ends))
    return {"steps": steps, "decode_attn_bound_s": attn,
            "decode_attn_calls": steps * a["num_layers"],
            "decode_attn_launches": traced["decode_launches"],
            "untraced_steps": len(untraced),
            "untraced_s": ends[-1] - traced["resumed"] if untraced else 0.0,
            "untraced_bound_s": sum(counts.bound_s(*counts.decode_step(
                a, b, slots(i))) for i in untraced)}


def layer_weights(params: dict, a: dict, i: int) -> dict:
    """Layer ``i``'s weights from the benchmark's tree, in float32."""
    group = params["layers"][weights.group_name(a)]

    def up(node):
        return {k: up(v) if isinstance(v, dict) else v[i].float()
                for k, v in node.items()}
    return up(group)


def top_weights(params: dict, a: dict) -> dict:
    return {n: params[n].float() for n in weights.top_shapes(a)}


def ref_wave(ctx, params, prefix_k, prefix_v, inputs, quant=None,
             chunk: int = 16, kv_layers: int = 2):
    """Reference over a wave, teacher-forced: inputs [B, W] at positions
    prompt_len.., each layer's prompt keys and values from prefix_k/v
    [L, B, Hk, P, D] on the host.  Returns the float32 logits [B, W, V]
    as a list of blocks of ``chunk`` sessions, and the wave's (keys,
    values) [B, W, Hk, D] of the first ``kv_layers`` layers."""
    from portbench.reference import dense, moe
    a, dev, p = ctx.arch, ctx.dev, ctx.tp["prompt_len"]
    top = top_weights(params, a)
    x = dense.rnd(top["embed"][inputs], quant)
    pos = torch.arange(p, p + inputs.shape[1], device=dev)
    kv = []
    for i in range(a["num_layers"]):
        w = layer_weights(params, a, i)
        pk = dense.rnd(prefix_k[i].to(dev).float().transpose(1, 2), quant)
        pv = dense.rnd(prefix_v[i].to(dev).float().transpose(1, 2), quant)
        x, (k, v) = dense.block(x, w, pos, a, moe.ffn, prefix=(pk, pv),
                                groups="step", quant=quant)
        if i < kv_layers:
            kv.append((dense.rnd(k, quant), dense.rnd(v, quant)))
        del w, pk, pv, k, v
    return [dense.logits(x[r:r + chunk], top, a)
            for r in range(0, x.shape[0], chunk)], kv


def ref_prefill(ctx, params, prompts, quant=None, layers=None):
    """Reference prefill of one group through its first ``layers`` layers
    (all for None): each one's (keys, values) [B, P, Hk, D], and the last
    token's logits [B, V] where every layer ran (else None)."""
    from portbench.reference import dense, moe
    a, dev = ctx.arch, ctx.dev
    top = top_weights(params, a)
    x = dense.rnd(top["embed"][prompts], quant)
    pos = torch.arange(prompts.shape[1], device=dev)
    kv = []
    for i in range(layers or a["num_layers"]):
        w = layer_weights(params, a, i)
        x, (k, v) = dense.block(x, w, pos, a, moe.ffn, groups="call",
                                quant=quant)
        kv.append((dense.rnd(k, quant), dense.rnd(v, quant)))
        del w
    whole = len(kv) == a["num_layers"]
    return kv, dense.logits(x[:, -1], top, a) if whole else None


def _finish_the_wave(s) -> None:
    """Decode on (untimed) until the wave in progress is done, so that
    the served tokens and the slots past the prompt are one wave's."""
    while s.i or not s.wave:
        s.step()


def check_inputs(ctx, s, kv_layers: int = 2) -> dict:
    """What the check compares, once the window has closed: the last
    wave's served tokens and inputs, the program's keys and values of its
    slots in the first ``kv_layers`` layers and of the prefill group
    drawn from the seed, and every layer's prompt slots moved to the host;
    the program's caches are then freed on the device (beside the weights
    they leave the reference too little)."""
    tp, a = ctx.tp, ctx.arch
    _finish_the_wave(s)
    g, p, w = weights.group_name(a), tp["prompt_len"], tp["wave_tokens"]
    group = weights.derive(ctx.seed, "group") % (tp["batch"]
                                                 // tp["prefill_group"])
    rows = slice(group * tp["prefill_group"],
                 (group + 1) * tp["prefill_group"])
    k, v = s.caches[g]["k"], s.caches[g]["v"]

    def bshd(t):                       # [B, Hk, S, D] -> [B, S, Hk, D]
        return t.transpose(1, 2).float()
    first = s.first[(s.wave - 1) % len(s.first)]
    out = {"served": s.out.clone(),
           "inputs": torch.cat([first[:, None], s.out[:, :-1]], dim=1),
           "wave_kv": [(bshd(k[i, :, :, p:p + w]), bshd(v[i, :, :, p:p + w]))
                       for i in range(kv_layers)],
           "prompt_kv": [(bshd(k[i, rows, :, :p]), bshd(v[i, rows, :, :p]))
                         for i in range(kv_layers)],
           "prompts": s.prompts[rows],
           "pk": k[:, :, :, :p].cpu(), "pv": v[:, :, :, :p].cpu()}
    s.caches = None
    del k, v
    ctx.free()
    return out


def check(ctx, s, samples: dict, control: bool = False) -> dict:
    from portbench.reference import dense
    dense.exact_matmul()
    c = check_inputs(ctx, s)
    with span("reference"):
        return numbers(ctx, s.params, c, control)


def _kv_err(got: list, want: list) -> float:
    """The worst rms error of keys or values over the layers given."""
    return max(max(compare.rms_err(gk, wk), compare.rms_err(gv, wv))
               for (gk, gv), (wk, wv) in zip(got, want))


@torch.no_grad()
def numbers(ctx, params, c: dict, control: bool = False) -> dict:
    """The numbers held to limits, over the last wave's served tokens
    and the gap by which a served token's reference logit lies below the
    reference's best at its position: ``gap_mean``, the mean gap in
    logits; ``row_median``, the worst session's median gap in units of
    the reference logits' standard deviation at each position; and
    ``kv_l01``, the worst root-mean-square error over the reference's of
    the keys or values of the first two layers, in the wave's slots and
    in the sampled prefill group's.  {"program": ...}; with ``control``
    the reference in float8 held in the program's place too ("fp8"): its
    own argmax in place of the served tokens, its keys and values in
    place of the program's."""
    ref, ref_kv = ref_wave(ctx, params, c["pk"], c["pv"], c["inputs"])
    ref_pre = ref_prefill(ctx, params, c["prompts"], layers=2)[0]
    got = {"program": (c["served"], c["wave_kv"], c["prompt_kv"])}
    if control:
        low, low_kv = ref_wave(ctx, params, c["pk"], c["pv"], c["inputs"],
                               "fp8")
        got["fp8"] = (torch.cat([lg.argmax(-1) for lg in low]), low_kv,
                      ref_prefill(ctx, params, c["prompts"], "fp8", 2)[0])
        del low
    chunk = ref[0].shape[0]
    out = {}
    for name, (tok, wave_kv, prompt_kv) in got.items():
        gaps, scaled = [], []
        for r, lg in enumerate(ref):
            gp = compare.token_gaps(lg, tok[r * chunk:(r + 1) * chunk])
            gaps.append(gp)
            scaled.append(gp / lg.std(-1))
        gaps, scaled = torch.cat(gaps), torch.cat(scaled)     # [B, W]
        out[name] = {"gap_mean": float(gaps.mean()),
                     "row_median": float(scaled.median(-1).values.max()),
                     "kv_l01": max(_kv_err(wave_kv, ref_kv),
                                   _kv_err(prompt_kv, ref_pre))}
    return out
