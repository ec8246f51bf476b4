"""The plain references agree with the port at a small size in float32:
the training loss and every gradient, the MoE layer with its capacity
bound (drops included), and prefill then decode through the cache."""
from __future__ import annotations

import pytest
import torch

from portbench import weights
from portbench.reference import dense, moe
from portbench.tests.tiny import SEED, TINY

F32 = {"compute_dtype": "float32", "param_dtype": "float32",
       "opt_dtype": "float32", "rope_theta": 10000.0, "capacity_factor": 1.25,
       "tie_embeddings": True, "family": "dense", "name": "tiny",
       "remat": "none"}


def _cfg(a):
    from repro_torch.models.config import ArchConfig
    return ArchConfig(**a)


def _ref_layers(params, a):
    group = params["layers"][weights.group_name(a)]

    def at(node, i):
        return {k: at(v, i) if isinstance(v, dict) else v[i]
                for k, v in node.items()}
    return [at(group, i) for i in range(a["num_layers"])]


def test_loss_and_every_gradient_match_the_port():
    from repro_torch.models import get_model
    a = TINY | F32
    cfg = _cfg(a)
    params = weights.make_params(a, SEED, "cpu", serve=False)
    toks = weights.tokens(SEED, "cpu", a["vocab_size"], (2, 48), "t")
    flat = {}

    def leaves(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                leaves(v, pre + (k,))
            else:
                flat[pre + (k,)] = v.requires_grad_(True)
    leaves(params)
    loss = get_model(cfg).loss(params, {"tokens": toks}, cfg)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    top = {n: params[n] for n in weights.top_shapes(a)}
    want = dense.loss_sum(top, _ref_layers(params, a), toks, a) / (2 * 47)
    wgrads = dict(zip(flat, torch.autograd.grad(want, list(flat.values()))))
    assert abs(float(loss.detach()) - float(want.detach())) < 1e-5
    for k in flat:
        err = (grads[k] - wgrads[k]).abs().max() / wgrads[k].abs().max()
        assert err < 1e-4, k


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_layer_matches_the_port_with_its_drops(factor):
    from repro_torch.models import moe as port_moe
    a = TINY | F32 | {"family": "moe", "num_experts": 4, "top_k": 2,
                      "capacity_factor": factor, "tie_embeddings": False}
    cfg = _cfg(a)
    params = weights.make_params(a, SEED, "cpu", serve=False)
    w = _ref_layers(params, a)[0]
    x = torch.randn(3, 40, a["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    port_moe.dropped = torch.zeros((), dtype=torch.long)
    try:
        got = port_moe.moe_ffn(w["moe"], x, cfg)
        drops = int(port_moe.dropped)
    finally:
        port_moe.dropped = None
    want = moe.ffn(x, w, a, groups="call")
    assert (drops > 0) == (factor < 1)
    assert (got - want).abs().max() < 1e-5


def test_prefill_then_decode_through_the_cache_match_the_reference():
    from portbench.run import Ctx
    from portbench.traffic import decode_pool
    from repro_torch.models import get_model
    a = TINY | F32 | {"family": "moe", "num_experts": 4, "top_k": 2,
                      "tie_embeddings": False}
    cfg = _cfg(a)
    tp = {"prompt_len": 24, "batch": 6}
    ctx = Ctx(SEED, torch.device("cpu"), a, cfg, tp, False)
    params = weights.make_params(a, SEED, "cpu", serve=False)
    model = get_model(cfg)
    prompts = weights.tokens(SEED, "cpu", a["vocab_size"], (6, 24), "p")
    inputs = weights.tokens(SEED, "cpu", a["vocab_size"], (6, 5), "i")
    with torch.no_grad():
        lg0, caches = model.prefill(params, {"tokens": prompts}, cfg)
        caches = {g: {kv: torch.nn.functional.pad(c[kv], (0, 0, 0, 5))
                      for kv in c} for g, c in caches.items()}
        pk = caches["moe"]["k"][:, :, :, :24].clone()
        pv = caches["moe"]["v"][:, :, :, :24].clone()
        got = []
        for j in range(5):
            lg, caches = model.decode(params, caches, inputs[:, j:j + 1],
                                      24 + j, cfg)
            got.append(lg)
        got = torch.stack(got, 1)
        kv, want0 = decode_pool.ref_prefill(ctx, params, prompts)
        blocks, wave_kv = decode_pool.ref_wave(ctx, params, pk, pv, inputs,
                                               kv_layers=a["num_layers"])
        want = torch.cat(blocks)
    assert (lg0 - want0).abs().max() < 1e-4
    for i, (k, v) in enumerate(kv):
        assert (pk[i].transpose(1, 2) - k).abs().max() < 1e-4
        assert (pv[i].transpose(1, 2) - v).abs().max() < 1e-4
    for i, (k, v) in enumerate(wave_kv):
        for got_kv, want_kv in ((caches["moe"]["k"], k),
                                (caches["moe"]["v"], v)):
            slots = got_kv[i, :, :, 24:29].transpose(1, 2)
            assert (slots - want_kv).abs().max() < 1e-4
    assert len(kv) == len(wave_kv) == a["num_layers"]
    assert (got - want).abs().max() < 1e-4


def test_the_float8_control_rounds_what_the_program_holds_in_bf16():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(2))
    w = torch.randn(32, 16, generator=torch.Generator().manual_seed(3))
    exact = x @ w
    err8 = ((dense.mm(x, w, "fp8") - exact).abs().max()
            / exact.abs().max())
    errbf = ((x.bfloat16().float() @ w.bfloat16().float() - exact).abs().max()
             / exact.abs().max())
    assert err8 > 4 * errbf
    assert torch.equal(dense.mm(x, w), exact)
