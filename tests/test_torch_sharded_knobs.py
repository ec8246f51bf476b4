"""The reference's attention and remat knobs across ranks: the port's
serving and training steps under ``attn_shard`` "heads" and "seq",
``pad_heads_to`` and ``remat="dots"`` against the JAX package's on 8
devices.

8 gloo ranks on the CPU (``launch.mesh.run_ranks``, spawned once for the
module, one intra-op thread each) run every serving case of
``torch_sharded_knobs_cases`` (a prefill over ``[batch, 16]`` tokens and
4 decode steps) and every training case of
``torch_sharded_knobs_train_cases`` (2 AdamW steps), every rank holding
only its blocks of the parameters, the caches, the moments and the
batch.  Held against the reference's answers in
``tests/data/torch_sharded_knobs.json`` (written by ``test_torch_pins.py
--write-sharded-knobs``) on every rank: the gathered logits and caches
within 2e-5 (float32, values of order 1); the training cases within
``torch_sharded_train_cases.check_case``'s bounds (losses 1e-5 relative,
gradients 2e-6 + 1e-4 relative, parameters 1e-6); each step's collectives
equal to a ``CountingMesh``'s count of the same step on meta tensors;
the MoE cases' routing clear of ties (the top-k gap above 1e-5).
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_knobs_cases as S  # noqa: E402
import torch_sharded_knobs_train_cases as T  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.sharding import CountingMesh, MeshCtx  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

PINS = json.loads((pathlib.Path(__file__).resolve().parent / "data"
                   / "torch_sharded_knobs.json").read_text())
SERVE = {k.removeprefix("serve/"): v for k, v in PINS.items()
         if k.startswith("serve/")}
TRAIN = {k.removeprefix("train/"): v for k, v in PINS.items()
         if k.startswith("train/")}
ATOL = 2e-5
ROUTE_GAP = 1e-5


@pytest.fixture(scope="module")
def ranks() -> list:
    """Every rank's answers to every case (one spawn of 8 ranks)."""
    return run_ranks(S.rank_all, S.WORLD, "cpu", timeout_s=900)


def _train_paths(name: str) -> list:
    cfg = T.port_config(name)
    return T.paths(get_model(cfg).param_shapes(cfg))


def test_pin_file_covers_every_case():
    keys = set(S.case_keys())
    for name in S.CASES:
        cfg = S.port_config(name)
        keys |= {f"{name}/{k}" for k in S.cache_paths(
            tfm.kv_shapes(cfg, 1, 1))}
    assert set(SERVE) == keys
    assert set(TRAIN) == {k for name in T.CASES
                          for k in T.pin_keys(name, _train_paths(name))}
    meta = PINS["_meta"]
    assert meta["serve"] == {k: list(v) for k, v in S.CASES.items()}
    assert meta["serve_replace"] == {k: S.case_replace(k) for k in S.CASES}
    assert meta["train"] == {k: list(v) for k, v in T.CASES.items()}
    assert meta["train_replace"] == {k: T.replace(k) for k in T.CASES}
    assert (meta["steps"], meta["train_steps"]) == (S.STEPS, T.STEPS)
    assert (meta["prompts"], meta["seqs"]) == (S.PROMPTS, T.SEQS)


def test_the_cases_cover_every_knob():
    """"heads" and "seq" on both meshes, the uneven "heads" split (a rank
    with no head), padding that ``model`` divides where the heads it pads
    do not, "seq" with a window and a chunk shorter than a rank's span
    away from position 0, "seq" with a rank holding no query row, a batch
    the data axes do not divide, "dots"."""
    serve = {n: S.port_config(n) for n in S.CASES}
    train = {n: T.port_config(n) for n in T.CASES}
    for cfgs, cases in ((serve, S.CASES), (train, T.CASES)):
        assert {c.attn_shard for c in cfgs.values()} == {"auto", "heads",
                                                         "seq"}
        assert any(c.padded_heads % 4 == 0 and c.num_heads % 4
                   for c in cfgs.values())
        assert any(c.attn_shard == "heads" and c.num_heads % 4
                   for c in cfgs.values())
        assert any(c.attn_shard == "seq" and c.window for c in
                   cfgs.values())
        assert any(c.attn_shard == "seq" and c.chunk_attn for c in
                   cfgs.values())
        assert {cases[n][2] for n, c in cfgs.items()
                if c.attn_shard == "seq"} == set(S.MESHES)
    assert any(v[3] % 2 for v in S.CASES.values())
    for cases, lengths in ((S.CASES, S.PROMPTS), (T.CASES, T.SEQS)):
        # 4 model ranks take the ceiling of the positions over 4 each
        assert any(cases[n][1].get("attn_shard") == "seq"
                   and cases[n][2] == "2x4" and 3 * -(-s // 4) >= s
                   for n, s in lengths.items())
    assert {c.remat for c in train.values()} == {"full", "dots"}
    assert any(c.remat == "dots" and c.num_experts for c in train.values())
    # "heads" with 6 heads over 4 ranks: 2, 2, 2 and none
    cfg = serve["llama-heads6/2x4/heads"]
    spans = []
    for r in range(4):
        rk = tfm._Ranks(cfg, MeshCtx(CountingMesh(
            (2, 4), ("data", "model"), {"data": 0, "model": r})), 4, 2, 20)
        spans.append((rk.q0, rk.q1, rk.whole))
    assert spans == [(0, 2, True), (2, 4, True), (4, 6, True),
                     (6, 6, True)]


@pytest.mark.parametrize("name", list(S.CASES))
def test_served_on_ranks_matches_reference_pin(ranks, name):
    for r in ranks:
        got = r["serve"][name]
        for step in S.steps():
            want = S.decode(SERVE[f"{name}/{step}"])
            assert got[step].shape == want.shape == (S.CASES[name][3], 256)
            assert 0.5 < np.abs(want).max() < 20
            assert np.abs(got[step] - want).max() <= ATOL, (name, step)
        for key in [k for k in SERVE if k.startswith(f"{name}/cache/")]:
            want = S.decode(SERVE[key])
            have = got[key[len(name) + 1:]]
            assert have.shape == want.shape
            assert np.abs(have - want).max() <= ATOL, key


@pytest.mark.parametrize("name", list(T.CASES))
def test_trained_on_ranks_matches_reference_pin(ranks, name):
    got = T.check_case(name, [r["train"][name] for r in ranks], TRAIN,
                       _train_paths(name))
    print(f"{name}: {got}")
    assert got["loss_rel"] <= T.LOSS_RTOL
    for r in ranks[1:]:
        assert r["train"][name]["loss"] == ranks[0]["train"][name]["loss"]


def test_every_rank_counts_what_a_counting_mesh_counts(ranks):
    """Serving: each step's collectives; training: the first step's,
    backward and recompute included, and every later step's the
    first's."""
    for r in ranks:
        for name in S.CASES:
            for step in S.steps():
                assert r["serve"][name][f"log/{step}"] == \
                    r["serve"][name][f"count/{step}"], (name, step)
        for name in T.CASES:
            rec = r["train"][name]
            assert rec["log/0"] == rec["count"], name
            assert all(rec[f"log/{i}"] == rec["log/0"]
                       for i in range(T.STEPS)), name


def test_seq_gathers_its_rows_and_the_whole_weights(ranks):
    """Under "seq" a layer gathers ``wq``, ``wk``, ``wv`` and ``wo`` whole
    over ``model`` (their column or row blocks: 4 gathers where "auto"
    gathers ``wk`` and ``wv`` only) and its rows of ``o @ wo`` once, and
    issues no attention psum over ``model``; decode runs as "auto"."""
    r = ranks[0]["serve"]
    seq = r["llama/2x4/seq"]["log/prefill"]["all-gather model"][0]
    heads = r["llama/2x4/heads"]["log/prefill"]["all-gather model"][0]
    layers = S.port_config("llama/2x4/seq").num_layers
    assert seq - heads == layers * (4 + 1 - 2)
    psums = {k: r[k]["log/prefill"]["all-reduce model"][0]
             for k in ("llama/2x4/seq", "llama/2x4/heads")}
    assert psums["llama/2x4/heads"] - psums["llama/2x4/seq"] == layers
    assert r["llama/2x4/seq"]["log/decode0"] == \
        r["llama/2x4/heads"]["log/decode0"]


@pytest.mark.parametrize("name", [n for n in T.CASES
                                  if T.port_config(n).num_experts])
def test_moe_cases_route_clear_of_ties(name, monkeypatch):
    """Each MoE training case on one device: every routing's k-th and
    (k+1)-th router probabilities at least ``ROUTE_GAP`` apart, so the
    ranks' other summation orders pick the reference's experts."""
    from repro_torch.models import moe
    from repro_torch.train.optimizer import init_opt_state
    cfg = T.port_config(name)
    inp = T.case_inputs(name, get_model(cfg).param_shapes(cfg), cfg)
    gaps = []
    top_k = moe.top_k

    def spy(probs, k):
        vals = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True).values
        gaps.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return top_k(probs, k)
    monkeypatch.setattr(moe, "top_k", spy)
    params = params_from_numpy(inp["params"], "cpu")
    ocfg = AdamWConfig(opt_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg, T.CASES[name][4])
    for _ in range(T.STEPS):
        params, opt, _ = step(params, opt, {
            "tokens": torch.from_numpy(inp["tokens"])})
    assert len(gaps) >= 2 * T.STEPS and min(gaps) >= ROUTE_GAP, gaps


def test_serving_moe_case_routes_clear_of_ties(monkeypatch):
    """The llama4 serving case's prefill and decode steps on one device:
    every routing clear of ties by ``ROUTE_GAP``."""
    from repro_torch.models import moe
    name = "llama4-expert/2x4/seq"
    cfg = S.port_config(name)
    model = get_model(cfg)
    inp = S.inputs(name, model.param_shapes(cfg), cfg.vocab_size,
                   cfg.d_model, 0)
    gaps = []
    top_k = moe.top_k

    def spy(probs, k):
        vals = torch.sort(probs, dim=-1, descending=True, stable=True).values
        gaps.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return top_k(probs, k)
    monkeypatch.setattr(moe, "top_k", spy)
    p = params_from_numpy(inp["params"], "cpu")
    toks = torch.from_numpy(inp["tokens"])
    with torch.no_grad():
        _, caches = model.prefill(p, {"tokens": toks[:, :S.PROMPT]}, cfg)
        caches = {g: {kv: torch.nn.functional.pad(c, (0, 0, 0, 4))
                      for kv, c in v.items()} for g, v in caches.items()}
        for i in range(S.STEPS):
            t = S.PROMPT + i
            _, caches = model.decode(p, caches, toks[:, t:t + 1], t, cfg)
    assert len(gaps) >= 1 + S.STEPS and min(gaps) >= ROUTE_GAP, gaps
