"""The port's training step across ranks against the JAX package's jitted
``make_train_step`` on 8 devices.

8 gloo ranks on the CPU (``launch.mesh.run_ranks``, spawned once for the
module, one intra-op thread each) train every case of
``torch_sharded_train_cases``: the reduced dense llama (2 KV heads that 4
model ranks do not divide; on 2x4, on 2x2x2, with a batch of 1 and with 2
microbatches), h2o-danube (a binding window), mixtral in each
``moe_shard`` mode, llama4 ("expert", a shared expert, a binding chunk)
and internvl2 (image tokens), float32 with ``remat="full"``, for 2 AdamW
steps, every rank holding only its blocks of the parameters, the moments
and the batch.  Held against the reference's 8-device answers in
``tests/data/torch_sharded_train.json`` (written by ``test_torch_pins.py
--write-sharded-train``), on every rank:

* each step's loss and gradient norm within ``LOSS_RTOL`` (relative);
* the first step's gradient blocks: every sampled element within
  ``GRAD_ATOL`` + ``GRAD_RTOL`` of its value, and each leaf's sum of
  squares over the ranks' distinct blocks within ``SUMSQ_RTOL``;
* the parameter blocks after the last step: every sampled element within
  ``PARAM_ATOL``, except where the pinned first gradient is itself within
  ``GRAD_ATOL`` of 0 (rounding noise: llama4's top-1 router, whose
  renormalised gate is 1, has a gradient of 0 in exact arithmetic and of
  ~1e-9 in float32).  Adam's first steps are nearly ``lr * sign(g)``, so
  such an element may move up to ``2 * lr`` a step either way:
  ``ADAM_SIGN_TOL`` in all.  Those elements are counted and reported
  (the bounds are ``torch_sharded_train_cases``', which the card's phase
  15 (a) uses too);
* the first train step's collectives (calls and bytes per kind and
  axes, the backward's and the recompute's included) equal a
  ``CountingMesh``'s count of the same step on meta tensors, and every
  later step's the first's.

Each collective's gradient is checked alone first, against its transpose
written out.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_train_cases as C  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.sharding import CountingMesh, MeshCtx  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (make_loss_fn,  # noqa: E402
                                          make_train_step, value_and_grad)

PINS = json.loads((pathlib.Path(__file__).resolve().parent / "data"
                   / "torch_sharded_train.json").read_text())
@pytest.fixture(scope="module")
def ranks() -> list:
    """Every rank's answers to every case (one spawn of 8 ranks)."""
    return run_ranks(C.rank_cases, C.WORLD, "cpu", timeout_s=900)


def _paths(name: str) -> list:
    cfg = C.port_config(name)
    return C.paths(get_model(cfg).param_shapes(cfg))


def test_pin_file_covers_every_case():
    keys = {k for name in C.CASES for k in C.pin_keys(name, _paths(name))}
    assert set(PINS) == {"_meta", *keys}
    assert PINS["_meta"]["cases"] == {k: list(v) for k, v in
                                      C.CASES.items()}
    assert PINS["_meta"]["replace"] == {k: C.replace(k) for k in C.CASES}
    assert PINS["_meta"]["steps"] == C.STEPS


def test_the_adam_bound_is_the_configs():
    from repro_torch.train.optimizer import AdamWConfig
    assert C.LR == AdamWConfig().lr


def test_the_cases_cover_what_training_branches_on():
    cfgs = {n: C.port_config(n) for n in C.CASES}
    assert {c.family for c in cfgs.values()} == {"dense", "moe", "vlm"}
    assert {c.moe_shard for c in cfgs.values() if c.num_experts} == {
        "expert", "ffn", "2d"}
    assert all(not c.num_experts for n, c in cfgs.items()
               if C.CASES[n][1] is None)
    assert {v[2] for v in C.CASES.values()} == set(C.MESHES)
    assert any(v[3] % 2 for v in C.CASES.values())        # dp does not divide
    assert any(v[4] > 1 for v in C.CASES.values())        # microbatches
    assert all(c.remat == "full" and c.compute_dtype == "float32"
               for c in cfgs.values())
    assert cfgs["h2o/2x4"].window < C.SEQ
    assert cfgs["llama4-expert/2x4"].chunk_attn < C.SEQ
    from repro_torch.models.transformer import _Ranks
    layouts = set()
    for name, (_, _, mesh, batch, _) in C.CASES.items():
        shape, names = C.MESHES[mesh]
        dp = int(np.prod(shape[:-1]))
        for r in range(shape[-1]):
            rk = _Ranks(cfgs[name], MeshCtx(CountingMesh(
                shape, names, {**dict.fromkeys(names, 0), "model": r})),
                batch, batch // dp if batch % dp == 0 else batch, C.SEQ)
            layouts.add(("q heads cut" if cfgs[name].num_heads % rk.tp
                         else "q heads whole",
                         "kv by model" if rk.k1 - rk.k0 < cfgs[name]
                         .num_kv_heads else "every kv",
                         "index_select" if len(set(rk.kv_idx)) > 1
                         and len(rk.kv_idx) % len(set(rk.kv_idx))
                         else "slice"))
    assert layouts == {("q heads whole", "every kv", "slice"),
                       ("q heads whole", "kv by model", "slice"),
                       ("q heads cut", "every kv", "slice"),
                       ("q heads whole", "every kv", "index_select")}


def _expected_collective_grads(rank: int) -> dict:
    """The 2x2x2 ("pod", "data", "model") mesh, rank r at (r // 4,
    r // 2 % 2, r % 2): x_r = r * 10 + arange(6), cotangents (r + 1)."""
    x = {r: r * 10.0 + np.arange(6.0) for r in range(8)}
    c = {r: float(r + 1) for r in range(8)}
    m = rank % 2
    dp_group = [i * 2 + m for i in range(4)]            # in (pod, data) order
    pair = [rank - m, rank - m + 1]                     # in model order
    flat = np.concatenate([np.tile(x[r], 4) for r in range(8)]
                          ).reshape(8, 24)
    gathered = np.concatenate([[c[r]] * 3 for r in range(8)])
    return {
        "psum pod,data": (sum(x[r] for r in dp_group)[None],
                          np.full((1, 6), c[rank])),
        "pvary model": (x[rank][None], np.full((1, 6), c[pair[0]]
                                               + c[pair[1]])),
        "all_gather pod,data dim0": (np.stack([x[r] for r in dp_group]),
                                     np.full((1, 6), sum(c[r] for r in
                                                         dp_group))),
        "all_gather model dim1": (np.concatenate([x[r] for r in pair])[None],
                                  np.full((1, 6), c[pair[0]] + c[pair[1]])),
        "reduce_scatter pod,data,model dim1": (
            flat[:, 3 * rank:3 * rank + 3].sum(0)[None],
            gathered.reshape(4, 6).sum(0)[None]),
        "reduce_scatter model dim1 bf16": (
            (x[pair[0]] + x[pair[1]])[3 * m:3 * m + 3][None],
            np.repeat([c[pair[0]], c[pair[1]]], 3)[None]),
    }


def test_each_collective_gradient_is_its_transpose(ranks):
    """psum's backward the identity, pvary's a psum, all_gather's a
    reduce-scatter and reduce_scatter's an all-gather, each on its own,
    on every rank; the bfloat16 reduce-scatter sums in float32."""
    for rank, r in enumerate(ranks):
        got = r["_collective_grads"]
        want = _expected_collective_grads(rank)
        assert set(got) == set(want)
        for label, (y, g) in want.items():
            np.testing.assert_array_equal(got[label]["y"], y,
                                          f"rank {rank} {label}")
            np.testing.assert_array_equal(got[label]["grad"], g,
                                          f"rank {rank} {label} grad")


def _pin(name: str, key: str) -> np.ndarray:
    return C.decode(PINS[f"{name}/{key}"])


@pytest.mark.parametrize("name", list(C.CASES))
def test_port_on_ranks_matches_reference_pin(ranks, name):
    """Losses and gradient norms, gradient and parameter blocks within the
    bounds of ``torch_sharded_train_cases.check_case`` on every rank."""
    got = C.check_case(name, [r[name] for r in ranks], PINS, _paths(name))
    print(f"{name}: {got}")
    assert got["loss_rel"] <= C.LOSS_RTOL


def test_every_rank_reports_the_same_loss(ranks):
    for name in C.CASES:
        for r in ranks[1:]:
            assert r[name]["loss"] == ranks[0][name]["loss"], name
            assert r[name]["grad_norm"] == ranks[0][name]["grad_norm"], name


def test_every_rank_counts_what_a_counting_mesh_counts(ranks):
    """Calls and output bytes per kind and axes, the backward's and the
    recompute's collectives included, step by step."""
    for r in ranks:
        for name in C.CASES:
            assert r[name]["log/0"] == r[name]["count"], name
            assert all(r[name][f"log/{i}"] == r[name]["log/0"]
                       for i in range(C.STEPS)), name
            kinds = {k.split()[0] for k in r[name]["log/0"]}
            assert kinds == {"all-gather", "all-reduce", "reduce-scatter"}, \
                (name, kinds)


@pytest.mark.parametrize("name", ["llama/2x4", "mixtral-2d/2x4"])
def test_pins_equal_the_one_device_gradient(name):
    """The dense decoder's and "2d"'s sharded step computes the
    one-device function: the port's one-device loss and gradient norm on
    the same inputs land within ``LOSS_RTOL`` of the pins ("ffn" and
    "expert" route per dp shard and do not)."""
    cfg = C.port_config(name)
    model = get_model(cfg)
    inp = C.inputs(name, model.param_shapes(cfg), cfg.vocab_size,
                   cfg.d_model, 0)
    p = params_from_numpy(inp["params"], "cpu")
    loss, grads = value_and_grad(make_loss_fn(cfg), p, {
        "tokens": torch.from_numpy(inp["tokens"])})
    want = _pin(name, "loss")[0]
    assert abs(float(loss) - want) <= C.LOSS_RTOL * want
    sumsq = _pin(name, "grad/sumsq")
    got = [float(torch.sum(torch.square(C.leaf(grads, path).double())))
           for path in _paths(name)]
    np.testing.assert_allclose(got, sumsq, rtol=C.SUMSQ_RTOL)


ROUTE_GAP = 1e-5


@pytest.mark.parametrize("name", [n for n, c in C.CASES.items() if c[1]])
def test_moe_cases_route_clear_of_ties(name, monkeypatch):
    """Each MoE case trained on one device: at every routing of every step
    (forward and recompute), each token's k-th and (k+1)-th router
    probabilities at least ``ROUTE_GAP`` apart.  The ranks sum in other
    orders (~1e-6 on the block's input), so a closer pair could pick
    other experts than the reference does, and the comparison would hold
    a tie, not the port, to the pins."""
    from repro_torch.models import moe
    from repro_torch.train.optimizer import init_opt_state
    cfg = C.port_config(name)
    inp = C.inputs(name, get_model(cfg).param_shapes(cfg), cfg.vocab_size,
                   cfg.d_model, 0)
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
    step = make_train_step(cfg, ocfg, C.CASES[name][4])
    for _ in range(C.STEPS):
        params, opt, _ = step(params, opt, {
            "tokens": torch.from_numpy(inp["tokens"])})
    assert len(gaps) >= 2 * C.STEPS and min(gaps) >= ROUTE_GAP, gaps


def test_what_does_not_train_across_ranks_raises():
    """A loss or a train step across ranks without its global batch, for
    every family (each family's loss trains across ranks:
    ``test_torch_sharded_families_train.py`` for the enc-dec, SSM and
    hybrid ones)."""
    from repro_torch.configs import get_config
    mctx = MeshCtx(CountingMesh((2, 4), ("data", "model")))
    toks = torch.zeros((2, 4), dtype=torch.int32)
    for arch in ("llama3.2-3b", "whisper-medium", "mamba2-130m",
                 "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(ValueError, match="global_batch"):
            get_model(cfg).loss({}, {"tokens": toks}, cfg, mctx)
        with pytest.raises(ValueError, match="global_batch"):
            make_train_step(cfg, mctx=mctx)({}, {}, {"tokens": toks})
