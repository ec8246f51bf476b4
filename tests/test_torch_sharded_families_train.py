"""The port's training step across ranks for the enc-dec, SSM and hybrid
families against the JAX package's jitted ``make_train_step`` on 8
devices.

8 gloo ranks on the CPU (``launch.mesh.run_ranks``, spawned once for the
module, one intra-op thread each) train every case of
``torch_sharded_families_train_cases``: the reduced whisper (on 2x4, on
2x2x2, with a batch of 1), mamba2 (on 2x4, with heads that ``model``
cuts, with ``ssm_state`` 14, on 2x2x2, with 2 microbatches) and
recurrentgemma (a full group and a tail layer; 4 and 10 q heads on its
one KV head), float32 with ``remat="full"``, for 2 AdamW steps, every
rank holding only its blocks of the parameters, the moments and the
batch.  Held against the reference's 8-device answers in
``tests/data/torch_sharded_families_train.json`` (written by
``test_torch_pins.py --write-sharded-families-train``), on every rank,
within ``torch_sharded_train_cases.check_case``'s bounds:

* each step's loss and gradient norm within ``LOSS_RTOL`` (relative);
* the first step's gradient blocks: every sampled element within
  ``GRAD_ATOL`` + ``GRAD_RTOL`` of its value, and each leaf's sum of
  squares over the ranks' distinct blocks within ``SUMSQ_RTOL`` (so
  whisper's encoder leaves, whose cotangents gather from every decoder
  layer's cross-attention, are held leaf by leaf, not only through the
  norm);
* the parameter blocks after the last step within ``PARAM_ATOL``;
* every rank reports the same losses;
* each train step's collectives (the backward's and the recompute's
  included) equal a ``CountingMesh``'s count of the same step on meta
  tensors, and every later step's the first's.

The pins are also the one-device function's: the port's loss and
gradient on one device, from the same inputs, land on them.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_families_train_cases as C  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.sharding import CountingMesh, MeshCtx  # noqa: E402
from repro_torch.train.train_step import (make_loss_fn,  # noqa: E402
                                          value_and_grad)

PINS = json.loads((pathlib.Path(__file__).resolve().parent / "data"
                   / "torch_sharded_families_train.json").read_text())


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


def test_the_cases_cover_what_training_branches_on():
    """Every family on both meshes' layouts, a batch the data axes do not
    divide, microbatches; whisper's KV heads computed whole (2x4) and cut
    (2x2x2) within one ``attn_kv_chunk`` of frames; mamba2's heads whole
    and cut by ``model`` (overlapping head spans); recurrentgemma's
    group under ``remat`` and its tail layer, with its q heads even and
    uneven over ``model``."""
    from repro_torch.models.hybrid import _pattern_counts
    from repro_torch.models.ssm import _head_span
    from repro_torch.models.transformer import _Ranks
    cfgs = {n: C.port_config(n) for n in C.CASES}
    assert {c.family for c in cfgs.values()} == {"encdec", "ssm", "hybrid"}
    assert {v[2] for v in C.CASES.values()} == set(C.MESHES)
    assert any(v[3] % 2 for v in C.CASES.values())        # dp does not divide
    assert any(v[4] > 1 for v in C.CASES.values())        # microbatches
    assert all(c.remat == "full" and c.compute_dtype == "float32"
               and c.param_dtype == "float32" for c in cfgs.values())
    layouts = set()
    for name, (_, _, mesh, batch, _) in C.CASES.items():
        cfg = cfgs[name]
        shape, names = C.MESHES[mesh]
        tp = shape[-1]
        if cfg.family == "encdec":
            assert cfg.enc_seq <= cfg.attn_kv_chunk
            layouts.add(("encdec", "kv cut" if cfg.num_kv_heads % tp == 0
                         else "kv whole"))
        elif cfg.family == "ssm":
            spans = [_head_span(cfg, tp, r)[:2] for r in range(tp)]
            layouts.add(("ssm", "heads cut" if any(
                a[1] > b[0] for a, b in zip(spans, spans[1:]))
                else "heads whole"))
        else:
            assert _pattern_counts(cfg) == (1, 1)
            dp = int(np.prod(shape[:-1]))
            rk = _Ranks(cfg, MeshCtx(CountingMesh(shape, names)), batch,
                        batch // dp if batch % dp == 0 else batch, C.SEQ)
            layouts.add(("hybrid", "q heads cut" if cfg.num_heads % rk.tp
                         else "q heads whole"))
    assert layouts == {("encdec", "kv whole"), ("encdec", "kv cut"),
                       ("ssm", "heads whole"), ("ssm", "heads cut"),
                       ("hybrid", "q heads whole"), ("hybrid", "q heads cut")}


@pytest.mark.parametrize("name", list(C.CASES))
def test_port_on_ranks_matches_reference_pin(ranks, name):
    """Losses and gradient norms, gradient and parameter blocks within the
    bounds of ``torch_sharded_train_cases.check_case`` on every rank (a
    parameter whose pinned first gradient is within ``GRAD_ATOL`` of 0
    takes Adam's sign bound, counted in ``adam_sign``)."""
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
    recompute's collectives included, step by step; a family's step
    issues all three kinds (the FSDP gathers' reduce-scatters)."""
    for r in ranks:
        for name in C.CASES:
            assert r[name]["log/0"] == r[name]["count"], name
            assert all(r[name][f"log/{i}"] == r[name]["log/0"]
                       for i in range(C.STEPS)), name
            kinds = {k.split()[0] for k in r[name]["log/0"]}
            assert kinds == {"all-gather", "all-reduce", "reduce-scatter"}, \
                (name, kinds)


def test_whisper_encoder_leaves_are_pinned_leaf_by_leaf():
    """The encoder's gradients are held leaf by leaf: every ``enc_layers``
    leaf has its own pinned sum of squares, none of them 0."""
    for name in (n for n in C.CASES if C.CASES[n][0] == "whisper-medium"):
        paths = _paths(name)
        sumsq = C.decode(PINS[f"{name}/grad/sumsq"])
        enc = [s for p, s in zip(paths, sumsq) if p[0] == "enc_layers"]
        assert len(enc) == len(get_model(C.port_config(name)).param_shapes(
            C.port_config(name))["enc_layers"])
        assert min(enc) > 0, name


@pytest.mark.parametrize("name", list(C.CASES))
def test_pins_equal_the_one_device_gradient(name):
    """These families' sharded step computes the one-device function: the
    port's one-device loss and each leaf's gradient sum of squares on the
    same inputs land within ``LOSS_RTOL`` and ``SUMSQ_RTOL`` of the pins
    (the 1x1 case)."""
    cfg = C.port_config(name)
    model = get_model(cfg)
    inp = C.case_inputs(name, model.param_shapes(cfg), cfg)
    p = params_from_numpy(inp["params"], "cpu")
    feed = {k: torch.from_numpy(v) for k, v in inp.items() if k != "params"}
    loss, grads = value_and_grad(make_loss_fn(cfg), p, feed, C.CASES[name][4])
    want = C.decode(PINS[f"{name}/loss"])[0]
    assert abs(float(loss) - want) <= C.LOSS_RTOL * want
    sumsq = C.decode(PINS[f"{name}/grad/sumsq"])
    got = [float(torch.sum(torch.square(C.leaf(grads, path).double())))
           for path in _paths(name)]
    np.testing.assert_allclose(got, sumsq, rtol=C.SUMSQ_RTOL)
