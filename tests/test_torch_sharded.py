"""The port's decoder steps across ranks against the JAX package's on 8
devices.

8 gloo ranks on the CPU (``launch.mesh.run_ranks``, spawned once for the
module, one intra-op thread each) run every case of
``torch_sharded_cases``: reduced llama3.2-3b (tied embedding),
h2o-danube-1.8b (window), mixtral-8x7b ("ffn" and "2d"),
llama4-maverick ("expert", every second layer MoE, a shared expert) and
internvl2 (image tokens) on a 2x4 ``("data", "model")`` mesh and a 2x2x2
``("pod", "data", "model")`` one: a prefill over ``[4, 16]`` tokens and
4 decode steps, every rank holding only its blocks of the parameters,
the caches and the batch.  The gathered logits and caches are held to
the reference's answers in ``tests/data/torch_sharded.json`` (written by
``test_torch_pins.py --write-sharded``) within 2e-5 absolute, float32
with values of order 1; every rank gathers the same.  Each rank's
collectives are counted (``Mesh.collective_log``) and equal a
``CountingMesh``'s count of the same step on meta tensors, and a count
written out per layer; each rank's parameter bytes equal the dry-run's
per-device bytes.
"""
import collections
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharded_cases as C  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import abstract_params  # noqa: E402
from repro_torch.models.sharding import (CountingMesh, Mesh,  # noqa: E402
                                         MeshCtx, P, cpu_mesh_ctx,
                                         relayout)
from repro_torch.train.train_step import make_train_step  # noqa: E402

PINS = json.loads((pathlib.Path(__file__).resolve().parent / "data"
                   / "torch_sharded.json").read_text())
ATOL = 2e-5


@pytest.fixture(scope="module")
def ranks() -> list:
    """Every rank's answers to every case (one spawn of 8 ranks)."""
    return run_ranks(C.rank_cases, C.WORLD, "cpu", timeout_s=600)


def _mctx(mesh: str, coords=None) -> MeshCtx:
    shape, names = C.MESHES[mesh]
    return MeshCtx(CountingMesh(shape, names, coords))


def test_pin_file_covers_every_case():
    keys = set(C.case_keys())
    for name in C.CASES:
        cfg = C.port_config(name)
        keys |= {f"{name}/{k}" for k in C.cache_paths(
            tfm.kv_shapes(cfg, 1, 1))}
    assert set(PINS) == {"_meta", *keys}
    assert PINS["_meta"]["replace"] == C.REPLACE
    assert PINS["_meta"]["cases"] == {k: list(v) for k, v in
                                      C.CASES.items()}


@pytest.mark.parametrize("name", list(C.CASES))
def test_port_on_ranks_matches_reference_pin(ranks, name):
    got = ranks[0][name]
    for step in C.steps():
        want = C.decode(PINS[f"{name}/{step}"])
        assert got[step].shape == want.shape == (C.CASES[name][3], 256)
        assert 0.5 < np.abs(want).max() < 20          # values of order 1
        assert np.abs(got[step] - want).max() <= ATOL, (name, step)
    caches = [k for k in PINS if k.startswith(f"{name}/cache/")]
    assert caches
    for key in caches:
        want = C.decode(PINS[key])
        have = got[key[len(name) + 1:]]
        assert have.shape == want.shape
        assert np.abs(have - want).max() <= ATOL, key


def test_every_rank_gathers_the_same(ranks):
    for name in C.CASES:
        for key, val in ranks[0][name].items():
            if isinstance(val, np.ndarray):
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[name][key], val,
                                                  (name, key))


def _branch(name: str) -> str:
    cfg = C.port_config(name)
    spec = tfm.kv_spec(cfg, _mctx(C.CASES[name][2]), C.CASES[name][4])
    return "heads" if spec[2] == "model" else (
        "slots" if spec[3] == "model" else "replicated")


def test_the_cases_cover_what_the_step_branches_on():
    """All three ``kv_spec`` branches, both meshes, a dense, a windowed, a
    vlm and each MoE mode, and a batch the data axes do not divide."""
    assert {_branch(n) for n in C.CASES} == {"heads", "slots",
                                             "replicated"}
    assert {c[2] for c in C.CASES.values()} == set(C.MESHES)
    cfgs = [C.port_config(n) for n in C.CASES]
    assert {c.family for c in cfgs} == {"dense", "moe", "vlm"}
    assert any(c.window for c in cfgs) and any(c.tie_embeddings
                                               for c in cfgs)
    assert {c.moe_shard for c in cfgs if c.num_experts} == {"expert", "ffn",
                                                            "2d"}
    assert any(c[3] % 2 for c in C.CASES.values())
    # the reduced heads: on 2x4 one q head a rank, two ranks on a KV head
    assert all((c.num_heads, c.num_kv_heads) == (4, 2) for c in cfgs)


def test_each_rank_holds_the_dry_runs_parameter_bytes(ranks):
    """The cases hold float32 parameters (llama4's config stores bf16):
    the dry-run's bytes of the config in float32."""
    for name, (_, _, mesh, _, _) in C.CASES.items():
        cfg = C.port_config(name).replace(param_dtype="float32")
        shape, names = C.MESHES[mesh]
        abstract = MeshCtx(Mesh(np.arange(C.WORLD).reshape(shape), names))
        want = sum(leaf.shard_nbytes for leaf in _leaves(
            abstract_params(cfg, abstract)))
        assert want < sum(leaf.nbytes for leaf in _leaves(
            abstract_params(cfg)))
        assert {r[name]["param_bytes"] for r in ranks} == {want}, name


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_every_rank_counts_what_a_counting_mesh_counts(ranks):
    """Calls and output bytes per kind and axes, step by step."""
    for r in ranks:
        for name in C.CASES:
            for step in C.steps():
                assert r[name][f"log/{step}"] == r[name][f"count/{step}"], \
                    (name, step)


def expected_calls(name: str, step: str) -> dict:
    """The collectives of one step written out layer by layer: the
    embedding's psum over ``model``; per layer 4 FSDP gathers over the
    data axes (``wq``, ``wk``, ``wv``, ``wo``), ``wk``/``wv``'s columns
    gathered over ``model`` where the KV heads do not divide it, the
    attention output's psum over ``model``, a slot-split cache's two
    gathers over ``model`` a decode step; a dense layer's 3 more FSDP
    gathers and its FFN's psum; a MoE layer's expert gathers from FSDP
    storage (none in "2d") and the block's own collectives."""
    cfg = C.port_config(name)
    _, mode, mesh, batch, _ = C.CASES[name]
    shape, names = C.MESHES[mesh]
    sizes = dict(zip(names, shape))
    dp = ",".join(a for a in names if a != "model")
    dp_size = int(np.prod([sizes[a] for a in names if a != "model"]))
    calls = collections.Counter({"all-reduce model": 1})
    layers = collections.Counter()
    for group, shapes in tfm._layer_group_shapes(cfg).items():
        layers[group] = shapes["ln1"][0]
    for group, n in layers.items():
        per = collections.Counter({f"all-gather {dp}": 4,
                                   "all-reduce model": 1})
        if cfg.num_kv_heads % sizes["model"]:
            per["all-gather model"] += 2
        if step != "prefill" and _branch(name) == "slots":
            per["all-gather model"] += 2
        if group.startswith("dense"):
            per[f"all-gather {dp}"] += 3
            per["all-reduce model"] += 1
        elif mode == "2d" and batch % dp_size == 0:
            per[f"all-gather {dp}"] += 1                 # the tokens
            per[f"all-reduce model,{dp}"] += 1
            if cfg.shared_expert:
                per[f"all-reduce {dp}"] += 2
        else:
            per[f"all-gather {dp}"] += 6 if cfg.shared_expert else 3
            per["all-reduce model"] += 1
        for k, v in per.items():
            calls[k] += n * v
    return dict(calls)


def test_every_rank_issues_the_collectives_written_out(ranks):
    for name in C.CASES:
        for step in C.steps():
            want = expected_calls(name, step)
            for r in ranks:
                got = {k: v[0] for k, v in r[name][f"log/{step}"].items()}
                assert got == want, (name, step)


@pytest.mark.parametrize("name", ["llama/2x4/slots", "h2o/2x4/slots"])
def test_dense_pins_equal_the_one_device_answer(name):
    """A dense decoder's sharded answer is the one-device function: the
    port on no mesh lands within 2e-5 of the pins (MoE in "ffn" and
    "expert" routes per dp shard and does not)."""
    cfg = C.port_config(name)
    model = get_model(cfg)
    inp = C.inputs(name, model.param_shapes(cfg), cfg.vocab_size,
                   cfg.d_model, 0)
    p = params_from_numpy(inp["params"], "cpu")
    toks = torch.from_numpy(inp["tokens"])
    with torch.no_grad():
        logits, caches = model.prefill(p, {"tokens": toks[:, :C.PROMPT]},
                                       cfg)
        got = [logits]
        caches = {g: {kv: torch.nn.functional.pad(c, (0, 0, 0, C.CASES[
            name][4] - C.PROMPT)) for kv, c in v.items()}
            for g, v in caches.items()}
        for i in range(C.STEPS):
            t = C.PROMPT + i
            logits, caches = model.decode(p, caches, toks[:, t:t + 1], t,
                                          cfg)
            got.append(logits)
    for step, have in zip(C.steps(), got):
        want = C.decode(PINS[f"{name}/{step}"])
        assert np.abs(have.numpy() - want).max() <= ATOL, step


def test_one_by_one_mesh_computes_what_no_mesh_computes():
    name = "llama/2x4/slots"
    cfg = C.port_config(name)
    model = get_model(cfg)
    inp = C.inputs(name, model.param_shapes(cfg), cfg.vocab_size,
                   cfg.d_model, 0)
    p = params_from_numpy(inp["params"], "cpu")
    batch = {"tokens": torch.from_numpy(inp["tokens"][:, :C.PROMPT])}
    with torch.no_grad():
        one, c1 = model.prefill(p, batch, cfg, cpu_mesh_ctx())
        none, c0 = model.prefill(p, batch, cfg)
    assert torch.equal(one, none)
    assert all(torch.equal(c1[g][kv], c0[g][kv]) for g in c0
               for kv in ("k", "v"))


def test_relayout_gathers_and_cuts():
    """On a counting mesh (no values moved) the shapes and the count: a
    gather per dim whose axes the target drops, a local cut per dim it
    adds, nothing for equal layouts."""
    mctx = _mctx("2x2x2", {"pod": 1, "data": 0, "model": 1})
    mesh = mctx.mesh
    x = torch.arange(16.0).reshape(4, 4)
    assert relayout(x, P(None, "model"), P(None, "model"), mctx) is x
    y = relayout(x, P(("pod", "data"), "model"), P(None, "model"), mctx)
    assert y.shape == (16, 4)
    y = relayout(x, P(None, "model"), P("model", None), mctx)
    assert torch.equal(y, torch.cat([x[2:]] * 2, dim=1))
    assert {k: v["calls"] for k, v in mesh.collective_log.items()} == {
        ("all-gather", ("pod", "data")): 1, ("all-gather", ("model",)): 1}
    assert mesh.collective_bytes() == {"all-gather": (64 + 16) * 4}
    with pytest.raises(ValueError, match="splits"):
        relayout(torch.ones(3, 1), P(), P("model"), mctx)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def test_what_does_not_run_across_ranks_raises():
    """The "heads"/"seq" layouts run (their values against the reference's:
    ``test_torch_sharded_knobs.py``), a step without its global batch or
    slot count (the enc-dec, SSM and hybrid families' loss, prefill and
    decode too: they run across ranks, ``test_torch_sharded_families.py``
    and ``test_torch_sharded_families_train.py``), and an abstract mesh
    of more than one device."""
    from repro_torch.configs import get_config
    mctx = _mctx("2x4")
    for arch in ("whisper-medium", "mamba2-130m", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(ValueError, match="global_batch"):
            get_model(cfg).loss({}, {"tokens": torch.zeros(
                (2, 4), dtype=torch.int32)}, cfg, mctx)
        with pytest.raises(ValueError, match="global_batch"):
            get_model(cfg).prefill({}, {"tokens": torch.zeros(
                (2, 4), dtype=torch.int32)}, cfg, mctx)
        if cfg.family != "ssm":                  # its caches hold no slots
            with pytest.raises(ValueError, match="n_slots"):
                get_model(cfg).decode({}, {}, torch.zeros(
                    (2, 1), dtype=torch.int32), 4, cfg, mctx,
                    global_batch=4)
    cfg = get_config("whisper-medium").reduced()
    with pytest.raises(ValueError, match="rows"):
        make_train_step(cfg, mctx=mctx)({}, {}, {"tokens": torch.zeros(
            (2, 4), dtype=torch.int32)}, global_batch=2)
    cfg = C.port_config("llama/2x4/slots")
    make_train_step(cfg, mctx=mctx)
    make_train_step(cfg, mctx=cpu_mesh_ctx())
    model = get_model(cfg)
    params = {}
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="global_batch"):
        model.prefill(params, {"tokens": toks}, cfg, mctx)
    with pytest.raises(ValueError, match="rows"):
        model.prefill(params, {"tokens": toks}, cfg, mctx, global_batch=2)
    with pytest.raises(ValueError, match="n_slots"):
        model.decode(params, {}, toks[:, :1], 4, cfg, mctx, global_batch=4)
    for hint in ("heads", "seq"):
        # the steps run across ranks (on a counting mesh, meta)
        hinted = cfg.replace(attn_shard=hint)
        counting = MeshCtx(CountingMesh((2, 4), ("data", "model")))
        blocks = {k: torch.empty(v.sharding.shard_shape(v.shape),
                                 dtype=v.dtype, device="meta")
                  for k, v in _flat(abstract_params(hinted, counting))}
        logits, _ = model.prefill(_unflat(blocks), {"tokens": torch.zeros(
            (2, 16), dtype=torch.int32, device="meta")}, hinted, counting,
            global_batch=4)
        assert tuple(logits.shape) == (2, 64)
    from repro_torch.launch.mesh import production_mesh_ctx
    with pytest.raises(RuntimeError, match="process group"):
        model.prefill(params, {"tokens": toks}, cfg, production_mesh_ctx(),
                      global_batch=32)
