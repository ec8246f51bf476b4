"""The port's MoE block across ranks against the JAX package's on 8 devices.

8 gloo ranks on the CPU (``launch.mesh.run_ranks``, spawned once for the
module, one intra-op thread each) run every case of ``torch_mesh_cases``:
``moe_ffn`` in the ``"expert"``, ``"ffn"`` and ``"2d"`` modes on a 2x4
``("data", "model")`` mesh and a 2x2x2 ``("pod", "data", "model")`` one,
for the reduced llama4-maverick and mixtral at 8 experts, on x ``[4, 8,
64]`` (dp divides the batch) and ``[1, 8, 64]`` (replicated; ``"2d"``
falls through to ``"ffn"``), and the two decoders' prefill over ``[4,
16]`` tokens and two decode steps on 2x4.  Each rank holds only its
blocks of the MoE weights (``convert.moe_blocks``) and of x, and returns
its block of the output, which the rank gathers; the decoders hold every
parameter, cache and token as the rank's block (``convert.blocks``) and
run the whole sharded step (``test_torch_sharded.py``).  Every case is
held to the reference's answer in ``tests/data/torch_mesh.json`` (written by
``test_torch_pins.py --write-mesh``) within 2e-5 absolute, float32 with
values of order 1; every rank returns the same output.  The pins of
``"expert"`` and ``"ffn"`` differ from the one-device answer by more than
0.1 (each dp shard routes its own tokens under its own capacity), so the
port cannot pass by computing the one-device function.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_cases as C  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch.mesh import (RankPool,  # noqa: E402
                                     production_mesh_ctx, rank_mesh_ctx,
                                     run_ranks)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402
from repro_torch.models.sharding import Mesh, cpu_mesh_ctx  # noqa: E402

PINS = json.loads((pathlib.Path(__file__).resolve().parent / "data"
                   / "torch_mesh.json").read_text())
ATOL = 2e-5


@pytest.fixture(scope="module")
def ranks() -> list:
    """Every rank's answers to every case (one spawn of 8 ranks)."""
    return run_ranks(C.rank_cases, C.WORLD, "cpu", timeout_s=300)


def test_pin_file_covers_every_case():
    assert sorted(PINS) == sorted(["_meta", *C.case_keys()])
    assert PINS["_meta"]["replace"] == C.REPLACE


@pytest.mark.parametrize("key", C.case_keys())
def test_port_on_ranks_matches_reference_pin(ranks, key):
    want = C.decode(PINS[key])
    got = ranks[0][key]
    assert got.shape == want.shape and got.dtype == np.float32
    assert 0.5 < np.abs(want).max() < 20          # values of order 1
    assert np.abs(got - want).max() <= ATOL, key


def test_every_rank_returns_the_same_output(ranks):
    for key in C.case_keys():
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], key)


def _one_device(arch: str, b: int) -> np.ndarray:
    cfg = C.port_config(arch, "expert")
    inp = C.moe_inputs(arch, cfg.d_model, cfg.d_ff, cfg.num_experts,
                       cfg.shared_expert)
    return moe_ffn(params_from_numpy(inp["params"], "cpu"),
                   torch.from_numpy(inp[f"x{b}"]), cfg).numpy()


@pytest.mark.parametrize("mesh", list(C.MESHES))
@pytest.mark.parametrize("arch", C.ARCHS)
def test_only_2d_and_the_replicated_batch_give_the_one_device_answer(
        mesh, arch):
    """On x [4, 8, 64] the "expert" and "ffn" pins differ from the port's
    one-device answer by more than 0.1 and "2d"'s equals it; on [1, 8,
    64], which dp does not divide, every mode routes every token and
    equals it."""
    one4, one1 = _one_device(arch, 4), _one_device(arch, 1)
    for mode in C.MODES:
        pin4 = C.decode(PINS[f"moe/{mesh}/{arch}/{mode}/x4"])
        pin1 = C.decode(PINS[f"moe/{mesh}/{arch}/{mode}/x1"])
        assert np.abs(pin1 - one1).max() <= ATOL, mode
        if mode == "2d":
            assert np.abs(pin4 - one4).max() <= ATOL
        else:
            assert np.abs(pin4 - one4).max() > 0.1, mode


def test_rank_coordinates_indices_and_collectives(ranks):
    """Rank r sits at the row-major coordinates of the 2x2x2 mesh; the dp
    index is pod * 2 + data; a gather follows the order of the axes
    named; a sum covers exactly the ranks along its axes."""
    for r, res in enumerate(ranks):
        ch = res["_checks"]
        pod, data, model = divmod(r, 4)[0], divmod(r, 2)[0] % 2, r % 2
        assert ch["coords"] == {"pod": pod, "data": data, "model": model}
        assert ch["index_dp"] == pod * 2 + data
        assert ch["index_model_pod"] == model * 2 + pod
        same = [q for q in range(8) if q % 2 == model]
        assert ch["gather ('pod', 'data')"] == same
        assert ch["gather ('data', 'pod')"] == [same[i] for i in (0, 2, 1,
                                                                 3)]
        assert ch["psum ('pod', 'data')"] == sum(same)
        assert ch["gather ('model',)"] == [r - model, r - model + 1]
        assert ch["gather ('pod', 'data', 'model')"] == list(range(8))
        assert ch["psum ('pod', 'data', 'model')"] == 28
        # P(dp, "model") of a [4, 6] array: row pod * 2 + data, columns
        # model * 3 .. model * 3 + 2
        row = pod * 2 + data
        assert ch["block"] == [[row * 6 + model * 3 + j for j in range(3)]]


def test_every_rank_counts_the_same_collectives(ranks):
    """Each mesh counts its collectives; the decoder cases run on 2x4
    only, so it issued more."""
    calls = ranks[0]["_collectives"]
    assert calls["2x4"]["calls"] > calls["2x2x2"]["calls"] > 0
    assert all(r["_collectives"] == calls for r in ranks)


def test_a_rank_refuses_global_weights_and_draws_only_its_blocks(ranks):
    for res in ranks:
        ch = res["_checks"]
        assert "takes this rank's blocks" in ch["global_weights"]
        for arch in C.ARCHS:
            for mode in C.MODES:
                init = ch[f"init {arch} {mode}"]
                # every MoE leaf but the router is cut, and the blockwise
                # draw equals the global draw's blocks; the rest is whole
                assert init["cut"] == init["leaves"] - 1 > 0, (arch, mode)
                assert init["blocks_equal"] and init["rest_equal"]


@pytest.mark.parametrize("mode", C.MODES)
def test_one_by_one_mesh_computes_what_no_mesh_computes(mode):
    """A 1x1 mesh (no process group needed) takes the one-device body:
    bit for bit the answer with ``mctx=None``, for the block and through
    the decoder."""
    arch = C.ARCHS[0]
    cfg = C.port_config(arch, mode)
    inp = C.moe_inputs(arch, cfg.d_model, cfg.d_ff, cfg.num_experts,
                       cfg.shared_expert)
    params = params_from_numpy(inp["params"], "cpu")
    x = torch.from_numpy(inp["x4"])
    assert torch.equal(moe_ffn(params, x, cfg, cpu_mesh_ctx()),
                       moe_ffn(params, x, cfg))
    model = get_model(cfg)
    dec = C.decoder_inputs(arch, model.param_shapes(cfg), cfg.vocab_size)
    p = params_from_numpy(dec["params"], "cpu")
    batch = {"tokens": torch.from_numpy(dec["tokens"][:, :C.PROMPT])}
    with torch.no_grad():
        assert torch.equal(model.prefill(p, batch, cfg, cpu_mesh_ctx())[0],
                           model.prefill(p, batch, cfg)[0])


def test_a_multi_device_mesh_without_a_process_group_raises():
    cfg = C.port_config(C.ARCHS[1], "2d")
    inp = C.moe_inputs(C.ARCHS[1], cfg.d_model, cfg.d_ff, cfg.num_experts,
                       cfg.shared_expert)
    params = params_from_numpy(inp["params"], "cpu")
    for mode in C.MODES:
        with pytest.raises(RuntimeError, match="process group"):
            moe_ffn(params, torch.from_numpy(inp["x4"]),
                    cfg.replace(moe_shard=mode), production_mesh_ctx())
    with pytest.raises(RuntimeError, match="process group"):
        Mesh.over_ranks((2, 4), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        rank_mesh_ctx((2, 4))
    with pytest.raises(RuntimeError, match="process group"):
        production_mesh_ctx().mesh.psum(torch.ones(1), "model")


def test_run_ranks_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="on purpose") as err:
        run_ranks(C.raise_on_rank, 2, 1, timeout_s=120)
    assert "ranks [1] failed" in str(err.value)


def test_rank_pool_runs_every_call_on_one_set_of_ranks():
    """Inside a ``RankPool`` the calls of ``run_ranks`` of its world run on
    its ranks, one process group throughout; another world spawns its
    own; once closed, ``run_ranks`` spawns again."""
    with RankPool(2, timeout_s=120) as pool:
        first = run_ranks(C.rank_process, 2, timeout_s=120)
        second = run_ranks(C.rank_process, 2, timeout_s=120)
        alone = run_ranks(C.rank_process, 1, timeout_s=120)
        pids = [p.pid for p in pool.procs.processes]
        assert [r[1] for r in first] == [r[1] for r in second] == pids
        assert first == second == [(0, first[0][1], 2, 1.0),
                                   (1, first[1][1], 2, 1.0)]
        assert alone[0][1] not in pids and alone[0][2:] == (1, 0.0)
    assert launch_mesh._POOL is None and pool.procs is None
    after = run_ranks(C.rank_process, 2, timeout_s=120)
    assert not {r[1] for r in after} & {r[1] for r in first}


def test_rank_pool_calls_see_the_callers_import_path(tmp_path,
                                                    monkeypatch):
    """A call imports its function from a directory put on ``sys.path``
    after the pool's ranks started, as a freshly spawned rank would."""
    with RankPool(2, timeout_s=120):
        (tmp_path / "late_rank_module.py").write_text(
            "def rank_id(rank):\n    return rank * 10\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        import late_rank_module
        assert run_ranks(late_rank_module.rank_id, 2, timeout_s=120) == [0,
                                                                         10]


def test_rank_pool_raises_with_the_failing_ranks_traceback_and_closes():
    with pytest.raises(RuntimeError, match="on purpose") as err:
        with RankPool(2, timeout_s=120) as pool:
            run_ranks(C.raise_on_rank, 2, 1, timeout_s=120)
    assert "rank 1 failed" in str(err.value)
    assert launch_mesh._POOL is None and pool.procs is None
