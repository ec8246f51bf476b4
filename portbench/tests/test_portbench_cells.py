"""Every cell's traffic runs end to end at a small size on the CPU to the
result's last line; the comparison holds a sound run and fails every
planted fault the cell can have, and the float8 control."""
from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import faults, run
from portbench.tests.tiny import CELLS, SEED

BENCH = run.load(run.ROOT / "BENCHMARK.json")
KIND = {w["name"]: run.load(run.HERE / "traffic" / f"{w['traffic']}.json")
        ["kind"] for w in BENCH["workloads"]}


def _run(cell, **kw):
    return run.run_cell(cell, SEED, 0.5, False, device="cpu",
                        overrides=CELLS[cell], **kw)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_runs_to_its_last_line(cell):
    result, parts = _run(cell)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run.emit(result, parts)
    last = json.loads(out.getvalue().splitlines()[-1])
    assert list(last)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    e2e = [m["name"] for m in run.wanted(BENCH, run.cell_of(BENCH, cell),
                                          "end_to_end")]
    assert sorted(last["metrics"]) == sorted(e2e)
    assert all(v["value"] > 0 for v in last["metrics"].values())
    assert err.getvalue().splitlines()[-1].startswith("compared ")
    assert "setup_parts" in json.loads(out.getvalue().splitlines()[0])


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in sorted(CELLS) for f in faults.APPLIES[KIND[c]]])
def test_a_planted_fault_fails_the_comparison(cell, fault):
    result, _ = _run(cell, fault=fault)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_float8_control_fails_the_comparison(cell):
    result, _ = _run(cell, control=True)
    assert result["correct"] is True
    limits = {k: lim for k, (_, lim) in result["compared"].items()}
    assert any(result["fp8"][k] > lim for k, lim in limits.items()), \
        (result["fp8"], limits)
