"""The pinned answers of ``chip_smoke.py``'s scenario phase.

``tests/data/torch_scenarios.json`` holds the reference package's answers
to the phase's runs: (a) q8 justin vs threshold under a savepoint cost
model, (b) q11 under a spike with a straggler and a killed task, (c) the
ds2/justin q11 pair on one shared-TM cluster under preemption, (d) sampled
fleets of 32 tenants x 6 windows and 128 x 20.  ``chip_smoke.py`` imports
nothing of the reference, so the card holds the port against this file.

Here the same run functions (``chip_smoke.run_*``) run over the reference
and over the port on the CPU; both must reproduce the pin exactly (every
field of every history row, the admission outcomes, the usage series).
The q8 runs (about 70 s for both packages on one CPU) and the 128-tenant
fleet (about 15 s) would take this file past a minute, so they are
marked ``slow``; the card checks them on every ``chip_smoke.py`` run,
and ``-m ""`` runs them here.

Write the file from the reference with

    PYTHONPATH=src python tests/test_torch_pins.py --write
"""
import importlib.util
import json
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These runs are many small tensor ops on the CPU: one intra-op
    thread runs them faster than a pool, and keeps parallel test workers
    from oversubscribing the cores with spinning pool threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device": "cpu"}


def reference_api():
    """The reference's entry points under the names ``chip_smoke``'s run
    functions use (its ``port_api`` gives the port's)."""
    from repro.core.controller import AutoScaler, ControllerConfig
    from repro.core.justin import JustinParams
    from repro.core.policy import make_policy
    from repro.data.nexmark import QUERIES, TARGET_RATES
    from repro.migration import CostModel, MigrationRuntime
    from repro.obs import Tracer, write_jsonl
    from repro.scenarios import (KillTask, SetStraggler, fleet_stats,
                                 run_colocation, run_fleet, run_scenario)
    from repro.scenarios import cluster
    from repro.scenarios.runner import scenario_horizon_s
    from repro.streaming.engine import StreamEngine
    return SimpleNamespace(**locals())


def compute(key: str, api, dev: dict, driver: str = "vectorized",
            trace_path=None):
    if key == "a_savepoint":
        return chip_smoke.run_savepoint(api, dev)
    if key == "b_faults":
        return chip_smoke.run_faults(api, dev, trace_path)
    if key == "c_colocation":
        return chip_smoke.run_colocation_pair(api, dev, driver)
    return chip_smoke.run_fleet_case(api, dev, key, driver)[0]


def write_pins() -> None:
    api, dev = reference_api(), {}
    pins = {"_meta": {
        "written_by": "PYTHONPATH=src python tests/test_torch_pins.py "
                      "--write (the reference package, on the CPU)",
        "row_fields": list(chip_smoke.ROW_FIELDS),
        "seed": 3, "max_level": 2,
        "fleets": chip_smoke.FLEETS}}
    for key in ("a_savepoint", "b_faults", "c_colocation",
                *chip_smoke.FLEETS):
        pins[key] = compute(key, api, dev)
        print(key, "written", flush=True)
    chip_smoke.PINS.write_text(json.dumps(pins, separators=(",", ":"))
                               + "\n")


PINS = json.loads(chip_smoke.PINS.read_text()) \
    if chip_smoke.PINS.exists() else {}
SLOW = pytest.mark.slow
RUNS = [pytest.param("a_savepoint", marks=SLOW), "b_faults",
        "c_colocation", "d_fleet_32",
        pytest.param("d_fleet_128", marks=SLOW)]


def test_pin_file_covers_every_run():
    assert set(PINS) == {"_meta", "a_savepoint", "b_faults",
                         "c_colocation", *chip_smoke.FLEETS}
    assert PINS["_meta"]["row_fields"] == list(chip_smoke.ROW_FIELDS)
    # raises unless the reference's headline holds in the pinned run
    got = chip_smoke.check_savepoint(PINS["a_savepoint"])
    assert (got["justin"]["steps"], got["threshold"]["steps"]) == (3, 4)


@pytest.mark.parametrize("key", RUNS)
def test_reference_reproduces_pin(key):
    chip_smoke.hold(key, compute(key, reference_api(), {}), PINS[key])


@pytest.mark.parametrize("key", RUNS)
def test_port_on_cpu_reproduces_pin(key, tmp_path):
    """The port on ``device="cpu"``; (c) and the fleets under both of
    their drivers, (b) with its trace checked by ``tools/check_trace.py``
    as the card's run checks it."""
    api, dev = chip_smoke.port_api(), CPU
    if key == "b_faults":
        trace = tmp_path / "b.jsonl"
        chip_smoke.hold(key, compute(key, api, dev, trace_path=trace),
                        PINS[key])
        out = subprocess.run([sys.executable,
                              str(ROOT / "tools" / "check_trace.py"),
                              str(trace)], capture_output=True, text=True)
        assert out.returncode == 0, out.stdout + out.stderr
        return
    drivers = ("vectorized", "scalar") if key == "c_colocation" \
        else chip_smoke.FLEETS.get(key, {}).get("drivers", ("vectorized",))
    for driver in drivers:
        chip_smoke.hold(f"{key} ({driver})",
                        compute(key, api, dev, driver), PINS[key])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_pins.py "
                 "--write")
    write_pins()
