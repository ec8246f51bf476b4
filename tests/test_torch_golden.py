"""The golden autoscaling episodes through the PyTorch port on the CPU.

Same recipe and same comparison as ``test_golden_trace``: fixed-seed
Nexmark episodes at the reference's full sizes (q8: 600,000 sellers and
~2.4 M warmed state entries; q11: 600,000 active bidders), and every
enacted configuration, trigger, step count and final footprint must equal
``tests/data/golden_autoscale.json``.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.controller import AutoScaler, ControllerConfig  # noqa
from repro_torch.core.justin import JustinParams  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402
from repro_torch.data.nexmark import QUERIES, TARGET_RATES  # noqa: E402
from repro_torch.streaming.engine import StreamEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The episodes are many small tensor ops on the CPU: one intra-op
    thread runs them faster than a pool, and keeps parallel test workers
    from oversubscribing the cores with spinning pool threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "data" / "golden_autoscale.json")
    .read_text())


def run_episode(qname: str, policy: str, device: str = "cpu") -> dict:
    meta = GOLDEN["_meta"]
    eng = StreamEngine(QUERIES[qname](), seed=meta["seed"], device=device)
    cfg = ControllerConfig(
        policy=policy, justin=JustinParams(max_level=meta["max_level"]))
    ctl = AutoScaler(eng, TARGET_RATES[qname], cfg,
                     policy=make_policy(policy, cfg))
    hist = ctl.run()
    return {
        "steps": ctl.steps,
        "configs": [sorted((op, list(pc)) for op, pc in h.config.items())
                    for h in hist],
        "triggered": [h.triggered for h in hist],
        "cpu_cores": hist[-1].cpu_cores,
        "memory_mb": hist[-1].memory_mb,
        "final_rate_ok": hist[-1].achieved_rate
        >= 0.97 * TARGET_RATES[qname],
    }


@pytest.mark.parametrize("key", [
    "q11_justin", "q11_ds2", "q8_justin",
    pytest.param("q8_ds2", marks=pytest.mark.slow),
])
def test_port_reproduces_golden_episode(key):
    assert_matches_golden(key, "cpu")


def assert_matches_golden(key: str, device: str) -> None:
    got = run_episode(*key.split("_"), device=device)
    want = GOLDEN[key]
    assert got["steps"] == want["steps"], (got["steps"], want["steps"])
    assert got["triggered"] == want["triggered"]
    want_cfg = [[(op, list(pc)) for op, pc in w] for w in want["configs"]]
    got_cfg = [[(op, list(pc)) for op, pc in w] for w in got["configs"]]
    assert got_cfg == want_cfg
    assert got["cpu_cores"] == want["cpu_cores"]
    assert got["memory_mb"] == want["memory_mb"]
    assert got["final_rate_ok"] and want["final_rate_ok"]
