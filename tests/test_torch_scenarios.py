"""The port's scenario layer (``repro_torch.scenarios``: profiles, fault
schedules, ``run_scenario``, the SLO metrics) against the reference's.

Profiles are pure float arithmetic in the reference's order and are
compared with ``==``.  The episodes are the dynamic-workload cases of the
reference's tests/test_scenarios.py (its ``quick_cfg``); their history
rows and SLO scorecards are compared field for field with ``==``: every
float in them is Python float64 computed in the same order by both
packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as R  # noqa: E402
import repro_torch.scenarios as T  # noqa: E402
from repro.core.controller import ControllerConfig as RConfig  # noqa: E402
from repro.core.justin import JustinParams as RJustin  # noqa: E402
from repro.data.nexmark import BidGen as RBidGen  # noqa: E402
from repro.streaming.engine import StreamEngine as REngine  # noqa: E402
from repro.streaming.graph import Dataflow as RFlow  # noqa: E402
from repro.streaming import operators as rops  # noqa: E402
from repro_torch.core.controller import ControllerConfig as TConfig  # noqa
from repro_torch.core.justin import JustinParams as TJustin  # noqa: E402
from repro_torch.data.nexmark import BidGen as TBidGen  # noqa: E402
from repro_torch.streaming.engine import StreamEngine as TEngine  # noqa
from repro_torch.streaming.graph import Dataflow as TFlow  # noqa: E402
from repro_torch.streaming import operators as tops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These runs are many small tensor ops on the CPU: one intra-op
    thread runs them faster than a pool, and keeps parallel test workers
    from oversubscribing the cores with spinning pool threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROFILE_NAMES = ("constant", "ramp", "spike", "diurnal", "sinusoid", "step")


def test_public_names_match_the_reference():
    assert T.__all__ == R.__all__


def profile_pairs():
    """The same profile built by both packages: every named shape at two
    scales, and each class with explicit (odd) parameters."""
    for name in PROFILE_NAMES:
        for target, horizon in ((1000.0, 96.0), (61_234.5, 333.3)):
            yield (f"{name}@{target}", R.make_profile(name, target, horizon),
                   T.make_profile(name, target, horizon))
    for cls, kw in (("Constant", dict(value=7.25)),
                    ("Ramp", dict(start=10, end=110, duration_s=100,
                                  t0=50)),
                    ("Spike", dict(base=10, peak=90, t0=20,
                                   duration_s=10)),
                    ("Diurnal", dict(low=10, high=110, period_s=100,
                                     phase_s=13.7)),
                    ("Sinusoid", dict(mean=10, amplitude=100, period_s=40,
                                      phase_s=3.0)),
                    ("Step", dict(times=(0, 10, 20, 35.5),
                                  rates=(5, 50, 25, 0.5)))):
        yield cls, getattr(R, cls)(**kw), getattr(T, cls)(**kw)


@pytest.mark.parametrize("label,r,t", list(profile_pairs()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_profile_equal_at_200_sample_times(label, r, t):
    ts = np.random.default_rng(0).uniform(-20.0, 700.0, 200).tolist()
    ts += [0.0, 10.0, 20.0, 50.0, 100.0, 150.0]
    got = [t(x) for x in ts]
    assert got == [r(x) for x in ts], label
    assert all(type(v) is float and v >= 0.0 for v in got)


def test_profile_errors_match():
    for mod in (R, T):
        with pytest.raises(ValueError):
            mod.make_profile("nope", 1.0, 1.0)
        with pytest.raises(ValueError):
            mod.Step(times=(10, 0), rates=(1, 2))


def test_parse_fault_equal():
    for spec in ("kill:30:window_join:2", "kill:5:op",
                 "straggle:10:op:0:20:5", "straggle:1.5:user_sessions:3"):
        r, t = R.parse_fault(spec), T.parse_fault(spec)
        assert type(t).__name__ == type(r).__name__
        assert dataclasses.astuple(t) == dataclasses.astuple(r)
    with pytest.raises(ValueError):
        T.parse_fault("explode:1:op")


def fault_engine(pkg: str):
    """The reference test's two-task map flow, built by one package."""
    if pkg == "reference":
        f = RFlow("t")
        f.chain(rops.SourceOp("source", RBidGen(seed=1)),
                rops.MapOp("m", lambda b: b), rops.SinkOp("sink"))
        f.nodes["m"].parallelism = 2
        return REngine(f, seed=0), R
    f = TFlow("t")
    f.chain(tops.SourceOp("source", TBidGen(seed=1)),
            tops.MapOp("m", lambda b: b), tops.SinkOp("sink"))
    f.nodes["m"].parallelism = 2
    return TEngine(f, seed=0, device="cpu"), T


def test_fault_schedule_fires_in_order_with_recovery():
    """Straggler at 5 s with a 10 s recovery, a kill at 12 s: both
    packages fire the same faults at the same boundaries and leave the
    same slowdowns and queues behind."""
    out = {}
    for pkg in ("reference", "port"):
        eng, mod = fault_engine(pkg)
        eng.run(3.0, 20_000)
        sched = mod.FaultSchedule([
            mod.SetStraggler(5.0, "m", 0, 8.0, duration_s=10.0),
            mod.KillTask(12.0, "m", 1)])
        seen = [len(sched.pending)]
        for now in (4.9, 5.0, 20.0, 1e9):
            fired = sched.apply_due(eng, now)
            seen.append([(type(f).__name__, *dataclasses.astuple(f))
                         for f in fired])
            seen.append([t.slowdown for t in eng.tasks["m"]])
            seen.append([t.queued_events for t in eng.tasks["m"]])
        out[pkg] = seen
    assert out["port"] == out["reference"]
    assert out["port"][0] == 3                 # straggler, recovery, kill
    assert out["port"][5] == [8.0, 1.0]        # straggling at 5 s
    assert out["port"][8] == [1.0, 1.0]        # recovered by 20 s


def quick_cfg(pkg: str, policy: str):
    C, J = (RConfig, RJustin) if pkg == "reference" else (TConfig, TJustin)
    return C(policy=policy, decision_window_s=60.0, stabilization_s=30.0,
             justin=J(max_level=2))


# the dynamic-workload cases of the reference's tests/test_scenarios.py
CASES = {
    "ramp": dict(policy="justin", query="q5", profile="ramp", windows=6),
    "spike": dict(policy="ds2", query="q5", profile="spike", windows=6),
    "straggler": dict(policy="justin", query="q5", profile="ramp",
                      windows=6, faults=("straggler", 12.0,
                                         "hot_auctions", 0, 15.0, 12.0)),
    "kill_task": dict(policy="justin", query="q5", profile="constant",
                      windows=4, faults=("kill", 10.0, "hot_auctions", 0)),
    "diurnal": dict(policy="justin", query="q5", profile="diurnal",
                    windows=8),
}


def scenario(pkg: str, case: dict):
    mod = R if pkg == "reference" else T
    kw = {} if pkg == "reference" else {"device": "cpu"}
    faults = None
    if case.get("faults"):
        kind, *args = case["faults"]
        if kind == "kill":
            faults = [mod.KillTask(*args)]
        else:
            t, op, idx, factor, dur = args
            faults = [mod.SetStraggler(t, op, idx, factor, duration_s=dur)]
    return mod.run_scenario(case["policy"], case["query"], case["profile"],
                            windows=case["windows"],
                            cfg=quick_cfg(pkg, case["policy"]),
                            faults=faults, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_run_scenario_equals_the_reference(name):
    r = scenario("reference", CASES[name])
    t = scenario("port", CASES[name])
    assert [dataclasses.asdict(h) for h in t.history] \
        == [dataclasses.asdict(h) for h in r.history]
    assert [dataclasses.astuple(f) for f in t.faults_fired] \
        == [dataclasses.astuple(f) for f in r.faults_fired]
    assert t.summary() == r.summary()
    for after_t in (0.0, 30.0):
        assert t.slo(after_t=after_t).to_dict() \
            == r.slo(after_t=after_t).to_dict()
    assert T.metrics.reconfig_cost_totals(t.history) \
        == R.metrics.reconfig_cost_totals(r.history)
    assert [dataclasses.asdict(e) for e in T.catch_up_episodes(t.history)] \
        == [dataclasses.asdict(e) for e in R.catch_up_episodes(r.history)]
    # the reference test's own claims hold on the port
    assert t.recovered()
    if CASES[name].get("faults"):
        assert t.faults_fired


def test_scenario_horizon_equals_the_reference():
    from repro.scenarios.runner import scenario_horizon_s as rh
    from repro_torch.scenarios.runner import scenario_horizon_s as th
    for w in (1, 6, 8, 100):
        assert th(TConfig(), w) == rh(RConfig(), w)
        assert th(quick_cfg("port", "ds2"), w) \
            == rh(quick_cfg("reference", "ds2"), w)


def test_run_grid_and_its_renderers_equal_the_reference():
    """A small grid (q1 under a spike, the ds2/justin pair, handoff
    priced): equal cells, and every markdown renderer gives the same
    text over them."""
    kw = dict(queries=["q1"], profiles=["spike"],
              policies=["ds2", "justin"], windows=2, verbose=False,
              reconfig_cost="handoff")
    want = R.run_grid(**kw)
    got = T.run_grid(**kw, device="cpu")
    assert got == want
    from repro.scenarios import grid as rg
    from repro_torch.scenarios import grid as tg
    for fn in ("grid_markdown", "cells_markdown", "reconfig_markdown",
               "comparison_rows"):
        assert getattr(tg, fn)(got) == getattr(rg, fn)(want), fn
    assert tg.PROFILES == rg.PROFILES
