"""The port's reconfiguration runtime (``repro_torch.migration``) against
the reference's (``repro.migration``): the same placements give the same
handoff plans and prices, the same warmed engine the same measured
payloads, and the same priced episodes the same histories and costs.

Every float compared here (MB, downtime seconds) is compared with ``==``:
both packages compute it in Python float64 from the same integer counts
in the same order.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import placement as rp  # noqa: E402
from repro.core.controller import AutoScaler as RAutoScaler  # noqa: E402
from repro.core.controller import ControllerConfig as RConfig  # noqa: E402
from repro.core.justin import JustinParams as RJustin  # noqa: E402
from repro.core.policy import make_policy as r_make_policy  # noqa: E402
from repro.data.nexmark import QUERIES as R_QUERIES  # noqa: E402
from repro.data.nexmark import TARGET_RATES  # noqa: E402
from repro import migration as rm  # noqa: E402
from repro.streaming.engine import StreamEngine as REngine  # noqa: E402
from repro_torch.core import placement as tp  # noqa: E402
from repro_torch.core.controller import AutoScaler as TAutoScaler  # noqa
from repro_torch.core.controller import ControllerConfig as TConfig  # noqa
from repro_torch.core.justin import JustinParams as TJustin  # noqa: E402
from repro_torch.core.policy import make_policy as t_make_policy  # noqa
from repro_torch.data.nexmark import QUERIES as T_QUERIES  # noqa: E402
from repro_torch import migration as tm  # noqa: E402
from repro_torch.streaming.engine import StreamEngine as TEngine  # noqa


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These runs are many small tensor ops on the CPU: one intra-op
    thread runs them faster than a pool, and keeps parallel test workers
    from oversubscribing the cores with spinning pool threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "data" / "golden_autoscale.json")
    .read_text())


def rows(history) -> list[dict]:
    return [dataclasses.asdict(h) for h in history]


def random_config(rng) -> dict:
    ops = [f"op{i}" for i in range(rng.integers(1, 5))]
    return {op: (int(rng.integers(1, 9)),
                 int(rng.integers(0, 3)) if rng.random() < 0.7 else None)
            for op in ops}


def plans(old_cfg, new_cfg, stats=None, tenant=""):
    """The same (old, new) placement pair planned by both packages."""
    out = []
    for pl, mig in ((rp, rm), (tp, tm)):
        spec = pl.default_tm_spec()
        old = pl.bin_pack(pl.placement_requests(old_cfg, tenant=tenant),
                          spec)
        new = pl.bin_pack(pl.placement_requests(new_cfg, tenant=tenant),
                          spec)
        out.append(mig.plan_migration(old, new, stats))
    return out


def test_public_names_match_the_reference():
    assert tm.__all__ == rm.__all__
    assert tm.KEYSPACE == rm.KEYSPACE and tm.MECHANISMS == rm.MECHANISMS


@pytest.mark.parametrize("measured", [False, True])
def test_plans_and_prices_equal_the_reference(measured):
    """Random (old, new) configurations, with and without measured store
    stats: equal handoff lists, aggregates and prices under every
    mechanism."""
    rng = np.random.default_rng(7)
    models = [dict(mechanism=m) for m in ("instant", "savepoint",
                                          "handoff")] \
        + [dict(mechanism="savepoint", savepoint_mb_per_s=6.0,
                restart_s=10.0),
           dict(mechanism="handoff", handoff_mb_per_s=100.0, barrier_s=0.5)]
    for _ in range(30):
        old_cfg, new_cfg = random_config(rng), random_config(rng)
        new_cfg.update({op: pc for op, pc in random_config(rng).items()
                        if op in old_cfg})
        stats = None
        if measured:
            stats = {("t", op, i): float(rng.uniform(0, 500))
                     for op, (p, _) in old_cfg.items() for i in range(p)}
        r, t = plans(old_cfg, new_cfg, stats, tenant="t")
        assert [dataclasses.asdict(h) for h in t.handoffs] \
            == [dataclasses.asdict(h) for h in r.handoffs]
        assert (t.total_mb, t.transfer_mb, t.tasks_moved) \
            == (r.total_mb, r.transfer_mb, r.tasks_moved)
        assert dataclasses.asdict(t.migration_cost()) \
            == dataclasses.asdict(r.migration_cost())
        for kw in models:
            assert dataclasses.asdict(tm.CostModel(**kw).price(t)) \
                == dataclasses.asdict(rm.CostModel(**kw).price(r))
    with pytest.raises(ValueError):
        tm.CostModel("teleport")


def test_plan_reconciles_with_the_ports_repack():
    """The plan's move subset reproduces the port's ``repack`` cost, as
    the reference's does its own."""
    rng = np.random.default_rng(11)
    spec = tp.default_tm_spec()
    for _ in range(20):
        tenants = {f"t{i}": tp.placement_requests(random_config(rng),
                                                  tenant=f"t{i}")
                   for i in range(int(rng.integers(1, 4)))}
        prev = tp.shared_pack(tenants, spec)
        victim = sorted(tenants)[0]
        tenants[victim] = tp.placement_requests(random_config(rng),
                                                tenant=victim)
        new, cost = tp.repack(tenants, spec, prev)
        got = tm.plan_migration(prev, new).migration_cost()
        assert (got.tasks_moved, got.state_mb) \
            == (cost.tasks_moved, cost.state_mb)


def test_engine_store_stats_equal_on_warm_q11():
    r = rm.engine_store_stats(REngine(R_QUERIES["q11"](), seed=3),
                              tenant="t")
    t = tm.engine_store_stats(TEngine(T_QUERIES["q11"](), seed=3,
                                      device="cpu"), tenant="t")
    assert t == r
    assert sum(t.values()) > 0
    assert all(type(v) is float for v in t.values())


def test_instant_runtime_is_a_strict_noop_on_golden_trace():
    meta = GOLDEN["_meta"]
    eng = TEngine(T_QUERIES["q11"](), seed=meta["seed"], device="cpu")
    cfg = TConfig(policy="justin",
                  justin=TJustin(max_level=meta["max_level"]))
    ctl = TAutoScaler(eng, TARGET_RATES["q11"], cfg,
                      policy=t_make_policy("justin", cfg),
                      migration=tm.MigrationRuntime("instant"))
    hist = ctl.run()
    want = GOLDEN["q11_justin"]
    assert ctl.steps == want["steps"]
    assert [h.triggered for h in hist] == want["triggered"]
    assert [sorted((op, list(pc)) for op, pc in h.config.items())
            for h in hist] \
        == [[(op, list(pc)) for op, pc in w] for w in want["configs"]]
    assert hist[-1].memory_mb == want["memory_mb"]
    assert ctl.migration.events and all(
        e.cost.free for e in ctl.migration.events)
    assert all(h.reconfig_downtime == 0.0 for h in hist)


def priced_episode(pkg: str, policy: str, cost: dict):
    if pkg == "reference":
        cfg = RConfig(policy=policy, justin=RJustin(max_level=2))
        ctl = RAutoScaler(REngine(R_QUERIES["q11"](), seed=3),
                          TARGET_RATES["q11"], cfg,
                          policy=r_make_policy(policy, cfg),
                          migration=rm.MigrationRuntime(
                              rm.CostModel(**cost)))
    else:
        cfg = TConfig(policy=policy, justin=TJustin(max_level=2))
        ctl = TAutoScaler(TEngine(T_QUERIES["q11"](), seed=3, device="cpu"),
                          TARGET_RATES["q11"], cfg,
                          policy=t_make_policy(policy, cfg),
                          migration=tm.MigrationRuntime(
                              tm.CostModel(**cost)))
    ctl.run(max_windows=6)
    return ctl


@pytest.mark.parametrize("policy", ["justin", "threshold"])
def test_savepoint_q11_histories_and_costs_equal(policy):
    """q11 under a savepoint cost model slow enough to pause the job for
    whole ticks: equal history rows (every field, downtime and moved MB
    included) and equal priced events."""
    cost = dict(mechanism="savepoint", savepoint_mb_per_s=6.0)
    r = priced_episode("reference", policy, cost)
    t = priced_episode("port", policy, cost)
    assert rows(t.history) == rows(r.history)
    assert [dataclasses.asdict(e) for e in t.migration.events] \
        == [dataclasses.asdict(e) for e in r.migration.events]
    assert t.migration.totals() == r.migration.totals()
    assert any(h.reconfig_downtime > 0 for h in t.history)


def budget_pair(pkg: str, budget):
    """The reference's tests/test_migration.py budget-deferral scenario:
    tenant A's q1 scale-out would displace tenant B's tasks."""
    if pkg == "reference":
        from repro.scenarios import Cluster, ColocatedSpec, run_colocated
        C, J, spec, dev = RConfig, RJustin, rp.default_tm_spec(), {}
    else:
        from repro_torch.scenarios import (Cluster, ColocatedSpec,
                                           run_colocated)
        C, J, spec, dev = TConfig, TJustin, tp.default_tm_spec(), \
            {"device": "cpu"}
    cluster = Cluster(cpu_slots=24, memory_mb=30_000.0, tm_spec=spec)
    return run_colocated(
        [ColocatedSpec("ds2", "q1", name="A"),
         ColocatedSpec("static", "q1", name="B")],
        cluster, windows=3,
        cfg=C(decision_window_s=60.0, stabilization_s=30.0,
              justin=J(max_level=2)),
        migration_budget_mb=budget, **dev)


@pytest.mark.parametrize("budget", [None, 100.0])
def test_migration_budget_deferral_equals_the_reference(budget):
    r = budget_pair("reference", budget)
    t = budget_pair("port", budget)
    assert t.usage == r.usage
    for a, b in zip(t.tenants, r.tenants):
        assert (a.name, a.denials, a.deferrals, a.preemptions,
                a.scaler.steps) \
            == (b.name, b.denials, b.deferrals, b.preemptions,
                b.scaler.steps)
        assert rows(a.history) == rows(b.history)
    assert t.summary() == r.summary()
    a = t.tenant("A")
    if budget is None:
        assert a.deferrals == [] and a.scaler.steps > 0
    else:
        assert a.deferrals and set(a.deferrals) <= set(a.denials)
