"""The port's shared-cluster layer (``repro_torch.scenarios.cluster`` and
``population``) against the reference's: the ``Cluster`` budget model, the
co-located pairs of the reference's tests/test_cluster.py under every
admission mode, the port's vectorized fleet driver against its own scalar
oracle, and sampled fleets and populations tenant for tenant.

Decisions (denials, deferrals, preemptions, configurations, CPU slots)
are compared exactly; so are the memory figures (``used_mem``, the usage
series, ``amortized_mb``): both packages sum the same Python floats in
the same order.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as R  # noqa: E402
import repro_torch.scenarios as T  # noqa: E402
from repro.core import placement as rp  # noqa: E402
from repro.core.controller import ControllerConfig as RConfig  # noqa: E402
from repro.core.justin import JustinParams as RJustin  # noqa: E402
from repro.scenarios.cluster import _arbitration_order as r_order  # noqa
from repro_torch.core import placement as tp  # noqa: E402
from repro_torch.core.controller import ControllerConfig as TConfig  # noqa
from repro_torch.core.justin import JustinParams as TJustin  # noqa: E402
from repro_torch.scenarios.cluster import _arbitration_order as t_order  # noqa


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """These runs are many small tensor ops on the CPU: one intra-op
    thread runs them faster than a pool, and keeps parallel test workers
    from oversubscribing the cores with spinning pool threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ADMISSIONS = ("priority", "fair_share", "first_come", "preemption")
PKGS = {"reference": (R, rp, RConfig, RJustin, {}),
        "port": (T, tp, TConfig, TJustin, {"device": "cpu"})}


def test_public_names_match_the_reference():
    assert T.ADMISSION_POLICIES == R.ADMISSION_POLICIES
    assert T.DRIVERS == R.DRIVERS


# ------------------------------------------------------------ budget model
def cluster_trace(mod, pl) -> list:
    """One reserve/deny/release sequence on each cluster mode; the state
    after every step."""
    out = []
    c = mod.Cluster(cpu_slots=8, memory_mb=1000.0)
    for name, cpu, mem in (("a", 4, 600.0), ("b", 4, 500.0), ("b", 5, 100.0),
                           ("b", 4, 400.0), ("a", 2, 200.0), ("b", 6, 800.0)):
        out.append((c.reserve(name, cpu, mem), dict(c.used_cpu),
                    dict(c.used_mem), c.available(), c.share(name)))
    c.release("a")
    out.append((dict(c.used_cpu), c.available()))
    drift = mod.Cluster(cpu_slots=3, memory_mb=0.3)
    out.append([drift.reserve(n, 1, 0.1) for n in "abc"]
               + [drift.mem_in_use, drift.fits("a", 1, 0.1),
                  drift.reserve("a", 1, 0.1)])
    spec = pl.TMSpec(slots=4, managed_pool_mb=640.0, base_mb=1000.0)
    s = mod.Cluster(cpu_slots=8, memory_mb=3000.0, tm_spec=spec)
    with pytest.raises(TypeError):
        s.reserve("a", 1, 100.0)
    for name, n in (("a", 2), ("b", 2), ("b", 9), ("a", 3)):
        reqs = [pl.TaskRequest("op", i, 158.0) for i in range(n)]
        out.append((s.quote(name, reqs),
                    dataclasses.astuple(s.quote_migration(name, reqs)),
                    s.reserve_tasks(name, reqs), dict(s.used_cpu),
                    dict(s.used_mem), s.placement().n_tms))
    s.release("b")
    out.append((dict(s.used_mem), s.mem_in_use,
                dataclasses.astuple(s.migration_total())))
    return out


def test_cluster_reserve_deny_release_equal_the_reference():
    got = cluster_trace(T, tp)
    assert got == cluster_trace(R, rp)
    # the reference test's claims, on the port
    assert got[0][0] and not got[1][0] and not got[2][0]
    assert got[1][1] == {"a": 4}                 # a denial changes nothing
    assert got[7][-1] is True                    # drift never denies


class _T:
    def __init__(self, name, first_pending=None):
        self.name = name
        self.first_pending = first_pending


def test_arbitration_orders_equal_the_reference():
    for mod, order in ((R, r_order), (T, t_order)):
        c = mod.Cluster(cpu_slots=10, memory_mb=1000.0)
        c.reserve("big", 8, 200.0)
        c.reserve("small", 1, 100.0)
        ts = [_T("big", 3), _T("small", 1), _T("new")]
        got = {a: [t.name for t in order(ts, c, a)] for a in ADMISSIONS}
        if mod is R:
            want = got
        else:
            assert got == want
        with pytest.raises(ValueError):
            order(ts, c, "lottery")


# ------------------------------------------------------- co-located pairs
def assert_same_run(got, want) -> None:
    """Every observable of two co-located runs (across packages or across
    drivers): usage, admission outcomes, full histories, summaries."""
    assert got.usage == want.usage
    assert [t.name for t in got.tenants] == [t.name for t in want.tenants]
    for a, b in zip(got.tenants, want.tenants):
        assert (a.denials, a.deferrals, a.preemptions, a.first_pending,
                a.scaler.preemptions, a.scaler.steps) \
            == (b.denials, b.deferrals, b.preemptions, b.first_pending,
                b.scaler.preemptions, b.scaler.steps), a.name
        assert [dataclasses.astuple(f) for f in a.faults_fired] \
            == [dataclasses.astuple(f) for f in b.faults_fired], a.name
        assert [dataclasses.asdict(h) for h in a.history] \
            == [dataclasses.asdict(h) for h in b.history], a.name
    assert got.summary() == want.summary()


def quick_cfg(C, J):
    return C(decision_window_s=60.0, stabilization_s=30.0,
             justin=J(max_level=2))


def run_pair(pkg: str, first_policy: str, admission: str,
             driver: str = "vectorized"):
    """The reference's run_pair: two q1 tenants on 16 slots / 7,000 MB."""
    mod, _, C, J, dev = PKGS[pkg]
    return mod.run_colocated(
        [mod.ColocatedSpec(first_policy, "q1", name="A"),
         mod.ColocatedSpec("ds2", "q1", name="B")],
        mod.Cluster(cpu_slots=16, memory_mb=7000.0), windows=5,
        cfg=quick_cfg(C, J), admission=admission, driver=driver, **dev)


def preemption_pair(pkg: str, admission: str, driver: str = "vectorized",
                    shared: bool = False, budget=None, windows: int = 5):
    """The reference's preemption_pair: a static q11 tenant pinned at
    storage level 2 holds the memory a ds2 q1 tenant needs."""
    mod, pl, C, J, dev = PKGS[pkg]
    specs = [mod.ColocatedSpec("ds2", "q1", name="H"),
             mod.ColocatedSpec("static", "q11", name="V", target=5_000,
                               config={"user_sessions": (6, 2)})]
    return mod.run_colocated(
        specs, mod.Cluster(cpu_slots=16, memory_mb=8500.0,
                           tm_spec=pl.default_tm_spec(158.0) if shared
                           else None),
        windows=windows, cfg=quick_cfg(C, J), admission=admission,
        driver=driver, migration_budget_mb=budget, **dev)


@pytest.mark.parametrize("admission", ADMISSIONS)
def test_run_pair_equals_the_reference(admission):
    """A ds2 first tenant, whose packaged scale-out crowds B out: every
    admission mode equals the reference, and the port's scalar oracle
    agrees with its vectorized driver."""
    got = run_pair("port", "ds2", admission)
    assert_same_run(got, run_pair("reference", "ds2", admission))
    assert_same_run(run_pair("port", "ds2", admission, "scalar"), got)
    assert got.tenant("B").denials


def test_justin_frees_capacity_ds2_blocks_as_in_the_reference():
    got = run_pair("port", "justin", "priority")
    assert_same_run(got, run_pair("reference", "justin", "priority"))
    assert got.tenant("B").denials == []
    assert got.tenant("B").slo().recovered


@pytest.mark.parametrize("admission", ADMISSIONS)
def test_preemption_pair_equals_the_reference(admission):
    got = preemption_pair("port", admission)
    assert_same_run(got, preemption_pair("reference", admission))
    assert_same_run(preemption_pair("port", admission, "scalar"), got)
    if admission == "preemption":
        assert got.tenant("V").preemptions == [0, 1]
        assert got.tenant("H").denials == []


def test_budgeted_shared_preemption_equals_the_reference():
    """Shared TaskManagers and a migration budget: give-backs charged to
    the budget, the requester deferred."""
    got = preemption_pair("port", "preemption", shared=True, budget=800.0,
                          windows=3)
    assert_same_run(got, preemption_pair("reference", "preemption",
                                         shared=True, budget=800.0,
                                         windows=3))
    assert_same_run(preemption_pair("port", "preemption", "scalar",
                                    shared=True, budget=800.0, windows=3),
                    got)
    assert got.tenant("V").preemptions == [0]
    assert got.tenant("H").deferrals == [1, 2]


# ------------------------------------------------------ fleets, populations
def spec_record(s) -> tuple:
    """A ColocatedSpec with its profile's and faults' class names."""
    def named(x):
        return None if x is None else (type(x).__name__,
                                       dataclasses.astuple(x))
    return (s.policy, s.query, named(s.profile), s.name, s.target,
            None if s.faults is None else [named(f) for f in s.faults],
            s.config)


@pytest.mark.parametrize("tenants,seed,windows", [(40, 7, 10), (200, 1, 20),
                                                  (1000, 0, 100)])
def test_sample_population_equals_the_reference(tenants, seed, windows):
    cfg_t, cfg_r = T.fleet_cfg(), R.fleet_cfg()
    from repro.scenarios.runner import scenario_horizon_s as rh
    from repro_torch.scenarios.runner import scenario_horizon_s as th
    assert th(cfg_t, windows) == rh(cfg_r, windows)
    got = T.sample_population(T.PopulationSpec(tenants=tenants, seed=seed),
                              th(cfg_t, windows))
    want = R.sample_population(R.PopulationSpec(tenants=tenants, seed=seed),
                               rh(cfg_r, windows))
    assert [spec_record(s) for s in got] == [spec_record(s) for s in want]
    tc, rc = T.size_cluster(got, cfg_t), R.size_cluster(want, cfg_r)
    assert (tc.cpu_slots, tc.memory_mb) == (rc.cpu_slots, rc.memory_mb)


@pytest.mark.parametrize("admission,budget", [("fair_share", None),
                                              ("preemption", 1500.0)])
def test_run_fleet_equals_the_reference_under_both_drivers(admission,
                                                           budget):
    want = R.run_fleet(32, 6, admission=admission, seed=0,
                       migration_budget_mb=budget)
    got = {d: T.run_fleet(32, 6, admission=admission, seed=0, driver=d,
                          migration_budget_mb=budget, device="cpu")
           for d in T.DRIVERS}
    for d, res in got.items():
        assert_same_run(res, want)
    assert T.fleet_stats(got["vectorized"]) == R.fleet_stats(want)
    assert T.fleet_stats(got["scalar"]) == R.fleet_stats(want)
    assert got["vectorized"].fleet.denied.shape == (6, 32)


def test_fleet_drivers_agree_on_a_random_population():
    """The reference's property sweep, one population: 12 tenants, every
    admission mode under a migration budget, port vectorized = port
    scalar = reference."""
    cfg = T.fleet_cfg()
    from repro_torch.scenarios.runner import scenario_horizon_s
    pop = T.sample_population(T.PopulationSpec(tenants=12, seed=23),
                              scenario_horizon_s(cfg, 4))
    rcfg = R.fleet_cfg()
    from repro.scenarios.runner import scenario_horizon_s as rh
    rpop = R.sample_population(R.PopulationSpec(tenants=12, seed=23),
                               rh(rcfg, 4))
    for admission in ADMISSIONS:
        runs = {d: T.run_colocated(pop, T.size_cluster(pop, cfg), windows=4,
                                   cfg=cfg, admission=admission, driver=d,
                                   migration_budget_mb=1500.0, device="cpu")
                for d in T.DRIVERS}
        assert_same_run(runs["vectorized"], runs["scalar"])
        assert_same_run(runs["vectorized"], R.run_colocated(
            rpop, R.size_cluster(rpop, rcfg), windows=4, cfg=rcfg,
            admission=admission, migration_budget_mb=1500.0))


def test_initial_placement_must_fit_and_names_never_compound():
    for mod, dev in ((R, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.run_colocated([("ds2", "q1")],
                              mod.Cluster(cpu_slots=1, memory_mb=10.0),
                              windows=1, **dev)
        with pytest.raises(ValueError, match="unknown driver"):
            mod.run_colocated([("ds2", "q1")],
                              mod.Cluster(cpu_slots=8, memory_mb=1e4),
                              windows=0, driver="simd", **dev)
    res = T.run_colocated([("ds2", "q1")] * 3,
                          T.Cluster(cpu_slots=24, memory_mb=20000.0),
                          windows=0, device="cpu")
    assert [t.name for t in res.tenants] \
        == ["ds2:q1", "ds2:q1#2", "ds2:q1#3"]
