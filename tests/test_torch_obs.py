"""The port's observability (``repro_torch.obs``: the span tracer, the
``Explain`` provenance records, the metrics registry and the exporters)
against the reference's.

On the golden q11 episodes both packages must emit the same span stream
(sim times, sequence numbers, names, tenants, windows and args — the
policies' ``Explain`` records and the LSM θ/τ ride in the args), the same
``HistoryRow.reason``s, and write byte-identical JSONL.  Every float in a
span is Python float64 computed in the same order by both packages, so
all of it is compared with ``==``; only the registry's wall-clock timers
are left out.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.obs as RO  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro.core.controller import AutoScaler as RAutoScaler  # noqa: E402
from repro.core.controller import ControllerConfig as RConfig  # noqa: E402
from repro.core.justin import JustinParams as RJustin  # noqa: E402
from repro.core.policy import make_policy as r_make_policy  # noqa: E402
from repro.data.nexmark import QUERIES as R_QUERIES  # noqa: E402
from repro.data.nexmark import TARGET_RATES  # noqa: E402
from repro.streaming.engine import StreamEngine as REngine  # noqa: E402
from repro_torch.core.controller import AutoScaler as TAutoScaler  # noqa
from repro_torch.core.controller import ControllerConfig as TConfig  # noqa
from repro_torch.core.justin import JustinParams as TJustin  # noqa: E402
from repro_torch.core.policy import make_policy as t_make_policy  # noqa
from repro_torch.data.nexmark import QUERIES as T_QUERIES  # noqa: E402
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


REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests/data/golden_autoscale.json").read_text())
CHECKER = REPO / "tools" / "check_trace.py"


def _load_checker():
    spec = importlib.util.spec_from_file_location("check_trace", CHECKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traced_episode(pkg: str, key: str, max_windows=None):
    """A golden episode with a live tracer; the policy's proposals are
    caught on their way out so their ``Explain`` records can be read."""
    qname, policy = key.split("_")
    meta = GOLDEN["_meta"]
    if pkg == "reference":
        C, J, mk, A, eng, obs = RConfig, RJustin, r_make_policy, \
            RAutoScaler, REngine(R_QUERIES[qname](), seed=meta["seed"]), RO
    else:
        C, J, mk, A, obs = TConfig, TJustin, t_make_policy, TAutoScaler, TO
        eng = TEngine(T_QUERIES[qname](), seed=meta["seed"], device="cpu")
    cfg = C(policy=policy, justin=J(max_level=meta["max_level"]))
    tracer = obs.Tracer(enabled=True)
    ctl = A(eng, TARGET_RATES[qname], cfg, policy=mk(policy, cfg),
            tracer=tracer)
    explains = []
    propose = ctl.policy.propose

    def catching(*a, **kw):
        prop = propose(*a, **kw)
        explains.append(None if prop.explain is None
                        else prop.explain.to_dict())
        return prop

    ctl.policy.propose = catching
    hist = ctl.run() if max_windows is None \
        else ctl.run(max_windows=max_windows)
    return ctl, hist, tracer, explains


@pytest.fixture(scope="module", params=["q11_justin", "q11_ds2"])
def episodes(request):
    key = request.param
    return key, {pkg: traced_episode(pkg, key)
                 for pkg in ("reference", "port")}


def test_span_stream_explains_and_reasons_equal_the_reference(episodes):
    key, runs = episodes
    _, r_hist, r_tr, r_exp = runs["reference"]
    _, t_hist, t_tr, t_exp = runs["port"]
    assert [s.to_dict() for s in t_tr.spans] \
        == [s.to_dict() for s in r_tr.spans]
    assert [s.seq for s in t_tr.spans] == list(range(len(t_tr.spans)))
    assert t_exp == r_exp and any(e is not None for e in t_exp)
    assert [h.reason for h in t_hist] == [h.reason for h in r_hist]
    assert TO.reason_counts(t_hist) == RO.reason_counts(r_hist)
    assert t_tr.summary() == r_tr.summary()
    cats = {s.cat for s in t_tr.spans}
    assert {"engine", "policy", "lsm"} <= cats


def test_tracing_leaves_the_golden_decisions_unchanged(episodes):
    key, runs = episodes
    ctl, hist, _, _ = runs["port"]
    want = GOLDEN[key]
    assert ctl.steps == want["steps"]
    assert [h.triggered for h in hist] == want["triggered"]
    assert [[(op, list(pc)) for op, pc in
             sorted((op, list(pc)) for op, pc in h.config.items())]
            for h in hist] \
        == [[(op, list(pc)) for op, pc in w] for w in want["configs"]]
    assert (hist[-1].cpu_cores, hist[-1].memory_mb) \
        == (want["cpu_cores"], want["memory_mb"])


def test_jsonl_bytes_equal_and_cross_read(episodes, tmp_path):
    """Each package writes its own spans: the files are byte-identical,
    each reads in the other package, and the stdlib checker (run as its
    own process) accepts the port's."""
    key, runs = episodes
    r_spans, t_spans = runs["reference"][2].spans, runs["port"][2].spans
    rp, tp = tmp_path / "r.jsonl", tmp_path / "t.jsonl"
    RO.write_jsonl(r_spans, str(rp), meta={"episode": key})
    TO.write_jsonl(t_spans, str(tp), meta={"episode": key})
    assert tp.read_bytes() == rp.read_bytes()
    assert TO.read_jsonl(str(rp)) == RO.read_jsonl(str(tp))
    out = subprocess.run([sys.executable, str(CHECKER), str(tp)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.dumps(TO.chrome_trace(t_spans, {"episode": key})) \
        == json.dumps(RO.chrome_trace(r_spans, {"episode": key}))
    cp = tmp_path / "t.json"
    TO.write_chrome(t_spans, str(cp))
    out = subprocess.run([sys.executable, str(CHECKER), "--chrome",
                          str(cp)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.jsonl"
        bad.write_text('{"kind": "other"}\n')
        TO.read_jsonl(str(bad))


def test_schema_constants_match_the_reference_and_checker():
    from repro.obs import export as rx
    from repro_torch.obs import export as tx
    checker = _load_checker()
    assert (tx.TRACE_KIND, tx.TRACE_VERSION) \
        == (rx.TRACE_KIND, rx.TRACE_VERSION) \
        == (checker.TRACE_KIND, checker.TRACE_VERSION)
    assert TO.CATS == RO.CATS == checker.CATS
    assert TO.REASONS == RO.REASONS
    assert TO.__all__ == RO.__all__


# ---------------------------------------------------------------- registry
def _untimed(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k != "timers"}


def exercise(obs) -> dict:
    reg = obs.MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.5)
    for v in (3.0, 1.0, 2.0):
        reg.histogram("h").observe(v)
    with reg.timer("t") as t:
        pass
    assert t.s >= 0.0 and reg.timer("t").count == 1
    snap = reg.snapshot()
    assert set(snap["timers"]) == {"t"}
    off = obs.MetricsRegistry(enabled=False)
    off.counter("x").inc()
    assert off.counter("x") is off.gauge("y")
    return {"snap": _untimed(snap), "off": off.snapshot(),
            "null": obs.NULL_REGISTRY.snapshot()}


def test_registry_instruments_equal_the_reference():
    assert exercise(TO) == exercise(RO)


def test_absorb_engine_snapshot_equals_the_reference():
    """Per-operator LSM totals and per-task cost EWMAs of the same engine
    after the same 12 s at q11's target rate."""
    snaps = {}
    for pkg, eng, obs in (
            ("reference", REngine(R_QUERIES["q11"](), seed=3), RO),
            ("port", TEngine(T_QUERIES["q11"](), seed=3, device="cpu"),
             TO)):
        eng.run(12.0, TARGET_RATES["q11"])
        reg = obs.MetricsRegistry()
        reg.absorb_engine(eng, prefix="e")
        snaps[pkg] = _untimed(reg.snapshot())
    assert snaps["port"] == snaps["reference"]
    gauges = snaps["port"]["gauges"]
    assert gauges["e.lsm.user_sessions.reads"] > 0
    assert all(type(v) in (int, float) for v in gauges.values())


def test_absorb_fleet_snapshot_equals_the_reference():
    from repro.scenarios import run_fleet as r_run_fleet
    from repro_torch.scenarios import run_fleet as t_run_fleet
    snaps = {}
    for pkg, res, obs in (
            ("reference", r_run_fleet(48, 10, admission="priority", seed=0),
             RO),
            ("port", t_run_fleet(48, 10, admission="priority", seed=0,
                                 device="cpu"), TO)):
        reg = obs.MetricsRegistry()
        reg.absorb_fleet(res, prefix="f")
        snaps[pkg] = _untimed(reg.snapshot())
    assert snaps["port"] == snaps["reference"]
    assert snaps["port"]["counters"]["f.tenants"] == 48
    assert snaps["port"]["counters"]["f.policy_steps"] > 0


def test_fleet_trace_summaries_equal_across_drivers_and_packages():
    """With a tracer shared by a fleet's tenants, the port's vectorized
    driver, its scalar oracle and the reference record the same spans."""
    import repro.scenarios as R
    import repro_torch.scenarios as T
    out = {}
    for pkg, mod, obs, dev in (("reference", R, RO, {}),
                               ("port", T, TO, {"device": "cpu"})):
        cfg = mod.fleet_cfg()
        pop = mod.sample_population(
            mod.PopulationSpec(tenants=12, seed=23),
            mod.runner.scenario_horizon_s(cfg, 4))
        for driver in ("vectorized", "scalar"):
            tr = obs.Tracer(enabled=True)
            mod.run_colocated(pop, mod.size_cluster(pop, cfg), windows=4,
                              cfg=cfg, admission="preemption",
                              migration_budget_mb=1500.0, driver=driver,
                              tracer=tr, **dev)
            out[pkg, driver] = ([s.to_dict() for s in tr.spans],
                                tr.summary())
    assert out["port", "vectorized"] == out["reference", "vectorized"]
    assert out["port", "scalar"] == out["reference", "scalar"]
    summary = out["port", "scalar"][1]
    assert out["port", "vectorized"][1] == summary
    assert len({k.split("|")[0] for k in summary}) == 12
