"""The port's serve controller (``repro_torch.serve``) against the JAX
package's (``repro.serve``): the same operations on the same inputs give
equal state and equal answers under ``==``, floats included.

``PagedKVCache``: sequences of inserts, lookups, evictions to the host
tier, promotions back and resizes, compared field by field (page table,
CLOCK hand and reference bits, prefix index, metrics).  The controller:
``JustinServeController.autoscale()`` under ds2, justin and threshold
(history, steps, replicas, level, θ, busyness).  The six cases of the
reference's ``tests/test_serve.py`` run on both packages; its two
controller cases use a smaller ``WorkloadSpec`` than the default (whose
windows take seconds each on a CPU): 160 prefixes of 256 tokens at 120
requests/s, at which the first window is above 0.8 busy, Justin scales
up its page budget and every policy takes at least one step.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import kv_cache as ref_kv  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from repro_torch.serve import kv_cache as port_kv  # noqa: E402

PACKAGES = {"reference": (ref_kv, ref_engine), "port": (port_kv, port_engine)}
SMALL = dict(n_prefixes=160, prefix_tokens=256)
RATE = 120


def _cache_state(c) -> dict:
    return {"metrics": vars(c.metrics).copy(), "tier": dict(c.page_tier),
            "ref": dict(c.page_ref), "index": dict(c.prefix_index),
            "clock": list(c._clock), "hand": c._hand,
            "next": c._next_page, "budget": c.hbm_budget_bytes,
            "capacity": c.hbm_capacity, "hbm_pages": c.hbm_pages}


def _both(fn):
    """``fn(kv_module, engine_module)`` on both packages; the two answers,
    which must be equal."""
    got = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _hit_after_insert(kv, _):
    c = kv.PagedKVCache(64 * 2**21)
    toks = np.arange(256, dtype=np.int32)
    out = [c.lookup_prefix(toks)]
    c.insert_prefix(toks)
    out.append(c.lookup_prefix(toks))
    return out, c.metrics.hit_rate, _cache_state(c)


def _evict_and_promote(kv, _):
    c = kv.PagedKVCache(4 * 2**21)                 # 4 pages
    for i in range(8):
        c.insert_prefix(np.arange(64, dtype=np.int32) + 1000 * i)
    out = [_cache_state(c)]
    out.append(c.lookup_prefix(np.arange(64, dtype=np.int32)))
    out.append(_cache_state(c))
    return out


def _resize(kv, _):
    c = kv.PagedKVCache(4 * 2**21)
    caps = [c.hbm_capacity]
    c.resize(16 * 2**21)
    caps.append(c.hbm_capacity)
    return caps


def _replica_reuse(kv, eng):
    r = eng.ServingReplica(eng.BASE_HBM_BUDGET * 4, eng.ServeCosts())
    gen = eng.RequestGen(eng.WorkloadSpec(n_prefixes=1))
    ms = [r.serve(gen.make(1)[0]), r.serve(gen.make(1)[0])]
    return ms, vars(r.stats).copy(), _cache_state(r.cache)


def _mixed_sequence(kv, _):
    """Interleaved inserts, lookups (hits, host fetches, misses) and
    resizes that shrink the budget below the resident pages and grow it
    back, on a page spec of 16 tokens."""
    spec = kv.PageSpec(page_tokens=16, page_bytes=1 << 20)
    c = kv.PagedKVCache(6 << 20, spec)
    r = np.random.default_rng(7)
    prefixes = [r.integers(0, 30_000, 80).astype(np.int32)
                for _ in range(5)]
    out = []
    for step in range(60):
        toks = np.concatenate([prefixes[int(r.integers(5))],
                               r.integers(0, 30_000, 8).astype(np.int32)])
        out.append(c.lookup_prefix(toks))
        if step % 3:
            c.insert_prefix(toks)
        if step in (20, 40):
            c.resize((2 if step == 20 else 12) << 20)
        out.append(_cache_state(c))
    c.metrics.reset()
    out.append(_cache_state(c))
    return out


@pytest.mark.parametrize("case", [_hit_after_insert, _evict_and_promote,
                                  _resize, _replica_reuse, _mixed_sequence],
                         ids=lambda f: f.__name__.strip("_"))
def test_paged_cache_and_replica_equal_reference(case):
    got = _both(case)
    if case is _hit_after_insert:
        assert got[0][0][0] == 0 and got[0][1][0] == 256 and got[1] > 0
    if case is _evict_and_promote:
        assert got[0]["metrics"]["evictions"] > 0
        assert got[0]["hbm_pages"] <= got[0]["capacity"]
    if case is _resize:
        assert got == [4, 16]
    if case is _replica_reuse:
        assert got[0][1] < 0.5 * got[0][0]
    if case is _mixed_sequence:
        m = got[-2]["metrics"]
        assert m["host_fetches"] > 0 and m["evictions"] > 0 \
            and m["hbm_hits"] > 0


def _autoscale(policy: str, rate=RATE, workload=SMALL):
    def run(_, eng):
        ctl = eng.JustinServeController(
            rate, policy=policy, workload=eng.WorkloadSpec(**workload))
        res = ctl.autoscale()
        return {"result": res, "history": ctl.history, "steps": ctl.steps,
                "replicas": len(ctl.replicas), "level": ctl.level,
                "budgets": [r.cache.hbm_budget_bytes for r in ctl.replicas]}
    return run


@pytest.fixture(scope="module")
def autoscaled():
    return {p: _both(_autoscale(p)) for p in ("ds2", "justin", "threshold")}


@pytest.mark.parametrize("policy", ["ds2", "justin", "threshold"])
def test_autoscale_equals_reference(autoscaled, policy):
    got = autoscaled[policy]
    assert got["history"][0]["busyness"] > 0.8
    assert got["steps"] >= 1
    assert got["result"]["busyness"] <= 0.95


def test_justin_serve_beats_replica_only(autoscaled):
    """The reference's claim on the port's (equal) answers: the hybrid
    policy meets the target with no more replicas than ds2, by scaling
    the page budget up."""
    j, d = autoscaled["justin"]["result"], autoscaled["ds2"]["result"]
    assert j["replicas"] <= d["replicas"]
    assert j["level"] >= 1
    assert j["busyness"] <= 1.0


def test_serve_controller_converges():
    got = _both(_autoscale("justin", rate=30, workload=dict(
        n_prefixes=64, prefix_tokens=256)))
    assert got["result"]["busyness"] <= 0.95


def test_serve_holds_no_tensor():
    """The controller is host bookkeeping: nothing it keeps is a tensor."""
    import torch
    ctl = port_engine.JustinServeController(
        RATE, workload=port_engine.WorkloadSpec(**SMALL))
    ctl.autoscale(max_rounds=2)
    seen = [ctl.__dict__, *(r.__dict__ for r in ctl.replicas),
            *(r.cache.__dict__ for r in ctl.replicas), *ctl.history]
    for d in seen:
        assert not any(isinstance(v, torch.Tensor) for v in d.values())
