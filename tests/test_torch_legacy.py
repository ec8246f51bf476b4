"""The port's frozen legacy LSM store and the store switch, on the CPU.

* **Lockstep**: pinned-seed op sequences drive ``repro.state.legacy`` and
  ``repro_torch.state.legacy`` side by side; after every op the values,
  found masks, the full metrics snapshot (``access_latency_total_ms``
  included), entry counts, ``items()`` and the four CLOCK arrays must be
  equal with ``==``.
* **The port's differential harness**: the port's columnar store against
  the port's legacy store against a dict model, as
  ``test_lsm_differential`` holds the reference's two stores.
* State carried across packages and stores, the switches
  (``stable_argsort_keys``, ``set_store_impl``/``store_class``/
  ``make_store``), the lexsort installer against the reference engine's,
  and the golden episodes under the legacy store.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.state.lsm as ref_lsm  # noqa: E402
import repro.streaming.engine as ref_engine  # noqa: E402
import repro_torch.state.lsm as lsm  # noqa: E402
import repro_torch.streaming.engine as port_engine  # noqa: E402
from repro.state.legacy import LegacyLSMStore as RefLegacy  # noqa: E402
from repro_torch.state.convert import (snapshot_to_numpy,  # noqa: E402
                                       snapshot_to_torch)
from repro_torch.state.legacy import LegacyLSMStore  # noqa: E402
from repro_torch.state.lsm import LSMStore  # noqa: E402
from test_torch_engine import PORT, REF, _flow  # noqa: E402
from test_torch_golden import assert_matches_golden  # noqa: E402
from test_lsm_differential import (  # noqa: E402
    _gen_sequence as _differential_sequence)
from test_torch_lsm import _gen_sequence as columnar_sequence  # noqa: E402

N_LOCKSTEP = 32
N_DIFFERENTIAL = 16
CACHE_ATTRS = ("cache_keys", "cache_vals", "cache_ref", "cache_hand")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many small tensor ops: one intra-op thread runs them faster than a
    pool and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def legacy_switch(monkeypatch):
    """Both packages' store switch on "legacy" for one test; monkeypatch
    puts the module globals back afterwards."""
    monkeypatch.setattr(lsm, "_ACTIVE_STORE_IMPL", "columnar")
    monkeypatch.setattr(ref_lsm, "_ACTIVE_STORE_IMPL", "columnar")
    lsm.set_store_impl("legacy")
    ref_lsm.set_store_impl("legacy")


def T(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def N(t):
    return t.cpu().numpy()


# ------------------------------------------------------------- lockstep
def _gen_sequence(seed: int):
    """One pinned-seed op sequence: ``test_torch_lsm``'s generator without
    its hinted puts (the legacy store takes no hint)."""
    memory_mb, use_filter, ops = columnar_sequence(seed)
    return memory_mb, use_filter, [op for op in ops if op[0] != "hint"]


def assert_legacy_equal(a: LegacyLSMStore, b: RefLegacy, tag: str) -> None:
    assert a.metrics.snapshot() == b.metrics.snapshot(), tag
    assert a.entry_count == b.entry_count, tag
    assert a.mem_n == b.mem_n, tag
    assert (a.memtable_cap, a.cache_sets, a.cache_ways) == \
        (b.memtable_cap, b.cache_sets, b.cache_ways), tag
    for attr in CACHE_ATTRS:
        got = N(getattr(a, attr))
        want = getattr(b, attr)
        assert got.dtype == want.dtype, (tag, attr)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag} {attr}")


def assert_items_equal(port, ref_items, tag: str) -> None:
    kp, vp = port.items()
    kr, vr = ref_items
    np.testing.assert_array_equal(N(kp), kr, err_msg=tag)
    np.testing.assert_array_equal(N(vp), vr, err_msg=tag)


def run_lockstep(seed: int, device: str = "cpu") -> None:
    """One sequence through the reference's legacy store and the port's
    on ``device``, compared after every op."""
    memory_mb, use_filter, ops = _gen_sequence(seed)
    port = LegacyLSMStore(memory_mb, value_words=2, device=device)
    ref = RefLegacy(memory_mb, value_words=2)
    if use_filter:
        port.compact_filter = lambda keys: keys % 3 != 0
        ref.compact_filter = lambda keys: keys % 3 != 0
    for step, op in enumerate(ops):
        tag = f"seed={seed} step={step} op={op[0]}"
        if op[0] == "put":
            _, keys, vals = op
            assert port.put_batch(T(keys, device), T(vals, device)) is None
            assert ref.put_batch(keys, vals) is None
        elif op[0] == "get":
            _, q = op
            gp, fp = port.get_batch(T(q, device))
            gr, fr = ref.get_batch(q)
            np.testing.assert_array_equal(N(fp), fr, err_msg=tag)
            np.testing.assert_array_equal(N(gp), gr, err_msg=tag)
        elif op[0] == "resize":
            port.resize(op[1])
            ref.resize(op[1])
        elif op[0] == "bulk":
            _, keys, vals = op
            port.bulk_load(T(keys, device), T(vals, device))
            ref.bulk_load(keys, vals)
        elif op[0] == "items":
            assert_items_equal(port, ref.items(), tag)
        elif op[0] == "snapshot":
            sp = snapshot_to_numpy(port.snapshot())
            sr = ref.snapshot()
            assert sorted(sp) == sorted(sr), tag
            for f in ("keys", "vals"):
                np.testing.assert_array_equal(sp[f], sr[f], err_msg=tag)
            assert sp["memory_mb"] == sr["memory_mb"], tag
            rp = LegacyLSMStore.restore(port.snapshot(), device=device)
            rr = RefLegacy.restore(sr)
            assert_items_equal(rp, rr.items(), tag)
            assert_legacy_equal(rp, rr, tag + " restored")
        assert_legacy_equal(port, ref, tag)
        assert_items_equal(port, ref.items(), tag)


@pytest.mark.parametrize("seed", range(N_LOCKSTEP))
def test_port_legacy_matches_reference_legacy_in_lockstep(seed):
    run_lockstep(seed)


def test_lockstep_sequences_cover_every_op():
    kinds, filters, budgets = set(), set(), set()
    for seed in range(N_LOCKSTEP):
        mb, use_filter, ops = _gen_sequence(seed)
        filters.add(use_filter)
        budgets.add(mb)
        kinds.update(op[0] for op in ops)
    assert kinds == {"put", "get", "items", "resize", "snapshot", "bulk"}
    assert filters == {True, False}
    assert 32.0 in budgets


def test_delta_spill_and_clock_rounds_are_exercised():
    """The large-memtable path: the delta buffer spills into the view
    (``np.insert`` of many keys, existing keys overwritten in place), and
    misses that share a cache set are inserted in several CLOCK rounds."""
    rng = np.random.default_rng(3)
    port = LegacyLSMStore(32.0, value_words=2, device="cpu")
    ref = RefLegacy(32.0, value_words=2)
    spilled = 0
    for step in range(5):
        # ~2,360 unique keys a put: over the 2,048-key delta buffer
        keys = rng.integers(0, 6_000, 3_000).astype(np.int64)
        vals = rng.integers(0, 1 << 30, (len(keys), 2)).astype(np.int32)
        port.put_batch(T(keys), T(vals))
        ref.put_batch(keys, vals)
        assert_legacy_equal(port, ref, f"put {step}")
        spilled += len(ref._view_keys) > 0
        q = rng.integers(0, 7_000, 900).astype(np.int64)
        gp, fp = port.get_batch(T(q))
        gr, fr = ref.get_batch(q)
        np.testing.assert_array_equal(N(gp), gr)
        np.testing.assert_array_equal(N(fp), fr)
        assert_legacy_equal(port, ref, f"get {step}")
    assert_items_equal(port, ref.items(), "end")
    assert spilled >= 2 and ref.metrics.flushes >= 1
    # a set receiving more than one miss in one call takes several rounds
    sets = ref._sets(np.arange(0, 7_000, dtype=np.int64))
    assert np.bincount(sets).max() > 1


# ---------------------------------------------- the port's own harness
def _assert_stores_equal(col: LSMStore, leg: LegacyLSMStore,
                         tag: str) -> None:
    assert col.metrics.snapshot() == leg.metrics.snapshot(), tag
    assert col.entry_count == leg.entry_count, tag
    assert col.memtable_cap == leg.memtable_cap, tag
    assert (col.cache_sets, col.cache_ways) == \
        (leg.cache_sets, leg.cache_ways), tag
    for attr in CACHE_ATTRS:
        assert torch.equal(getattr(col, attr), getattr(leg, attr)), \
            (tag, attr)


def run_differential(seed: int) -> None:
    """Port columnar against port legacy against a dict model, with the
    reference harness's model of bulk loads (a put in the current
    memtable epoch shadows a later bulk load; a cached key may serve its
    stale value until evicted, so it is exempt from value checks)."""
    memory_mb, use_filter, ops = _differential_sequence(seed)
    col = LSMStore(memory_mb, value_words=2, device="cpu")
    leg = LegacyLSMStore(memory_mb, value_words=2, device="cpu")
    model: dict[int, tuple] = {}
    epoch_puts: set[int] = set()
    tainted: set[int] = set()
    mem_count = 0
    if use_filter:
        col.compact_filter = leg.compact_filter = \
            lambda keys: keys % 3 != 0
    for step, op in enumerate(ops):
        tag = f"seed={seed} step={step} op={op[0]}"
        if op[0] == "put":
            _, keys, vals = op
            col.put_batch(T(keys), T(vals))
            leg.put_batch(T(keys), T(vals))
            for k, v in zip(keys.tolist(), vals.tolist()):
                model[k] = tuple(v)
            tainted.difference_update(keys.tolist())
            off, cap = 0, col.memtable_cap
            while off < len(keys):
                take = min(cap - mem_count, len(keys) - off)
                epoch_puts.update(keys[off:off + take].tolist())
                mem_count += take
                off += take
                if mem_count >= cap:                 # flush boundary
                    epoch_puts.clear()
                    mem_count = 0
        elif op[0] == "get":
            _, q = op
            gc, fc = col.get_batch(T(q))
            gl, fl = leg.get_batch(T(q))
            assert torch.equal(fc, fl), tag
            assert torch.equal(gc, gl), tag
            if not use_filter:          # the dict model has no annihilation
                for i, k in enumerate(q.tolist()):
                    assert bool(fc[i]) == (k in model), tag
                    if fc[i] and k not in tainted:
                        assert tuple(gc[i].tolist()) == model[k], tag
        elif op[0] == "resize":
            col.resize(op[1])
            leg.resize(op[1])
            epoch_puts.clear()
            tainted.clear()
            mem_count = 0
        elif op[0] == "bulk":
            _, keys, vals = op
            col.bulk_load(T(keys), T(vals))
            leg.bulk_load(T(keys), T(vals))
            cached = set(col.cache_keys[col.cache_keys >= 0].tolist())
            for k, v in zip(keys.tolist(), vals.tolist()):
                if k in epoch_puts:
                    continue
                model[k] = tuple(v)
                if k in cached:
                    tainted.add(k)
        elif op[0] == "items":
            kc, vc = col.items()
            kl, vl = leg.items()
            assert torch.equal(kc, kl) and torch.equal(vc, vl), tag
            if not use_filter:
                assert set(kc.tolist()) == set(model), tag
        elif op[0] == "snapshot":
            sc, sl = col.snapshot(), leg.snapshot()
            assert torch.equal(sc["keys"], sl["keys"]), tag
            assert torch.equal(sc["vals"], sl["vals"]), tag
            assert sc["memory_mb"] == sl["memory_mb"], tag
            assert int(sc["weights"].sum()) >= len(sc["keys"]), tag
            rc = LSMStore.restore(sc, device="cpu")
            rl = LegacyLSMStore.restore(sl, device="cpu")
            assert torch.equal(rc.items()[0], rl.items()[0]), tag
            assert torch.equal(rc.items()[1], rl.items()[1]), tag
        _assert_stores_equal(col, leg, tag)


@pytest.mark.parametrize("seed", range(N_DIFFERENTIAL))
def test_port_columnar_matches_port_legacy_and_model(seed):
    run_differential(seed)


def test_differential_sequences_cover_every_op():
    kinds, filters = set(), set()
    for seed in range(N_DIFFERENTIAL):
        _, use_filter, ops = _differential_sequence(seed)
        filters.add(use_filter)
        kinds.update(op[0] for op in ops)
    assert kinds == {"put", "get", "items", "resize", "snapshot", "bulk"}
    assert filters == {True, False}


# ------------------------------------------------------ state carried across
def test_reference_legacy_snapshot_restores_into_port_legacy():
    rng = np.random.default_rng(21)
    ref = RefLegacy(0.5, value_words=2)
    for _ in range(5):
        keys = rng.integers(0, 3_000, 700).astype(np.int64)
        ref.put_batch(keys, rng.integers(0, 1 << 30, (700, 2))
                      .astype(np.int32))
    snap = ref.snapshot()
    port = LegacyLSMStore.restore(snapshot_to_torch(snap, "cpu"),
                                  device="cpu")
    assert_items_equal(port, ref.items(), "restored")
    again = RefLegacy.restore(snap)
    assert_legacy_equal(port, again, "restored")
    q = rng.integers(0, 3_500, 900).astype(np.int64)
    gp, fp = port.get_batch(T(q))
    gr, fr = again.get_batch(q)
    np.testing.assert_array_equal(N(gp), gr)
    np.testing.assert_array_equal(N(fp), fr)
    assert_legacy_equal(port, again, "after get")


def test_columnar_snapshot_restores_into_legacy():
    rng = np.random.default_rng(22)
    col = LSMStore(0.5, value_words=2, device="cpu")
    for _ in range(6):
        keys = rng.integers(0, 3_000, 900).astype(np.int64)
        col.put_batch(T(keys), T(rng.integers(0, 1 << 30, (900, 2))
                                  .astype(np.int32)))
    snap = col.snapshot()
    leg = LegacyLSMStore.restore(snap, device="cpu")
    kc, vc = col.items()
    kl, vl = leg.items()
    assert torch.equal(kc, kl) and torch.equal(vc, vl)
    assert leg.entry_count == len(kc)


# ------------------------------------------------------------- the switches
@pytest.mark.parametrize("case", ["small", "radix", "negative", "wide",
                                  "empty"])
def test_stable_argsort_keys_matches_reference(case):
    rng = np.random.default_rng(7)
    n = 1_000 if case == "small" else 9_000
    a = rng.integers(0, 600, n).astype(np.int64)     # many repeats
    if case == "negative":
        a[::7] = -a[::7] - 1
    elif case == "wide":
        a[::5] += np.int64(1) << 40
        a[3] = np.iinfo(np.int64).max
    elif case == "empty":
        a = a[:0]
    want = ref_lsm.stable_argsort_keys(a)
    got = lsm.stable_argsort_keys(T(a))
    np.testing.assert_array_equal(N(got), want)


def test_store_switch_matches_reference(monkeypatch):
    monkeypatch.setattr(lsm, "_ACTIVE_STORE_IMPL", "columnar")
    monkeypatch.setattr(ref_lsm, "_ACTIVE_STORE_IMPL", "columnar")
    for mod, legacy in ((lsm, LegacyLSMStore), (ref_lsm, RefLegacy)):
        kw = {"device": "cpu"} if mod is lsm else {}
        assert mod.get_store_impl() == "columnar"
        assert mod.store_class() is mod.LSMStore
        assert mod.store_class("legacy") is legacy
        assert type(mod.make_store(1.0, **kw)) is mod.LSMStore
        mod.set_store_impl("legacy")
        assert mod.get_store_impl() == "legacy"
        assert mod.store_class() is legacy
        assert mod.store_class("columnar") is mod.LSMStore
        s = mod.make_store(1.0, value_words=3, **kw)
        assert type(s) is legacy and s.value_words == 3
        with pytest.raises(ValueError, match="unknown store impl 'rows'"):
            mod.set_store_impl("rows")
        assert mod.get_store_impl() == "legacy"
        mod.set_store_impl("columnar")
        assert mod.store_class() is mod.LSMStore


# --------------------------------------------------- the lexsort installer
def _task_states_equal(ref, port, tag: str) -> None:
    for name, tasks in ref.tasks.items():
        for i, tr in enumerate(tasks):
            if tr.state is None:
                continue
            ps = port.tasks[name][i].state
            assert type(ps) is LegacyLSMStore, tag
            assert type(tr.state) is RefLegacy, tag
            assert_items_equal(ps, tr.state.items(), f"{tag} {name}[{i}]")
            assert_legacy_equal(ps, tr.state, f"{tag} {name}[{i}]")


@pytest.mark.parametrize("kind", ["sessions", "window_join"])
def test_lexsort_installer_matches_reference(kind, legacy_switch):
    """Warm install, windows of traffic, then a reconfigure that
    redistributes state over more tasks: every task's items, metrics and
    CLOCK arrays equal the reference engine's under its legacy store."""
    kw = dict(seed=4, base_mem_mb=2.0, chunk_events=512)
    ref = ref_engine.StreamEngine(_flow(REF, kind), **kw)
    port = port_engine.StreamEngine(_flow(PORT, kind), device="cpu", **kw)
    _task_states_equal(ref, port, "warm")
    for w in range(2):
        ref.run(2, 9_000)
        port.run(2, 9_000)
        assert port.collect() == ref.collect(), w
    _task_states_equal(ref, port, "ran")
    stateful = [n for n, node in ref.flow.nodes.items() if node.op.stateful]
    new = {n: (ref.flow.nodes[n].parallelism + 1, 1) for n in stateful}
    ref.reconfigure(new)
    port.reconfigure(new)
    _task_states_equal(ref, port, "reconfigured")
    ref.run(2, 9_000)
    port.run(2, 9_000)
    assert port.collect() == ref.collect()
    _task_states_equal(ref, port, "after")


# ----------------------------------------- golden episodes under legacy
@pytest.mark.parametrize("key", [
    "q11_justin", "q11_ds2",
    pytest.param("q8_justin", marks=pytest.mark.slow),
    pytest.param("q8_ds2", marks=pytest.mark.slow),
])
def test_golden_episode_under_legacy_store(key, legacy_switch):
    assert_matches_golden(key, "cpu")
