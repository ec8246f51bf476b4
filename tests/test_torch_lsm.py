"""The port's columnar LSMStore against the reference numpy store.

Pinned-seed op sequences (put / get / items / resize / snapshot / bulk,
in the manner of ``test_lsm_differential``) drive ``repro.state.lsm``
and ``repro_torch.state.lsm`` in lockstep on the CPU.  After every op the
get results, the full metrics snapshot, entry counts and the CLOCK cache
arrays must be identical — θ and τ, and so every policy decision, are
functions of exactly these.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.state.lsm import LSMStore as RefStore  # noqa: E402
from repro_torch.state.convert import (snapshot_to_numpy,  # noqa: E402
                                       snapshot_to_torch)
from repro_torch.state.lsm import LSMStore  # noqa: E402

N_SEQUENCES = 48
KEYSPACE = 4_000
CACHE_ATTRS = ("cache_keys", "cache_vals", "cache_ref", "cache_hand")
LIM45 = 1 << 45


def T(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def N(t):
    return t.cpu().numpy()


def _gen_sequence(seed: int):
    """One pinned-seed op sequence: (memory_mb, use_filter, [op...])."""
    r = np.random.default_rng(seed)
    # tiny budgets flush and compact often; 32 MB stacks delta runs
    memory_mb = float(r.choice([0.25, 0.5, 2.0, 32.0]))
    use_filter = seed % 5 == 0                      # annihilation coverage
    ops = []
    for _ in range(int(r.integers(6, 24))):
        kind = r.choice(["put", "put", "put", "get", "get", "items",
                         "resize", "snapshot", "bulk", "hint"])
        if kind in ("put", "hint"):
            # small batches stack delta runs => consolidation, tier merges
            n = int(r.integers(1, 1_200 if r.random() < 0.6 else 80))
            ops.append((kind,
                        r.integers(0, KEYSPACE, n).astype(np.int64),
                        r.integers(0, 1 << 30, (n, 2)).astype(np.int32)))
        elif kind == "get":
            n = int(r.integers(1, 600))
            # duplicate-laden probes exercise the θ/τ duplicate accounting
            q = r.integers(0, KEYSPACE + 500, n).astype(np.int64)
            if n > 10 and r.random() < 0.5:
                q[n // 2:] = q[: n - n // 2]
            if r.random() < 0.15:       # out-of-band keys: per-run fallback
                q[0] = LIM45 + int(r.integers(0, 50))
            ops.append(("get", q))
        elif kind == "resize":
            ops.append(("resize", float(r.choice([0.25, 0.5, 2.0, 8.0]))))
        elif kind == "bulk":
            n = int(r.integers(1, 800))
            ops.append(("bulk",
                        r.integers(0, KEYSPACE, n).astype(np.int64),
                        r.integers(0, 1 << 30, (n, 2)).astype(np.int32)))
        else:
            ops.append((kind,))
    ops.append(("items",))
    return memory_mb, use_filter, ops


def assert_state_equal(a: LSMStore, b: RefStore, tag: str) -> None:
    assert a.metrics.snapshot() == b.metrics.snapshot(), tag
    assert a.entry_count == b.entry_count, tag
    assert a.annihilated == b.annihilated, tag
    assert (a.memtable_cap, a.cache_sets, a.cache_ways) == \
        (b.memtable_cap, b.cache_sets, b.cache_ways), tag
    for attr in CACHE_ATTRS:
        got = N(getattr(a, attr))
        want = getattr(b, attr)
        assert got.dtype == want.dtype, (tag, attr)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag} {attr}")


def run_lockstep(seed: int, device: str = "cpu") -> None:
    memory_mb, use_filter, ops = _gen_sequence(seed)
    port = LSMStore(memory_mb, value_words=2, device=device)
    ref = RefStore(memory_mb, value_words=2)
    if use_filter:
        port.compact_filter = lambda keys: keys % 3 != 0
        ref.compact_filter = lambda keys: keys % 3 != 0
    for step, op in enumerate(ops):
        tag = f"seed={seed} step={step} op={op[0]}"
        if op[0] == "put":
            _, keys, vals = op
            dp = port.put_batch(T(keys, device), T(vals, device))
            dr = ref.put_batch(keys, vals)
            for a, b in zip(dp, dr):
                np.testing.assert_array_equal(N(a), b, err_msg=tag)
        elif op[0] == "hint":
            # put then probe the same batch shifted, reusing the delta
            _, keys, vals = op
            dp = port.put_batch(T(keys, device), T(vals, device))
            dr = ref.put_batch(keys, vals)
            gp, fp = port.get_batch(T(keys + 3, device),
                                    uhint=(dp[0] + 3, dp[1]))
            gr, fr = ref.get_batch(keys + 3, uhint=(dr[0] + 3, dr[1]))
            np.testing.assert_array_equal(N(fp), fr, err_msg=tag)
            np.testing.assert_array_equal(N(gp), gr, err_msg=tag)
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
            kp, vp = port.items()
            kr, vr = ref.items()
            np.testing.assert_array_equal(N(kp), kr, err_msg=tag)
            np.testing.assert_array_equal(N(vp), vr, err_msg=tag)
        elif op[0] == "snapshot":
            sp = snapshot_to_numpy(port.snapshot())
            sr = ref.snapshot()
            for f in ("keys", "vals", "weights"):
                np.testing.assert_array_equal(sp[f], sr[f], err_msg=tag)
            assert sp["memory_mb"] == sr["memory_mb"], tag
            rp = LSMStore.restore(port.snapshot(), device=device)
            rr = RefStore.restore(sr)
            np.testing.assert_array_equal(N(rp.items()[0]), rr.items()[0])
            np.testing.assert_array_equal(N(rp.items()[1]), rr.items()[1])
            assert rp.total_weight() == rr.total_weight(), tag
        assert_state_equal(port, ref, tag)


@pytest.mark.parametrize("seed", range(N_SEQUENCES))
def test_port_store_matches_reference_in_lockstep(seed):
    run_lockstep(seed)


def test_sequence_space_covers_all_ops():
    kinds, filters = set(), set()
    for seed in range(N_SEQUENCES):
        _, use_filter, ops = _gen_sequence(seed)
        filters.add(use_filter)
        kinds.update(op[0] for op in ops)
    assert kinds == {"put", "hint", "get", "items", "resize", "snapshot",
                     "bulk"}
    assert filters == {True, False}


def test_prewarm_and_install_match_reference():
    """The engine's install path: one sorted run, then a cache prewarm
    sampled from the same numpy rng stream — the virgin fill, the
    sampled prewarm and the later CLOCK inserts stay bit-identical."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 200_000, 30_000)).astype(np.int64)
    vals = rng.integers(0, 1 << 30, (len(keys), 4)).astype(np.int32)
    port = LSMStore(2.0, device="cpu")
    ref = RefStore(2.0)
    port.install_run(T(keys), T(vals))
    ref.install_run(keys, vals)
    port.prewarm_cache(T(keys), T(vals), np.random.default_rng(9))
    ref.prewarm_cache(keys, vals, np.random.default_rng(9))
    assert_state_equal(port, ref, "prewarm")
    for step in range(6):
        q = rng.integers(0, 220_000, 5_000).astype(np.int64)
        gp, fp = port.get_batch(T(q))
        gr, fr = ref.get_batch(q)
        np.testing.assert_array_equal(N(gp), gr)
        np.testing.assert_array_equal(N(fp), fr)
        w = rng.integers(0, 220_000, 3_000).astype(np.int64)
        wv = rng.integers(0, 1 << 30, (len(w), 4)).astype(np.int32)
        port.put_batch(T(w), T(wv))
        ref.put_batch(w, wv)
        assert_state_equal(port, ref, f"step {step}")


# ---------------------------------------- packed-key bounds (45/47 bits)
def _vals(keys, words=4):
    k = np.asarray(keys, np.int64)
    return (k[:, None] * 10 + np.arange(words)).astype(np.int32)


def _pair():
    return LSMStore(64, device="cpu"), RefStore(64)


def _both_get(port, ref, q):
    q = np.asarray(q, np.int64)
    gp, fp = port.get_batch(T(q))
    gr, fr = ref.get_batch(q)
    np.testing.assert_array_equal(N(fp), fr)
    np.testing.assert_array_equal(N(gp), gr)
    assert port.metrics.snapshot() == ref.metrics.snapshot()
    return N(gp), N(fp)


def _both_put(port, ref, keys):
    keys = np.asarray(keys, np.int64)
    port.put_batch(T(keys), T(_vals(keys)))
    ref.put_batch(keys, _vals(keys))


def test_out_of_band_query_key_does_not_false_hit():
    port, ref = _pair()
    _both_put(port, ref, [5, 7])
    _both_put(port, ref, [7, 9])
    vals, found = _both_get(port, ref, [LIM45 + 7])
    assert not found[0] and (vals[0] == 0).all()


def test_negative_query_key_takes_fallback():
    port, ref = _pair()
    _both_put(port, ref, [5, 7])
    _both_put(port, ref, [7, 9])
    vals, found = _both_get(port, ref, [5, 9, -1])
    assert found[0] and found[1]
    np.testing.assert_array_equal(vals[0], _vals([5])[0])


def test_stored_key_past_45_bits_resolves_through_fallback():
    port, ref = _pair()
    big = LIM45 + 7
    _both_put(port, ref, [3, big])
    vals, found = _both_get(port, ref, [big, 3, big + 1])
    assert found[0] and found[1] and not found[2]
    np.testing.assert_array_equal(vals[0], _vals([big])[0])


def test_fast_path_serves_key_at_band_edge():
    port, ref = _pair()
    edge = LIM45 - 1
    _both_put(port, ref, [0, edge])
    _both_put(port, ref, [1])
    vals, found = _both_get(port, ref, [edge, 0, 1])
    assert found.all()
    np.testing.assert_array_equal(vals[0], _vals([edge])[0])


def test_prewarm_at_47_bit_edge_matches_reference():
    lim47 = 1 << 47
    lo = np.arange(64, dtype=np.int64) * 3 + 1
    for keys in (lo, np.concatenate([lo[:-1], [lim47 + 5]])):
        port, ref = _pair()
        port.prewarm_cache(T(keys), T(_vals(keys)))
        ref.prewarm_cache(keys, _vals(keys))
        assert_state_equal(port, ref, "prewarm47")
        _both_put(port, ref, keys)
        _, found = _both_get(port, ref, keys)
        assert found.all()
        assert_state_equal(port, ref, "after")


def test_items_and_snapshot_are_copies():
    port = LSMStore(64, device="cpu")
    keys = np.array([2, 4, 6], np.int64)
    port.put_batch(T(keys), T(_vals(keys)))
    k, v = port.items()
    k[:] = -1
    v[:] = -999
    snap = port.snapshot()
    snap["keys"][:] = 0
    vals, found = port.get_batch(T(keys))
    assert bool(found.all())
    np.testing.assert_array_equal(N(vals), _vals(keys))
    np.testing.assert_array_equal(N(port.items()[0]), keys)


def test_snapshot_to_torch_round_trip_from_reference_store():
    rng = np.random.default_rng(21)
    ref = RefStore(0.5, value_words=2)
    for _ in range(5):
        keys = rng.integers(0, 3_000, 700).astype(np.int64)
        ref.put_batch(keys, rng.integers(0, 1 << 30, (700, 2))
                      .astype(np.int32))
    snap = ref.snapshot()
    tsnap = snapshot_to_torch(snap, "cpu")
    assert tsnap["keys"].dtype == torch.int64
    assert tsnap["vals"].dtype == torch.int32
    back = snapshot_to_numpy(tsnap)
    for f in ("keys", "vals", "weights"):
        np.testing.assert_array_equal(back[f], snap[f])
    port = LSMStore.restore(tsnap, device="cpu")
    again = RefStore.restore(snap)
    assert_state_equal(port, again, "restored")
    q = rng.integers(0, 3_500, 900).astype(np.int64)
    gp, fp = port.get_batch(T(q))
    gr, fr = again.get_batch(q)
    np.testing.assert_array_equal(N(gp), gr)
    np.testing.assert_array_equal(N(fp), fr)
    assert_state_equal(port, again, "after get")

