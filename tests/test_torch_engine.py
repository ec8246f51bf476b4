"""The port's streaming engine and operators in lockstep with the
reference engine on small flows.

Both packages build the same dataflow from the same seeds; every window's
``collect()`` metrics (rates, busyness, θ, τ, backlog — everything the
policies read) must be identical, through a reconfiguration and across a
snapshot restored into both packages (``snapshot_to_torch``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data.nexmark as ref_nexmark  # noqa: E402
import repro.streaming.engine as ref_engine  # noqa: E402
import repro.streaming.graph as ref_graph  # noqa: E402
import repro.streaming.operators as ref_ops  # noqa: E402
import repro_torch.data.nexmark as port_nexmark  # noqa: E402
import repro_torch.streaming.engine as port_engine  # noqa: E402
import repro_torch.streaming.graph as port_graph  # noqa: E402
import repro_torch.streaming.operators as port_ops  # noqa: E402
from repro_torch.state.convert import (snapshot_to_numpy,  # noqa: E402
                                       snapshot_to_torch)

REF = (ref_nexmark, ref_graph, ref_ops)
PORT = (port_nexmark, port_graph, port_ops)
BASE_MB = 2.0                    # tiny stores: flushes and evictions happen


def _flow(mods, kind: str):
    N, G, O = mods
    f = G.Dataflow(kind)
    if kind == "sessions":       # q11's shape over a small keyspace
        f.chain(O.SourceOp("source", N.BidGen(seed=5, users=6_000)),
                O.SessionWindowOp("sessions", gap_s=3.0, keyspace=6_000),
                O.SinkOp("sink"))
        f.nodes["sessions"].parallelism = 2
    elif kind == "window_join":  # q8's shape over a small keyspace
        f.chain(O.SourceOp("source", N.NexmarkGen(
                    seed=9, mix=(10, 36, 0), sellers=4_000, skew=False)),
                O.JoinOp("join", N.PERSON, N.AUCTION, window_s=3.0,
                         keyspace=4_000),
                O.SinkOp("sink"))
        f.nodes["join"].parallelism = 3
    elif kind == "keyed_update":
        f.chain(O.SourceOp("source", N.BidGen(seed=2, users=3_000)),
                O.KeyedStateOp("update", "update", keyspace=3_000),
                O.SinkOp("sink"))
    elif kind in ("q3", "q5"):
        return N.QUERIES[kind]()
    return f


KINDS = ["sessions", "window_join", "keyed_update", "q3", "q5"]
RATES = {"sessions": 9_000, "window_join": 9_000, "keyed_update": 6_000,
         "q3": 12_000, "q5": 9_000}


def _engines(kind: str, warm: bool = True):
    ref = ref_engine.StreamEngine(_flow(REF, kind), seed=4, warm=warm,
                                  base_mem_mb=BASE_MB, chunk_events=512)
    port = port_engine.StreamEngine(_flow(PORT, kind), seed=4, warm=warm,
                                    base_mem_mb=BASE_MB, chunk_events=512,
                                    device="cpu")
    return ref, port


def _assert_same(ref, port, tag: str) -> None:
    mr, mp = ref.collect(), port.collect()
    assert mp == mr, tag
    for name, tasks in ref.tasks.items():
        for i, tr in enumerate(tasks):
            tp = port.tasks[name][i]
            assert tp.queued_events == tr.queued_events, (tag, name, i)
            if tr.state is not None:
                assert tp.state.metrics.snapshot() == \
                    tr.state.metrics.snapshot(), (tag, name, i)
                np.testing.assert_array_equal(tp.state.cache_keys.numpy(),
                                              tr.state.cache_keys)


def _run(ref, port, ticks: int, rate: float, tag: str) -> None:
    for w in range(ticks // 2):
        ref.run(2, rate)
        port.run(2, rate)
        _assert_same(ref, port, f"{tag} window {w}")


@pytest.mark.parametrize("kind", KINDS)
def test_engine_lockstep_with_reconfigure(kind):
    ref, port = _engines(kind)
    rate = RATES[kind]
    _run(ref, port, 6, rate, "start")
    stateful = [n for n, node in ref.flow.nodes.items() if node.op.stateful]
    new = {n: (node.parallelism + 1, 1) for n, node in
           ref.flow.nodes.items() if n in stateful}
    ref.reconfigure(new)
    port.reconfigure(new)
    _run(ref, port, 4, rate, "scaled")
    sr = ref.snapshot()
    sp = snapshot_to_numpy(port.snapshot())
    assert sp["now"] == sr["now"]
    assert sp["source_emitted"] == sr["source_emitted"]
    for name in stateful:
        for a, b in zip(sp["ops"][name], sr["ops"][name]):
            for f in ("keys", "vals", "weights"):
                np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize("kind", ["sessions", "window_join"])
def test_reference_state_restored_into_both_packages(kind):
    """One reference snapshot, carried over with ``snapshot_to_torch``,
    drives fresh engines of both packages to identical windows."""
    src, _ = _engines(kind)
    src.run(4, RATES[kind])
    snap = src.snapshot()
    ref, port = _engines(kind, warm=False)
    ref.restore(snap)
    port.restore(snapshot_to_torch(snap, "cpu"))
    _run(ref, port, 6, RATES[kind], "restored")


def test_sink_and_filters_run_on_tensors():
    eng = port_engine.StreamEngine(port_nexmark.q2(), seed=1, device="cpu")
    eng.run(2, 20_000)
    m = eng.collect()
    assert m["source"]["processed"] == 40_000
    assert 0 < m["bid_filter"]["selectivity"] < 0.05
