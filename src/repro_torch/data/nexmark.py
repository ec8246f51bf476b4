"""Nexmark benchmark (Tucker et al.) — generator + the six queries of the
paper's evaluation (q1, q2, q3, q5, q8, q11), built on the port's
streaming engine.  Port of ``repro.data.nexmark``.

Event kinds: 0 = Person, 1 = Auction, 2 = Bid (proportions 1:3:46, the
standard Nexmark mix).  Events are drawn on the host from the same numpy
``default_rng(seed)`` streams as the reference (a torch generator cannot
reproduce PCG64, and the golden traces need identical events) and handed
over as CPU tensors; the engine moves each batch to its device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.streaming.events import PAYLOAD_WORDS, EventBatch
from repro_torch.streaming.graph import Dataflow
from repro_torch.streaming.operators import (FilterOp, JoinOp, MapOp,
                                             SessionWindowOp, SinkOp,
                                             SourceOp, WindowAggOp)

PERSON, AUCTION, BID = 0, 1, 2

N_USERS = 1_000_000
N_ACTIVE_USERS = 600_000  # concurrently-active bidders (q11 working set)
N_AUCTIONS = 10_000
N_SELLERS = 8_000         # q3 join keyspace (small state, ~8 MB — §5)
N_SELLERS_Q8 = 600_000    # q8 window-join keyspace (memory-pressured)


HOT_FRACTION = 0.8        # share of key draws hitting the hot set
HOT_SET = 6               # hot set = keyspace / HOT_SET


def _skewed(rng: np.random.Generator, n: int, keyspace: int) -> np.ndarray:
    """Hot-set skew: 80% of draws hit the hottest keyspace/6 keys."""
    hot = rng.random(n) < HOT_FRACTION
    keys = np.empty(n, np.int64)
    keys[hot] = rng.integers(0, max(1, keyspace // HOT_SET), hot.sum())
    keys[~hot] = rng.integers(0, keyspace, (~hot).sum())
    return keys


def _batch(key: np.ndarray, value: np.ndarray, ts: np.ndarray,
           kind: np.ndarray) -> EventBatch:
    return EventBatch(torch.from_numpy(key), torch.from_numpy(value),
                      torch.from_numpy(ts), torch.from_numpy(kind))


class NexmarkGen:
    """Deterministic event generator with the standard 1:3:46 mix."""

    def __init__(self, seed: int = 7, mix=(1, 3, 46),
                 sellers: int = N_SELLERS, users: int = N_ACTIVE_USERS,
                 skew: bool = True):
        self.rng = np.random.default_rng(seed)
        w = np.array(mix, np.float64)
        self.mix = w / w.sum()
        self.sellers = sellers
        self.users = users
        self.skew = skew

    def _draw(self, n: int, keyspace: int) -> np.ndarray:
        if self.skew:
            return _skewed(self.rng, n, keyspace)
        return self.rng.integers(0, keyspace, n)

    def _arrays(self, n: int, now_s: float):
        """(key, value, ts, kind) numpy arrays, in the reference's draw
        order; None for n <= 0."""
        if n <= 0:
            return None
        kind = self.rng.choice(3, size=n, p=self.mix).astype(np.int8)
        key = np.empty(n, np.int64)
        p, a, b = kind == PERSON, kind == AUCTION, kind == BID
        key[p] = self._draw(int(p.sum()), self.sellers)
        key[a] = self._draw(int(a.sum()), self.sellers)       # seller id
        key[b] = self._draw(int(b.sum()), self.users)         # bidder id
        value = self.rng.integers(0, 10_000, (n, PAYLOAD_WORDS),
                                  dtype=np.int64).astype(np.int32)
        value[a, 2] = self.rng.integers(0, N_AUCTIONS, a.sum())
        value[b, 2] = self.rng.integers(0, N_AUCTIONS, b.sum())  # auction id
        ts = np.full(n, now_s, np.float64)
        return key, value, ts, kind

    def __call__(self, n: int, now_s: float) -> EventBatch:
        arrs = self._arrays(n, now_s)
        return EventBatch.empty() if arrs is None else _batch(*arrs)


class BidGen(NexmarkGen):
    """Bid-only stream (q1, q2, q5, q11)."""

    def __call__(self, n: int, now_s: float) -> EventBatch:
        arrs = self._arrays(n, now_s)
        if arrs is None:
            _skewed(self.rng, 0, self.users)    # the reference's empty draw
            return EventBatch.empty()
        key, value, ts, kind = arrs
        kind[:] = BID
        key[:] = _skewed(self.rng, n, self.users)
        return _batch(key, value, ts, kind)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def _currency(batch: EventBatch) -> EventBatch:
    v = batch.value.clone()
    v[:, 0] = (v[:, 0].to(torch.int64) * 908 // 1000).to(torch.int32)
    return EventBatch(batch.key, v, batch.ts, batch.kind)


# q1/q2 run at 1/10th of the paper's 2.25M events/s with 10x the per-event
# CPU cost: identical busyness/parallelism dynamics.
RATE_SCALE_STATELESS = 10


def q1() -> Dataflow:
    """Currency conversion: one stateless Map."""
    f = Dataflow("q1")
    f.chain(SourceOp("source", BidGen()),
            MapOp("currency_map", _currency,
                  cpu_cost_us=2.2 * RATE_SCALE_STATELESS),
            SinkOp("sink"))
    return f


def q2() -> Dataflow:
    """Bid filter on auction id."""
    f = Dataflow("q2")
    f.chain(SourceOp("source", BidGen()),
            FilterOp("bid_filter", lambda b: b.value[:, 2] % 123 == 0,
                     cpu_cost_us=2.0 * RATE_SCALE_STATELESS),
            SinkOp("sink"))
    return f


def q3() -> Dataflow:
    """Incremental (unbounded) join of persons and auctions + two filters.
    Join state converges to a small set (~N_SELLERS entries)."""
    f = Dataflow("q3")
    f.chain(SourceOp("source", NexmarkGen()),
            FilterOp("person_filter",
                     lambda b: (b.kind != PERSON) | (b.value[:, 1] % 4 == 0),
                     cpu_cost_us=2.0),
            FilterOp("auction_filter",
                     lambda b: (b.kind != AUCTION) | (b.value[:, 1] % 3 == 0),
                     cpu_cost_us=2.0))
    join = JoinOp("incr_join", PERSON, AUCTION, window_s=None)
    join.cpu_cost_us = 3.0
    f.add(join, after="auction_filter")
    f.add(SinkOp("sink"), after="incr_join")
    return f


def q5() -> Dataflow:
    """Hot auctions: sliding-window count per auction (small state)."""
    f = Dataflow("q5")
    src = SourceOp("source", BidGen())
    key_by_auction = MapOp(
        "key_by_auction",
        lambda b: EventBatch(b.value[:, 2].to(torch.int64), b.value,
                             b.ts, b.kind),
        cpu_cost_us=1.0)
    agg = WindowAggOp("hot_auctions", size_s=10.0, slide_s=5.0)
    f.chain(src, key_by_auction, agg, SinkOp("sink"))
    return f


def q8() -> Dataflow:
    """Monitor new users: tumbling-window join of persons and auctions.
    Window-scoped keys make the working set large (memory-pressured)."""
    f = Dataflow("q8")
    # unskewed: q8's window-scoped join state churns every window, so its
    # working set is the full seller space (the memory-pressured case)
    src = SourceOp("source", NexmarkGen(mix=(10, 36, 0),
                                        sellers=N_SELLERS_Q8, skew=False))
    join = JoinOp("window_join", PERSON, AUCTION, window_s=30.0,
                  keyspace=N_SELLERS_Q8)
    join.cpu_cost_us = 3.0
    f.chain(src, join, SinkOp("sink"))
    return f


def q11() -> Dataflow:
    """User sessions: bids per user while active — update-heavy with a
    ~N_USERS working set (the paper's flagship hybrid-scaling case)."""
    f = Dataflow("q11")
    f.chain(SourceOp("source", BidGen()),
            SessionWindowOp("user_sessions", gap_s=30.0,
                            keyspace=N_ACTIVE_USERS),
            SinkOp("sink"))
    return f


QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q5": q5, "q8": q8, "q11": q11}

# Queries whose working set exceeds one memory level (§5).
MEMORY_PRESSURED = frozenset({"q8", "q11"})

# Per-query target rates (events/s), as in the reference.
TARGET_RATES = {"q1": 2_250_000 // RATE_SCALE_STATELESS,
                "q2": 2_250_000 // RATE_SCALE_STATELESS,
                "q3": 400_000, "q5": 120_000, "q8": 60_000, "q11": 60_000}
