"""Streaming operators (port of ``repro.streaming.operators``).

Stateless operators never touch the state backend (Justin strips their
managed memory — Takeaway 1); stateful operators access their per-task
``LSMStore`` with the read/write profile the paper's §3 microbenchmarks
characterize.  Batches and state live on the engine's device; warm-state
payloads are drawn from the engine's numpy rng on the host (the
reference's PCG64 stream) and moved over.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.state.lsm import LSMStore, make_store
from repro_torch.streaming.events import PAYLOAD_WORDS, EventBatch


class Operator:
    """Base: subclasses implement process(task_state, batch) -> out batch."""
    stateful = False
    cpu_cost_us = 1.0                   # per-event CPU service time component
    entry_bytes = 1000                  # logical state-entry size (§3: 1 KB)

    def __init__(self, name: str):
        self.name = name

    def make_state(self, memory_mb: float, seed: int = 0,
                   device=None) -> LSMStore | None:
        if not self.stateful:
            return None
        return make_store(memory_mb, value_words=PAYLOAD_WORDS,
                          entry_bytes=self.entry_bytes, seed=seed,
                          device=device)

    def process(self, state: LSMStore | None, batch: EventBatch) -> EventBatch:
        raise NotImplementedError

    def warm_state(self, state: LSMStore, rng: np.random.Generator) -> None:
        """Optional pre-population (paper §3 pre-populates every key)."""


class SourceOp(Operator):
    """Workload injector: emits up to ``rate`` events/s, subject to
    backpressure (paper: sources are excluded from the resource count).
    The generator returns a host batch; the engine moves it over."""
    cpu_cost_us = 0.2

    def __init__(self, name: str,
                 generator: Callable[[int, float], EventBatch]):
        super().__init__(name)
        self.generator = generator

    def emit(self, n: int, now_s: float) -> EventBatch:
        return self.generator(n, now_s)

    def process(self, state, batch):
        return batch


class MapOp(Operator):
    def __init__(self, name: str, fn: Callable[[EventBatch], EventBatch],
                 cpu_cost_us: float = 1.2):
        super().__init__(name)
        self.fn = fn
        self.cpu_cost_us = cpu_cost_us

    def process(self, state, batch):
        return self.fn(batch)


class FilterOp(Operator):
    def __init__(self, name: str,
                 pred: Callable[[EventBatch], torch.Tensor],
                 cpu_cost_us: float = 0.8):
        super().__init__(name)
        self.pred = pred
        self.cpu_cost_us = cpu_cost_us

    def process(self, state, batch):
        return batch.select(self.pred(batch))


class FlatMapOp(Operator):
    def __init__(self, name: str, fn: Callable[[EventBatch], EventBatch],
                 cpu_cost_us: float = 1.5):
        super().__init__(name)
        self.fn = fn
        self.cpu_cost_us = cpu_cost_us

    def process(self, state, batch):
        return self.fn(batch)


class SinkOp(Operator):
    cpu_cost_us = 0.5

    def __init__(self, name: str = "sink"):
        super().__init__(name)
        self.received = 0

    def process(self, state, batch):
        self.received += len(batch)
        return EventBatch.empty(device=batch.device)


class KeyedStateOp(Operator):
    """§3 microbenchmark operator: one state access per event."""
    stateful = True
    cpu_cost_us = 2.0

    def __init__(self, name: str, mode: str, keyspace: int = 1_000_000,
                 prepopulate: bool = True):
        super().__init__(name)
        if mode not in ("read", "write", "update"):
            raise ValueError(f"unknown KeyedStateOp mode {mode!r}")
        self.mode = mode
        self.keyspace = keyspace
        self.prepopulate = prepopulate

    def warm_state(self, state: LSMStore, rng: np.random.Generator) -> None:
        if not self.prepopulate:
            return
        keys = torch.arange(self.keyspace, dtype=torch.int64,
                            device=state.device)
        vals = rng.integers(0, 2**31 - 1, (self.keyspace, PAYLOAD_WORDS),
                            dtype=np.int64).astype(np.int32)
        state.bulk_load(keys, torch.from_numpy(vals).to(state.device))
        state.metrics.reset()

    def process(self, state: LSMStore, batch: EventBatch) -> EventBatch:
        if self.mode == "read":
            vals, _ = state.get_batch(batch.key)
            out = batch.value + vals[:, :batch.value.shape[1]]
            return EventBatch(batch.key, out.to(torch.int32), batch.ts,
                              batch.kind)
        if self.mode == "write":
            state.put_batch(batch.key, batch.value)
            return batch
        vals, _ = state.get_batch(batch.key)           # update = read + write
        new = (vals + batch.value).to(torch.int32)
        state.put_batch(batch.key, new)
        return EventBatch(batch.key, new, batch.ts, batch.kind)


class WindowAggOp(Operator):
    """Keyed tumbling/sliding window aggregation (count/sum).

    State key = (key, window_id); each event is a read-modify-write.
    Sliding windows touch size/slide window ids per event.
    """
    stateful = True
    cpu_cost_us = 2.5
    entry_bytes = 500                    # window aggregates are small records

    def __init__(self, name: str, size_s: float, slide_s: float | None = None,
                 emit: bool = True):
        super().__init__(name)
        self.size_s = size_s
        self.slide_s = slide_s or size_s
        self.emit = emit
        self._watermark = 0.0

    def _state_key(self, keys, window_id):
        return keys * (1 << 20) + (window_id % (1 << 20))

    def process(self, state: LSMStore, batch: EventBatch) -> EventBatch:
        if len(batch) == 0:
            return EventBatch.empty(device=batch.device)
        # compaction filter: drop windows older than the retention horizon
        ts_max = float(batch.ts.max())
        wm = int(ts_max // self.size_s)
        state.compact_filter = \
            lambda keys, w=wm: (keys % (1 << 20)) >= max(0, w - 4)
        n_windows = max(1, int(round(self.size_s / self.slide_s)))
        outs = []
        for w in range(n_windows):
            wid = torch.floor_divide(batch.ts - w * self.slide_s,
                                     self.size_s).to(torch.int64)
            sk = self._state_key(batch.key, wid)
            vals, _ = state.get_batch(sk)
            vals[:, 0] += 1                             # count
            vals[:, 1] = (vals[:, 1] + batch.value[:, 0]).to(torch.int32)
            state.put_batch(sk, vals)
            if w == 0:
                outs.append(EventBatch(batch.key, vals, batch.ts, batch.kind))
        self._watermark = max(self._watermark, ts_max)
        if not self.emit:
            return EventBatch.empty(device=batch.device)
        # emit current aggregates for closed-ish windows (downstream load)
        return outs[0]


class SessionWindowOp(Operator):
    """q11: per-user session tracking — update-heavy, working set = active
    users (the memory-pressured operator where Justin's scale-up wins)."""
    stateful = True
    cpu_cost_us = 3.0
    entry_bytes = 500                    # session records are small

    def __init__(self, name: str, gap_s: float = 10.0,
                 keyspace: int = 1_000_000):
        super().__init__(name)
        self.gap_s = gap_s
        self.keyspace = keyspace

    def warm_state(self, state: LSMStore, rng: np.random.Generator) -> None:
        dev = state.device
        state.bulk_load(torch.arange(self.keyspace, dtype=torch.int64,
                                     device=dev),
                        torch.zeros((self.keyspace, PAYLOAD_WORDS),
                                    dtype=torch.int32, device=dev))
        state.metrics.reset()

    def process(self, state: LSMStore, batch: EventBatch) -> EventBatch:
        if len(batch) == 0:
            return EventBatch.empty(device=batch.device)
        vals, found = state.get_batch(batch.key)
        last_ts = vals[:, 0].to(torch.float64)
        expired = (batch.ts - last_ts) > self.gap_s
        emitted = batch.select(expired & found)          # closed sessions
        vals[:, 0] = torch.clamp(batch.ts, max=2**30).to(torch.int32)
        vals[:, 1] = torch.where(expired, 1, vals[:, 1] + 1)  # bids/session
        state.put_batch(batch.key, vals)
        return emitted


class JoinOp(Operator):
    """Two-sided keyed join.  Events with kind==left_kind are stored and
    probe the right side (and vice versa).  ``window_s`` scopes state
    keys by tumbling window id (q8); otherwise the join is incremental and
    unbounded (q3)."""
    stateful = True
    cpu_cost_us = 3.0
    entry_bytes = 500                    # join-side records are small

    def __init__(self, name: str, left_kind: int, right_kind: int,
                 window_s: float | None = None, keyspace: int = 0):
        super().__init__(name)
        self.left_kind = left_kind
        self.right_kind = right_kind
        self.window_s = window_s
        self.keyspace = keyspace         # pre-populated steady-state size

    def warm_state(self, state, rng: np.random.Generator) -> None:
        """Steady-state pre-population: both sides of the live window(s)."""
        if not self.keyspace:
            return
        wids = (0, 1) if self.window_s is not None else (None,)
        all_keys, all_vals = [], []
        for side in (0, 1):
            for wid in wids:
                keys = np.arange(self.keyspace, dtype=np.int64) * 4 + side
                if wid is not None:
                    keys = keys * np.int64(1 << 16) + wid
                vals = rng.integers(0, 2**31 - 1,
                                    (self.keyspace, PAYLOAD_WORDS),
                                    dtype=np.int64).astype(np.int32)
                all_keys.append(keys)
                all_vals.append(vals)
        dev = state.device
        state.bulk_load(torch.from_numpy(np.concatenate(all_keys)).to(dev),
                        torch.from_numpy(np.concatenate(all_vals)).to(dev))
        state.metrics.reset()

    def _skey(self, keys, ts, side: int) -> torch.Tensor:
        k = keys * 4 + side
        if self.window_s is not None:
            wid = torch.floor_divide(ts, self.window_s).to(torch.int64)
            k = k * (1 << 16) + (wid % (1 << 16))
        return k

    def process(self, state: LSMStore, batch: EventBatch) -> EventBatch:
        if len(batch) == 0:
            return EventBatch.empty(device=batch.device)
        if self.window_s is not None:
            wm = int(float(batch.ts.max()) // self.window_s)
            state.compact_filter = \
                lambda keys, w=wm: (keys % (1 << 16)) >= max(0, w - 2)
        left = batch.kind == self.left_kind
        right = batch.kind == self.right_kind
        out = []
        for mask, mine, other in ((left, 0, 1), (right, 1, 0)):
            if not bool(mask.any()):
                continue
            sub = batch.select(mask)
            d = state.put_batch(self._skey(sub.key, sub.ts, mine), sub.value)
            if d is not None:
                # probe keys are the put keys shifted by a constant (the
                # side bit is below the window bits), so the put batch's
                # delta decomposition doubles as the probe's sorted-unique
                # hint; the legacy store returns no decomposition
                shift = (other - mine) * ((1 << 16) if self.window_s
                                          is not None else 1)
                vals, found = state.get_batch(
                    self._skey(sub.key, sub.ts, other),
                    uhint=(d[0] + shift, d[1]))
            else:
                vals, found = state.get_batch(
                    self._skey(sub.key, sub.ts, other))
            if bool(found.any()):
                joined = sub.select(found)
                out.append(EventBatch(joined.key, vals[found], joined.ts,
                                      joined.kind))
        return EventBatch.concat(out) if out else \
            EventBatch.empty(device=batch.device)
