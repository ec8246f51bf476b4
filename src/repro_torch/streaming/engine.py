"""Discrete-time streaming executor (port of ``repro.streaming.engine``).

Events are *really processed* (real LSM state on the device, real
vectorized operator compute); only wall-clock is modeled: each task has a
per-tick time budget and each processed chunk charges ``events x cpu_cost
+ measured state latency`` against it.  The charges come from the LSM's
modeled latency counters, not from the clock, so the port reaches the
reference's decisions exactly on any device.  Budget, EWMA and metric
arithmetic stay Python float64 on the host in the reference's order.

Mechanics (see the reference module for the full contract): hash
partitioning of keyed streams onto an operator's tasks, bounded
inter-operator queues with backpressure, busyness per window (DS2's
signal), θ/τ from each task's LSM metrics (Justin's signals),
epoch-barrier snapshots, and reconfiguration with state re-partitioning
(scale out/in) and backend resize (scale up/down).

The engine runs on ``device`` (``cuda`` unless ``device="cpu"`` is
passed; with neither given nor available it raises).  Source batches are
drawn on the host and moved to the device once; every store and every
batch downstream lives there.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.sorted_probe.ops import probe
from repro_torch.state.lsm import get_store_impl, stable_argsort_keys
from repro_torch.streaming.events import EventBatch, hash_partition
from repro_torch.streaming.graph import Dataflow
from repro_torch.streaming.operators import (JoinOp, Operator, SourceOp,
                                             WindowAggOp)

BASE_MEM_MB = 158.0                  # default managed memory per slot (§5)


def level_mb(level: int | None, base_mb: float = BASE_MEM_MB) -> float:
    """Justin memory levels: level x doubles the base grant; ⊥ -> 0."""
    return 0.0 if level is None else base_mb * (2 ** level)


def state_partition_keys(op: Operator, state_keys: torch.Tensor
                         ) -> torch.Tensor:
    """Recover the event key a state entry belongs to (for re-partitioning).
    ``//`` on int64 tensors floors, as numpy's does."""
    if isinstance(op, WindowAggOp):
        return state_keys // (1 << 20)
    if isinstance(op, JoinOp):
        k = state_keys
        if op.window_s is not None:
            k = k // (1 << 16)
        return k // 4
    return state_keys


def _partition_bounds(part: torch.Tensor, p: int
                      ) -> tuple[torch.Tensor, list[int]]:
    """(stable order by partition id, per-partition slice bounds on the
    host).  The stable sort keeps the original relative order within each
    partition."""
    order = torch.sort(part, stable=True).indices
    edges = torch.arange(p + 1, dtype=part.dtype, device=part.device)
    bounds = probe(part[order], edges)[0].tolist()
    return order, bounds


def _partition_groups(part: torch.Tensor, p: int):
    """Yield per-partition index tensors in one O(n log n) pass."""
    order, bounds = _partition_bounds(part, p)
    for i in range(p):
        yield order[bounds[i]:bounds[i + 1]]


@dataclass
class TaskRuntime:
    queue: deque = field(default_factory=deque)
    queued_events: int = 0
    state: object = None             # LSMStore | None
    busy_s: float = 0.0
    processed: int = 0
    slowdown: float = 1.0            # straggler injection factor
    cost_per_event: float | None = None   # EWMA of measured s/event (incl.
                                          # slowdown); None until calibrated


@dataclass
class OpWindowStats:
    """Metrics over one observation window (reset on collect)."""
    in_events: int = 0
    out_events: int = 0
    processed: int = 0
    busy_s: float = 0.0
    task_time_s: float = 0.0
    blocked: bool = False
    cache_hits: int = 0
    cache_misses: int = 0
    level_probes: int = 0
    reads: int = 0
    writes: int = 0
    latency_ms: float = 0.0


class StreamEngine:
    def __init__(self, flow: Dataflow, *, tick_s: float = 1.0,
                 chunk_events: int = 2048, queue_cap_events: int = 200_000,
                 base_mem_mb: float = BASE_MEM_MB, seed: int = 0,
                 warm: bool = True, device=None):
        self.device = resolve_device(device)
        self.flow = flow
        self.tick_s = tick_s
        self.chunk = chunk_events
        self.queue_cap = queue_cap_events
        self.base_mem_mb = base_mem_mb
        self.rng = np.random.default_rng(seed)
        self.now = 0.0
        self.topo = flow.topo_order()
        self.tasks: dict[str, list[TaskRuntime]] = {}
        self.stats: dict[str, OpWindowStats] = {}
        self._lsm_marks: dict[tuple[str, int], tuple] = {}
        self._down = {n: flow.downstream(n) for n in self.topo}
        self._over: dict[str, int] = {}   # tasks per op with queue over cap
        self.source_emitted = 0
        self.source_target_rate = 0.0
        for name in self.topo:
            self._init_op(name, warm=warm)

    # ------------------------------------------------------------- lifecycle
    def _make_state(self, node, mb: float, seed: int):
        return node.op.make_state(mb, seed=seed, device=self.device)

    def _init_op(self, name: str, *, warm: bool,
                 snapshots: list[dict] | None = None) -> None:
        node = self.flow.nodes[name]
        p = node.parallelism
        tasks = []
        for i in range(p):
            tr = TaskRuntime()
            if node.op.stateful:
                mb = level_mb(node.memory_level, self.base_mem_mb)
                tr.state = self._make_state(node, mb, i)
            tasks.append(tr)
        self.tasks[name] = tasks
        self.stats[name] = OpWindowStats()
        self._over[name] = 0
        if node.op.stateful:
            if snapshots is not None:
                self._load_state(name, snapshots)
            elif warm:
                self._warm(name)
        for i, tr in enumerate(tasks):
            if tr.state is not None:
                self._lsm_marks[(name, i)] = tr.state.metrics.counters()

    def _warm(self, name: str) -> None:
        node = self.flow.nodes[name]
        # build the full keyspace once, partition onto tasks
        tmp = self._make_state(node, 64.0, 123)
        node.op.warm_state(tmp, self.rng)
        keys, vals = tmp.items()
        if len(keys) == 0:
            return
        self._install_partitions(name, [{"keys": keys, "vals": vals}])

    def _install_partitions(self, name: str, sources: list[dict]) -> None:
        """Distribute state snapshots onto the op's tasks.

        Per source (keys already sorted), one stable sort by destination
        partition keeps each destination slice key-sorted; per
        destination, the per-source slices are merged by one stable sort
        over their concatenation (ties resolve in source order).  Each
        task gets its merged partition as one installed run plus a cache
        prewarm over the partition in original arrival order (per-source
        ascending positions, sources in order), so the shared rng draws
        exactly as the reference's.  Under the legacy store
        (``state.lsm.set_store_impl("legacy")``) the pre-columnar
        installer runs instead."""
        if get_store_impl() == "legacy":
            self._install_partitions_lexsort(name, sources)
            return
        node = self.flow.nodes[name]
        p = len(self.tasks[name])
        dev = self.device
        dk = [[] for _ in range(p)]          # key-sorted run fragments
        dw = [[] for _ in range(p)]
        dv = [[] for _ in range(p)]
        for s in sources:
            keys = torch.as_tensor(s["keys"], dtype=torch.int64, device=dev)
            if not len(keys):
                continue
            vals = torch.as_tensor(s["vals"], dtype=torch.int32, device=dev)
            w = s.get("weights")
            w = torch.ones(len(keys), dtype=torch.int64, device=dev) \
                if w is None else torch.as_tensor(w, dtype=torch.int64,
                                                  device=dev)
            part = hash_partition(state_partition_keys(node.op, keys), p)
            order, bounds = _partition_bounds(part, p)
            for i in range(p):
                # stable sort on partition only => each slice is in
                # original arrival order, so the install fragment doubles
                # as the prewarm fragment
                if bounds[i + 1] == bounds[i]:
                    continue
                sl = order[bounds[i]:bounds[i + 1]]
                dk[i].append(keys[sl])
                dw[i].append(w[sl])
                dv[i].append(vals[sl])
        for i in range(p):
            tr = self.tasks[name][i]
            if dk[i]:
                if len(dk[i]) == 1:
                    mk, mw, mv = dk[i][0], dw[i][0], dv[i][0]
                else:
                    mk = torch.cat(dk[i])
                    mw = torch.cat(dw[i])
                    mv = torch.cat(dv[i])
                # arrival order (before the key sort) feeds the prewarm
                wk, wv = mk, mv
                if len(mk) > 1 and (len(dk[i]) > 1
                                    or bool((mk[1:] < mk[:-1]).any())):
                    o = stable_argsort_keys(mk)
                    mk, mw, mv = mk[o], mw[o], mv[o]
                tr.state.install_run(mk, mv, mw)
                tr.state.prewarm_cache(wk, wv, self.rng)
            tr.state.metrics.reset()

    def _install_partitions_lexsort(self, name: str,
                                    sources: list[dict]) -> None:
        """The pre-columnar installer (the reference's one global
        ``np.lexsort((keys, part))``), run with the frozen legacy store so
        the two backends are compared like for like (store and install
        path together).  The lexsort is a stable sort by key, then a
        stable sort by partition; each task's run is installed without
        weights and its cache prewarmed over the run in original order."""
        node = self.flow.nodes[name]
        dev = self.device
        keys = torch.cat([torch.as_tensor(s["keys"], dtype=torch.int64,
                                          device=dev) for s in sources])
        vals = torch.cat([torch.as_tensor(s["vals"], dtype=torch.int32,
                                          device=dev) for s in sources])
        p = len(self.tasks[name])
        part = hash_partition(state_partition_keys(node.op, keys), p)
        by_key = stable_argsort_keys(keys)
        order, bounds = _partition_bounds(part[by_key], p)
        srt = by_key[order]                      # by partition, then key
        for i in range(p):
            tr = self.tasks[name][i]
            if bounds[i + 1] > bounds[i]:
                run = srt[bounds[i]:bounds[i + 1]]
                tr.state.install_run(keys[run], vals[run])
                sl = torch.sort(run).values      # original order
                tr.state.prewarm_cache(keys[sl], vals[sl], self.rng)
            tr.state.metrics.reset()

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> dict:
        """Epoch-barrier snapshot of all operator state + clock."""
        snap = {"now": self.now, "source_emitted": self.source_emitted,
                "ops": {}}
        for name, tasks in self.tasks.items():
            if self.flow.nodes[name].op.stateful:
                snap["ops"][name] = [t.state.snapshot() for t in tasks]
        return snap

    def restore(self, snap: dict) -> None:
        self.now = snap["now"]
        self.source_emitted = snap["source_emitted"]
        for name in self.topo:
            if name in snap["ops"]:
                self._init_op(name, warm=False, snapshots=snap["ops"][name])

    def _load_state(self, name: str, snapshots: list[dict]) -> None:
        sources = [s for s in snapshots if len(s["keys"])]
        if sources:
            self._install_partitions(name, sources)

    # -------------------------------------------------------- reconfiguration
    def reconfigure(self, new_config: dict[str, tuple[int, int | None]]
                    ) -> None:
        """Apply C^t: scale out/in re-partitions state; scale up/down resizes
        the state backend (both incur a cold cache)."""
        for name, (p, lvl) in new_config.items():
            node = self.flow.nodes[name]
            p_old, lvl_old = node.parallelism, node.memory_level
            lvl = lvl if node.op.stateful else None
            if p == p_old and lvl == lvl_old:
                continue
            snaps = None
            if node.op.stateful:
                snaps = [t.state.snapshot() for t in self.tasks[name]]
            node.parallelism = p
            node.memory_level = lvl
            self._init_op(name, warm=False, snapshots=snaps)

    # ---------------------------------------------------------- fault hooks
    def kill_task(self, name: str, idx: int) -> None:
        """Simulate a task/TM loss: its state and queue are gone."""
        node = self.flow.nodes[name]
        tr = TaskRuntime()
        if node.op.stateful:
            tr.state = self._make_state(
                node, level_mb(node.memory_level, self.base_mem_mb), idx)
            self._lsm_marks[(name, idx)] = tr.state.metrics.counters()
        self.tasks[name][idx] = tr
        self._over[name] = sum(t.queued_events > self.queue_cap
                               for t in self.tasks[name])

    def set_straggler(self, name: str, idx: int, factor: float) -> None:
        self.tasks[name][idx].slowdown = factor

    # ------------------------------------------------------------- execution
    def _queued_delta(self, name: str, tr: TaskRuntime, delta: int) -> None:
        """Adjust a task's queued-event count, maintaining the per-op
        over-capacity counter ``_downstream_room`` reads."""
        if delta == 0:
            return
        was_over = tr.queued_events > self.queue_cap
        tr.queued_events += delta
        if (tr.queued_events > self.queue_cap) != was_over:
            self._over[name] += -1 if was_over else 1

    def _emit(self, name: str, out: EventBatch) -> None:
        if len(out) == 0:
            return
        for d in self._down[name]:
            dn = self.flow.nodes[d]
            if dn.op.stateful:
                part = hash_partition(out.key, dn.parallelism)
                for i, sl in enumerate(
                        _partition_groups(part, dn.parallelism)):
                    if len(sl):
                        sub = out.select(sl)
                        t = self.tasks[d][i]
                        t.queue.append(sub)
                        self._queued_delta(d, t, len(sub))
            else:                                   # rebalance round-robin
                # stable: the assignment must depend on task index, not on
                # sort-algorithm internals
                order = np.argsort([t.queued_events for t in self.tasks[d]],
                                   kind="stable")
                # same contiguous ranges np.array_split produces, as views
                q, r = divmod(len(out), dn.parallelism)
                lo = 0
                for j, i in enumerate(order):
                    hi = lo + q + (1 if j < r else 0)
                    if hi > lo:
                        sub = out.slice(lo, hi)
                        t = self.tasks[d][i]
                        t.queue.append(sub)
                        self._queued_delta(d, t, len(sub))
                    lo = hi
            self.stats[d].in_events += len(out)

    def _downstream_room(self, name: str) -> bool:
        for d in self._down[name]:
            if self._over[d]:
                return False
        return True

    def _take(self, name: str, tr: TaskRuntime, n: int) -> EventBatch:
        """Pop up to ``n`` events off the head batch of a task queue; a
        partially-consumed batch's remainder returns to the queue head.
        Deliberately does NOT coalesce across queued-batch boundaries."""
        b = tr.queue.popleft()
        if len(b) > n:
            b, rest = b.split(n)
            tr.queue.appendleft(rest)
        self._queued_delta(name, tr, -len(b))
        return b

    def _charge(self, name: str, idx: int) -> float:
        """State-latency delta (s) since the last mark for this task —
        O(1) scalar counter reads."""
        tr = self.tasks[name][idx]
        if tr.state is None:
            return 0.0
        mt = tr.state.metrics
        r0, w0, h0, m0, p0, l0 = self._lsm_marks[(name, idx)]
        st = self.stats[name]
        st.reads += mt.reads - r0
        st.writes += mt.writes - w0
        st.cache_hits += mt.cache_hits - h0
        st.cache_misses += mt.cache_misses - m0
        st.level_probes += mt.level_probes - p0
        d_lat = mt.access_latency_total_ms - l0
        st.latency_ms += d_lat
        self._lsm_marks[(name, idx)] = mt.counters()
        return d_lat / 1e3

    def _source_emit(self, name: str, target_rate: float) -> EventBatch:
        op = self.flow.nodes[name].op
        out = op.emit(int(target_rate * self.tick_s), self.now)
        return out.to(self.device)

    def run_tick(self, target_rate: float) -> None:
        self.source_target_rate = target_rate
        for name in self.topo:
            node = self.flow.nodes[name]
            op = node.op
            st = self.stats[name]
            if isinstance(op, SourceOp):
                if self._downstream_room(name):
                    out = self._source_emit(name, target_rate)
                    self.source_emitted += len(out)
                    st.in_events += len(out)
                    st.out_events += len(out)
                    st.processed += len(out)
                    # source busyness: proportional to emitted volume
                    per_task = len(out) * op.cpu_cost_us * 1e-6 \
                        / node.parallelism
                    for tr in self.tasks[name]:
                        tr.busy_s += min(per_task, self.tick_s)
                    self._emit(name, out)
                else:
                    st.blocked = True
                st.task_time_s += self.tick_s * node.parallelism
                continue

            room = self._downstream_room(name)
            for idx, tr in enumerate(self.tasks[name]):
                budget = self.tick_s
                while budget > 0 and tr.queue and room:
                    # coalesce queued batches into one vectorized process
                    # call sized by the task's measured per-event cost;
                    # takes are chunk-quantized and never target more than
                    # a third of the tick (the reference's profile)
                    if tr.cost_per_event is None:    # calibration take
                        n_take = self.chunk
                    else:
                        plan = int(min(budget, self.tick_s / 3)
                                   / tr.cost_per_event)
                        n_take = max(self.chunk, plan // self.chunk
                                     * self.chunk)
                    batch = self._take(name, tr, n_take)
                    out = op.process(tr.state, batch)
                    cost = (len(batch) * op.cpu_cost_us * 1e-6
                            + self._charge(name, idx))
                    cost *= tr.slowdown
                    per = cost / len(batch)
                    tr.cost_per_event = per if tr.cost_per_event is None \
                        else 0.5 * tr.cost_per_event + 0.5 * per
                    budget -= cost
                    tr.busy_s += cost
                    tr.processed += len(batch)
                    st.processed += len(batch)
                    st.out_events += len(out)
                    self._emit(name, out)
                st.busy_s += min(self.tick_s, self.tick_s - budget) \
                    if budget < self.tick_s else self.tick_s - budget
                st.task_time_s += self.tick_s
                if not room:
                    st.blocked = True
            # straggler mitigation: re-balance stateless task queues
            if not op.stateful and node.parallelism > 1:
                self._rebalance(name)
        self.now += self.tick_s

    def _rebalance(self, name: str) -> None:
        tasks = self.tasks[name]
        loads = np.array([t.queued_events for t in tasks])
        if loads.max() > 4 * max(1, np.median(loads)) + self.chunk:
            src = tasks[int(loads.argmax())]
            dst = tasks[int(loads.argmin())]
            move = len(src.queue) // 2
            for _ in range(move):
                b = src.queue.pop()
                self._queued_delta(name, src, -len(b))
                dst.queue.append(b)
                self._queued_delta(name, dst, len(b))

    def run(self, seconds: float, target_rate: float) -> None:
        for _ in range(int(round(seconds / self.tick_s))):
            self.run_tick(target_rate)

    def run_paused(self, seconds: float, target_rate: float) -> None:
        """Reconfiguration downtime: sources keep producing until
        backpressure blocks them, but NO operator processes, so arrivals
        accrue as queued backlog the resumed configuration must drain."""
        for _ in range(int(round(seconds / self.tick_s))):
            for name in self.topo:
                node = self.flow.nodes[name]
                st = self.stats[name]
                st.task_time_s += self.tick_s * node.parallelism
                if isinstance(node.op, SourceOp):
                    if self._downstream_room(name):
                        out = self._source_emit(name, target_rate)
                        self.source_emitted += len(out)
                        st.in_events += len(out)
                        st.out_events += len(out)
                        st.processed += len(out)
                        self._emit(name, out)
                    else:
                        st.blocked = True
            self.now += self.tick_s

    # --------------------------------------------------------------- metrics
    def collect(self, reset: bool = True) -> dict[str, dict]:
        out = {}
        for name in self.topo:
            node = self.flow.nodes[name]
            st = self.stats[name]
            dur = max(st.task_time_s / max(node.parallelism, 1), 1e-9)
            sops = st.reads + st.writes
            # θ: effective in-memory hit rate — the fraction of reads that
            # avoided the slow tier (memtable + block cache + bloom-filtered
            # negatives)
            theta = max(0.0, 1.0 - st.level_probes / st.reads) \
                if st.reads else None
            out[name] = {
                "stateful": node.op.stateful,
                "parallelism": node.parallelism,
                "memory_level": node.memory_level,
                "rate_in": st.in_events / dur,
                "rate_out": st.out_events / dur,
                "rate_processed": st.processed / dur,
                "busyness": st.busy_s / max(st.task_time_s, 1e-9),
                "busy_s": st.busy_s,
                "processed": st.processed,
                "selectivity": st.out_events / max(st.in_events, 1),
                "theta": theta,
                "tau_ms": (st.latency_ms / sops) if sops else None,
                "blocked": st.blocked,
                "backlog": sum(t.queued_events for t in self.tasks[name]),
            }
            if reset:
                self.stats[name] = OpWindowStats()
        return out
