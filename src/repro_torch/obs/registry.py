"""Unified metrics registry: counters / gauges / histograms / timers
(port of ``repro.obs.registry``; pure host code).

One snapshot API over every number the repo used to scatter: the
per-store ``LSMMetrics`` totals, the engine's per-task cost EWMAs, and
the fleet drivers' audit totals (``absorb_engine`` / ``absorb_fleet``
pull them in).  Benchmarks time through :meth:`MetricsRegistry.timer`
instead of ad-hoc ``time.time()`` reads, so benchmarks and traces
report from one clock path.

Disabled path is O(1): a disabled registry hands out one shared no-op
instrument, so instrumented code needs no ``if enabled`` guards.  Like
``obs.trace``, the wall clock lives only here (timers) — decision modules
never construct or read a registry.
"""
from __future__ import annotations

import time


class Counter:
    """Monotone count."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins level."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Streaming count/total/min/max — enough for rates and spreads
    without holding samples."""
    __slots__ = ("count", "total", "vmin", "vmax")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Timer(Histogram):
    """A histogram of wall-clock laps, usable as a context manager:

        with reg.timer("episode") as t:
            run()
        print(t.s)          # last lap, seconds

    ``total`` accumulates across laps — the registry's one clock path.
    """
    __slots__ = ("_t0", "last_s")

    def __init__(self):
        super().__init__()
        self._t0 = None
        self.last_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last_s = time.perf_counter() - self._t0
        self._t0 = None
        self.observe(self.last_s)
        return False

    @property
    def s(self) -> float:
        return self.last_s

    @property
    def us(self) -> float:
        return self.last_s * 1e6


class _Noop:
    """Shared do-nothing instrument a disabled registry hands out."""
    __slots__ = ()
    value = 0
    count = 0
    total = 0.0
    mean = 0.0
    s = 0.0
    us = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class MetricsRegistry:
    """Name -> instrument, with one ``snapshot()`` over everything."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._timers: dict[str, Timer] = {}

    def _get(self, table, name, ctor):
        if not self.enabled:
            return _NOOP
        inst = table.get(name)
        if inst is None:
            inst = table[name] = ctor()
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def timer(self, name: str) -> Timer:
        return self._get(self._timers, name, Timer)

    # -------------------------------------------------------------- absorb
    def absorb_engine(self, engine, prefix: str = "engine") -> None:
        """Pull the engine's observable totals behind the snapshot API:
        per-operator LSM store counters (reads/writes/hits/probes/
        flushes/compactions) summed over tasks, and the per-task cost
        EWMAs the charge model calibrates."""
        for name in sorted(engine.tasks):
            reads = writes = hits = misses = probes = 0
            flushes = compactions = 0
            stateful = False
            for i, tr in enumerate(engine.tasks[name]):
                if tr.cost_per_event is not None:
                    self.gauge(f"{prefix}.task.{name}.{i}.cost_per_event"
                               ).set(tr.cost_per_event)
                if tr.state is None:
                    continue
                stateful = True
                m = tr.state.metrics
                reads += m.reads
                writes += m.writes
                hits += m.cache_hits + m.memtable_hits
                misses += m.cache_misses
                probes += m.level_probes
                f, c = m.maintenance()
                flushes += f
                compactions += c
            if not stateful:
                continue
            g = f"{prefix}.lsm.{name}"
            self.gauge(f"{g}.reads").set(reads)
            self.gauge(f"{g}.writes").set(writes)
            self.gauge(f"{g}.hits").set(hits)
            self.gauge(f"{g}.misses").set(misses)
            self.gauge(f"{g}.level_probes").set(probes)
            self.gauge(f"{g}.flushes").set(flushes)
            self.gauge(f"{g}.compactions").set(compactions)

    def absorb_fleet(self, result, prefix: str = "fleet") -> None:
        """Fleet-driver audit totals (denials / deferrals / preemptions /
        policy steps / downtime) from a ``run_colocated`` result."""
        denied = deferred = preempted = steps = 0
        downtime = moved = 0.0
        for t in result.tenants:
            denied += len(t.denials)
            deferred += len(t.deferrals)
            preempted += len(t.preemptions)
            steps += t.scaler.steps
            for h in t.scaler.history:
                downtime += h.reconfig_downtime
                moved += h.moved_mb
        self.counter(f"{prefix}.tenants").inc(len(result.tenants))
        self.counter(f"{prefix}.denied_windows").inc(denied)
        self.counter(f"{prefix}.deferred_windows").inc(deferred)
        self.counter(f"{prefix}.preempted_windows").inc(preempted)
        self.counter(f"{prefix}.policy_steps").inc(steps)
        self.gauge(f"{prefix}.reconfig_downtime_s").set(downtime)
        self.gauge(f"{prefix}.moved_mb").set(moved)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """Everything, JSON-ready, sorted by name."""
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: {"count": h.count, "total": h.total,
                               "min": h.vmin, "max": h.vmax,
                               "mean": h.mean}
                           for k, h in sorted(self._histograms.items())},
            "timers": {k: {"count": t.count, "total_s": t.total,
                           "min_s": t.vmin, "max_s": t.vmax,
                           "mean_s": t.mean}
                       for k, t in sorted(self._timers.items())},
        }


NULL_REGISTRY = MetricsRegistry(enabled=False)
