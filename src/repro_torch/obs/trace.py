"""Deterministic span tracer for the control loop (port of
``repro.obs.trace``; pure host code).

Every window phase — engine step, ``should_trigger``/``propose``/
``commit``, admission quote + arbitration, migration plan/charge/paused
catch-up, LSM flush/compact/probe totals — can record a :class:`Span`.
Spans are stamped with SIM time (``engine.now``) plus a monotone sequence
counter, never the wall clock, so a traced episode is a pure function of
(seed, inputs) and the four golden traces stay byte-identical with
tracing on or off.

Determinism contract:

* ``record`` on a disabled tracer is a single attribute check (O(1));
  ``NULL_TRACER`` is the shared disabled instance the controller falls
  back to.
* ``record`` never reads engine RNG or mutates anything a decision
  reads; span ``args`` are copied into fresh dicts at record time.
* The one wall-clock read lives behind ``self_profile=True`` and flows
  ONLY into ``overhead_s`` (how much wall time tracing itself cost).
  Decision modules call ``record`` only as a discarded expression
  statement, so no value returned here reaches a decision.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

# span categories — the same schema as the reference tracer's
CATS = ("window", "engine", "policy", "admission", "migration", "lsm",
        "preempt")


@dataclass
class Span:
    """One traced phase: a ``[t0, t1]`` sim-time interval with a payload."""
    seq: int                    # monotone per-tracer record index
    name: str                   # phase, e.g. "policy.propose"
    cat: str                    # one of CATS
    t0: float                   # sim seconds (engine.now at phase start)
    t1: float                   # sim seconds (>= t0)
    tenant: str = ""            # "" for single-tenant episodes
    window: int | None = None   # decision-window index when known
    args: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "name": self.name, "cat": self.cat,
                "t0": self.t0, "t1": self.t1, "tenant": self.tenant,
                "window": self.window, "args": self.args}


class Tracer:
    """Collects :class:`Span` records; disabled path is O(1).

    ``self_profile=True`` additionally measures the wall-clock overhead
    of tracing itself into ``overhead_s`` — the only ``time`` read in
    this module, and it never leaves the tracer.
    """

    def __init__(self, enabled: bool = True, self_profile: bool = False):
        self.enabled = enabled
        self.self_profile = self_profile
        self.spans: list[Span] = []
        self.overhead_s = 0.0
        self._seq = 0

    def record(self, name: str, cat: str, t0: float, t1: float,
             tenant: str = "", window: int | None = None,
             args: dict | None = None) -> None:
        """Record one span.  Decision modules call this as a bare
        statement only — the return value is always None."""
        if not self.enabled:
            return
        wall = time.perf_counter() if self.self_profile else None
        self.spans.append(Span(self._seq, name, cat, float(t0), float(t1),
                               tenant, window,
                               dict(args) if args else {}))
        self._seq += 1
        if wall is not None:
            self.overhead_s += time.perf_counter() - wall

    def clear(self) -> None:
        self.spans = []
        self._seq = 0
        self.overhead_s = 0.0

    def summary(self) -> dict[str, dict]:
        """Per-(tenant, cat, name) aggregate: span count and total sim
        duration."""
        agg: dict[str, dict] = {}
        for s in self.spans:
            key = f"{s.tenant}|{s.cat}|{s.name}"
            a = agg.get(key)
            if a is None:
                agg[key] = {"count": 1, "sim_s": s.t1 - s.t0}
            else:
                a["count"] += 1
                a["sim_s"] += s.t1 - s.t0
        return agg


# shared disabled instance: `tracer or NULL_TRACER` keeps every call site
# unconditional while the disabled record stays a single attribute check
NULL_TRACER = Tracer(enabled=False)
