"""Fault & straggler injection schedules (port of
``repro.scenarios.faults``, on the port's engine hooks).

Each fault names an engine hook and a firing time (sim-seconds).  The
schedule applies everything due at decision-window boundaries — the
granularity at which the controller can observe the damage, matching how
the paper's testbed loses whole TaskManagers between observations.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.streaming.engine import StreamEngine


@dataclass(frozen=True)
class KillTask:
    """Lose a task's state and queue at time ``t`` (TM failure)."""
    t: float
    op: str
    idx: int = 0

    def apply(self, engine: StreamEngine) -> None:
        engine.kill_task(self.op, self.idx)


@dataclass(frozen=True)
class SetStraggler:
    """Slow one task by ``factor`` at time ``t``; a finite ``duration_s``
    schedules the automatic recovery (factor back to 1)."""
    t: float
    op: str
    idx: int = 0
    factor: float = 10.0
    duration_s: float | None = None

    def apply(self, engine: StreamEngine) -> None:
        engine.set_straggler(self.op, self.idx, self.factor)

    def recovery(self) -> "SetStraggler | None":
        if self.duration_s is None:
            return None
        return SetStraggler(self.t + self.duration_s, self.op, self.idx, 1.0)


@dataclass
class FaultSchedule:
    """Ordered fault list; ``apply_due(engine, now)`` fires everything with
    ``t <= now`` once and returns what fired (recoveries auto-enqueued)."""
    faults: list = field(default_factory=list)

    def __post_init__(self):
        pending = list(self.faults)
        for f in self.faults:
            rec = getattr(f, "recovery", lambda: None)()
            if rec is not None:
                pending.append(rec)
        self._pending = sorted(pending, key=lambda f: f.t)

    def apply_due(self, engine: StreamEngine, now: float) -> list:
        fired = []
        while self._pending and self._pending[0].t <= now:
            f = self._pending.pop(0)
            f.apply(engine)
            fired.append(f)
        return fired

    @property
    def pending(self) -> list:
        return list(self._pending)


def parse_fault(spec: str) -> KillTask | SetStraggler:
    """CLI shorthand: ``kill:T:op[:idx]`` or
    ``straggle:T:op[:idx[:factor[:duration]]]``."""
    parts = spec.split(":")
    kind, t, op = parts[0], float(parts[1]), parts[2]
    idx = int(parts[3]) if len(parts) > 3 else 0
    if kind == "kill":
        return KillTask(t, op, idx)
    if kind == "straggle":
        factor = float(parts[4]) if len(parts) > 4 else 10.0
        duration = float(parts[5]) if len(parts) > 5 else None
        return SetStraggler(t, op, idx, factor, duration)
    raise ValueError(f"unknown fault kind {kind!r} in {spec!r}")
