"""Downtime pricing for a planned reconfiguration (port of
``repro.migration.costs``; pure host code).

Flink-style reconfiguration is a savepoint/stop/restore cycle: the job
pauses, state is written out and read back, and the paused seconds turn
into backlog the new configuration must drain.  Three mechanisms:

* ``instant``  — reconfiguration is free, as in the controller without a
  runtime.  A strict no-op (zero downtime, zero moved MB), kept as the
  default so the golden traces stay byte-identical.
* ``savepoint`` — full snapshot + restore.  Downtime is a fixed
  stop/redeploy overhead plus the WHOLE state footprint over the
  savepoint throughput: every reconfiguration pays for all state, moved
  or not — which is what makes churn-happy policies (threshold's
  doubling ratchet) pay for their extra steps.
* ``handoff``  — incremental LSM-level transfer (the engine's existing
  snapshot -> hash-partition -> ``bulk_load`` path: sorted runs move as
  runs, untouched tasks keep their stores).  Downtime is an epoch-barrier
  alignment plus only the MB that actually travels — so a memory-only
  adjustment (backend resize in place, no task relocated) is near-free
  while a parallelism change still pays for the re-shuffle.

Throughputs and fixed overheads are in paper-seconds (the controller's
``decision_window_s`` clock); the runtime converts to engine ticks via
``sim_time_scale`` like every other §5 duration.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.migration.planner import MigrationPlan

MECHANISMS = ("instant", "savepoint", "handoff")


@dataclass(frozen=True)
class ReconfigCost:
    """What one reconfiguration costs: paused paper-seconds and the MB of
    state that physically travelled (the budget arbiter's currency)."""
    mechanism: str
    downtime_s: float
    moved_mb: float                 # state that travelled
    total_mb: float                 # full footprint at the reconfig point

    @property
    def free(self) -> bool:
        return self.downtime_s <= 0.0


@dataclass(frozen=True)
class CostModel:
    """Calibrated mechanism parameters (paper-seconds / MB-per-second).

    Defaults follow the testbed the paper describes: a savepoint cycle
    redeploys pods (~30 s) and restores through object storage
    (~64 MB/s), while an incremental handoff only aligns an epoch
    barrier (~2 s) and streams runs TM-to-TM (~512 MB/s).
    """
    mechanism: str = "instant"
    savepoint_mb_per_s: float = 64.0
    handoff_mb_per_s: float = 512.0
    restart_s: float = 30.0          # stop + redeploy + restore fixed cost
    barrier_s: float = 2.0           # epoch-barrier alignment (handoff)

    def __post_init__(self) -> None:
        if self.mechanism not in MECHANISMS:
            raise ValueError(
                f"unknown reconfiguration mechanism {self.mechanism!r} "
                f"(have: {', '.join(MECHANISMS)})")

    def price(self, plan: MigrationPlan) -> ReconfigCost:
        """Downtime + moved MB for one planned reconfiguration."""
        if self.mechanism == "instant":
            return ReconfigCost("instant", 0.0, 0.0, plan.total_mb)
        if self.mechanism == "savepoint":
            total = plan.total_mb
            return ReconfigCost(
                "savepoint",
                self.restart_s + total / self.savepoint_mb_per_s,
                total, total)
        moved = plan.transfer_mb
        return ReconfigCost(
            "handoff",
            self.barrier_s + moved / self.handoff_mb_per_s,
            moved, plan.total_mb)
