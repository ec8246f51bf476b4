"""SLO metrics over controller histories (port of
``repro.scenarios.metrics``; pure host code).

The controller's ``HistoryRow`` series (one row per decision window) is the
raw signal Fig. 5 plots; this module reduces it to the quality-of-service
numbers the dynamic-autoscaling literature (Daedalus, Phoebe) compares
policies on:

* **violation windows** — windows whose achieved source rate fell below
  ``slack * target`` (the paper's 97% convergence criterion, applied per
  window instead of only at the end);
* **catch-up time** — after a violation onset (a spike, fault, or cold
  start), how long until the first window back above the slack line;
* **p95 backlog** — tail of the queued-event backlog series, the
  user-visible latency proxy;
* **resource-time integrals** — CPU-slot-windows and MB-windows, the
  "total cluster resources spent" axis on which Justin's hybrid scaling
  claims to beat DS2's CPU-only packages; on shared-TM clusters the
  amortized-MB integral prices each window at the tenant's attribution
  (base_mb split across co-residents) instead of a private fleet's quote;
* **admission outcomes** — denied windows (requests the cluster rejected)
  and preempted windows (forced memory give-backs suffered under
  ``admission="preemption"``);
* **reconfiguration cost** — downtime windows (windows whose
  reconfiguration paused the job), total paused paper-seconds, and the
  moved-MB integral (state that physically travelled), priced by the
  migration runtime (``repro_torch.migration``); all zero under the default
  ``instant`` mechanism.

Everything is computed from plain ``HistoryRow`` lists, so the same
functions serve single-episode scenarios, co-located cluster runs, and the
policy×profile evaluation grid.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

DEFAULT_SLACK = 0.97      # the paper's "supports the target rate" criterion


def violation_windows(history: list, slack: float = DEFAULT_SLACK
                      ) -> list[int]:
    """Indices of windows where achieved_rate < slack * target."""
    return [i for i, h in enumerate(history)
            if h.achieved_rate < slack * h.target]


@dataclass(frozen=True)
class CatchUp:
    """One violation episode: onset window through first recovered window.
    ``recovered_window is None`` means the episode never caught back up
    within the history (``duration_s`` then spans to the history's end)."""
    onset_window: int
    recovered_window: int | None
    duration_s: float

    @property
    def recovered(self) -> bool:
        return self.recovered_window is not None


def catch_up_episodes(history: list, slack: float = DEFAULT_SLACK,
                      after_t: float = 0.0) -> list[CatchUp]:
    """Group consecutive violation windows into episodes and measure each
    episode's catch-up time: sim-seconds from the first violating window's
    timestamp to the first subsequent window back above ``slack*target``.

    ``after_t`` restricts to episodes whose onset is at or after that time
    (e.g. pass the spike's t0 to exclude the cold-start transient).
    """
    bad = set(violation_windows(history, slack))
    episodes: list[CatchUp] = []
    i = 0
    while i < len(history):
        if i not in bad:
            i += 1
            continue
        if history[i].t < after_t:
            # an episode whose onset precedes after_t is excluded whole —
            # its tail must not re-enter as a fresh (truncated) episode
            while i < len(history) and i in bad:
                i += 1
            continue
        onset = i
        while i < len(history) and i in bad:
            i += 1
        if i < len(history):
            episodes.append(CatchUp(onset, i, history[i].t
                                    - history[onset].t))
        else:
            # still violating at the history's end: the violation persisted
            # through the last window, so the open-ended duration extends
            # one window past it — an episode spanning k windows never
            # scores better than a recovered episode spanning k windows
            episodes.append(CatchUp(onset, None, history[-1].t
                                    - history[onset].t
                                    + _mean_window_s(history)))
    return episodes


def _mean_window_s(history: list) -> float:
    """Mean decision-window spacing of a history (row timestamps are
    window-end times).  A single row carries no spacing information —
    its ``t`` is the episode's absolute start offset, NOT a window span,
    and returning it inflated a 1-window open-ended violation's catch-up
    to its onset time — so the spacing degrades to 0 rather than
    guessing."""
    if len(history) > 1:
        return (history[-1].t - history[0].t) / (len(history) - 1)
    return 0.0


def catch_up_time_s(history: list, slack: float = DEFAULT_SLACK,
                    after_t: float = 0.0) -> float | None:
    """Worst-case catch-up time across violation episodes (sim-seconds);
    ``None`` when the history has no violations after ``after_t``.  An
    episode still violating at the history's end counts with its open-ended
    duration — a policy that never recovers must not score better than one
    that recovers slowly."""
    eps = catch_up_episodes(history, slack, after_t)
    return max(e.duration_s for e in eps) if eps else None


def p95_backlog(history: list) -> float:
    """95th percentile of the queued-event backlog series (linear
    interpolation, no numpy dependency for a 3-line quantile)."""
    xs = sorted(h.backlog for h in history)
    if not xs:
        return 0.0
    pos = 0.95 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])


def resource_integrals(history: list) -> tuple[int, float]:
    """(CPU-slot-windows, MB-windows): resources held, summed over decision
    windows.  One row == one window, so the sums are discrete integrals of
    the Fig. 5 resource curves — the efficiency axis on which hybrid
    scaling's "fewer total cluster resources" claim is settled."""
    return (sum(h.cpu_cores for h in history),
            sum(h.memory_mb for h in history))


def amortized_mb_windows(history: list) -> float:
    """Amortized-MB-windows: the memory integral under shared-TM
    attribution (each window's ``amortized_mb`` — the tenant's managed
    grants plus its slot-proportional share of co-resident TMs' base
    memory).  Falls back to the private ``memory_mb`` for windows without
    an attribution (single-tenant histories, scalar-footprint clusters),
    so private and shared runs stay directly comparable."""
    return sum(h.memory_mb if getattr(h, "amortized_mb", None) is None
               else h.amortized_mb for h in history)


def reconfig_cost_totals(history: list) -> tuple[int, float, float]:
    """(downtime windows, total downtime paper-s, moved-MB integral):
    the reconfiguration-cost axes of a history.  A *downtime window* is a
    window whose reconfiguration paused the job (``reconfig_downtime``
    > 0) — churn-happy policies accumulate them even when each pause is
    short; the moved-MB integral is the total state that physically
    travelled.  All zero for histories run without a migration runtime
    (or under the ``instant`` mechanism)."""
    down = [getattr(h, "reconfig_downtime", 0.0) for h in history]
    return (sum(1 for d in down if d > 0), sum(down),
            sum(getattr(h, "moved_mb", 0.0) for h in history))


@dataclass(frozen=True)
class SLOReport:
    """Per-episode SLO scorecard; ``slo_report`` builds it."""
    windows: int
    violations: int                  # count of violating windows
    violation_windows: tuple         # their indices
    catch_up_s: float | None         # worst episode, None if no violations
    recovered: bool                  # above the slack line at the end
    p95_backlog: float
    cpu_slot_windows: int
    mb_windows: float
    amortized_mb_windows: float      # shared-TM attribution integral
                                     # (== mb_windows on private placements)
    denied_windows: int              # admission rejections (co-location)
    preempted_windows: int           # forced memory give-backs suffered
    downtime_windows: int            # windows whose reconfiguration paused
                                     # the job (migration runtime)
    downtime_s: float                # total paused paper-seconds
    moved_mb: float                  # state-moved integral across windows
    slack: float
    violations_by_reason: dict = field(default_factory=dict)
                                     # violating windows grouped by their
                                     # HistoryRow.reason (obs.provenance
                                     # enum): was the SLO missed while
                                     # steady, denied, deferred, shrunk,
                                     # or mid-reconfiguration?

    def to_dict(self) -> dict:
        d = asdict(self)
        d["violation_windows"] = list(d["violation_windows"])
        return d


def slo_report(history: list, slack: float = DEFAULT_SLACK,
               after_t: float = 0.0) -> SLOReport:
    """The full scorecard for one controller history."""
    bad = violation_windows(history, slack)
    cpu_w, mb_w = resource_integrals(history)
    down_w, down_s, moved = reconfig_cost_totals(history)
    by_reason: dict[str, int] = {}
    for i in bad:
        r = getattr(history[i], "reason", "steady")
        by_reason[r] = by_reason.get(r, 0) + 1
    last = history[-1] if history else None
    return SLOReport(
        windows=len(history),
        violations=len(bad),
        violation_windows=tuple(bad),
        catch_up_s=catch_up_time_s(history, slack, after_t),
        recovered=(last is not None
                   and last.achieved_rate >= slack * last.target),
        p95_backlog=p95_backlog(history),
        cpu_slot_windows=cpu_w,
        mb_windows=mb_w,
        amortized_mb_windows=amortized_mb_windows(history),
        denied_windows=sum(1 for h in history if h.denied),
        preempted_windows=sum(1 for h in history
                              if getattr(h, "preempted", False)),
        downtime_windows=down_w,
        downtime_s=down_s,
        moved_mb=moved,
        slack=slack,
        violations_by_reason={k: by_reason[k] for k in sorted(by_reason)})
