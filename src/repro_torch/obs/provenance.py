"""Decision provenance: structured *why* records for the control loop
(port of ``repro.obs.provenance``; pure host code).

Every :class:`~repro_torch.core.policy.Proposal` carries an
:class:`Explain` — the signal values that crossed (or didn't cross) the
policy's thresholds, per operator, with the action the policy took — and
every admission verdict carries an :func:`explain_admission` payload.

Deliberately PURE: no clocks, no RNG, no engine state — only arithmetic
over the metrics dicts the policies themselves read.

The per-window *reason* enum also lives here: ``HistoryRow.reason``
records why a window ended the way it did.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ds2 import true_rate_per_task
from repro_torch.core.justin import JustinParams, JustinState, _improved

# ------------------------------------------------------------------ reasons
# why a window ended the way it did (HistoryRow.reason); the fleet
# drivers upgrade denied -> deferred and steady -> shrunk in their
# end-of-window back-fill (the R304-blessed mutation point)
REASON_STEADY = "steady"              # no trigger
REASON_TRIGGERED = "triggered"        # triggered, but proposal == current
REASON_RECONFIGURED = "reconfigured"  # proposal admitted and enacted
REASON_DENIED = "denied"              # admission rejected the scale-up
REASON_DEFERRED = "deferred"          # denied on migration budget: queued
REASON_SHRUNK = "shrunk"              # preempted: forced memory give-back
REASONS = (REASON_STEADY, REASON_TRIGGERED, REASON_RECONFIGURED,
           REASON_DENIED, REASON_DEFERRED, REASON_SHRUNK)


def reason_counts(history) -> dict[str, int]:
    """``{reason: windows}`` over a history, sorted by reason name."""
    counts: dict[str, int] = {}
    for row in history:
        r = getattr(row, "reason", REASON_STEADY)
        counts[r] = counts.get(r, 0) + 1
    return {k: counts[k] for k in sorted(counts)}


# ------------------------------------------------------------------ explain
@dataclass(frozen=True)
class Explain:
    """Why a policy proposed what it proposed, with exact signal values.

    ``operators`` maps op name -> {"action": str, "signals": {...}}: the
    per-operator observation the action was computed from, in the same
    units the policy read them (rates in events/s, tau in ms, theta in
    [0, 1]).  ``thresholds`` holds the policy parameters the signals
    were compared against.
    """
    policy: str
    target: float
    thresholds: dict = field(default_factory=dict)
    operators: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"policy": self.policy, "target": self.target,
                "thresholds": dict(self.thresholds),
                "operators": {op: {"action": rec["action"],
                                   "signals": dict(rec["signals"])}
                              for op, rec in self.operators.items()}}


def _signals(m: dict) -> dict:
    """The observation subset every policy family reads."""
    return {"parallelism": m["parallelism"],
            "memory_level": m["memory_level"],
            "busyness": m["busyness"],
            "rate_in": m["rate_in"], "rate_out": m["rate_out"],
            "selectivity": m["selectivity"],
            "backlog": m["backlog"], "blocked": m["blocked"],
            "theta": m.get("theta"), "tau_ms": m.get("tau_ms")}


def explain_ds2(metrics: dict[str, dict], ds2_p: dict[str, int],
                target: float, cfg) -> Explain:
    """CPU-only DS2: per-operator true processing rate vs propagated
    target input rate decides the new parallelism."""
    ops = {}
    for name, m in metrics.items():
        p_new = ds2_p.get(name, m["parallelism"])
        sig = _signals(m)
        sig["true_rate_per_task"] = true_rate_per_task(m)
        sig["ds2_parallelism"] = p_new
        if p_new > m["parallelism"]:
            action = "scale_out"
        elif p_new < m["parallelism"]:
            action = "scale_in"
        else:
            action = "hold"
        ops[name] = {"action": action, "signals": sig}
    return Explain("ds2", target,
                   {"target_busyness": cfg.target_busyness,
                    "max_parallelism": cfg.max_parallelism}, ops)


def explain_justin(metrics: dict[str, dict], ds2_p: dict[str, int],
                   decisions: dict, state: JustinState, target: float,
                   params: JustinParams) -> Explain:
    """Algorithm 1 provenance: for each stateful operator, the theta/tau
    observations vs the pressure thresholds, the previous window's
    scale-up verdict, and which Algorithm-1 branch fired."""
    ops = {}
    for name, m in metrics.items():
        d = decisions[name]
        prev = state.prev_config.get(name)
        prev_m = state.prev_metrics.get(name, m)
        sig = _signals(m)
        sig["ds2_parallelism"] = ds2_p.get(name, m["parallelism"])
        if not m["stateful"]:
            action = "rescale" if d.parallelism != m["parallelism"] \
                else "hold"
            ops[name] = {"action": action, "signals": sig}
            continue
        prev_p = prev.parallelism if prev is not None else m["parallelism"]
        prev_lvl = (prev.memory_level if prev is not None
                    and prev.memory_level is not None
                    else (m["memory_level"] or 0))
        prev_up = prev.scaled_up if prev is not None else False
        sig["theta_prev"] = prev_m.get("theta")
        sig["tau_prev_ms"] = prev_m.get("tau_ms")
        sig["prev_scaled_up"] = prev_up
        sig["memory_level_prev"] = prev_lvl
        theta, tau = m.get("theta"), m.get("tau_ms")
        if sig["ds2_parallelism"] == prev_p:
            action = "hold"                          # line 6: sufficient
        elif prev_up:                                # line 7
            improved = _improved(theta, tau, sig["theta_prev"],
                                 sig["tau_prev_ms"], params.hysteresis)
            sig["improved"] = improved
            if d.scaled_up:
                action = "memory_scale_up_again"     # lines 8-12
            elif improved:
                action = "rescale"                   # improved, no headroom
            else:
                action = "rollback_memory"           # lines 13-14
        else:                                        # line 16
            pressure = ((theta is not None and theta < params.delta_theta)
                        or (tau is not None and tau > params.delta_tau_ms))
            sig["memory_pressure"] = pressure
            if d.scaled_up:
                action = "cancel_rescale_memory_up"  # lines 17-19
            else:
                action = "rescale" if not pressure else "rescale_at_max_level"
        ops[name] = {"action": action, "signals": sig}
    return Explain("justin", target,
                   {"delta_theta": params.delta_theta,
                    "delta_tau_ms": params.delta_tau_ms,
                    "max_level": params.max_level,
                    "hysteresis": params.hysteresis}, ops)


def explain_static(metrics: dict[str, dict], target: float) -> Explain:
    """Fixed allocation: every operator holds by construction."""
    return Explain("static", target, {},
                   {name: {"action": "hold", "signals": _signals(m)}
                    for name, m in metrics.items()})


def explain_threshold(flow, metrics: dict[str, dict], target: float,
                      cfg, scale_factor: float) -> Explain:
    """Dhalion-style symptom detection: which operators were hotter than
    ``busy_high`` (or, absent any, which was blamed as busiest)."""
    sources, sinks = set(flow.sources()), set(flow.sinks())
    scalable = [n for n in metrics
                if n not in sources and n not in sinks]
    hot = [n for n in scalable
           if metrics[n]["busyness"] > cfg.busy_high]
    blamed = []
    if not hot and scalable:
        blamed = [max(scalable, key=lambda n: metrics[n]["busyness"])]
    ops = {}
    for name, m in metrics.items():
        sig = _signals(m)
        sig["hot"] = name in hot
        if name in hot:
            action = "scale_out"
        elif name in blamed:
            action = "scale_out_blamed_busiest"
        else:
            action = "hold"
        ops[name] = {"action": action, "signals": sig}
    return Explain("threshold", target,
                   {"busy_high": cfg.busy_high,
                    "scale_factor": scale_factor,
                    "max_parallelism": cfg.max_parallelism}, ops)


def explain_admission(*, cpu_cur, mem_cur, cpu_new, mem_new, grows,
                      admitted, shared: bool) -> dict:
    """The admission verdict's provenance payload: what was quoted, did
    it grow the footprint, and did the arbiter let it through (None =
    no gate consulted: not growing, or no admission hook)."""
    return {"cpu_cur": cpu_cur, "mem_cur": mem_cur,
            "cpu_new": cpu_new, "mem_new": mem_new,
            "grows": grows, "admitted": admitted, "shared": shared}
