"""Justin's hybrid elastic-scaling policy — Algorithm 1 of the paper,
implemented verbatim over the DS2 proposal.  Port of
``repro.core.justin``; pure host code.

Per stateful operator o_i with a DS2 rescale proposal:
  * if it was scaled up last time (v^{t-1}):
      - improvement (θ↑ or τ↓)?  keep p, scale up again (until maxLevel)
      - no improvement?           roll the memory back, keep DS2's p
  * else: memory pressure (θ < Δθ or τ > Δτ) and headroom?  cancel the
    scale-out, scale up instead.
Stateless operators get m = ⊥ (no managed memory) — Takeaway 1.

Symbol map (paper → code):

=============  ==========================================================
paper          here
=============  ==========================================================
θ (theta)      effective in-memory hit rate of an operator's state reads
               (fraction that never probed an on-"disk" LSM level);
               computed per window in ``StreamEngine.collect`` from the
               LSM counters, read by the policy as ``metrics[op]["theta"]``
               — the §4.2 storage-performance signal
τ (tau)        mean state-access latency in ms over the window
               (``metrics[op]["tau_ms"]``), θ's companion signal
Δθ, Δτ         pressure thresholds (``JustinParams.delta_theta`` /
               ``delta_tau_ms``): θ below Δθ or τ above Δτ ⇒ the operator
               is memory-pressured (Algorithm 1 line 16)
m, maxLevel    the memory-level ladder: level ℓ grants base·2^ℓ MB of
               managed memory per task (``engine.level_mb``; base 158 MB,
               §5 testbed), capped at ``JustinParams.max_level``; ⊥
               (``None``) = no managed memory for stateless operators
v^t            ``OperatorDecision.scaled_up`` — "this window's decision
               was a memory scale-up", consulted at t+1 (line 7)
C^t            the per-operator ``(parallelism, memory_level)`` map the
               controller enacts (``AutoScaler._propose``)
footnote 3     ``JustinParams.hysteresis``: a scale-up must improve θ/τ
               by this relative margin to count (line 8), else line 14
               rolls the level back
=============  ==========================================================
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class JustinParams:
    delta_theta: float = 0.80        # Δθ: cache hit rate threshold
    delta_tau_ms: float = 1.0        # Δτ: state access latency threshold
    max_level: int = 3               # memory levels (0 => base grant)
    hysteresis: float = 0.10         # min relative improvement (footnote 3):
                                     # below this a scale-up "did not improve"
                                     # and is rolled back (Algorithm 1 l.14)


@dataclass
class OperatorDecision:
    parallelism: int
    memory_level: int | None        # None == ⊥
    scaled_up: bool = False          # v^t


@dataclass
class JustinState:
    """Decision history C^0..C^{t-1} plus last-window metrics."""
    prev_config: dict[str, OperatorDecision] = field(default_factory=dict)
    prev_metrics: dict[str, dict] = field(default_factory=dict)


def justin_policy(flow, metrics: dict[str, dict], ds2_p: dict[str, int],
                  state: JustinState, params: JustinParams = JustinParams()
                  ) -> dict[str, OperatorDecision]:
    """Algorithm 1.  Returns the new configuration C^t."""
    out: dict[str, OperatorDecision] = {}
    for name, m in metrics.items():
        p_new = ds2_p.get(name, m["parallelism"])
        prev = state.prev_config.get(
            name, OperatorDecision(m["parallelism"],
                                   m["memory_level"], False))
        prev_m = state.prev_metrics.get(name, m)

        if not m["stateful"]:                          # line 3-4
            out[name] = OperatorDecision(p_new, None, False)
            continue

        m_prev = prev.memory_level if prev.memory_level is not None else 0
        dec = OperatorDecision(p_new, m_prev, False)

        if p_new != prev.parallelism:                  # line 6: insufficient
            theta, tau = m.get("theta"), m.get("tau_ms")
            theta_p = prev_m.get("theta")
            tau_p = prev_m.get("tau_ms")
            if prev.scaled_up:                         # line 7
                improved = _improved(theta, tau, theta_p, tau_p,
                                     params.hysteresis)
                if improved and (m_prev + 1) < params.max_level:  # line 8-9
                    dec.parallelism = prev.parallelism  # line 10: cancel out
                    dec.memory_level = m_prev + 1       # line 11
                    dec.scaled_up = True                # line 12
                elif not improved:                      # line 13
                    dec.memory_level = max(0, m_prev - 1)  # line 14 rollback
            else:                                      # line 16
                pressure = ((theta is not None and theta < params.delta_theta)
                            or (tau is not None and tau > params.delta_tau_ms))
                if pressure and (m_prev + 1) < params.max_level:
                    dec.parallelism = prev.parallelism  # line 17: cancel out
                    dec.memory_level = m_prev + 1       # line 18
                    dec.scaled_up = True                # line 19
        out[name] = dec
    return out


def _improved(theta, tau, theta_prev, tau_prev, eps: float) -> bool:
    """Line 8: θ^t > θ^{t-1} or τ^t < τ^{t-1}, with hysteresis (footnote 3)."""
    if theta is not None and theta_prev is not None \
            and theta > theta_prev * (1 + eps):
        return True
    if tau is not None and tau_prev is not None \
            and tau < tau_prev * (1 - eps):
        return True
    return False


def commit(state: JustinState, config: dict[str, OperatorDecision],
           metrics: dict[str, dict]) -> None:
    state.prev_config = dict(config)
    state.prev_metrics = dict(metrics)
