"""``run_scenario`` — one policy, one query, one rate profile, optional
faults; returns the controller history plus scenario bookkeeping (port of
``repro.scenarios.runner``).

The profile's time axis is engine sim-seconds (``ControllerConfig`` maps one
decision window to ``decision_window_s x sim_time_scale`` of them, 12 by
default), so a scenario spanning W windows should shape its profile over
roughly ``W x 12`` seconds — ``scenario_horizon_s`` computes that.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch import resolve_device
from repro_torch.core.controller import (AutoScaler, ControllerConfig,
                                         HistoryRow)
from repro_torch.core.justin import JustinParams
from repro_torch.core.policy import make_policy
from repro_torch.data.nexmark import QUERIES, TARGET_RATES
from repro_torch.scenarios.faults import FaultSchedule
from repro_torch.scenarios.profiles import Profile, make_profile
from repro_torch.streaming.engine import StreamEngine


def scenario_horizon_s(cfg: ControllerConfig, windows: int) -> float:
    """Sim-seconds spanned by ``windows`` decision windows (excluding
    stabilization periods, which don't sample the profile)."""
    return windows * cfg.decision_window_s * cfg.sim_time_scale


@dataclass
class ScenarioResult:
    policy: str
    query: str
    history: list                    # HistoryRow per decision window
    faults_fired: list = field(default_factory=list)

    @property
    def steps(self) -> int:
        return self.history[-1].step if self.history else 0

    @property
    def final(self) -> HistoryRow:
        return self.history[-1]

    def recovered(self, slack: float = 0.97) -> bool:
        """Did the last window achieve its (time-varying) target?"""
        last = self.final
        return last.achieved_rate >= slack * last.target

    def slo(self, slack: float = 0.97, after_t: float = 0.0):
        """SLO scorecard for this episode (see ``scenarios.metrics``)."""
        from repro_torch.scenarios.metrics import slo_report
        return slo_report(self.history, slack, after_t)

    def summary(self) -> dict:
        last = self.final
        return {"policy": self.policy, "query": self.query,
                "steps": self.steps, "windows": len(self.history),
                "achieved_rate": last.achieved_rate, "target": last.target,
                "cpu_cores": last.cpu_cores, "memory_mb": last.memory_mb,
                "config": dict(last.config),
                "faults_fired": len(self.faults_fired),
                "recovered": self.recovered()}


def run_scenario(policy: str, query: str, profile: Profile | str,
                 *, faults: FaultSchedule | list | None = None,
                 windows: int = 8, seed: int = 3, max_level: int = 2,
                 cfg: ControllerConfig | None = None,
                 warm: bool = True,
                 reconfig_cost="instant",
                 tracer=None, tenant: str = "",
                 device=None) -> ScenarioResult:
    """Drive ``policy`` (any registered name — see
    ``repro_torch.core.policy.available_policies()``) on Nexmark ``query``
    under a time-varying ``profile`` (a :class:`Profile` or a named shape from
    ``make_profile``) with optional fault injection.

    Returns the full controller history: what Fig. 5 plots, but over a
    dynamic workload.  ``cfg`` is a template: its ``policy`` field is
    overridden from the ``policy`` argument.  ``reconfig_cost`` (a
    mechanism name or :class:`repro_torch.migration.CostModel`) prices every
    reconfiguration as paused downtime; the default ``"instant"`` keeps
    reconfiguration free, as the golden traces pin.  The engine runs on
    ``device`` (``cuda`` unless ``device="cpu"`` is passed).
    """
    device = resolve_device(device)
    cfg = cfg or ControllerConfig(policy=policy,
                                  justin=JustinParams(max_level=max_level))
    if cfg.policy != policy:
        cfg = dataclasses.replace(cfg, policy=policy)
    if isinstance(profile, str):
        profile = make_profile(profile, TARGET_RATES[query],
                               scenario_horizon_s(cfg, windows))
    if isinstance(faults, (list, tuple)):
        faults = FaultSchedule(list(faults))

    flow = QUERIES[query]()
    engine = StreamEngine(flow, seed=seed, warm=warm, device=device)
    from repro_torch.migration import CostModel, MigrationRuntime
    cost_model = reconfig_cost if isinstance(reconfig_cost, CostModel) \
        else CostModel(mechanism=reconfig_cost)
    migration = None if cost_model.mechanism == "instant" \
        else MigrationRuntime(cost_model)
    scaler = AutoScaler(engine, profile(0.0), cfg,
                        policy=make_policy(policy, cfg),
                        migration=migration, tracer=tracer)
    if tenant:
        scaler.tenant = tenant
    fired: list = []

    def hook(eng, w):
        if faults is not None:
            fired.extend(faults.apply_due(eng, eng.now))

    scaler.run(max_windows=windows, target_profile=profile,
               window_hook=hook)
    return ScenarioResult(policy=policy, query=query,
                          history=scaler.history, faults_fired=fired)
