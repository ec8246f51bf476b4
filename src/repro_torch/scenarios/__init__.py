"""Scenario vocabulary for autoscaling experiments.

Declarative rate profiles (constant, ramp, spike, diurnal, sinusoid, step),
fault/straggler injection schedules, and a ``run_scenario`` driver that runs
a policy against a Nexmark query under a time-varying workload and returns
the controller history — the Daedalus/Phoebe-style dynamic evaluations the
paper's fixed-rate protocol doesn't cover.  Port of ``repro.scenarios``:
host logic over the port's engines, which run on ``device`` (``cuda``
unless ``device="cpu"`` is passed).

On top of the single-episode driver sit three layers:

* ``metrics`` — SLO scorecards over controller histories (violation
  windows, catch-up time, p95 backlog, resource-time integrals);
* ``cluster`` — a shared finite ``Cluster`` budget plus ``run_colocated``,
  stepping N (policy, query, profile) episodes in lockstep with per-window
  admission arbitration (priority / fair_share / first_come / preemption),
  with a vectorized structure-of-arrays fleet driver (and the original
  scalar loop as its decision-identical oracle);
* ``population`` — fleet-scale tenant sampling (heavy-tailed rates,
  staggered diurnal phases, flash crowds, faults) plus ``run_fleet``;
* ``grid`` — the {policy} × {profile} × {query} evaluation grid.
"""
from repro_torch.scenarios.cluster import (ADMISSION_POLICIES, DRIVERS,
                                           Cluster, ColocatedResult,
                                           ColocatedSpec, TenantRun,
                                           run_colocated)
from repro_torch.scenarios.faults import (FaultSchedule, KillTask,
                                          SetStraggler, parse_fault)
from repro_torch.scenarios.grid import (colocation_markdown, comparison_rows,
                                        grid_markdown, run_colocation,
                                        run_grid)
from repro_torch.scenarios.metrics import (CatchUp, SLOReport,
                                           amortized_mb_windows,
                                           catch_up_episodes, catch_up_time_s,
                                           p95_backlog, resource_integrals,
                                           slo_report, violation_windows)
from repro_torch.scenarios.population import (PopulationSpec, fleet_cfg,
                                              fleet_stats, run_fleet,
                                              sample_population, size_cluster)
from repro_torch.scenarios.profiles import (Constant, Diurnal, Profile, Ramp,
                                            Sinusoid, Spike, Step,
                                            make_profile)
from repro_torch.scenarios.runner import ScenarioResult, run_scenario

__all__ = [
    "Constant", "Diurnal", "Profile", "Ramp", "Sinusoid", "Spike", "Step",
    "make_profile", "FaultSchedule", "KillTask", "SetStraggler",
    "parse_fault", "ScenarioResult", "run_scenario",
    "CatchUp", "SLOReport", "catch_up_episodes", "catch_up_time_s",
    "p95_backlog", "resource_integrals", "slo_report", "violation_windows",
    "amortized_mb_windows",
    "ADMISSION_POLICIES", "DRIVERS", "Cluster", "ColocatedResult",
    "ColocatedSpec", "TenantRun", "run_colocated",
    "PopulationSpec", "fleet_cfg", "fleet_stats", "run_fleet",
    "sample_population", "size_cluster",
    "colocation_markdown", "comparison_rows", "grid_markdown",
    "run_colocation", "run_grid",
]
