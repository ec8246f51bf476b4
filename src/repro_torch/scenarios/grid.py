"""Policy × profile × query evaluation grid.

Runs every registered scaling policy (``repro_torch.core.policy``; ds2, justin,
static, threshold out of the box) × {rate profiles} × {queries} through
``run_scenario`` and reduces each episode to its SLO scorecard
(``scenarios.metrics``): steps to converge, SLO-violation count, worst
catch-up time, and the CPU/memory resource-time integrals — the axes
Daedalus/Phoebe-style evaluations compare autoscalers on, and the ones the
paper's "fewer total cluster resources" claim lives on.

Port of ``repro.scenarios.grid``.  :func:`grid_markdown` renders a grid
as README-ready tables: one all-policies cell table plus the
ds2-vs-justin savings comparison when both are present.

``admission=<mode>`` adds a **co-location section**
(:func:`run_colocation`): per query, the ds2/justin pair competing on one
shared-TM cluster under the chosen admission mode.  Its savings table
carries the admission-aware-placement axes — per-tenant amortized-memory
integrals (base_mb amortized across co-resident TMs), a preemption column
(forced give-backs suffered), and the shared-fleet vs
sum-of-private-fleets memory saving.

``reconfig_cost`` (``instant``/``savepoint``/``handoff``) makes every
episode PAY for its reconfigurations (``repro_torch.migration``): cells
gain downtime windows / paused seconds / moved-MB columns and
:func:`reconfig_markdown` renders the headline comparison.
``migration_budget_mb`` caps the state MB co-location admissions may move
per window (deferrals reuse the denial/retry path).
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.core.policy import available_policies
from repro_torch.data.nexmark import QUERIES
from repro_torch.scenarios.metrics import DEFAULT_SLACK, slo_report
from repro_torch.scenarios.runner import run_scenario

PROFILES = ("constant", "ramp", "spike", "diurnal", "sinusoid", "step")
# the pair the savings comparison (and the paper's Fig. 5) is built on
BASELINE, CONTENDER = "ds2", "justin"


def run_colocation(queries=None, admission: str = "preemption", *,
                   windows: int = 5, seed: int = 3, max_level: int = 2,
                   cpu_slots: int = 0, memory_mb: float = 0.0,
                   slack: float = DEFAULT_SLACK,
                   reconfig_cost: str = "instant",
                   migration_budget_mb: float | None = None,
                   driver: str = "vectorized",
                   verbose: bool = True, device=None) -> list[dict]:
    """Per query: the ds2/justin pair competing on ONE shared-TM cluster
    under ``admission`` (ds2 is the higher-priority tenant, so under
    ``"preemption"`` its denied scale-outs may reclaim the justin
    neighbor's storage levels).  ``cpu_slots``/``memory_mb`` of 0 auto-size
    the budget from the pair's initial placements (2x the slots, 1.5x the
    memory — room to grow, but contended).  Returns one cell per query
    with per-tenant SLO scorecards (incl. amortized-MB integrals and
    preemption counts) plus the shared-vs-private memory saving.  The
    engines run on ``device`` (``cuda`` unless ``device="cpu"``)."""
    device = resolve_device(device)
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.justin import JustinParams
    from repro_torch.core.placement import (default_tm_spec,
                                            placement_for_config)
    from repro_torch.core.policy import make_policy
    from repro_torch.scenarios.cluster import (Cluster, ColocatedSpec,
                                               run_colocated)
    queries = list(queries or QUERIES)
    cells = []
    for qname in queries:
        cfg = ControllerConfig(justin=JustinParams(max_level=max_level))
        specs = [ColocatedSpec(BASELINE, qname, name="hi"),
                 ColocatedSpec(CONTENDER, qname, name="lo")]
        # auto-size from the pair's initial private footprints — straight
        # placement quotes over the query's starting config, no engines
        flow = QUERIES[qname]()
        cpu0, mem0 = 0, 0.0
        for pol in (BASELINE, CONTENDER):
            quote = placement_for_config(
                make_policy(pol, cfg).resources_config(flow.config()),
                base_mem_mb=cfg.base_mem_mb,
                exclude=set(flow.sources()))
            cpu0 += quote.cpu_cores
            mem0 += quote.memory_mb
        slots = cpu_slots or 2 * cpu0
        mem = memory_mb or 1.5 * mem0
        cluster = Cluster(slots, mem,
                          tm_spec=default_tm_spec(cfg.base_mem_mb))
        res = run_colocated(specs, cluster, windows=windows, seed=seed,
                            admission=admission, cfg=cfg,
                            reconfig_cost=reconfig_cost,
                            migration_budget_mb=migration_budget_mb,
                            driver=driver, device=device)
        # both integrals quote the config running during each window:
        # private fleets vs the tenant's amortized shared-TM attribution
        shared_mb_w = sum(t.slo(slack).amortized_mb_windows
                          for t in res.tenants)
        private_mb_w = sum(t.slo(slack).mb_windows for t in res.tenants)
        cell = {"query": qname, "admission": admission,
                "cluster": {"cpu_slots": slots, "memory_mb": mem,
                            "shared_tm": True},
                "reconfig_cost": reconfig_cost,
                "migration_budget_mb": migration_budget_mb,
                "tenants": {t.name: {
                    "policy": t.spec.policy,
                    "denied": len(t.denials),
                    "preempted": len(t.preemptions),
                    "deferred": len(t.deferrals),
                    "slo": t.slo(slack).to_dict()} for t in res.tenants},
                "shared_mb_windows": shared_mb_w,
                "private_mb_windows": private_mb_w,
                "shared_mem_saving": 1 - shared_mb_w
                / max(private_mb_w, 1e-9)}
        mig = cluster.migration_total()
        cell["migration"] = {"tasks_moved": mig.tasks_moved,
                             "state_mb": mig.state_mb}
        cells.append(cell)
        if verbose:
            ten = cell["tenants"]
            print(f"{qname:4s} colocated {admission:10s} "
                  f"denied={[ten[n]['denied'] for n in ten]} "
                  f"preempted={[ten[n]['preempted'] for n in ten]} "
                  f"shared_saving={cell['shared_mem_saving']:.0%}",
                  flush=True)
    return cells


def run_grid(queries=None, profiles=None, policies=None, *,
             windows: int = 8, seed: int = 3, max_level: int = 2,
             slack: float = DEFAULT_SLACK, verbose: bool = True,
             admission: str | None = None, windows_colocated: int = 5,
             cluster_slots: int = 0, cluster_mb: float = 0.0,
             reconfig_cost: str = "instant",
             migration_budget_mb: float | None = None,
             driver: str = "vectorized", device=None) -> dict:
    """Run the full grid; returns ``{"cells": [...], "meta": {...}}`` where
    each cell is one (policy, query, profile) episode's summary + SLO
    scorecard.  ``policies`` defaults to every registered policy.  With
    ``admission`` set, a ``"colocation"`` section is added (see
    :func:`run_colocation`).

    ``reconfig_cost`` selects the reconfiguration mechanism every episode
    pays (``instant`` — the free default — or ``savepoint``/``handoff``;
    see ``repro_torch.migration``): cells then carry downtime-window counts,
    total paused seconds and the moved-MB integral in their scorecards.
    ``migration_budget_mb`` caps the state MB the co-location arbiter
    lets admissions move per window (requires ``admission``).  The
    engines run on ``device`` (``cuda`` unless ``device="cpu"``)."""
    device = resolve_device(device)
    queries = list(queries or QUERIES)
    profiles = list(profiles or PROFILES)
    policies = list(policies or available_policies())
    cells = []
    for qname in queries:
        for prof in profiles:
            for policy in policies:
                res = run_scenario(policy, qname, prof, windows=windows,
                                   seed=seed, max_level=max_level,
                                   reconfig_cost=reconfig_cost,
                                   device=device)
                rep = slo_report(res.history, slack)
                cell = {"policy": policy, "query": qname, "profile": prof,
                        "steps": res.steps,
                        "final_cpu": res.final.cpu_cores,
                        "final_mem": res.final.memory_mb,
                        "slo": rep.to_dict()}
                cells.append(cell)
                if verbose:
                    cu = rep.catch_up_s
                    print(f"{qname:4s} {prof:8s} {policy:9s} "
                          f"steps={res.steps} viol={rep.violations} "
                          f"catchup={'-' if cu is None else f'{cu:.0f}s'} "
                          f"cpu_w={rep.cpu_slot_windows} "
                          f"mb_w={rep.mb_windows:,.0f} "
                          f"down_w={rep.downtime_windows}", flush=True)
    out = {"cells": cells,
           "meta": {"queries": queries, "profiles": profiles,
                    "policies": list(policies), "windows": windows,
                    "seed": seed, "max_level": max_level, "slack": slack,
                    "admission": admission,
                    "reconfig_cost": reconfig_cost,
                    "migration_budget_mb": migration_budget_mb}}
    if admission is not None:
        out["colocation"] = run_colocation(
            queries, admission, windows=windows_colocated, seed=seed,
            max_level=max_level, cpu_slots=cluster_slots,
            memory_mb=cluster_mb, slack=slack,
            reconfig_cost=reconfig_cost,
            migration_budget_mb=migration_budget_mb, driver=driver,
            verbose=verbose, device=device)
    return out


def grid_cell(grid: dict, policy: str, query: str,
              profile: str) -> dict | None:
    """The (policy, query, profile) cell of a ``run_grid`` result, or
    None."""
    for c in grid["cells"]:
        if (c["policy"], c["query"], c["profile"]) == (policy, query,
                                                       profile):
            return c
    return None


def comparison_rows(grid: dict) -> list[dict]:
    """One row per (query, profile): ds2 vs justin on every SLO axis, plus
    the resource-integral savings justin achieved.  Empty when the grid
    was run without the ds2/justin pair."""
    rows = []
    for q in grid["meta"]["queries"]:
        for prof in grid["meta"]["profiles"]:
            d = grid_cell(grid, BASELINE, q, prof)
            j = grid_cell(grid, CONTENDER, q, prof)
            if d is None or j is None:
                continue
            row = {"query": q, "profile": prof}
            for tag, c in ((BASELINE, d), (CONTENDER, j)):
                row[f"{tag}_steps"] = c["steps"]
                row[f"{tag}_viol"] = c["slo"]["violations"]
                row[f"{tag}_catchup_s"] = c["slo"]["catch_up_s"]
                row[f"{tag}_cpu_w"] = c["slo"]["cpu_slot_windows"]
                row[f"{tag}_mb_w"] = c["slo"]["mb_windows"]
            row["cpu_w_saving"] = 1 - row["justin_cpu_w"] \
                / max(row["ds2_cpu_w"], 1)
            row["mb_w_saving"] = 1 - row["justin_mb_w"] \
                / max(row["ds2_mb_w"], 1e-9)
            rows.append(row)
    return rows


def _fmt_catchup(v) -> str:
    return "-" if v is None else f"{v:.0f}s"


def cells_markdown(grid: dict) -> str:
    """Every (query, profile, policy) cell as one table row — works for any
    policy set, which is what ``--grid`` runs by default."""
    out = ["| query | profile | policy | steps | SLO viol | catch-up | "
           "CPU-slot-w | MB-w |",
           "|" + "---|" * 8]
    for q in grid["meta"]["queries"]:
        for prof in grid["meta"]["profiles"]:
            for pol in grid["meta"]["policies"]:
                c = grid_cell(grid, pol, q, prof)
                if c is None:
                    continue
                s = c["slo"]
                out.append(
                    f"| {q} | {prof} | {pol} | {c['steps']} "
                    f"| {s['violations']} | {_fmt_catchup(s['catch_up_s'])} "
                    f"| {s['cpu_slot_windows']} | {s['mb_windows']:,.0f} |")
    return "\n".join(out)


def colocation_markdown(cells: list[dict]) -> str:
    """The co-location savings table: per tenant the denials/preemptions/
    budget-deferrals and both memory integrals (private quote vs
    amortized shared-TM attribution), per cell the shared-fleet saving
    over private fleets."""
    out = ["| query | admission | tenant | policy | denied | preempted | "
           "deferred | recovered | MB-w private | MB-w amortized | "
           "shared saving |",
           "|" + "---|" * 11]
    for c in cells:
        for name, t in c["tenants"].items():
            s = t["slo"]
            out.append(
                f"| {c['query']} | {c['admission']} | {name} "
                f"| {t['policy']} | {t['denied']} | {t['preempted']} "
                f"| {t.get('deferred', 0)} "
                f"| {s['recovered']} | {s['mb_windows']:,.0f} "
                f"| {s['amortized_mb_windows']:,.0f} "
                f"| {c['shared_mem_saving']:.0%} |")
    return "\n".join(out)


def reconfig_markdown(grid: dict) -> str:
    """The reconfiguration-cost headline table: per (query, profile,
    policy) the price of churn under the grid's mechanism — steps taken,
    windows paused by a reconfiguration, total paused paper-seconds, and
    the state MB moved.  This is where a churn-happy policy (threshold's
    doubling ratchet) pays for its extra reconfigurations in downtime
    while justin's fewer steps win, and where ``handoff`` makes
    memory-only adjustments near-free."""
    mech = grid["meta"].get("reconfig_cost", "instant")
    out = [f"Reconfiguration cost (mechanism: `{mech}`)", "",
           "| query | profile | policy | steps | downtime windows | "
           "downtime s | moved MB |",
           "|" + "---|" * 7]
    for q in grid["meta"]["queries"]:
        for prof in grid["meta"]["profiles"]:
            for pol in grid["meta"]["policies"]:
                c = grid_cell(grid, pol, q, prof)
                if c is None:
                    continue
                s = c["slo"]
                out.append(
                    f"| {q} | {prof} | {pol} | {c['steps']} "
                    f"| {s['downtime_windows']} | {s['downtime_s']:,.0f} "
                    f"| {s['moved_mb']:,.0f} |")
    return "\n".join(out)


def grid_markdown(grid: dict) -> str:
    """Render the grid as GitHub-flavored markdown: the all-policies cell
    table, plus the ds2-vs-justin savings comparison when both ran."""
    parts = [cells_markdown(grid)]
    if grid["meta"].get("reconfig_cost", "instant") != "instant":
        parts.append(reconfig_markdown(grid))
    if grid.get("colocation"):
        parts.append(colocation_markdown(grid["colocation"]))
    rows = comparison_rows(grid)
    if rows:
        head = ("| query | profile | steps d/j | SLO viol d/j | "
                "catch-up d/j | CPU-slot-w d/j | MB-w d/j | "
                "CPU saving | MEM saving |")
        sep = "|" + "---|" * 9
        out = [head, sep]
        for r in rows:
            out.append(
                f"| {r['query']} | {r['profile']} "
                f"| {r['ds2_steps']}/{r['justin_steps']} "
                f"| {r['ds2_viol']}/{r['justin_viol']} "
                f"| {_fmt_catchup(r['ds2_catchup_s'])}"
                f"/{_fmt_catchup(r['justin_catchup_s'])} "
                f"| {r['ds2_cpu_w']}/{r['justin_cpu_w']} "
                f"| {r['ds2_mb_w']:,.0f}/{r['justin_mb_w']:,.0f} "
                f"| {r['cpu_w_saving']:.0%} | {r['mb_w_saving']:.0%} |")
        parts.append("\n".join(out))
    return "\n\n".join(parts)
