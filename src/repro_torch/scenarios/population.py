"""Fleet-scale tenant population generator.

The co-location scenarios so far hand-pick 2–3 tenants; the fleet driver
needs *populations* — a thousand tenants whose load shapes look like a
production cluster rather than a benchmark pair.  This module samples
them deterministically:

* **heavy-tailed rates** — per-tenant target rates are lognormal around
  ``rate_median`` (σ = ``rate_sigma``), capped at ``rate_cap``: most
  tenants are small, a fat tail is not;
* **query/policy mixes** — weighted draws over Nexmark queries and
  registered scaling policies (stateless-heavy by default: q1/q2
  dominate, as filter/map jobs dominate real fleets);
* **staggered diurnal phases** — a fraction of tenants ride a
  raised-cosine day/night cycle whose phase is drawn uniformly over the
  period, so the fleet's peaks don't align (the realistic case a single
  synchronized sinusoid hides);
* **flash crowds** — a correlated subset spikes to ``flash_factor`` ×
  its base rate in a narrow band around the same instant
  (``flash_at_frac`` of the horizon ± ``flash_spread_frac`` jitter): the
  co-ordinated scale-out burst that stresses admission arbitration;
* **faults on top** — a fraction of tenants carries a
  :class:`~repro_torch.scenarios.faults.SetStraggler` or
  :class:`~repro_torch.scenarios.faults.KillTask` schedule (emitted as plain
  lists so each ``run_colocated`` call builds a fresh, unfired
  ``FaultSchedule``).

:func:`run_fleet` ties it together: sample a population, size a cluster
that holds the initial placements with bounded headroom (scaling must
contend), and drive :func:`~repro_torch.scenarios.cluster.run_colocated`.
Port of ``repro.scenarios.population``: the same ``random.Random(seed)``
draws in the same order, so a population is the reference's tenant for
tenant.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass

from repro_torch import resolve_device
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.justin import JustinParams
from repro_torch.core.placement import placement_for_config
from repro_torch.core.policy import make_policy
from repro_torch.data.nexmark import QUERIES
from repro_torch.scenarios.cluster import (Cluster, ColocatedResult,
                                           ColocatedSpec, run_colocated)
from repro_torch.scenarios.faults import KillTask, SetStraggler
from repro_torch.scenarios.profiles import Diurnal, Ramp, Spike
from repro_torch.scenarios.runner import scenario_horizon_s

# stateless-heavy mixes: most of a production fleet is filter/map (q1/q2);
# q5/q11 contribute the windowed-state tenants Justin's levels matter for.
# (q3/q8 are excluded from the default mix: their person/auction generator
# is an order of magnitude slower per event, which would make fleet
# benches measure the data generator instead of the driver.)
DEFAULT_QUERY_MIX = (("q1", 0.52), ("q2", 0.33), ("q5", 0.09), ("q11", 0.06))
DEFAULT_POLICY_MIX = (("justin", 0.45), ("ds2", 0.30),
                      ("threshold", 0.15), ("static", 0.10))


@dataclass(frozen=True)
class PopulationSpec:
    """Knobs for one sampled fleet; every draw comes from ``seed``."""
    tenants: int = 1000
    seed: int = 0
    query_mix: tuple = DEFAULT_QUERY_MIX
    policy_mix: tuple = DEFAULT_POLICY_MIX
    rate_median: float = 800.0       # events/s, lognormal median
    rate_sigma: float = 1.0          # lognormal σ — the heavy tail
    rate_cap: float = 8000.0         # keep the tail simulable
    diurnal_fraction: float = 0.45   # staggered day/night riders
    ramp_fraction: float = 0.15      # slow organic growth
    flash_fraction: float = 0.15     # correlated flash-crowd members
    flash_at_frac: float = 0.5       # crowd instant, as horizon fraction
    flash_spread_frac: float = 0.05  # per-tenant jitter around it
    flash_factor: float = 3.0        # spike height over base rate
    flash_len_frac: float = 0.15     # spike length, as horizon fraction
    fault_fraction: float = 0.05     # tenants carrying a fault schedule
    underprov_fraction: float = 0.6  # stateful tenants that join at
                                     # (parallelism 1, level 0) and must
                                     # scale out through admission
    stateful_rate_boost: float = 2.5  # stateful tenants' rate multiplier
                                      # (their per-task capacity is lower,
                                      # so this is where scaling happens)


def _pick(rng: random.Random, mix: tuple) -> str:
    r = rng.random() * sum(w for _, w in mix)
    for name, w in mix:
        r -= w
        if r <= 0:
            return name
    return mix[-1][0]


def _first_op(query: str) -> str:
    """The query's first non-source operator — the fault target."""
    flow = QUERIES[query]()
    srcs = set(flow.sources())
    return next(n for n in flow.nodes if n not in srcs)


def sample_population(spec: PopulationSpec,
                      horizon_s: float) -> list[ColocatedSpec]:
    """Draw ``spec.tenants`` deterministic :class:`ColocatedSpec`\\ s.

    Flash-crowd membership overrides the base shape (the spike IS the
    tenant's profile); diurnal/ramp riders keep their own staggered
    phase; everyone else runs the fixed-target protocol."""
    rng = random.Random(spec.seed)
    fault_ops = {q: _first_op(q) for q, _ in spec.query_mix}
    stateful_ops = {"q5": "hot_auctions", "q11": "user_sessions",
                    "q8": "window_join", "q3": "incr_join"}
    out: list[ColocatedSpec] = []
    for i in range(spec.tenants):
        query = _pick(rng, spec.query_mix)
        policy = _pick(rng, spec.policy_mix)
        rate = min(spec.rate_cap,
                   spec.rate_median * math.exp(rng.gauss(0.0,
                                                         spec.rate_sigma)))
        config = None
        if query in stateful_ops:
            # stateful operators are where per-task capacity actually
            # binds, so this is where the fleet's scaling traffic comes
            # from: boost their rates, start half of them under-
            # provisioned (they grow through admission), and pin the
            # static ones at a raised level (the fair-share preemption
            # victims)
            rate = min(spec.rate_cap, rate * spec.stateful_rate_boost)
            if policy == "static":
                config = {stateful_ops[query]: (2, 2)}
            elif rng.random() < spec.underprov_fraction:
                config = {stateful_ops[query]: (1, 0)}
        shape = rng.random()
        profile = None
        if rng.random() < spec.flash_fraction:
            t0 = (spec.flash_at_frac
                  + rng.uniform(-spec.flash_spread_frac,
                                spec.flash_spread_frac)) * horizon_s
            profile = Spike(base=rate,
                            peak=min(spec.flash_factor * rate,
                                     spec.rate_cap),
                            t0=t0, duration_s=spec.flash_len_frac
                            * horizon_s)
        elif shape < spec.diurnal_fraction:
            period = horizon_s / 2.0
            profile = Diurnal(low=0.5 * rate, high=rate, period_s=period,
                              phase_s=rng.uniform(0.0, period))
        elif shape < spec.diurnal_fraction + spec.ramp_fraction:
            profile = Ramp(start=0.6 * rate, end=rate,
                           duration_s=0.7 * horizon_s,
                           t0=rng.uniform(0.0, 0.3 * horizon_s))
        faults = None
        if rng.random() < spec.fault_fraction:
            op = fault_ops[query]
            t = rng.uniform(0.1, 0.7) * horizon_s
            # lists, not FaultSchedule: the schedule is stateful, the
            # population must be re-runnable (oracle vs vectorized)
            if rng.random() < 0.5:
                faults = [SetStraggler(t=t, op=op, factor=4.0,
                                       duration_s=0.1 * horizon_s)]
            else:
                faults = [KillTask(t=t, op=op)]
        out.append(ColocatedSpec(policy, query, profile=profile,
                                 name=f"t{i:04d}", target=rate,
                                 faults=faults, config=config))
    return out


def size_cluster(specs: list[ColocatedSpec], cfg: ControllerConfig, *,
                 slots_factor: float = 1.1, mem_factor: float = 1.01,
                 tm_spec=None) -> Cluster:
    """A cluster that holds every initial placement with bounded headroom
    (``factor`` × the initial totals) — big enough that
    :func:`run_colocated`'s sizing check passes, small enough that
    scale-outs contend and admission actually arbitrates."""
    cpu = 0
    mem = 0.0
    quotes: dict[tuple, tuple[int, float]] = {}
    for s in specs:
        key = (s.query, s.policy, tuple(sorted((s.config or {}).items())))
        q = quotes.get(key)
        if q is None:
            flow = QUERIES[s.query]()
            init = dict(flow.config())
            init.update(s.config or {})
            # quote through the tenant's policy: its memory-coupling
            # model (e.g. DS2's uniform per-slot package) is what the
            # driver's initial reservation will actually charge
            init = make_policy(s.policy, cfg).resources_config(init)
            pl = placement_for_config(init, base_mem_mb=cfg.base_mem_mb,
                                      exclude=set(flow.sources()))
            q = quotes[key] = (pl.cpu_cores, pl.memory_mb)
        cpu += q[0]
        mem += q[1]
    return Cluster(cpu_slots=int(math.ceil(cpu * slots_factor)),
                   memory_mb=mem * mem_factor, tm_spec=tm_spec)


def fleet_cfg(*, decision_window_s: float = 8.0,
              stabilization_s: float = 4.0,
              busyness: float = 0.12,
              max_level: int = 2) -> ControllerConfig:
    """The fleet preset: short decision windows keep a tenant-window's
    engine cost in the low-millisecond range, and a LOW busyness
    setpoint rescales the whole control loop to low (cheap-to-simulate)
    event rates — per-task capacity ≈ busyness / cpu_cost, so at 0.12 a
    q1 tenant triggers near 5.5k ev/s instead of the paper's 36k.  The
    trigger/propose/admit dynamics are rate-ratio driven and unchanged;
    only the absolute event volume (and thus wall-clock cost) drops."""
    return ControllerConfig(decision_window_s=decision_window_s,
                            stabilization_s=stabilization_s,
                            busy_high=busyness,
                            target_busyness=busyness,
                            justin=JustinParams(max_level=max_level))


def run_fleet(tenants: int = 1000, windows: int = 100, *,
              admission: str = "fair_share", seed: int = 0,
              driver: str = "vectorized",
              migration_budget_mb: float | None = None,
              spec: PopulationSpec | None = None,
              cfg: ControllerConfig | None = None,
              slots_factor: float = 1.1,
              mem_factor: float = 1.01,
              tracer=None, device=None) -> ColocatedResult:
    """Sample a population, size its cluster, run the fleet driver; the
    tenants' engines run on ``device`` (``cuda`` unless ``device="cpu"``
    is passed)."""
    device = resolve_device(device)
    cfg = cfg or fleet_cfg()
    spec = spec or PopulationSpec(tenants=tenants, seed=seed)
    specs = sample_population(spec, scenario_horizon_s(cfg, windows))
    cluster = size_cluster(specs, cfg, slots_factor=slots_factor,
                           mem_factor=mem_factor)
    return run_colocated(specs, cluster, windows=windows, seed=seed,
                         cfg=cfg, admission=admission, driver=driver,
                         migration_budget_mb=migration_budget_mb,
                         tracer=tracer, device=device)


def fleet_stats(result: ColocatedResult,
                elapsed_s: float | None = None) -> dict:
    """Fleet-level reductions for benches and demos: tenant-window
    outcome counts, peak usage, policy steps — and simulated
    tenant-windows per wall-clock second when ``elapsed_s`` is given
    (the fleet's throughput headline)."""
    n = len(result.tenants)
    windows = len(result.usage)
    if result.fleet is not None:
        denied = int(result.fleet.denied.sum())
        deferred = int(result.fleet.deferred.sum())
        preempted = int(result.fleet.preempted.sum())
    else:
        denied = sum(len(t.denials) for t in result.tenants)
        deferred = sum(len(t.deferrals) for t in result.tenants)
        preempted = sum(len(t.preemptions) for t in result.tenants)
    out = {
        "tenants": n,
        "windows": windows,
        "tenant_windows": n * windows,
        "admission": result.admission,
        "denied_tenant_windows": denied,
        "deferred_tenant_windows": deferred,
        "preempted_tenant_windows": preempted,
        "policy_steps": sum(t.scaler.steps for t in result.tenants),
        "peak_cpu": max((c for c, _ in result.usage), default=0),
        "peak_mem_mb": max((m for _, m in result.usage), default=0.0),
        "cluster_cpu_slots": result.cluster.cpu_slots,
        "cluster_memory_mb": result.cluster.memory_mb,
    }
    if elapsed_s is not None:
        out["seconds"] = elapsed_s
        out["tenant_windows_per_s"] = (n * windows / elapsed_s
                                       if elapsed_s > 0 else 0.0)
    return out
