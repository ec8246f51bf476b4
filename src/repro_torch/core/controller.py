"""Reconfiguration controller: the auto-scaler loop (§5 protocol).
Port of ``repro.core.controller``; pure host code over the port's engine.

Runs the engine in decision windows; on a policy trigger asks the
:class:`~repro_torch.core.policy.ScalingPolicy` for a proposed
configuration, enacts it via the engine (state re-partition / backend
resize) and the bin-packing placement, then waits a stabilization period.
History rows capture achieved rate, CPU cores and memory MB per window,
plus the backlog and admission outcomes.

The optional hooks keep the reference's protocol: an ``admission``
callable gates growth of the resource footprint; a ``migration`` object
with ``charge(scaler, old_config, new_config)`` (returning a cost with
``downtime_s`` and ``moved_mb``) prices a reconfiguration as paused
engine time; a ``tracer`` records sim-time spans.  With none of them,
``run`` is the single-tenant loop the golden traces pin.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.justin import JustinParams
from repro_torch.core.placement import (TaskRequest, placement_for_config,
                                  placement_requests)
from repro_torch.core.policy import ScalingPolicy, make_policy
from repro_torch.core.units import mem_exceeds
from repro_torch.obs.provenance import (REASON_DENIED, REASON_RECONFIGURED,
                                  REASON_STEADY, REASON_TRIGGERED,
                                  explain_admission, reason_counts)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.streaming.engine import StreamEngine


@dataclass(frozen=True)
class ControllerConfig:
    policy: str = "justin"                 # registry name; see
                                           # repro_torch.core.policy
    decision_window_s: float = 120.0
    stabilization_s: float = 60.0
    busy_high: float = 0.8
    target_busyness: float = 0.8
    max_parallelism: int = 64
    max_reconfigs: int = 8
    justin: JustinParams = field(default_factory=JustinParams)
    base_mem_mb: float = 158.0
    sim_time_scale: float = 0.1            # 1 sim tick = 10 paper-seconds


@dataclass
class HistoryRow:
    t: float
    step: int
    achieved_rate: float
    cpu_cores: int
    memory_mb: float
    config: dict
    triggered: bool
    target: float = 0.0               # the (possibly time-varying) target
    backlog: int = 0                  # queued events across all tasks
    denied: bool = False              # admission hook rejected this window's
                                      # scale-up request (retried next window)
    preempted: bool = False           # a higher-priority tenant forced a
                                      # memory give-back this window
    amortized_mb: float | None = None  # shared-TM attribution (base_mb
                                       # amortized across co-residents);
                                       # None == private placement quote
    reconfig_downtime: float = 0.0    # paused paper-seconds this window's
                                      # reconfiguration cost (migration
                                      # runtime; 0 under "instant")
    moved_mb: float = 0.0             # state MB that physically travelled
                                      # for this window's reconfiguration
    reason: str = REASON_STEADY       # why the window ended this way
                                      # (repro_torch.obs.provenance.REASONS);
                                      # the fleet drivers upgrade
                                      # denied -> deferred and mark
                                      # preemption victims "shrunk"


class AutoScaler:
    def __init__(self, engine: StreamEngine, target_rate: float,
                 cfg: ControllerConfig = ControllerConfig(),
                 *, admission=None, policy: ScalingPolicy | None = None,
                 migration=None, tracer=None):
        self.engine = engine
        self.flow = engine.flow
        self.target = target_rate
        self.cfg = cfg
        # the policy drives every decision; by default it is constructed
        # from the registry under this episode's config
        self.policy = policy if policy is not None \
            else make_policy(cfg.policy, cfg)
        self.history: list[HistoryRow] = []
        self.steps = 0
        # optional ``admission(scaler, new_config, cpu, mem) -> bool``:
        # consulted before enacting a configuration that grows the resource
        # footprint (the cluster co-location arbitration point)
        self.admission = admission
        # co-location identity + quoting context, set by the cluster driver:
        # with a shared-TM ``cluster`` attached, admission quotes are the
        # tenant's amortized attribution under the shared placement
        self.tenant: str = ""
        self.cluster = None
        self.preemptions = 0          # forced give-backs suffered (not
                                      # counted in ``steps``: they are the
                                      # arbiter's reconfigs, not the
                                      # policy's)
        # optional migration runtime (see the module docstring): prices every
        # enacted reconfiguration and converts the price into paused
        # engine time.  None (and the "instant" mechanism) are strict
        # no-ops — the golden traces' default.
        self.migration = migration
        # optional fleet-wide placement-quote cache, attached by the
        # vectorized co-location driver: private-fleet quotes are pure
        # functions of (query, base grant, transformed config), so one
        # dict shared across tenants collapses N identical bin_packs per
        # window into one per DISTINCT configuration.  None (the
        # default, and the scalar oracle) recomputes every quote.
        self.quote_cache: dict | None = None
        self._last_metrics: dict[str, dict] = {}
        # optional deterministic span tracer (repro_torch.obs.trace): spans are
        # stamped with SIM time only, and the shared NULL_TRACER default
        # makes every record an O(1) no-op — decisions are byte-identical
        # with tracing on or off
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # per-operator (flushes, compactions) marks for the LSM window
        # spans — observability bookkeeping only, never read by decisions
        self._lsm_marks: dict[str, tuple[int, int]] = {}

    # ------------------------------------------------------------------ core
    def _window_s(self) -> float:
        return self.cfg.decision_window_s * self.cfg.sim_time_scale

    def decide(self, metrics: dict[str, dict]) -> dict[str, tuple[int, int | None]]:
        """Propose-and-commit in one call — the single-tenant convenience.
        NOT admission-aware: it commits the policy's decision history
        unconditionally, so co-located drivers must go through
        ``step_window`` (which defers the commit until the proposal is
        admitted)."""
        proposal = self.policy.propose(self.flow, metrics, self.target,
                                       self.cfg)
        self.policy.commit(metrics)
        return proposal.config

    def task_requests(self, config: dict | None = None) -> list[TaskRequest]:
        """The tenant-tagged task list ``config`` asks the packer for —
        what the shared-TM cluster packs alongside other tenants' tasks."""
        config = config if config is not None else self.flow.config()
        config = self.policy.resources_config(config)
        return placement_requests(config, base_mem_mb=self.cfg.base_mem_mb,
                                  exclude=set(self.flow.sources()),
                                  tenant=self.tenant)

    def resources(self, config: dict | None = None, *,
                  cluster=None) -> tuple[int, float]:
        """(CPU slots, memory MB) the placement needs for ``config`` —
        the *current* flow configuration when not given, or a proposed C^t
        (the admission hook's pre-enactment quote).  The policy's
        ``resources_config`` supplies the memory-coupling model (e.g. DS2
        keeps the uniform base grant on every slot — Takeaway 1).

        With a shared-TM ``cluster``, the quote is this tenant's amortized
        attribution under the cluster-level packing (its slots + managed
        grants + its slot-proportional share of each co-resident TM's
        ``base_mb``) instead of a private fleet's footprint."""
        if cluster is not None and getattr(cluster, "shared", False):
            return cluster.quote(self.tenant, self.task_requests(config))
        config = config if config is not None else self.flow.config()
        config = self.policy.resources_config(config)
        key = None
        if self.quote_cache is not None:
            key = (self.flow.name, self.cfg.base_mem_mb,
                   tuple(sorted(config.items())))
            hit = self.quote_cache.get(key)
            if hit is not None:
                return hit
        pl = placement_for_config(config, base_mem_mb=self.cfg.base_mem_mb,
                                  exclude=set(self.flow.sources()))
        out = (pl.cpu_cores, pl.memory_mb)
        if key is not None:
            self.quote_cache[key] = out
        return out

    def shrink_memory(self) -> tuple[int, float] | None:
        """Forced memory give-back — the §4.3 preemption mechanism.  Asks
        the policy for a one-level shrink proposal
        (:meth:`ScalingPolicy.propose_shrink`), enacts it through the
        normal reconfigure + stabilization path, and returns the new
        private (cpu, mem) footprint; ``None`` when nothing can shrink.
        Driven by the cluster arbiter when another tenant's admission
        needs the memory; the give-back is counted in
        ``preemptions``, not ``steps`` (it is the arbiter's
        reconfiguration, not this policy's)."""
        prop = self.policy.propose_shrink(self.flow, self.cfg)
        if prop is None or prop.config == self.flow.config():
            return None
        old_config = self.flow.config()
        self.policy.commit(self._last_metrics)
        t0 = self.engine.now
        cost = self._enact(prop.config)
        if cost is not None and self.history:
            # the give-back's price lands on the victim's current window
            row = self.history[-1]
            row.reconfig_downtime += cost.downtime_s
            row.moved_mb += cost.moved_mb
        self.preemptions += 1
        out = self.resources()
        self.tracer.record(
            "preempt.shrink", "preempt", t0, self.engine.now,
            tenant=self.tenant,
            args={"old": {op: list(pc) for op, pc in old_config.items()},
                  "new": {op: list(pc) for op, pc in prop.config.items()},
                  "cpu_cores": out[0], "memory_mb": out[1]})
        return out

    def _enact(self, new_config: dict, *, window: int | None = None):
        """Reconfigure + stabilize, pricing the re-shape through the
        migration runtime when one is attached: the planned downtime
        becomes PAUSED engine time (sources accrue backlog, nothing
        processes) before the stabilization window.  Returns the
        migration cost, or None without a
        runtime — in which case (and under the "instant" mechanism) the
        enactment is byte-identical to the pre-migration controller."""
        cost = None
        if self.migration is not None:
            # plan against the OLD config's live stores, before they are
            # re-partitioned away
            cost = self.migration.charge(self, self.flow.config(),
                                         new_config)
        self.engine.reconfigure(new_config)
        t0 = self.engine.now
        if cost is not None and cost.downtime_s > 0:
            self.engine.run_paused(
                cost.downtime_s * self.cfg.sim_time_scale, self.target)
            self.tracer.record(
                "migration.paused", "migration", t0, self.engine.now,
                tenant=self.tenant, window=window,
                args={"downtime_s": cost.downtime_s,
                      "moved_mb": cost.moved_mb})
        t1 = self.engine.now
        # stabilization: run and discard one short window
        self.engine.run(self.cfg.stabilization_s * self.cfg.sim_time_scale,
                        self.target)
        self.tracer.record("engine.stabilize", "engine", t1, self.engine.now,
                         tenant=self.tenant, window=window)
        self.engine.collect()
        return cost

    def _emit_lsm_spans(self, metrics: dict[str, dict], t0: float,
                        t1: float, w: int) -> None:
        """Per-stateful-operator storage span: the window's theta/tau plus
        flush/compaction work since the last mark.  Marks live in
        ``_lsm_marks`` (obs-only state); after a reconfigure the rebuilt
        stores restart their totals, so deltas clamp at zero and the mark
        re-baselines — never read by any decision."""
        for name, m in metrics.items():
            if not m["stateful"]:
                continue
            flushes = compactions = 0
            for tr in self.engine.tasks[name]:
                if tr.state is not None:
                    f, c = tr.state.metrics.maintenance()
                    flushes += f
                    compactions += c
            pf, pc = self._lsm_marks.get(name, (0, 0))
            self._lsm_marks[name] = (flushes, compactions)
            self.tracer.record(
                "lsm.window", "lsm", t0, t1, tenant=self.tenant, window=w,
                args={"op": name, "theta": m.get("theta"),
                      "tau_ms": m.get("tau_ms"),
                      "memory_level": m["memory_level"],
                      "flushes": max(flushes - pf, 0),
                      "compactions": max(compactions - pc, 0)})

    def step_window(self, w: int = 0, *, target_profile=None,
                    window_hook=None) -> bool:
        """Run ONE decision window: observe, maybe trigger, maybe
        reconfigure.  Returns True when the window saw no trigger (the
        single-tenant loop's convergence signal).  The co-location driver
        calls this directly to interleave N episodes in lockstep."""
        if target_profile is not None:
            self.target = float(target_profile(self.engine.now))
        if window_hook is not None:
            window_hook(self.engine, w)
        t0 = self.engine.now
        self.engine.run(self._window_s(), self.target)
        t_run = self.engine.now
        metrics = self.engine.collect()
        self._last_metrics = metrics
        src = sum(metrics[s]["rate_out"] for s in self.flow.sources())
        trig = (self.steps < self.cfg.max_reconfigs
                and self.policy.should_trigger(self.flow, metrics,
                                               self.target, self.cfg))
        cpu, mem = self.resources()
        row = HistoryRow(
            t=self.engine.now, step=self.steps, achieved_rate=src,
            cpu_cores=cpu, memory_mb=mem,
            config=self.flow.config(), triggered=trig,
            target=self.target,
            backlog=sum(m["backlog"] for m in metrics.values()))
        self.history.append(row)
        self.tracer.record("engine.window", "engine", t0, t_run,
                         tenant=self.tenant, window=w,
                         args={"target": self.target, "achieved_rate": src,
                               "backlog": row.backlog, "cpu_cores": cpu,
                               "memory_mb": mem})
        if self.tracer.enabled:
            self._emit_lsm_spans(metrics, t0, t_run, w)
        self.tracer.record("policy.should_trigger", "policy", t_run, t_run,
                         tenant=self.tenant, window=w,
                         args={"triggered": trig, "steps": self.steps,
                               "max_reconfigs": self.cfg.max_reconfigs})
        if not trig:
            return True
        row.reason = REASON_TRIGGERED
        proposal = self.policy.propose(self.flow, metrics, self.target,
                                       self.cfg)
        new_config = proposal.config
        if self.tracer.enabled:
            args = {"config": {op: list(pc)
                               for op, pc in new_config.items()},
                    "changed": new_config != self.flow.config()}
            if proposal.explain is not None:
                args.update(proposal.explain.to_dict())
            self.tracer.record("policy.propose", "policy", t_run, t_run,
                             tenant=self.tenant, window=w, args=args)
        if new_config != self.flow.config():
            # quote against the shared placement when a shared-TM cluster
            # is attached: admission gates growth of the tenant's
            # amortized attribution, not of a hypothetical private fleet
            # (a scalar cluster quotes private placements — identical to
            # the (cpu, mem) above, so don't re-pack)
            shared = self.cluster if self.cluster is not None \
                and self.cluster.shared else None
            cpu_new, mem_new = self.resources(new_config, cluster=shared)
            cpu_cur, mem_cur = (cpu, mem) if shared is None \
                else self.resources(cluster=shared)
            # epsilon-disciplined growth test: shared-TM attributions are
            # accumulated floats, and a drifted re-quote of an identical
            # footprint must not be gated (and possibly denied) as a
            # scale-up
            grows = cpu_new > cpu_cur or mem_exceeds(mem_new, mem_cur)
            admitted = None
            if grows and self.admission is not None:
                admitted = self.admission(self, new_config,
                                          cpu_new, mem_new)
            self.tracer.record(
                "admission.quote", "admission", t_run, t_run,
                tenant=self.tenant, window=w,
                args=explain_admission(
                    cpu_cur=cpu_cur, mem_cur=mem_cur, cpu_new=cpu_new,
                    mem_new=mem_new, grows=grows, admitted=admitted,
                    shared=shared is not None))
            if admitted is False:
                row.denied = True
                row.reason = REASON_DENIED
                return False        # retry at the next window boundary
        self.policy.commit(metrics)
        self.tracer.record("policy.commit", "policy", t_run, t_run,
                         tenant=self.tenant, window=w,
                         args={"enacting": new_config != self.flow.config()})
        if new_config != self.flow.config():
            self.steps += 1
            cost = self._enact(new_config, window=w)
            row.reason = REASON_RECONFIGURED
            if cost is not None:
                row.reconfig_downtime = cost.downtime_s
                row.moved_mb = cost.moved_mb
        return False

    def run(self, *, max_windows: int | None = None,
            target_profile=None, window_hook=None) -> list[HistoryRow]:
        """Run until converged (no trigger) or max_reconfigs spent.

        ``target_profile``: optional callable ``r(engine.now) -> events/s``
        sampled at each window boundary (the scenario subsystem's rate
        profiles).  With a profile the loop never declares convergence —
        the workload may move again — so it runs all ``max_windows``.
        ``window_hook``: optional callable ``(engine, window_idx)`` fired
        before each window (fault injection point).
        """
        # explicit None check: ``max_windows=0`` means zero windows, not
        # the default budget (the ``or`` idiom ran max_reconfigs + 4)
        windows = max_windows if max_windows is not None \
            else self.cfg.max_reconfigs + 4
        for w in range(windows):
            quiet = self.step_window(w, target_profile=target_profile,
                                     window_hook=window_hook)
            if quiet and w > 0 and target_profile is None:
                break       # converged after at least one observation
        return self.history

    # ------------------------------------------------------------- reporting
    def summary(self) -> dict:
        if not self.history:
            # zero-window summary: nothing observed yet, report the current
            # placement rather than crashing on history[-1]
            cpu, mem = self.resources()
            return {"policy": self.policy.name, "steps": self.steps,
                    "achieved_rate": 0.0, "target": self.target,
                    "cpu_cores": cpu, "memory_mb": mem,
                    "config": dict(self.flow.config()), "windows": 0,
                    "reconfig_downtime_s": 0.0, "moved_mb": 0.0,
                    "reasons": {}}
        last = self.history[-1]
        return {"policy": self.policy.name, "steps": self.steps,
                "achieved_rate": last.achieved_rate, "target": self.target,
                "cpu_cores": last.cpu_cores, "memory_mb": last.memory_mb,
                "config": {op: pc for op, pc in last.config.items()},
                "windows": len(self.history),
                "reconfig_downtime_s": sum(h.reconfig_downtime
                                           for h in self.history),
                "moved_mb": sum(h.moved_mb for h in self.history),
                "reasons": reason_counts(self.history)}
