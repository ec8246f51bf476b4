"""Multi-query co-location on one shared, finite cluster (port of
``repro.scenarios.cluster``; the tenants' engines run on the device, the
arbitration on the host).

The paper's headline — hybrid CPU/memory scaling supports a target rate
with *fewer total cluster resources* than CPU-only DS2 — is invisible when
every episode owns an unbounded cluster.  This module makes it measurable:

* :class:`Cluster` is a shared budget of CPU slots and memory MB with
  per-tenant accounting.  ``reserve`` is atomic (admit or deny, never
  overdraw) and an invariant check keeps total usage within budget.
* **Shared-TM packing** (``Cluster(..., tm_spec=...)``): instead of scalar
  footprints, tenants reserve tenant-tagged task lists that the cluster
  packs into ONE TaskManager fleet
  (``repro_torch.core.placement.shared_pack``).
  Each TM's ``base_mb`` is amortized across its co-resident tenants, so N
  co-located queries pay ~1 fleet's heap/network share instead of N — the
  resource-efficiency headline private fleets hide.  Every accepted
  re-reservation is priced as a repack (``MigrationCost``: tasks moved ×
  state MB).
* :func:`run_colocated` steps N ``(policy, query, profile)`` episodes in
  lockstep, one decision window at a time.  Each episode's scale-up request
  hits the cluster through the controller's admission hook; denied requests
  leave the episode's configuration untouched, so its trigger persists and
  the request is retried at the next window.  Scale-downs bypass admission
  and *release* capacity — which is precisely how Justin's give-back-memory
  decisions free room for a neighbor's scale-out that DS2's one-size-fits-
  all packages would keep blocked.

Admission arbitration (who gets first claim on the remaining budget each
window) supports four orders:

* ``"priority"``   — the spec list is the priority order, every window;
* ``"fair_share"`` — episodes using the smallest fraction of the budget go
  first (max of CPU share and memory share, ascending);
* ``"first_come"`` — episodes with the oldest unserved (denied) request go
  first; ties fall back to spec order.
* ``"preemption"`` — priority order for requests, plus the §4.3 re-shape
  mechanism with **fair-share victim selection**: when a request is
  denied, the arbiter forces tenants holding more than their fair
  allotment of the budget (1/N of the larger of their CPU and memory
  fractions) to give back one storage level at a time
  (``AutoScaler.shrink_memory``, built on the policy protocol's
  ``propose_shrink``) — biggest excess first, spec priority breaking
  ties — until the request fits or no over-allotment tenant can shrink.
  A tenant at or below its fair share is never preempted; a hog above it
  is reclaimable even by a lower-priority requester.  Give-backs are
  recorded per window in ``TenantRun.preemptions`` alongside
  ``denials``.

A per-window **migration budget** (``migration_budget_mb``) additionally
caps the state MB admissions may move each window: an admission whose
quoted migration cost exceeds the remaining allowance is deferred
through the same denial/retry path (``TenantRun.deferrals``) — the
migration-cost budget of the arbiter.  The
budget covers *everything* an admission moves: preemption give-backs are
quoted and charged like any other migration (an unaffordable give-back
is skipped, and the whole request deferred when the fleet cannot be
re-shaped within the window's remaining allowance), and after give-backs
re-shape the fleet the requester's own move is re-quoted at the
post-preemption price rather than charged its stale pre-preemption
quote.

Two interchangeable drivers step the fleet (``driver=`` on
:func:`run_colocated`):

* ``"scalar"`` — the original per-tenant Python loop: dict lookups,
  ``sorted`` arbitration, per-tenant list bookkeeping.  It is the
  *oracle*: simple enough to audit, kept byte-for-byte decision-
  compatible.
* ``"vectorized"`` (default) — structure-of-arrays fleet state
  (:class:`_FleetState`): per-tenant footprints, targets,
  pending/denial/deferral flags and per-window attribution live in numpy
  arrays; arbitration order, fair-share ranking and preemption victim
  ranking are array programs; admission quotes are cached fleet-wide
  (one ``bin_pack`` per distinct (query, config) instead of one per
  tenant per window); and the per-reservation full-sum budget audit
  becomes one fleet-level invariant check per window.  Decision-
  identical to the oracle — same denials, deferrals, preemptions, usage
  series — at thousand-tenant scale.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.controller import AutoScaler, ControllerConfig
from repro_torch.core.justin import JustinParams
from repro_torch.core.placement import (MigrationCost, SharedPlacement,
                                        TaskRequest, TMSpec, repack,
                                        shared_pack)
from repro_torch.core.policy import make_policy
from repro_torch.core.units import MB_EPS, mem_close
from repro_torch.data.nexmark import QUERIES, TARGET_RATES
from repro_torch.obs.provenance import (REASON_DEFERRED, REASON_SHRUNK,
                                        REASON_STEADY, REASON_TRIGGERED,
                                        reason_counts)
from repro_torch.scenarios.faults import FaultSchedule
from repro_torch.scenarios.metrics import SLOReport, slo_report
from repro_torch.scenarios.profiles import Profile, make_profile
from repro_torch.scenarios.runner import scenario_horizon_s
from repro_torch.streaming.engine import StreamEngine

ADMISSION_POLICIES = ("priority", "fair_share", "first_come", "preemption")
DRIVERS = ("vectorized", "scalar")

# one tolerance for every budget comparison: ``fits``, ``reserve_tasks``
# and the invariant asserts must agree, or float drift in the summed
# attribution can deny re-reserving an IDENTICAL footprint that the
# invariant happily accepts (the post-step resync then dies with a
# spurious "accounting desync").  The value is the repo-wide blessed
# tolerance from repro_torch.core.units, shared with the placement packer and
# the controller's admission-gating growth test.
_EPS = MB_EPS


@dataclass
class Cluster:
    """A finite pool of CPU slots and memory, shared by named tenants.

    Usage is tracked per tenant as the *absolute* footprint of that
    tenant's current placement (not deltas), so a reservation is simply
    "replace my footprint with this one" — admitted iff the cluster-wide
    totals stay within budget.  The totals are maintained incrementally
    (``cpu_in_use`` / ``mem_in_use`` are O(1), not a dict sum), which is
    what keeps a thousand-tenant window O(N) instead of O(N²).

    With ``tm_spec`` set the cluster runs in **shared-TM mode**: tenants
    reserve task lists (:meth:`reserve_tasks`) that are bin-packed into
    one fleet, and ``used_cpu`` / ``used_mem`` hold each tenant's
    *amortized attribution* (own slots + managed grants + its
    slot-proportional share of co-resident TMs' ``base_mb``), which sums
    exactly to the fleet totals."""
    cpu_slots: int
    memory_mb: float
    used_cpu: dict[str, int] = field(default_factory=dict)
    used_mem: dict[str, float] = field(default_factory=dict)
    tm_spec: TMSpec | None = None
    tasks: dict[str, list[TaskRequest]] = field(default_factory=dict)
    migrations: list[MigrationCost] = field(default_factory=list)
    _placement: SharedPlacement | None = field(default=None, repr=False)
    _cpu_total: int = field(default=0, init=False, repr=False)
    _mem_total: float = field(default=0.0, init=False, repr=False)

    def __post_init__(self) -> None:
        self._recount()

    def _recount(self) -> None:
        self._cpu_total = sum(self.used_cpu.values())
        self._mem_total = sum(self.used_mem.values())

    # ------------------------------------------------------------- accounting
    @property
    def shared(self) -> bool:
        return self.tm_spec is not None

    @property
    def cpu_in_use(self) -> int:
        return self._cpu_total

    @property
    def mem_in_use(self) -> float:
        return self._mem_total

    def available(self) -> tuple[int, float]:
        return (self.cpu_slots - self.cpu_in_use,
                self.memory_mb - self.mem_in_use)

    def fits(self, tenant: str, cpu: int, mem: float) -> bool:
        """Would replacing ``tenant``'s footprint with (cpu, mem) fit?
        Memory is compared with the same ``_EPS`` tolerance the invariant
        asserts and ``reserve_tasks`` use, so accumulated float drift in
        the attribution sum can never reject a footprint the invariant
        would accept."""
        cpu_total = self._cpu_total - self.used_cpu.get(tenant, 0) + cpu
        mem_total = self._mem_total - self.used_mem.get(tenant, 0.0) + mem
        return cpu_total <= self.cpu_slots \
            and mem_total <= self.memory_mb + _EPS

    def reserve(self, tenant: str, cpu: int, mem: float) -> bool:
        """Atomically replace ``tenant``'s footprint; False if it would
        overdraw the budget (nothing changes on denial)."""
        if self.shared:
            raise TypeError("shared-TM cluster: reserve task lists via "
                            "reserve_tasks, not scalar footprints")
        if not self.fits(tenant, cpu, mem):
            return False
        self._cpu_total += cpu - self.used_cpu.get(tenant, 0)
        self._mem_total += mem - self.used_mem.get(tenant, 0.0)
        self.used_cpu[tenant] = cpu
        self.used_mem[tenant] = mem
        assert self._cpu_total <= self.cpu_slots \
            and self._mem_total <= self.memory_mb + _EPS, "budget overdrawn"
        return True

    # ------------------------------------------------------ shared-TM packing
    def placement(self) -> SharedPlacement | None:
        """The current fleet (shared-TM mode), None before any reservation."""
        return self._placement

    def migration_total(self) -> MigrationCost:
        """Cumulative repack cost across accepted reservations."""
        return sum(self.migrations, MigrationCost())

    def _trial(self, tenant: str,
               reqs: list[TaskRequest]) -> dict[str, list[TaskRequest]]:
        trial = dict(self.tasks)
        trial[tenant] = list(reqs)
        return trial

    def quote(self, tenant: str, reqs: list[TaskRequest]) -> tuple[int, float]:
        """(cpu slots, amortized memory MB) ``tenant`` would be attributed
        if its task list became ``reqs`` — the admission hook's
        pre-enactment quote against the shared placement."""
        pl = shared_pack(self._trial(tenant, reqs), self.tm_spec)
        return pl.tenant_cpu(tenant), pl.tenant_memory_mb(tenant)

    def quote_migration(self, tenant: str,
                        reqs: list[TaskRequest]) -> MigrationCost:
        """The fleet-level repack cost ``tenant``'s reservation would
        incur (tasks moved × state MB) WITHOUT committing anything — what
        a per-window migration budget gates before admission."""
        _, cost = repack(self._trial(tenant, reqs), self.tm_spec,
                         self._placement)
        return cost

    def reserve_tasks(self, tenant: str, reqs: list[TaskRequest]) -> bool:
        """Atomically replace ``tenant``'s task list and repack the whole
        fleet; False if the packed totals would overdraw the budget
        (nothing changes on denial).  Accepted reservations append their
        :class:`MigrationCost` to ``migrations``."""
        pl, cost = repack(self._trial(tenant, reqs), self.tm_spec,
                          self._placement)
        if pl.cpu_cores > self.cpu_slots \
                or pl.memory_mb > self.memory_mb + _EPS:
            return False
        self.tasks[tenant] = list(reqs)
        self.migrations.append(cost)
        self._commit_placement(pl)
        return True

    def _commit_placement(self, pl: SharedPlacement) -> None:
        self._placement = pl
        att = pl.attribution()
        self.used_cpu = {t: att.get(t, (0, 0.0))[0] for t in self.tasks}
        self.used_mem = {t: att.get(t, (0, 0.0))[1] for t in self.tasks}
        self._recount()
        assert self._cpu_total <= self.cpu_slots \
            and self._mem_total <= self.memory_mb + _EPS, "budget overdrawn"

    def release(self, tenant: str) -> None:
        self._cpu_total -= self.used_cpu.pop(tenant, 0)
        self._mem_total -= self.used_mem.pop(tenant, 0.0)
        # releases can't overdraw, but the O(1) counters must stay honest
        # against the dicts they mirror: going negative means a double
        # release / stale-tenant bug upstream
        assert self._cpu_total >= 0 and self._mem_total >= -_EPS, \
            "budget counters negative after release"
        if self.shared and tenant in self.tasks:
            del self.tasks[tenant]
            self._commit_placement(shared_pack(self.tasks, self.tm_spec))

    def share(self, tenant: str) -> float:
        """Tenant's budget share: max of its CPU and memory fractions —
        the fair-share arbitration key."""
        return max(self.used_cpu.get(tenant, 0) / max(self.cpu_slots, 1),
                   self.used_mem.get(tenant, 0.0) / max(self.memory_mb, 1e-9))


# ---------------------------------------------------------------------------
# Co-located episodes
# ---------------------------------------------------------------------------

@dataclass
class ColocatedSpec:
    """One tenant: a policy driving a query under a rate profile.  ``name``
    defaults to ``{policy}:{query}`` (suffixed for uniqueness by the
    driver).  ``profile`` may be a Profile, a named shape ("ramp", ...) or
    None for the paper's fixed-target protocol; ``target`` overrides the
    query's default target rate.  ``config`` is an optional initial
    configuration override (partial ``{op: (parallelism, level)}``),
    enacted before the first window — e.g. a static tenant pinned at a
    raised storage level, the preemption scenarios' victim."""
    policy: str
    query: str
    profile: Profile | str | None = None
    name: str | None = None
    target: float | None = None
    faults: FaultSchedule | list | None = None
    config: dict | None = None


@dataclass
class TenantRun:
    """One tenant's episode state + outcome."""
    spec: ColocatedSpec
    name: str
    scaler: AutoScaler
    profile: Profile | None
    faults: FaultSchedule | None
    denials: list[int] = field(default_factory=list)     # window indices
    preemptions: list[int] = field(default_factory=list)  # windows with >= 1
                                                          # forced give-back
                                                          # (the give-back
                                                          # COUNT lives in
                                                          # scaler.preemptions)
    deferrals: list[int] = field(default_factory=list)   # windows denied by
                                                         # the migration
                                                         # budget (subset of
                                                         # ``denials``)
    faults_fired: list = field(default_factory=list)
    first_pending: int | None = None   # window of oldest unserved request

    @property
    def history(self) -> list:
        return self.scaler.history

    def slo(self, slack: float = 0.97) -> SLOReport:
        return slo_report(self.history, slack)


@dataclass
class ColocatedResult:
    cluster: Cluster
    tenants: list[TenantRun]
    admission: str
    # per-window cluster totals [(cpu_in_use, mem_in_use), ...]
    usage: list = field(default_factory=list)
    # the vectorized driver's structure-of-arrays state (None under the
    # scalar oracle): per-window denial/deferral/preemption flags and
    # attribution as (windows, tenants) numpy arrays — what fleet-scale
    # consumers reduce over without touching per-tenant lists
    fleet: "_FleetState | None" = None

    def tenant(self, name: str) -> TenantRun:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def summary(self, slack: float = 0.97) -> dict:
        out = {
            "admission": self.admission,
            "cluster": {"cpu_slots": self.cluster.cpu_slots,
                        "memory_mb": self.cluster.memory_mb,
                        "shared_tm": self.cluster.shared},
            "peak_cpu": max((c for c, _ in self.usage), default=0),
            "peak_mem": max((m for _, m in self.usage), default=0.0),
            "tenants": {t.name: {
                "policy": t.spec.policy, "query": t.spec.query,
                "steps": t.scaler.steps,
                "denied_windows": list(t.denials),
                "preempted_windows": list(t.preemptions),
                "deferred_windows": list(t.deferrals),
                "reasons": reason_counts(t.history),
                "slo": t.slo(slack).to_dict(),
            } for t in self.tenants},
        }
        # always emitted (zeroed on private-fleet clusters, which never
        # repack) so grid JSON keeps one schema across modes
        mig = self.cluster.migration_total()
        out["migration"] = {"tasks_moved": mig.tasks_moved,
                            "state_mb": mig.state_mb}
        return out


def _arbitration_order(tenants: list[TenantRun], cluster: Cluster,
                       admission: str) -> list[TenantRun]:
    if admission in ("priority", "preemption"):
        return list(tenants)
    if admission == "fair_share":
        return sorted(tenants, key=lambda t: cluster.share(t.name))
    if admission == "first_come":
        return sorted(tenants, key=lambda t: (t.first_pending is None,
                                              t.first_pending or 0))
    raise ValueError(f"unknown admission policy {admission!r} "
                     f"(have: {', '.join(ADMISSION_POLICIES)})")


# ---------------------------------------------------------------------------
# Driver-shared plumbing
# ---------------------------------------------------------------------------

def _reserve(cluster: Cluster, t: TenantRun, config: dict | None = None,
             cpu: int | None = None, mem: float | None = None) -> bool:
    """Replace ``t``'s cluster footprint: its task list under ``config``
    (shared-TM mode) or the scalar (cpu, mem) quote."""
    if cluster.shared:
        return cluster.reserve_tasks(t.name, t.scaler.task_requests(config))
    if cpu is None:
        cpu, mem = t.scaler.resources()
    return cluster.reserve(t.name, cpu, mem)


def _cfg_key(config: dict) -> tuple:
    return tuple(sorted(config.items()))


def _migration_quote(cluster: Cluster, base: ControllerConfig, t: TenantRun,
                     config: dict | None, cache: dict | None = None) -> float:
    """State MB ``t``'s reservation would move — the migration-budget
    currency.  Fleet-level repack cost on shared-TM clusters; the
    migration planner over the tenant's own placements otherwise (a pure
    function of (query, policy, old config, new config), which is what
    the vectorized driver's fleet-wide ``cache`` keys on)."""
    if cluster.shared:
        return cluster.quote_migration(
            t.name, t.scaler.task_requests(config)).state_mb
    from repro_torch.core.placement import bin_pack, default_tm_spec
    from repro_torch.migration import plan_migration
    key = None
    if cache is not None:
        key = (t.spec.query, t.scaler.policy.name,
               _cfg_key(t.scaler.flow.config()),
               _cfg_key(config if config is not None
                        else t.scaler.flow.config()))
        hit = cache.get(key)
        if hit is not None:
            return hit
    spec = default_tm_spec(base.base_mem_mb)
    old_pl = bin_pack(t.scaler.task_requests(), spec)
    new_pl = bin_pack(t.scaler.task_requests(config), spec)
    out = plan_migration(old_pl, new_pl).migration_cost().state_mb
    if cache is not None:
        cache[key] = out
    return out


def _footprint_shrank(cluster: Cluster, t: TenantRun) -> bool:
    """Is ``t``'s current task list no larger (slots and managed MB)
    than the one the cluster holds for it?"""
    old = cluster.tasks.get(t.name, [])
    new = t.scaler.task_requests()
    return (len(new) <= len(old)
            and sum(r.memory_mb for r in new)
            <= sum(r.memory_mb for r in old) + _EPS)


def _desync_error(cluster: Cluster, t: TenantRun, cpu_now: int,
                  mem_now: float) -> RuntimeError:
    return RuntimeError(
        f"cluster accounting desync: {t.name}'s enacted "
        f"placement ({cpu_now} slots, {mem_now:.0f} MB) does "
        f"not fit the budget its quoted admission passed "
        f"({cluster.cpu_slots} slots, "
        f"{cluster.memory_mb:.0f} MB, "
        f"{cluster.cpu_in_use - cluster.used_cpu.get(t.name, 0)}"
        f" slots/"
        f"{cluster.mem_in_use - cluster.used_mem.get(t.name, 0.0):.0f}"
        f" MB held by neighbors)")


def _setup_tenants(specs, cluster: Cluster, *, windows: int, seed: int,
                   base: ControllerConfig, warm: bool,
                   cost_model, tracer=None, device=None) -> list[TenantRun]:
    from repro_torch.migration import MigrationRuntime
    tenants: list[TenantRun] = []
    names: set[str] = set()
    for spec in specs:
        # deterministic unique names: always suffix the ORIGINAL base name
        # (compounding the suffixed name produced a#2#2... on repeated
        # collisions)
        base_name = spec.name or f"{spec.policy}:{spec.query}"
        name, k = base_name, 2
        while name in names:
            name = f"{base_name}#{k}"
            k += 1
        names.add(name)
        target = spec.target if spec.target is not None \
            else TARGET_RATES[spec.query]
        profile = spec.profile
        if isinstance(profile, str):
            profile = make_profile(profile, target,
                                   scenario_horizon_s(base, windows))
        faults = spec.faults
        if isinstance(faults, (list, tuple)):
            faults = FaultSchedule(list(faults))
        engine = StreamEngine(QUERIES[spec.query](), seed=seed, warm=warm,
                              device=device)
        if spec.config:
            engine.reconfigure(spec.config)
        scaler = AutoScaler(engine, profile(0.0) if profile else target,
                            base, policy=make_policy(spec.policy, base),
                            migration=None if cost_model.mechanism
                            == "instant" else MigrationRuntime(cost_model))
        scaler.tenant = name
        scaler.cluster = cluster
        if tracer is not None:
            scaler.tracer = tracer
        tenants.append(TenantRun(spec=spec, name=name, scaler=scaler,
                                 profile=profile, faults=faults))

    # initial placements must fit — this is cluster sizing, not admission
    for t in tenants:
        if not _reserve(cluster, t):
            cpu0, mem0 = t.scaler.resources()
            raise ValueError(
                f"cluster {cluster.cpu_slots} slots/{cluster.memory_mb} MB "
                f"cannot hold {t.name}'s initial placement "
                f"({cpu0} slots, {mem0} MB)")
    return tenants


# ---------------------------------------------------------------------------
# Scalar driver — the oracle
# ---------------------------------------------------------------------------

def _run_scalar(tenants: list[TenantRun], cluster: Cluster,
                result: ColocatedResult, *, windows: int, admission: str,
                migration_budget_mb: float | None,
                base: ControllerConfig) -> ColocatedResult:
    """The original per-tenant Python loop: dict snapshots, ``sorted``
    arbitration, per-tenant list bookkeeping.  Kept as the simple,
    auditable oracle the vectorized driver is equivalence-tested
    against."""
    prio = {t.name: i for i, t in enumerate(tenants)}

    def _preempt_for(requester: TenantRun, new_config: dict, cpu, mem,
                     w: int, budget_left: float | None
                     ) -> tuple[bool, float, bool]:
        """Fair-share victim selection: force give-backs from tenants
        holding MORE than their fair allotment of the budget (1/N of the
        max of CPU and memory fractions), biggest excess first, spec
        priority breaking ties (lower-priority tenants shrink first).
        One level at a time, re-ranking after every give-back (shares
        move), until the requester's reservation fits or no
        over-allotment tenant can shrink.  Every give-back is recorded
        on the victim.

        Unlike strict-priority victim selection, a tenant sitting at or
        below its fair share is never preempted — and a hog above its
        allotment is reclaimable even by a lower-priority requester.

        Under a migration budget, give-backs are migrations too: each is
        quoted before enactment and charged against the window's
        remaining allowance (an unaffordable give-back is skipped —
        blocked, not exhausted), and once the fleet has been re-shaped
        the requester's own move is re-quoted at the post-preemption
        price.  Returns ``(admitted, state MB charged, blocked)`` —
        ``blocked`` marks a request the budget (not capacity) turned
        away, the driver's deferral signal.
        """
        fair = 1.0 / max(len(tenants), 1)
        exhausted: set[str] = set()
        spent = 0.0
        blocked = False
        while True:
            victims = [v for v in tenants
                       if v is not requester and v.name not in exhausted
                       and cluster.share(v.name) > fair]
            victims.sort(key=lambda v: (fair - cluster.share(v.name),
                                        -prio[v.name]))
            for victim in victims:
                sc = victim.scaler
                prop = sc.policy.propose_shrink(sc.flow, sc.cfg)
                if prop is None or prop.config == sc.flow.config():
                    exhausted.add(victim.name)   # nothing left to give back
                    continue
                gb_mb = 0.0
                if budget_left is not None:
                    gb_mb = _migration_quote(cluster, base, victim,
                                             prop.config)
                    if gb_mb > budget_left - spent + _EPS:
                        blocked = True   # this victim's give-back moves
                        continue         # more than the window has left
                # FFD packing is non-monotone: a shrunk task list
                # can pack into a LARGER fleet.  Quote the give-back
                # BEFORE enacting it and skip this victim when shrinking
                # would not actually free budget — but do NOT mark it
                # exhausted: a later give-back reshapes the fleet and the
                # quote may succeed on the re-rank (only propose_shrink
                # exhaustion, which depends solely on the victim's own
                # config, is stable enough to cache).
                if cluster.shared:
                    if not cluster.reserve_tasks(
                            victim.name, sc.task_requests(prop.config)):
                        continue
                elif not cluster.fits(victim.name,
                                      *sc.resources(prop.config)):
                    continue
                shrunk = sc.shrink_memory()
                assert shrunk is not None   # prop said there was a level
                if not victim.preemptions or victim.preemptions[-1] != w:
                    victim.preemptions.append(w)
                if not cluster.shared:
                    freed = cluster.reserve(victim.name, *shrunk)
                    assert freed            # same quote fits() passed above
                spent += gb_mb
                if budget_left is not None:
                    # the give-backs re-shaped the fleet: the requester's
                    # own move costs the post-preemption price, not the
                    # stale quote taken before victims shrank
                    req_mb = _migration_quote(cluster, base, requester,
                                              new_config)
                    if req_mb > budget_left - spent + _EPS:
                        return False, spent, True
                else:
                    req_mb = 0.0
                if _reserve(cluster, requester, new_config, cpu, mem):
                    return True, spent + req_mb, False
                break               # shares moved: re-rank the victims
            else:
                return False, spent, blocked

    for w in range(windows):
        # the attribution backing the configs that RUN during this window
        # is the one reservations left behind at the previous boundary —
        # matching HistoryRow.memory_mb, which quotes the pre-reconfig
        # config (on preempted windows the victim's mid-window shrink
        # makes its row slightly conservative: it held the pre-shrink
        # grants when the window began)
        att_start = dict(cluster.used_mem)
        budget_left = migration_budget_mb     # per-window allowance
        for t in _arbitration_order(tenants, cluster, admission):
            def admit(scaler, new_config, cpu, mem, _t=t, _w=w):
                nonlocal budget_left
                quote_mb = 0.0
                if budget_left is not None:
                    # a quoted admission whose migration cost exceeds the
                    # window's remaining budget is DEFERRED — the normal
                    # denial/retry path, additionally marked a deferral
                    quote_mb = _migration_quote(cluster, base, _t,
                                                new_config)
                    if quote_mb > budget_left + _EPS:
                        _t.deferrals.append(_w)
                        _t.denials.append(_w)
                        if _t.first_pending is None:
                            _t.first_pending = _w
                        _t.scaler.tracer.record(
                            "admission.defer", "admission",
                            _t.scaler.engine.now, _t.scaler.engine.now,
                            tenant=_t.name, window=_w,
                            args={"quote_mb": quote_mb,
                                  "budget_left_mb": budget_left})
                        return False
                ok = _reserve(cluster, _t, new_config, cpu, mem)
                if ok:
                    if budget_left is not None:
                        budget_left -= quote_mb
                    return True
                if admission == "preemption":
                    ok, spent, blocked = _preempt_for(
                        _t, new_config, cpu, mem, _w, budget_left)
                    if budget_left is not None:
                        # give-backs moved state whether or not the
                        # request ultimately landed
                        budget_left -= spent
                    _t.scaler.tracer.record(
                        "admission.preempt", "admission",
                        _t.scaler.engine.now, _t.scaler.engine.now,
                        tenant=_t.name, window=_w,
                        args={"admitted": ok, "spent_mb": spent,
                              "blocked": blocked})
                    if ok:
                        return True
                    if blocked:
                        _t.deferrals.append(_w)
                _t.denials.append(_w)
                if _t.first_pending is None:
                    _t.first_pending = _w
                return False

            def hook(eng, _w, _t=t):
                if _t.faults is not None:
                    _t.faults_fired.extend(
                        _t.faults.apply_due(eng, eng.now))

            t.scaler.admission = admit
            t.scaler.step_window(w, target_profile=t.profile,
                                 window_hook=hook)
            # sync the enacted footprint (scale-downs release capacity;
            # admitted scale-ups were already reserved at the quoted size,
            # re-reserving the enacted placement keeps them in lockstep).
            # A failed resync of a footprint that GREW means per-tenant
            # accounting has desynced from reality (the enacted placement
            # differs from the quoted one and no longer fits) — a driver
            # invariant violation, never a legitimate denial, so fail
            # loudly.
            cpu_now, mem_now = t.scaler.resources()
            if not _reserve(cluster, t, None, cpu_now, mem_now) \
                    and not (cluster.shared and _footprint_shrank(cluster,
                                                                  t)):
                # (a shared-TM resync of a footprint that SHRANK may be
                # denied by FFD non-monotonicity — a smaller task list
                # repacking into a larger fleet; the previous, larger
                # reservation stays standing, which never under-states
                # the tenant and is corrected at its next successful
                # reservation)
                raise _desync_error(cluster, t, cpu_now, mem_now)
            if not t.history[-1].denied:
                t.first_pending = None
        for t in tenants:
            row = t.history[-1]
            row.amortized_mb = att_start.get(t.name)
            row.preempted = w in t.preemptions
            # provenance reasons the controller cannot see: a budget
            # deferral upgrades this window's denial, and a preemption
            # victim that did not itself reconfigure was "shrunk"
            if t.deferrals and t.deferrals[-1] == w:
                row.reason = REASON_DEFERRED
            if row.preempted and row.reason in (REASON_STEADY,
                                                REASON_TRIGGERED):
                row.reason = REASON_SHRUNK
        result.usage.append((cluster.cpu_in_use, cluster.mem_in_use))
    return result


# ---------------------------------------------------------------------------
# Vectorized driver — structure-of-arrays fleet state
# ---------------------------------------------------------------------------

class _FleetState:
    """Structure-of-arrays tenant state for the vectorized fleet driver.

    Per-tenant scalars the scalar oracle keeps in dicts and Python lists
    live here as numpy arrays indexed by spec order:

    * ``used_cpu`` / ``used_mem`` — each tenant's current cluster
      attribution (mirrors ``Cluster.used_cpu/used_mem``; maintained
      incrementally on private clusters, refreshed from the dicts after
      shared-TM repacks rewrite everyone's attribution);
    * ``targets`` — each tenant's current target rate;
    * ``first_pending`` — window of the oldest unserved request
      (−1 ≡ none), the ``first_come`` age key;
    * ``denied`` / ``deferred`` / ``preempted`` — (windows, tenants)
      per-window outcome flags;
    * ``attributed`` — (windows, tenants) start-of-window memory
      attribution (what ``HistoryRow.amortized_mb`` reports).

    Arbitration order, fair-share ranking and preemption victim ranking
    are array programs over this state — stable sorts chosen to be
    order-identical to the oracle's ``sorted`` calls.

    These arrays stay numpy arrays on the host, as the engine's own
    host-side bookkeeping does: they hold one row a tenant, see a few
    operations a window, and decide the order of the next host call.  On
    the device each ordering would cost a synchronisation a window, and a
    device sort could order ties differently from ``np.argsort(...,
    kind="stable")`` / ``np.lexsort`` and with them the decisions.
    """

    def __init__(self, tenants: list[TenantRun], cluster: Cluster,
                 windows: int):
        n = len(tenants)
        self.tenants = tenants
        self.cluster = cluster
        self.n = n
        self.names = [t.name for t in tenants]
        self.used_cpu = np.zeros(n, dtype=np.int64)
        self.used_mem = np.zeros(n, dtype=np.float64)
        self.targets = np.zeros(n, dtype=np.float64)
        self.first_pending = np.full(n, -1, dtype=np.int64)
        self.denied = np.zeros((windows, n), dtype=bool)
        self.deferred = np.zeros((windows, n), dtype=bool)
        self.preempted = np.zeros((windows, n), dtype=bool)
        self.attributed = np.zeros((windows, n), dtype=np.float64)
        self.refresh()

    def refresh(self) -> None:
        """Pull every tenant's attribution from the cluster dicts into
        the arrays — needed after shared-TM repacks, which rewrite all
        co-residents' amortized shares at once."""
        uc, um = self.cluster.used_cpu, self.cluster.used_mem
        self.used_cpu[:] = np.fromiter((uc.get(nm, 0) for nm in self.names),
                                       np.int64, self.n)
        self.used_mem[:] = np.fromiter(
            (um.get(nm, 0.0) for nm in self.names), np.float64, self.n)

    def set_footprint(self, i: int) -> None:
        """Mirror one tenant's cluster attribution into the arrays (the
        private-cluster incremental path: a reserve touches one row)."""
        name = self.names[i]
        self.used_cpu[i] = self.cluster.used_cpu.get(name, 0)
        self.used_mem[i] = self.cluster.used_mem.get(name, 0.0)

    def shares(self) -> np.ndarray:
        """Every tenant's budget share at once — elementwise the same
        arithmetic as ``Cluster.share`` so the two drivers rank
        identically."""
        return np.maximum(
            self.used_cpu / max(self.cluster.cpu_slots, 1),
            self.used_mem / max(self.cluster.memory_mb, 1e-9))

    def order(self, admission: str) -> np.ndarray:
        """This window's arbitration order as tenant indices — the
        vectorized ``_arbitration_order``.  Stable sorts keep ties in
        spec order, exactly like the oracle's Timsort."""
        if admission in ("priority", "preemption"):
            return np.arange(self.n)
        if self.cluster.shared:
            self.refresh()
        if admission == "fair_share":
            return np.argsort(self.shares(), kind="stable")
        if admission == "first_come":
            fp = self.first_pending
            served = fp < 0
            # sorted(key=(t.first_pending is None, t.first_pending or 0))
            return np.lexsort((np.where(served, 0, fp), served))
        raise ValueError(f"unknown admission policy {admission!r} "
                         f"(have: {', '.join(ADMISSION_POLICIES)})")

    def rank_victims(self, req_idx: int, fair: float,
                     exhausted: np.ndarray) -> np.ndarray:
        """Preemption victim ranking: tenants over their fair allotment,
        biggest excess first, spec priority breaking ties (larger index
        = lower priority = shrinks first) — the vectorized form of the
        oracle's ``sort(key=(fair - share, -prio))``."""
        if self.cluster.shared:
            self.refresh()
        sh = self.shares()
        mask = (sh > fair) & ~exhausted
        mask[req_idx] = False
        idx = np.nonzero(mask)[0]
        if idx.size:
            idx = idx[np.lexsort((-idx, fair - sh[idx]))]
        return idx


def _run_vectorized(tenants: list[TenantRun], cluster: Cluster,
                    result: ColocatedResult, *, windows: int, admission: str,
                    migration_budget_mb: float | None,
                    base: ControllerConfig) -> ColocatedResult:
    """The fleet driver: batches each window's bookkeeping across tenants
    (ordering, ranking, flags, attribution as array programs), caches
    admission quotes fleet-wide, and audits the budget once per window —
    decision-identical to :func:`_run_scalar`."""
    fleet = _FleetState(tenants, cluster, windows)
    result.fleet = fleet
    # admission quotes are pure functions of (query, transformed config)
    # on private clusters: one cache shared by the whole fleet turns N
    # bin_packs per window into one per DISTINCT configuration.  (Shared
    # TM quotes depend on every co-resident's task list — uncacheable.)
    if not cluster.shared:
        quote_cache: dict = {}
        mig_cache: dict | None = {}
        for t in tenants:
            t.scaler.quote_cache = quote_cache
    else:
        mig_cache = None

    def _preempt_for(requester: TenantRun, req_idx: int, new_config: dict,
                     cpu, mem, w: int, budget_left: float | None
                     ) -> tuple[bool, float, bool]:
        """Same state machine as the oracle's ``_preempt_for`` (see
        :func:`_run_scalar` for the full commentary); victim ranking and
        preemption marks go through the fleet arrays."""
        fair = 1.0 / max(fleet.n, 1)
        exhausted = np.zeros(fleet.n, dtype=bool)
        spent = 0.0
        blocked = False
        while True:
            for vi in fleet.rank_victims(req_idx, fair, exhausted):
                vi = int(vi)
                victim = tenants[vi]
                sc = victim.scaler
                prop = sc.policy.propose_shrink(sc.flow, sc.cfg)
                if prop is None or prop.config == sc.flow.config():
                    exhausted[vi] = True
                    continue
                gb_mb = 0.0
                if budget_left is not None:
                    gb_mb = _migration_quote(cluster, base, victim,
                                             prop.config, mig_cache)
                    if gb_mb > budget_left - spent + _EPS:
                        blocked = True
                        continue
                if cluster.shared:
                    if not cluster.reserve_tasks(
                            victim.name, sc.task_requests(prop.config)):
                        continue
                elif not cluster.fits(victim.name,
                                      *sc.resources(prop.config)):
                    continue
                shrunk = sc.shrink_memory()
                assert shrunk is not None
                fleet.preempted[w, vi] = True
                if not cluster.shared:
                    freed = cluster.reserve(victim.name, *shrunk)
                    assert freed
                    fleet.set_footprint(vi)
                spent += gb_mb
                if budget_left is not None:
                    req_mb = _migration_quote(cluster, base, requester,
                                              new_config, mig_cache)
                    if req_mb > budget_left - spent + _EPS:
                        return False, spent, True
                else:
                    req_mb = 0.0
                if _reserve(cluster, requester, new_config, cpu, mem):
                    return True, spent + req_mb, False
                break               # shares moved: re-rank the victims
            else:
                return False, spent, blocked

    for w in range(windows):
        # start-of-window attribution snapshot — one array copy instead
        # of the oracle's dict(cluster.used_mem)
        fleet.attributed[w, :] = fleet.used_mem
        budget_left = migration_budget_mb     # per-window allowance
        for i in fleet.order(admission):
            i = int(i)
            t = tenants[i]

            def admit(scaler, new_config, cpu, mem, _t=t, _i=i, _w=w):
                nonlocal budget_left
                quote_mb = 0.0
                if budget_left is not None:
                    quote_mb = _migration_quote(cluster, base, _t,
                                                new_config, mig_cache)
                    if quote_mb > budget_left + _EPS:
                        fleet.deferred[_w, _i] = True
                        fleet.denied[_w, _i] = True
                        if fleet.first_pending[_i] < 0:
                            fleet.first_pending[_i] = _w
                        _t.scaler.tracer.record(
                            "admission.defer", "admission",
                            _t.scaler.engine.now, _t.scaler.engine.now,
                            tenant=_t.name, window=_w,
                            args={"quote_mb": quote_mb,
                                  "budget_left_mb": budget_left})
                        return False
                ok = _reserve(cluster, _t, new_config, cpu, mem)
                if ok:
                    fleet.set_footprint(_i)
                    if budget_left is not None:
                        budget_left -= quote_mb
                    return True
                if admission == "preemption":
                    ok, spent, blocked = _preempt_for(
                        _t, _i, new_config, cpu, mem, _w, budget_left)
                    if budget_left is not None:
                        budget_left -= spent
                    _t.scaler.tracer.record(
                        "admission.preempt", "admission",
                        _t.scaler.engine.now, _t.scaler.engine.now,
                        tenant=_t.name, window=_w,
                        args={"admitted": ok, "spent_mb": spent,
                              "blocked": blocked})
                    if ok:
                        fleet.set_footprint(_i)
                        return True
                    if blocked:
                        fleet.deferred[_w, _i] = True
                fleet.denied[_w, _i] = True
                if fleet.first_pending[_i] < 0:
                    fleet.first_pending[_i] = _w
                return False

            def hook(eng, _w, _t=t):
                if _t.faults is not None:
                    _t.faults_fired.extend(
                        _t.faults.apply_due(eng, eng.now))

            t.scaler.admission = admit
            t.scaler.step_window(w, target_profile=t.profile,
                                 window_hook=hook)
            cpu_now, mem_now = t.scaler.resources()
            if not _reserve(cluster, t, None, cpu_now, mem_now) \
                    and not (cluster.shared and _footprint_shrank(cluster,
                                                                  t)):
                raise _desync_error(cluster, t, cpu_now, mem_now)
            fleet.set_footprint(i)
            fleet.targets[i] = t.scaler.target
            if not t.history[-1].denied:
                fleet.first_pending[i] = -1
        # ONE fleet-level budget audit per window (each Cluster.reserve
        # already asserts the O(1) running totals; this checks the
        # per-tenant array mirror still sums to them)
        if cluster.shared:
            fleet.refresh()
        assert int(fleet.used_cpu.sum()) == cluster.cpu_in_use \
            and mem_close(float(fleet.used_mem.sum()),
                          cluster.mem_in_use, eps=1e-6) \
            and cluster.cpu_in_use <= cluster.cpu_slots \
            and cluster.mem_in_use <= cluster.memory_mb + _EPS, \
            "fleet accounting desync"
        for j, t in enumerate(tenants):
            row = t.history[-1]
            row.amortized_mb = float(fleet.attributed[w, j])
            row.preempted = bool(fleet.preempted[w, j])
            # provenance reasons the controller cannot see: a budget
            # deferral upgrades this window's denial, and a preemption
            # victim that did not itself reconfigure was "shrunk"
            if fleet.deferred[w, j]:
                row.reason = REASON_DEFERRED
            if row.preempted and row.reason in (REASON_STEADY,
                                                REASON_TRIGGERED):
                row.reason = REASON_SHRUNK
        result.usage.append((cluster.cpu_in_use, cluster.mem_in_use))

    # fold the array flags back into the per-tenant lists the scalar API
    # (and every existing consumer) reads
    for j, t in enumerate(tenants):
        t.denials = [int(x) for x in np.nonzero(fleet.denied[:, j])[0]]
        t.deferrals = [int(x) for x in np.nonzero(fleet.deferred[:, j])[0]]
        t.preemptions = [int(x) for x in np.nonzero(fleet.preempted[:, j])[0]]
        fp = int(fleet.first_pending[j])
        t.first_pending = None if fp < 0 else fp
        t.scaler.quote_cache = None
    return result


def run_colocated(specs: list[ColocatedSpec | tuple], cluster: Cluster,
                  *, windows: int = 8, seed: int = 3, max_level: int = 2,
                  admission: str = "priority",
                  cfg: ControllerConfig | None = None,
                  warm: bool = True,
                  reconfig_cost="instant",
                  migration_budget_mb: float | None = None,
                  driver: str = "vectorized",
                  tracer=None, device=None
                  ) -> ColocatedResult:
    """Step every episode through ``windows`` decision windows in lockstep,
    arbitrating each window's scale-up requests against ``cluster``'s
    remaining budget.

    ``specs`` entries may be :class:`ColocatedSpec` or bare
    ``(policy, query)`` / ``(policy, query, profile)`` tuples.  ``cfg`` is a
    *template* shared by every tenant; each tenant's policy is constructed
    from the registry by its spec's name (any registered policy works, not
    just ds2/justin).  Episodes whose *initial* placement already exceeds
    the budget raise — a cluster that cannot hold the starting
    configurations is a sizing error, not an admission decision.

    With ``admission="preemption"`` the spec list is the priority order
    for *requests*; victims are selected fair-share (see module
    docstring).  On a shared-TM cluster, footprints are task lists packed
    into one fleet and history rows carry each tenant's amortized
    attribution (``amortized_mb``).

    ``reconfig_cost`` (a mechanism name or
    :class:`repro_torch.migration.CostModel`) attaches a migration runtime to
    every tenant: reconfigurations pause the tenant's engine for their
    priced downtime.  ``migration_budget_mb`` caps the state MB the
    arbiter lets *admissions* move per window, across all tenants: a
    quoted admission whose migration cost would blow the remaining
    window budget is deferred — the ordinary denial/retry path, recorded
    additionally in ``TenantRun.deferrals``.  Preemption give-backs are
    migrations too: they are quoted and charged against the same window
    allowance, and the requester is re-quoted after the give-backs
    re-shape the fleet.  (On private-fleet clusters the quote comes from
    the migration planner over the tenant's own placements; on shared-TM
    clusters from the fleet repack.)

    ``driver`` selects the fleet stepping implementation:
    ``"vectorized"`` (default) batches per-window bookkeeping across
    tenants as numpy array programs and scales to thousand-tenant
    fleets; ``"scalar"`` is the original per-tenant loop, kept as the
    decision-identical oracle.

    ``tracer`` (a ``repro_torch.obs.trace.Tracer``) is shared by every tenant's
    controller: all window/policy/admission/migration spans land in one
    stream, tagged per tenant.  Both drivers emit the same spans — the
    per-tenant summary aggregates are equivalence-tested alongside the
    decisions.

    Every tenant's engine runs on ``device`` (``cuda`` unless
    ``device="cpu"`` is passed).
    """
    if admission not in ADMISSION_POLICIES:
        raise ValueError(f"unknown admission policy {admission!r} "
                         f"(have: {', '.join(ADMISSION_POLICIES)})")
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r} "
                         f"(have: {', '.join(DRIVERS)})")
    device = resolve_device(device)
    from repro_torch.migration import CostModel
    cost_model = reconfig_cost if isinstance(reconfig_cost, CostModel) \
        else CostModel(mechanism=reconfig_cost)
    specs = [s if isinstance(s, ColocatedSpec) else ColocatedSpec(*s)
             for s in specs]
    base = cfg or ControllerConfig(justin=JustinParams(max_level=max_level))
    tenants = _setup_tenants(specs, cluster, windows=windows, seed=seed,
                             base=base, warm=warm, cost_model=cost_model,
                             tracer=tracer, device=device)
    result = ColocatedResult(cluster=cluster, tenants=tenants,
                             admission=admission)
    run = _run_vectorized if driver == "vectorized" else _run_scalar
    return run(tenants, cluster, result, windows=windows,
               admission=admission,
               migration_budget_mb=migration_budget_mb, base=base)
