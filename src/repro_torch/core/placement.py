"""Task-to-TaskManager placement: multidimensional bin packing (§4.3).
Port of ``repro.core.placement``; pure host code.

Each task needs (1 slot, m MB managed memory); each TM offers ``slots`` slots
and a managed-memory pool.  First-fit-decreasing on memory, spawning a new TM
whenever the packing fails — exactly the Kubernetes-Operator behaviour the
paper describes.  The resource accounting (CPU cores = used slots; memory =
TM base + managed) feeds the §5 comparison plots.

Two packing regimes:

* :func:`placement_for_config` / :func:`bin_pack` — one tenant, a private
  TM fleet.  Every tenant pays the full ``base_mb`` of every TM it spawns.
* :func:`shared_pack` / :func:`repack` — a *cluster-level* packer: multiple
  tenants' tenant-tagged :class:`TaskRequest` lists packed into ONE TM
  fleet (:class:`SharedPlacement`).  Slots and managed MB are attributed
  to the tenant that uses them; each TM's ``base_mb`` (heap/network/
  framework share) is amortized across its co-resident tenants in
  proportion to the slots they occupy — which is exactly the §4.3
  resource-efficiency headline private fleets hide: N co-located tenants
  pay ~1 fleet's base memory, not N.  ``repack`` additionally accounts the
  migration cost of re-shaping a running placement (tasks moved × state
  MB), the §4.3 reconfiguration-cost axis.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.units import mem_fits


@dataclass(frozen=True)
class TMSpec:
    slots: int = 4
    managed_pool_mb: float = 4 * 158.0        # default: 158 MB per slot (§5)
    base_mb: float = 2048.0 - 4 * 158.0       # heap/network/framework share


def default_tm_spec(base_mem_mb: float = 158.0) -> TMSpec:
    """The TM shape ``placement_for_config`` quotes against (pool sized for
    one scale-up headroom per slot) — shared so the cluster-level packer
    prices TMs identically to the per-tenant quotes."""
    return TMSpec(managed_pool_mb=4 * base_mem_mb * 4,
                  base_mb=2048.0 - 4 * base_mem_mb)


@dataclass
class TaskRequest:
    op: str
    index: int
    memory_mb: float
    tenant: str = ""                          # cluster-level packing tag

    @property
    def key(self) -> tuple[str, str, int]:
        """Stable task identity across repacks."""
        return (self.tenant, self.op, self.index)


@dataclass
class TaskManager:
    spec: TMSpec
    tasks: list[TaskRequest] = field(default_factory=list)

    @property
    def used_slots(self) -> int:
        return len(self.tasks)

    @property
    def used_mem(self) -> float:
        return sum(t.memory_mb for t in self.tasks)

    def fits(self, req: TaskRequest) -> bool:
        # used_mem is a float sum: an epsilon-free <= here denies a task
        # that exactly fills the pool whenever the accumulated grants
        # drift a few ULPs high (the Cluster.fits phantom-denial class)
        return (self.used_slots < self.spec.slots
                and mem_fits(self.used_mem + req.memory_mb,
                             self.spec.managed_pool_mb))

    def tenant_slots(self, tenant: str) -> int:
        return sum(1 for t in self.tasks if t.tenant == tenant)

    def tenant_mem(self, tenant: str) -> float:
        return sum(t.memory_mb for t in self.tasks if t.tenant == tenant)


@dataclass
class Placement:
    tms: list[TaskManager]

    @property
    def n_tms(self) -> int:
        return len(self.tms)

    @property
    def cpu_cores(self) -> int:
        return sum(tm.used_slots for tm in self.tms)

    @property
    def memory_mb(self) -> float:
        """Overall consumption (paper §5: heap + network + managed).  A
        spawned TM's heap/network share is reserved at pod creation and
        counts fully; managed memory counts per actual grant — which for DS2
        is the uniform per-slot reservation (Takeaway 1) and for Justin the
        heterogeneous task grants."""
        return sum(tm.spec.base_mb + tm.used_mem for tm in self.tms)


@dataclass
class SharedPlacement(Placement):
    """One TM fleet holding several tenants' tasks, with per-tenant
    attribution: a tenant is charged its own slots and managed grants plus
    a slot-proportional share of each TM's ``base_mb`` it co-resides on.
    Attributions sum exactly to the fleet totals."""

    @property
    def tenants(self) -> list[str]:
        seen: dict[str, None] = {}
        for tm in self.tms:
            for t in tm.tasks:
                seen.setdefault(t.tenant)
        return list(seen)

    def tenant_cpu(self, tenant: str) -> int:
        return sum(tm.tenant_slots(tenant) for tm in self.tms)

    def tenant_memory_mb(self, tenant: str) -> float:
        out = 0.0
        for tm in self.tms:
            slots = tm.tenant_slots(tenant)
            if slots == 0:
                continue
            out += tm.tenant_mem(tenant) \
                + tm.spec.base_mb * slots / tm.used_slots
        return out

    def attribution(self) -> dict[str, tuple[int, float]]:
        """{tenant: (cpu slots, amortized memory MB)} for every tenant."""
        return {t: (self.tenant_cpu(t), self.tenant_memory_mb(t))
                for t in self.tenants}

    def assignment(self) -> dict[tuple[str, str, int], int]:
        """Task identity -> TM index (the repack/migration diff basis)."""
        return {t.key: i for i, tm in enumerate(self.tms) for t in tm.tasks}


@dataclass(frozen=True)
class MigrationCost:
    """Cost of re-shaping a running placement: every task whose TM changed
    drags its managed state with it (§4.3: reconfigurations move state)."""
    tasks_moved: int = 0
    state_mb: float = 0.0

    def __add__(self, other: "MigrationCost") -> "MigrationCost":
        return MigrationCost(self.tasks_moved + other.tasks_moved,
                             self.state_mb + other.state_mb)


def bin_pack(requests: list[TaskRequest], spec: TMSpec = TMSpec(),
             existing: list[TaskManager] | None = None) -> Placement:
    """First-fit-decreasing on memory; spawn TMs on demand."""
    tms = existing or []
    for req in sorted(requests, key=lambda r: -r.memory_mb):
        for tm in tms:
            if tm.fits(req):
                tm.tasks.append(req)
                break
        else:
            tm = TaskManager(spec)
            if not tm.fits(req):
                raise ValueError(
                    f"task {req.op}[{req.index}] needs {req.memory_mb} MB "
                    f"> TM pool {spec.managed_pool_mb} MB")
            tm.tasks.append(req)
            tms.append(tm)
    return Placement(tms)


def shared_pack(requests_by_tenant: dict[str, list[TaskRequest]],
                spec: TMSpec = TMSpec()) -> SharedPlacement:
    """Pack every tenant's tasks into ONE fleet.  Requests are re-tagged
    with their tenant key; the FFD sort is stable, so equal-memory tasks
    keep tenant-insertion order and the packing is deterministic."""
    reqs: list[TaskRequest] = []
    for tenant, rs in requests_by_tenant.items():
        for r in rs:
            reqs.append(TaskRequest(r.op, r.index, r.memory_mb, tenant))
    return SharedPlacement(bin_pack(reqs, spec).tms)


def repack(requests_by_tenant: dict[str, list[TaskRequest]],
           spec: TMSpec = TMSpec(),
           previous: SharedPlacement | None = None
           ) -> tuple[SharedPlacement, MigrationCost]:
    """Re-pack the whole fleet from scratch and price the re-shape against
    ``previous``: tasks present in both placements whose TM changed are
    migrations (count × their state MB).  Newly spawned tasks receive
    re-partitioned state through the engine's reconfigure path and are not
    double-charged here."""
    new = shared_pack(requests_by_tenant, spec)
    if previous is None:
        return new, MigrationCost()
    old_at = previous.assignment()
    moved, mb = 0, 0.0
    for key, tm_idx in new.assignment().items():
        was = old_at.get(key)
        if was is not None and was != tm_idx:
            moved += 1
            mb += next(t.memory_mb for t in new.tms[tm_idx].tasks
                       if t.key == key)
    return new, MigrationCost(moved, mb)


def placement_requests(config: dict[str, tuple[int, int | None]],
                       *, base_mem_mb: float = 158.0,
                       exclude: set[str] | None = None,
                       tenant: str = "") -> list[TaskRequest]:
    """The task list a configuration C^t asks the packer for."""
    from repro_torch.streaming.engine import level_mb
    exclude = exclude or set()
    reqs = []
    for op, (p, lvl) in config.items():
        if op in exclude:
            continue
        for i in range(p):
            reqs.append(TaskRequest(op, i, level_mb(lvl, base_mem_mb),
                                    tenant))
    return reqs


def placement_for_config(config: dict[str, tuple[int, int | None]],
                         *, base_mem_mb: float = 158.0,
                         exclude: set[str] | None = None,
                         spec: TMSpec | None = None) -> Placement:
    """Build the task list from a configuration C^t and pack it."""
    spec = spec or default_tm_spec(base_mem_mb)
    return bin_pack(placement_requests(config, base_mem_mb=base_mem_mb,
                                       exclude=exclude), spec)
