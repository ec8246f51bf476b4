"""Controller-side migration driver: plan, price, pause (port of
``repro.migration.runtime``).

``AutoScaler`` owns an optional :class:`MigrationRuntime`.  When present,
every enacted reconfiguration is planned against the episode's private
placements (old config vs proposed config, packed exactly as admission
quotes pack them), priced by the runtime's :class:`CostModel`, and the
resulting downtime is converted into PAUSED engine time
(``StreamEngine.run_paused``): sources keep producing — input accrues as
queued backlog until backpressure blocks them — while no operator
processes, so the catch-up shows up in the existing SLO metrics with no
new machinery.  The price lands on the decision window's ``HistoryRow``
(``reconfig_downtime`` / ``moved_mb``) and each event is kept for
reporting.

Payloads are measured from the live stores
(:func:`engine_store_stats`): what moves is the state that EXISTS at the
reconfig point, not the managed grant a freshly scaled-up config merely
promises.

On a shared-TM cluster the fleet-level repack cost (what the admission
budget gates — see ``Cluster.quote_migration``) is a different view of
the same reconfiguration: the arbiter prices the *cluster's* re-shape,
this runtime prices the *episode's* downtime.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.placement import bin_pack, default_tm_spec
from repro_torch.migration.costs import CostModel, ReconfigCost
from repro_torch.migration.planner import MigrationPlan, plan_migration


def engine_store_stats(engine, tenant: str = ""
                       ) -> dict[tuple[str, str, int], float]:
    """Measured state MB per live task: ``(tenant, op, index) -> MB`` at
    the paper's logical entry size — the payload a migration actually
    carries, as opposed to the managed grant.  ``state_mb`` is host
    arithmetic over the store's entry counts (Python ints and tensor
    shapes), so a charge reads no device value."""
    out: dict[tuple[str, str, int], float] = {}
    for name, tasks in engine.tasks.items():
        for i, tr in enumerate(tasks):
            if tr.state is not None:
                out[(tenant, name, i)] = tr.state.state_mb
    return out


@dataclass
class ReconfigEvent:
    """One priced reconfiguration, for reporting."""
    t: float
    tenant: str
    old_config: dict
    new_config: dict
    cost: ReconfigCost
    tasks_moved: int


class MigrationRuntime:
    """Prices an episode's reconfigurations and records them.

    Construct from a mechanism name (``"instant"``/``"savepoint"``/
    ``"handoff"``) or a full :class:`CostModel`.  One runtime belongs to
    one episode (events accumulate per tenant); the cost model itself is
    immutable and may be shared.
    """

    def __init__(self, model: CostModel | str = "instant"):
        if isinstance(model, str):
            model = CostModel(mechanism=model)
        self.model = model
        self.events: list[ReconfigEvent] = []

    @property
    def mechanism(self) -> str:
        return self.model.mechanism

    def plan(self, scaler, old_config: dict,
             new_config: dict) -> MigrationPlan:
        """The handoff plan old -> new under the episode's private
        placement (same packing the admission quotes use), with payloads
        measured from the live stores."""
        spec = default_tm_spec(scaler.cfg.base_mem_mb)
        # the controller's own request builder, so the plan packs exactly
        # what admission quotes pack (resources_config coupling, source
        # exclusion, tenant tag)
        old_reqs = scaler.task_requests(old_config)
        new_reqs = scaler.task_requests(new_config)
        stats = engine_store_stats(scaler.engine, tenant=scaler.tenant)
        return plan_migration(bin_pack(old_reqs, spec),
                              bin_pack(new_reqs, spec), stats)

    def charge(self, scaler, old_config: dict,
               new_config: dict) -> ReconfigCost:
        """Plan + price one reconfiguration and record the event."""
        plan = self.plan(scaler, old_config, new_config)
        cost = self.model.price(plan)
        self.events.append(ReconfigEvent(
            t=scaler.engine.now, tenant=scaler.tenant,
            old_config=dict(old_config), new_config=dict(new_config),
            cost=cost, tasks_moved=plan.tasks_moved))
        scaler.tracer.record(
            "migration.charge", "migration", scaler.engine.now,
            scaler.engine.now, tenant=scaler.tenant,
            args={"mechanism": self.mechanism,
                  "downtime_s": cost.downtime_s,
                  "moved_mb": cost.moved_mb,
                  "tasks_moved": plan.tasks_moved})
        return cost

    def totals(self) -> dict:
        """Aggregate event totals (reporting)."""
        return {"reconfigs": len(self.events),
                "downtime_s": sum(e.cost.downtime_s for e in self.events),
                "moved_mb": sum(e.cost.moved_mb for e in self.events),
                "tasks_moved": sum(e.tasks_moved for e in self.events)}
