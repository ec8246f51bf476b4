"""Reconfiguration runtime: state-migration planning, downtime pricing,
and the paused-window mechanics that make a reconfiguration a *priced,
observable* event instead of a free function call (port of
``repro.migration``; pure host code over the port's engine).

See :mod:`repro_torch.migration.planner` (key-range handoff plans),
:mod:`repro_torch.migration.costs` (the instant/savepoint/handoff cost model)
and :mod:`repro_torch.migration.runtime` (the controller-side driver).
"""
from repro_torch.migration.costs import (MECHANISMS, CostModel, ReconfigCost)
from repro_torch.migration.planner import (KEYSPACE, Handoff, MigrationPlan,
                                           plan_migration)
from repro_torch.migration.runtime import (MigrationRuntime, ReconfigEvent,
                                           engine_store_stats)

__all__ = [
    "KEYSPACE", "Handoff", "MigrationPlan", "plan_migration",
    "MECHANISMS", "CostModel", "ReconfigCost",
    "MigrationRuntime", "ReconfigEvent", "engine_store_stats",
]
