"""State-migration planning: who hands which key range to whom (port of
``repro.migration.planner``; pure host code).

A reconfiguration C^{t-1} -> C^t re-shapes a running placement; the state
that makes streaming reconfiguration *expensive* (the savepoint/stop/
restore cycle the paper's "fewer reconfiguration steps" headline prices
implicitly) has to travel with it.  :func:`plan_migration` turns an
(old placement, new placement) pair into an explicit per-task handoff
plan:

* every task of the new placement receives exactly ONE contiguous slice
  of its operator's hash keyspace — the ownership model behind the
  engine's ``hash_partition`` + lexsort re-partitioning path.  Per
  ``(tenant, op)`` the slices tile ``[0, KEYSPACE)`` exactly once (no
  gaps, no overlaps) — the invariant the property tests pin;
* a task present in both placements whose TaskManager changed is a
  **move**: it drags its managed state across TMs.  The plan's
  :meth:`MigrationPlan.migration_cost` reproduces
  :func:`repro_torch.core.placement.repack`'s ``MigrationCost`` exactly
  (same rule, same grant MB) — the reconciliation invariant;
* an operator whose parallelism changed is **re-partitioned**: every one
  of its new tasks receives its key range re-shuffled from the old
  tasks' stores (the engine's snapshot -> hash-partition -> bulk-load
  path), so the whole operator's state is in flight even though
  ``repack`` (which prices only TM changes of surviving tasks) does not
  charge the newly spawned tasks.

Two MB figures ride on each handoff: ``mb`` is the *managed grant* of the
new placement's task request (what ``repack`` prices — reconciliation),
``payload_mb`` is the *actual* state behind it when the caller supplies
``store_stats`` (measured MB per old task, e.g. from the live LSM
stores) — what a downtime model should price, because a freshly doubled
grant does not double the bytes that move.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.placement import MigrationCost, Placement

# The modeled hash keyspace.  Any power of two works; 2^63 keeps range
# arithmetic in exact ints and leaves headroom over int64 event keys.
KEYSPACE = 1 << 63


def placement_assignment(pl: Placement) -> dict[tuple[str, str, int], int]:
    """Task identity -> TM index for ANY placement (``SharedPlacement``
    has this as a method; private ``Placement``s get it here)."""
    return {t.key: i for i, tm in enumerate(pl.tms) for t in tm.tasks}


@dataclass(frozen=True)
class Handoff:
    """One task's share of a reconfiguration: the key range it owns under
    the new placement, where that state comes from, and what it weighs."""
    task: tuple[str, str, int]       # (tenant, op, index)
    src_tm: int | None               # None == task did not exist before
    dst_tm: int
    key_range: tuple[int, int]       # [lo, hi) slice of the op keyspace
    mb: float                        # managed grant (reconciles with repack)
    payload_mb: float                # measured state MB (falls back to mb)
    tm_moved: bool                   # in both placements, TM changed
    repartitioned: bool              # op parallelism changed: state arrives
                                     # re-shuffled from the old tasks

    @property
    def moves_state(self) -> bool:
        """Does any state physically travel for this handoff?"""
        return self.tm_moved or self.repartitioned


@dataclass
class MigrationPlan:
    """The full handoff list for one reconfiguration, with the three MB
    aggregates the cost mechanisms price: everything (savepoint), only
    what travels (handoff), and the repack-reconcilable move subset."""
    handoffs: list[Handoff] = field(default_factory=list)

    def migration_cost(self) -> MigrationCost:
        """Exactly ``repack``'s rule: tasks present in both placements
        whose TM changed, priced at the NEW placement's grant MB."""
        moved = [h for h in self.handoffs if h.tm_moved]
        return MigrationCost(len(moved), sum(h.mb for h in moved))

    @property
    def tasks_moved(self) -> int:
        return self.migration_cost().tasks_moved

    @property
    def total_mb(self) -> float:
        """Full state footprint under the plan (savepoint writes and
        restores everything, moved or not)."""
        return sum(h.payload_mb for h in self.handoffs)

    @property
    def transfer_mb(self) -> float:
        """State that physically travels: TM moves plus re-partitioned
        operators (what an incremental handoff transfers)."""
        return sum(h.payload_mb for h in self.handoffs if h.moves_state)

    def by_op(self) -> dict[tuple[str, str], list[Handoff]]:
        out: dict[tuple[str, str], list[Handoff]] = {}
        for h in self.handoffs:
            out.setdefault((h.task[0], h.task[1]), []).append(h)
        return out


def _op_ranges(n: int) -> list[tuple[int, int]]:
    """``n`` contiguous slices tiling [0, KEYSPACE) exactly once."""
    return [(i * KEYSPACE // n, (i + 1) * KEYSPACE // n) for i in range(n)]


def plan_migration(old_placement: Placement, new_placement: Placement,
                   store_stats: dict[tuple[str, str, int], float]
                   | None = None) -> MigrationPlan:
    """Plan the state handoffs that take ``old_placement`` to
    ``new_placement``.

    ``store_stats`` optionally maps OLD task identity -> measured state MB
    (e.g. :func:`repro_torch.migration.runtime.engine_store_stats`); handoffs
    then carry the actual payload instead of the managed grant.  A
    re-partitioned operator's old payload is split evenly across its new
    tasks (hash partitioning is uniform in expectation).
    """
    old_at = placement_assignment(old_placement)
    new_at = placement_assignment(new_placement)
    # stats *provided* (even empty — a fully stateless job) means payloads
    # are measured: a task without a store carries 0 MB.  Only stats=None
    # (pure placement-level planning) falls back to the managed grants.
    measured = store_stats is not None
    stats = store_stats or {}

    # group the new placement's tasks per (tenant, op)
    tasks_by_op: dict[tuple[str, str], list] = {}
    for tm in new_placement.tms:
        for t in tm.tasks:
            tasks_by_op.setdefault((t.tenant, t.op), []).append(t)
    old_p: dict[tuple[str, str], int] = {}
    old_payload: dict[tuple[str, str], float] = {}
    for (tenant, op, idx), _tm in old_at.items():
        old_p[(tenant, op)] = old_p.get((tenant, op), 0) + 1
        old_payload[(tenant, op)] = old_payload.get((tenant, op), 0.0) \
            + stats.get((tenant, op, idx), 0.0)

    plan = MigrationPlan()
    for (tenant, op), tasks in tasks_by_op.items():
        seen = {t.index for t in tasks}
        if len(seen) != len(tasks):
            raise ValueError(f"duplicate task index in {tenant!r}/{op!r}")
        tasks = sorted(tasks, key=lambda t: t.index)
        ranges = _op_ranges(len(tasks))
        repart = old_p.get((tenant, op), len(tasks)) != len(tasks)
        for t, rng in zip(tasks, ranges):
            src = old_at.get(t.key)
            dst = new_at[t.key]
            moved = src is not None and src != dst
            if repart:
                # the op's whole state is re-shuffled; this task's share
                # of the old payload arrives hash-partitioned
                payload = old_payload.get((tenant, op), 0.0) / len(tasks) \
                    if measured else t.memory_mb
            else:
                payload = stats.get(t.key, 0.0) if measured \
                    else t.memory_mb
            plan.handoffs.append(Handoff(
                task=t.key, src_tm=src, dst_tm=dst, key_range=rng,
                mb=t.memory_mb, payload_mb=payload,
                tm_moved=moved, repartitioned=repart))
    return plan
