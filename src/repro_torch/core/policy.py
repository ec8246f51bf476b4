"""Pluggable scaling-policy API: the registry behind every ``--policy`` flag.

The paper positions Justin as one point in a *space* of auto-scaling
policies — it extends DS2 (Kalavri et al., OSDI'18) and evaluates against
it head-to-head; reactive threshold scalers (Dhalion, Floratou et al.,
VLDB'17) are the other obvious family.  This module makes that space a
first-class API so a new policy is an ``import`` + ``@register_policy``,
not a controller edit:

* :class:`ScalingPolicy` — the protocol the controller drives.  A policy
  owns the whole decision surface:

  - ``should_trigger(flow, metrics, target, cfg)`` — does this window need
    a reconfiguration?  (default: the unmodified DS2 trigger);
  - ``propose(flow, metrics, target, cfg)`` — compute the proposed C^t as
    a :class:`Proposal` WITHOUT committing any decision history;
  - ``commit(metrics)`` — the proposal was admitted: fold it into the
    policy's decision history (Justin's Algorithm-1 state lives here, so
    admission-denial semantics belong to the policy, not the controller);
  - ``resources_config(config)`` — the policy's memory-coupling model:
    how an enacted configuration translates into per-task memory grants
    when the placement is quoted (DS2-style packages keep the uniform
    base grant on every slot; Justin grants per level).

* :class:`Proposal` — the per-operator ``(parallelism, memory_level)`` map
  plus whatever pending decision state the policy needs at commit time.

* ``@register_policy("name")`` / :func:`make_policy` /
  :func:`available_policies` — the registry.  ``ControllerConfig.policy``
  is a registry name.

Built-ins: ``ds2``, ``justin`` (decision traces identical to the
reference package's), ``static`` (fixed-allocation baseline) and
``threshold`` (Dhalion-style backpressure-reactive scale-out with uniform
memory).  Port of ``repro.core.policy``; pure host code.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import ds2 as _ds2
from repro_torch.core.justin import (JustinState, OperatorDecision,
                               commit as _justin_commit, justin_policy)
from repro_torch.obs.provenance import (Explain, explain_ds2, explain_justin,
                                  explain_static, explain_threshold)

# A configuration C^t: per-operator (parallelism, memory_level), where the
# level is None (⊥) for operators holding no managed memory.
Config = dict[str, tuple[int, int | None]]


@dataclass
class Proposal:
    """A policy's proposed C^t plus the decision state that must only be
    folded into the policy's history once the proposal is admitted."""
    config: Config
    pending: object | None = None     # policy-private (e.g. Justin's
                                      # OperatorDecision map)
    explain: Explain | None = None    # decision provenance: the signal
                                      # values the proposal was computed
                                      # from (repro_torch.obs.provenance) —
                                      # pure observation, never read back
                                      # by the controller's decisions


class ScalingPolicy:
    """Base class / protocol for auto-scaling policies.

    Subclasses are constructed with the :class:`ControllerConfig` they will
    run under (``make_policy(name, cfg)``) and must implement ``propose``;
    the other hooks have DS2-shaped defaults.  A policy instance belongs to
    ONE episode: it may keep decision history across windows (Justin does).

    The base class does not retain ``cfg``: every hook receives the driving
    controller's cfg per call, which stays the single source of truth.  A
    subclass that needs construction-time parameters derives and stores
    them itself.
    """
    name: str = "?"                   # set by @register_policy

    def __init__(self, cfg):
        self._last: Proposal | None = None

    # ------------------------------------------------------------- protocol
    def should_trigger(self, flow, metrics: dict[str, dict], target: float,
                       cfg) -> bool:
        """Does this window warrant a reconfiguration?  Default: the
        unmodified DS2 trigger (under-rate, or busy + backlog)."""
        return _ds2.should_trigger(flow, metrics, target,
                                   busy_high=cfg.busy_high)

    def propose(self, flow, metrics: dict[str, dict], target: float,
                cfg) -> Proposal:
        """Compute the proposed C^t.  MUST NOT mutate policy history — a
        denied proposal never happened; history moves in ``commit``."""
        raise NotImplementedError

    def commit(self, metrics: dict[str, dict]) -> None:
        """The last proposal was admitted (or enacted): fold its pending
        decision state into the policy's history.  Default: stateless."""
        self._last = None

    def propose_shrink(self, flow, cfg) -> Proposal | None:
        """Preemptive reclamation (§4.3): propose giving back ONE storage
        level — drop the highest occupied memory level by one on the
        operator holding it.  The cluster arbiter drives this when
        another tenant's admission needs the memory
        (``AutoScaler.shrink_memory``).  Returns ``None`` when no operator
        holds a level above 0 — uniform-package policies at the base
        grant have nothing to give back, which is exactly the §4.3
        asymmetry: only hybrid-scaled tenants can be re-shaped in place.
        Like ``propose``, MUST NOT mutate history; ``commit`` does."""
        config = flow.config()
        cands = [(lvl, op) for op, (_p, lvl) in config.items()
                 if lvl is not None and lvl > 0]
        if not cands:
            return None
        lvl, op = max(cands)
        new = dict(config)
        new[op] = (config[op][0], lvl - 1)
        self._last = Proposal(new)
        return self._last

    def resources_config(self, config: Config) -> Config:
        """Map an enacted configuration to the per-task memory grants the
        placement should be quoted with — the policy's memory-coupling
        model.  Default: grants are exactly what the configuration says
        (Justin's heterogeneous per-level model)."""
        return config


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[ScalingPolicy]] = {}


def register_policy(name: str):
    """Class decorator: ``@register_policy("mine")`` makes the policy
    constructible everywhere a ``--policy``/``ControllerConfig.policy``
    name is accepted."""
    def deco(cls):
        if not (isinstance(cls, type) and issubclass(cls, ScalingPolicy)):
            raise TypeError(f"{cls!r} is not a ScalingPolicy subclass")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_policies() -> list[str]:
    """Registered policy names, sorted."""
    return sorted(_REGISTRY)


def make_policy(name: str, cfg) -> ScalingPolicy:
    """Construct a registered policy for one episode under ``cfg``."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scaling policy {name!r} "
            f"(available: {', '.join(available_policies())})") from None
    return cls(cfg)


# ---------------------------------------------------------------------------
# Built-in policies
# ---------------------------------------------------------------------------

@register_policy("ds2")
class DS2Policy(ScalingPolicy):
    """CPU-only DS2 (OSDI'18): enact the parallelism proposal as-is; every
    slot keeps the uniform base managed-memory grant whether its task uses
    it or not — the one-size-fits-all package Takeaway 1 criticizes."""

    def propose(self, flow, metrics, target, cfg) -> Proposal:
        ds2_p = _ds2.ds2_parallelism(flow, metrics, target,
                                     target_busyness=cfg.target_busyness,
                                     max_parallelism=cfg.max_parallelism)
        # memory is coupled to slots: level 0 everywhere (the engine maps
        # stateless operators to ⊥ at enactment)
        self._last = Proposal(
            {op: (p, 0) for op, p in ds2_p.items()},
            explain=explain_ds2(metrics, ds2_p, target, cfg))
        return self._last

    def resources_config(self, config: Config) -> Config:
        return {op: (p, 0) for op, (p, lvl) in config.items()}


@register_policy("justin")
class JustinPolicy(ScalingPolicy):
    """Justin's hybrid policy: Algorithm 1 over the DS2 proposal.  The
    deferred commit lives here — a denied proposal leaves the decision
    history C^0..C^{t-1} untouched, so the same request is re-made at the
    next window boundary."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.state = JustinState()

    def propose(self, flow, metrics, target, cfg) -> Proposal:
        ds2_p = _ds2.ds2_parallelism(flow, metrics, target,
                                     target_busyness=cfg.target_busyness,
                                     max_parallelism=cfg.max_parallelism)
        decisions = justin_policy(flow, metrics, ds2_p, self.state,
                                  cfg.justin)
        self._last = Proposal(
            {op: (d.parallelism, d.memory_level)
             for op, d in decisions.items()},
            pending=decisions,
            explain=explain_justin(metrics, ds2_p, decisions, self.state,
                                   target, cfg.justin))
        return self._last

    def commit(self, metrics: dict[str, dict]) -> None:
        if self._last is not None and self._last.pending is not None:
            _justin_commit(self.state, self._last.pending, metrics)
        self._last = None

    def propose_shrink(self, flow, cfg) -> Proposal | None:
        """A forced give-back enters Algorithm 1's history as a plain
        (not-scaled-up) decision, so the next window evaluates pressure
        afresh instead of judging the shrink as a failed scale-up."""
        prop = super().propose_shrink(flow, cfg)
        if prop is not None:
            prop.pending = {op: OperatorDecision(p, lvl, False)
                            for op, (p, lvl) in prop.config.items()}
        return prop


@register_policy("static")
class StaticPolicy(ScalingPolicy):
    """Fixed-allocation baseline: whatever the episode started with, it
    keeps.  Never triggers, never reconfigures — the floor every elastic
    policy is compared against (and the control for SLO-violation counts
    under dynamic profiles)."""

    def should_trigger(self, flow, metrics, target, cfg) -> bool:
        return False

    def propose(self, flow, metrics, target, cfg) -> Proposal:
        self._last = Proposal({op: (m["parallelism"], m["memory_level"])
                               for op, m in metrics.items()},
                              explain=explain_static(metrics, target))
        return self._last


@register_policy("threshold")
class ThresholdPolicy(ScalingPolicy):
    """Dhalion-style reactive threshold scaler (Floratou et al., VLDB'17):
    no performance model — when the symptom (backpressure) appears, double
    the parallelism of every operator busier than ``busy_high``; memory
    stays a uniform per-slot package like DS2's.  Scale-ins are never
    proposed (the classic ratchet the model-based policies avoid)."""

    scale_factor: float = 2.0

    def propose(self, flow, metrics, target, cfg) -> Proposal:
        sources, sinks = set(flow.sources()), set(flow.sinks())
        out: Config = {op: (m["parallelism"], 0) for op, m in metrics.items()}
        scalable = [n for n in metrics
                    if n not in sources and n not in sinks]
        hot = [n for n in scalable
               if metrics[n]["busyness"] > cfg.busy_high]
        if not hot and scalable:
            # triggered on under-rate alone: without a model, blame the
            # busiest operator
            hot = [max(scalable, key=lambda n: metrics[n]["busyness"])]
        for name in hot:
            p = metrics[name]["parallelism"]
            out[name] = (min(math.ceil(p * self.scale_factor),
                             cfg.max_parallelism), 0)
        self._last = Proposal(
            out, explain=explain_threshold(flow, metrics, target, cfg,
                                           self.scale_factor))
        return self._last

    def resources_config(self, config: Config) -> Config:
        return {op: (p, 0) for op, (p, lvl) in config.items()}
