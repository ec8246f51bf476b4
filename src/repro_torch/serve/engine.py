"""JustinServe: elastic LLM serving with hybrid replica/memory scaling
(port of ``repro.serve.engine``).

Continuous-batching inference *is* stream processing (DESIGN.md §4):
requests are events, prefill/decode are the stateful operators, the paged
KV cache is the state backend.  The controller drives a registry
:class:`~repro_torch.core.policy.ScalingPolicy` (``ds2``, ``justin``,
``threshold``, or anything ``@register_policy``-ed) over a one-operator
dataflow view of the fleet (:class:`_ServeFlow`) — the same pluggable
surface the streaming controller uses.  Under ``justin``, the unmodified
Algorithm 1 arbitrates:

  * scale OUT  — add decode replicas,
  * scale UP   — double a replica's HBM page budget (bigger prefix cache),

using θ = prefix-page hit rate, τ = average page-fetch latency, and
busyness = fraction of each window spent serving.

The data plane is a cost model, not a model: a request's service time is
:class:`ServeCosts` applied to its prompt tokens not reused from the
prefix cache, its decode tokens and the page fetches its prefix lookup
charged (:class:`~repro_torch.serve.kv_cache.PagedKVCache`).  No prefill or
decode runs here, and nothing here holds a tensor: the controller is host
logic in numpy and float64, in the reference's order, so its decisions
equal the reference's under ``==``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.controller import ControllerConfig
from repro_torch.core.justin import JustinParams
from repro_torch.core.policy import make_policy
from repro_torch.serve.kv_cache import PagedKVCache, PageSpec


@dataclass(frozen=True)
class ServeCosts:
    """Per-request service-time model (ms)."""
    prefill_ms_per_token: float = 0.02
    decode_ms_per_token: float = 0.4
    sched_ms: float = 0.05


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # token ids
    decode_tokens: int


@dataclass
class ReplicaStats:
    busy_ms: float = 0.0
    served_tokens: int = 0
    prefill_tokens: int = 0
    reused_tokens: int = 0


class ServingReplica:
    """One model replica: paged cache + service accounting."""

    def __init__(self, hbm_budget_bytes: int, costs: ServeCosts,
                 spec: PageSpec = PageSpec()):
        self.cache = PagedKVCache(hbm_budget_bytes, spec)
        self.costs = costs
        self.stats = ReplicaStats()

    def serve(self, req: Request) -> float:
        """Process one request; returns service time (ms)."""
        reused, fetch_ms = self.cache.lookup_prefix(req.prompt)
        prefill = len(req.prompt) - reused
        self.cache.insert_prefix(req.prompt)
        ms = (self.costs.sched_ms + fetch_ms
              + prefill * self.costs.prefill_ms_per_token
              + req.decode_tokens * self.costs.decode_ms_per_token)
        self.stats.busy_ms += ms
        self.stats.prefill_tokens += prefill
        self.stats.reused_tokens += reused
        self.stats.served_tokens += req.decode_tokens
        return ms


@dataclass(frozen=True)
class WorkloadSpec:
    """Shared-prefix request mix (system prompts + few-shot prefixes)."""
    n_prefixes: int = 64
    prefix_tokens: int = 2048       # long shared system/few-shot prefixes
    unique_tokens: int = 64
    decode_tokens: int = 16
    seed: int = 0


class RequestGen:
    def __init__(self, spec: WorkloadSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self._prefixes = [
            self.rng.integers(0, 30_000, spec.prefix_tokens).astype(np.int32)
            for _ in range(spec.n_prefixes)]
        self._rid = 0

    def make(self, n: int) -> list[Request]:
        out = []
        for _ in range(n):
            pre = self._prefixes[int(self.rng.integers(len(self._prefixes)))]
            uniq = self.rng.integers(0, 30_000,
                                     self.spec.unique_tokens).astype(np.int32)
            out.append(Request(self._rid,
                               np.concatenate([pre, uniq]),
                               self.spec.decode_tokens))
            self._rid += 1
        return out


BASE_HBM_BUDGET = 512 * 2 * 1024 * 1024      # level 0: 512 pages (1 GB)


class _ServeFlow:
    """The :class:`~repro_torch.core.policy.ScalingPolicy` protocol's dataflow
    view of the serving fleet: one source (the request stream) feeding one
    stateful operator (the replica pool).  Lets the generic registry
    policies — ds2's true-rate model, Justin's Algorithm 1, threshold's
    reactive doubling — drive serving without any serve-specific
    dispatch."""

    def __init__(self, controller: "JustinServeController"):
        self._ctl = controller

    def topo_order(self) -> list[str]:
        return ["requests", "serving"]

    def sources(self) -> list[str]:
        return ["requests"]

    def sinks(self) -> list[str]:
        return []

    def upstream(self, name: str) -> list[str]:
        return ["requests"] if name == "serving" else []

    def downstream(self, name: str) -> list[str]:
        return ["serving"] if name == "requests" else []

    def config(self) -> dict[str, tuple[int, int | None]]:
        return {"requests": (1, None),
                "serving": (len(self._ctl.replicas), self._ctl.level)}


class JustinServeController:
    """A registry :class:`ScalingPolicy` driving (replicas, page-budget
    level) — ``policy`` is any registered name (``ds2``, ``justin``,
    ``threshold``, ...), resolved through ``make_policy`` exactly like
    the streaming controller's; the old internal ds2/justin string
    switch is gone."""

    def __init__(self, target_rps: float, *, policy: str = "justin",
                 costs: ServeCosts = ServeCosts(),
                 workload: WorkloadSpec = WorkloadSpec(),
                 params: JustinParams = JustinParams(),
                 max_replicas: int = 64):
        self.target_rps = target_rps
        self.policy = policy
        self.costs = costs
        self.params = params
        self.max_replicas = max_replicas
        self.gen = RequestGen(workload)
        self.level = 0
        self.replicas = [self._new_replica()]
        # the serve-shaped ControllerConfig the registry policy runs under
        self._cfg = ControllerConfig(policy=policy, justin=params,
                                     max_parallelism=max_replicas)
        self._policy = make_policy(policy, self._cfg)
        self._flow = _ServeFlow(self)
        self.history: list[dict] = []
        self.steps = 0

    def _new_replica(self) -> ServingReplica:
        return ServingReplica(BASE_HBM_BUDGET * (2 ** self.level), self.costs)

    # ------------------------------------------------------------- metrics
    def _run_window(self, seconds: float = 10.0) -> dict:
        n_req = int(self.target_rps * seconds)
        reqs = self.gen.make(n_req)
        for r in self.replicas:
            r.stats = ReplicaStats()
            r.cache.metrics.reset()
        # round-robin dispatch (stateless load balancer)
        for i, req in enumerate(reqs):
            self.replicas[i % len(self.replicas)].serve(req)
        budget_ms = seconds * 1000.0
        busy = np.mean([r.stats.busy_ms / budget_ms for r in self.replicas])
        theta = float(np.mean([r.cache.metrics.hit_rate
                               for r in self.replicas]))
        tau = float(np.mean([r.cache.metrics.avg_fetch_ms
                             for r in self.replicas]))
        served = sum(r.stats.busy_ms <= budget_ms for r in self.replicas)
        capacity_rps = sum(
            min(1.0, budget_ms / max(r.stats.busy_ms, 1e-9))
            for r in self.replicas) * n_req / len(self.replicas) / seconds
        return {
            # the request stream, as the policy protocol's source operator
            "requests": {
                "stateful": False,
                "parallelism": 1,
                "memory_level": None,
                "busyness": 0.0,
                "busy_s": 0.0,
                "processed": n_req,
                "rate_in": n_req / seconds,
                "rate_out": n_req / seconds,
                "rate_processed": n_req / seconds,
                "selectivity": 1.0,
                "theta": None,
                "tau_ms": None,
                "backlog": 0,
                "blocked": False,
            },
            "serving": {
                "stateful": True,
                "parallelism": len(self.replicas),
                "memory_level": self.level,
                "busyness": min(float(busy), 1.0),
                "busy_s": sum(r.stats.busy_ms for r in self.replicas) / 1e3,
                "processed": n_req,
                "rate_in": n_req / seconds,
                "rate_out": min(capacity_rps, n_req / seconds),
                "rate_processed": n_req / seconds,
                "selectivity": 1.0,
                "theta": theta,
                "tau_ms": tau,
                "backlog": max(0.0, busy - 1.0),
                "blocked": busy > 1.0,
            }
        }

    # -------------------------------------------------------------- control
    def autoscale(self, max_rounds: int = 8) -> dict:
        for _ in range(max_rounds):
            metrics = self._run_window()
            m = metrics["serving"]
            over = m["busyness"] > 0.8
            self.history.append({"replicas": len(self.replicas),
                                 "level": self.level, **m})
            if not over:
                break
            # the registry policy owns the whole proposal surface: ds2's
            # true-rate model, Justin's Algorithm 1 over it (cancel-out +
            # HBM scale-up), threshold's doubling — no string dispatch.
            # Serving always enacts, so propose-and-commit in one go.
            proposal = self._policy.propose(self._flow, metrics,
                                            self.target_rps, self._cfg)
            self._policy.commit(metrics)
            p_new, lvl = proposal.config["serving"]
            if (p_new, lvl or 0) == (len(self.replicas), self.level):
                continue                    # proposal == current config
            self.steps += 1
            self.level = lvl or 0
            while len(self.replicas) < p_new:
                self.replicas.append(self._new_replica())
            del self.replicas[p_new:]
            for r in self.replicas:
                r.cache.resize(BASE_HBM_BUDGET * (2 ** self.level))
        last = self.history[-1]
        hbm_gb = (len(self.replicas) * BASE_HBM_BUDGET * (2 ** self.level)
                  / 2**30)
        return {"policy": self.policy, "steps": self.steps,
                "replicas": len(self.replicas), "level": self.level,
                "busyness": last["busyness"], "theta": last["theta"],
                "hbm_cache_gb": hbm_gb}
