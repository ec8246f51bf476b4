"""JustinServe, the port of ``repro.serve``: the Justin controller over
LLM serving replicas (scale out) and their paged KV-cache HBM budget
(scale up).  Host logic only; see :mod:`repro_torch.serve.engine`."""
from repro_torch.serve.engine import (BASE_HBM_BUDGET, JustinServeController,
                                      ReplicaStats, Request, RequestGen,
                                      ServeCosts, ServingReplica,
                                      WorkloadSpec)
from repro_torch.serve.kv_cache import PagedKVCache, PageMetrics, PageSpec

__all__ = ["BASE_HBM_BUDGET", "JustinServeController", "ReplicaStats",
           "Request", "RequestGen", "ServeCosts", "ServingReplica",
           "WorkloadSpec", "PagedKVCache", "PageMetrics", "PageSpec"]
