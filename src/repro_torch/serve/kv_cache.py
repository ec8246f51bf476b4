"""Paged, two-tier KV cache with prefix reuse — the serving analogue of the
paper's RocksDB state backend (DESIGN.md §4).  Port of
``repro.serve.kv_cache``: host bookkeeping in numpy and Python, no tensor.

* Pages (fixed token count) live in an HBM tier (fast, budgeted) or a host
  tier (slow).  The HBM budget is Justin's "managed memory": scale-up grows
  it by powers of two.
* A prefix index maps token-block hashes to pages (vLLM-style prefix
  caching).  The prefix *hit rate* is θ; the average *page-fetch latency*
  (host->HBM promotions on miss) is τ — exactly the metrics Algorithm 1
  consumes.
* Eviction HBM->host is CLOCK, like the LSM block cache.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PageMetrics:
    lookups: int = 0
    prefix_hits: int = 0
    hbm_hits: int = 0
    host_fetches: int = 0
    evictions: int = 0
    fetch_latency_total_ms: float = 0.0

    @property
    def hit_rate(self) -> float:
        return self.hbm_hits / self.lookups if self.lookups else 1.0

    @property
    def avg_fetch_ms(self) -> float:
        return (self.fetch_latency_total_ms / self.lookups
                if self.lookups else 0.0)

    def reset(self) -> None:
        self.__init__()


@dataclass(frozen=True)
class PageSpec:
    page_tokens: int = 64
    page_bytes: int = 2 * 1024 * 1024     # kv bytes per page (model-dep.)
    host_fetch_ms: float = 0.5            # PCIe/DMA promotion cost
    hbm_hit_ms: float = 0.002


class PagedKVCache:
    """Control-plane page table: which prefix blocks hold a page and in
    which tier.  It moves no KV bytes; its counters feed θ and τ."""

    def __init__(self, hbm_budget_bytes: int, spec: PageSpec = PageSpec()):
        self.spec = spec
        self.metrics = PageMetrics()
        self.resize(hbm_budget_bytes)
        self.prefix_index: dict[int, int] = {}     # block hash -> page id
        self.page_tier: dict[int, str] = {}        # page id -> "hbm"|"host"
        self.page_ref: dict[int, int] = {}         # CLOCK reference bits
        self._next_page = 0
        self._clock: list[int] = []
        self._hand = 0

    def resize(self, hbm_budget_bytes: int) -> None:
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        self.hbm_capacity = max(1, self.hbm_budget_bytes
                                // self.spec.page_bytes)

    @property
    def hbm_pages(self) -> int:
        return sum(1 for t in self.page_tier.values() if t == "hbm")

    # ------------------------------------------------------------------ ops
    @staticmethod
    def block_hash(tokens: np.ndarray, upto: int) -> int:
        return hash(tokens[:upto].tobytes())

    def lookup_prefix(self, tokens: np.ndarray) -> tuple[int, float]:
        """Longest cached prefix for a request: returns (tokens reused,
        latency charged).  Every page of the reused prefix is touched (the
        decode step reads all of its KV blocks); pages evicted to the host
        tier are promoted back and charged the fetch cost — that is the τ
        Algorithm 1 watches, and per-page HBM residency is its θ.
        """
        pt = self.spec.page_tokens
        reused = 0
        lat = 0.0
        depth = 0
        for nblocks in range(len(tokens) // pt, 0, -1):
            if self.block_hash(tokens, nblocks * pt) in self.prefix_index:
                depth = nblocks
                break
        if depth == 0:
            self.metrics.lookups += 1          # full miss
            self.metrics.fetch_latency_total_ms += lat
            return 0, lat
        self.metrics.prefix_hits += 1
        for j in range(1, depth + 1):          # touch every reused page
            page = self.prefix_index.get(self.block_hash(tokens, j * pt))
            if page is None:
                continue
            self.metrics.lookups += 1
            if self.page_tier[page] == "hbm":
                self.metrics.hbm_hits += 1
                lat += self.spec.hbm_hit_ms
            else:
                self.metrics.host_fetches += 1
                lat += self.spec.host_fetch_ms
                self._promote(page)
            self.page_ref[page] = 1
        reused = depth * pt
        self.metrics.fetch_latency_total_ms += lat
        return reused, lat

    def insert_prefix(self, tokens: np.ndarray) -> None:
        pt = self.spec.page_tokens
        for nblocks in range(1, len(tokens) // pt + 1):
            h = self.block_hash(tokens, nblocks * pt)
            if h not in self.prefix_index:
                self.prefix_index[h] = self._alloc_page()

    def _alloc_page(self) -> int:
        page = self._next_page
        self._next_page += 1
        self.page_tier[page] = "hbm"
        self.page_ref[page] = 1
        self._clock.append(page)
        self._evict_to_budget()
        return page

    def _promote(self, page: int) -> None:
        self.page_tier[page] = "hbm"
        self._evict_to_budget(exclude=page)

    def _evict_to_budget(self, exclude: int | None = None) -> None:
        guard = 0
        while self.hbm_pages > self.hbm_capacity and self._clock \
                and guard < 4 * len(self._clock):
            guard += 1
            page = self._clock[self._hand % len(self._clock)]
            self._hand = (self._hand + 1) % max(len(self._clock), 1)
            if page == exclude or self.page_tier.get(page) != "hbm":
                continue
            if self.page_ref.get(page, 0):
                self.page_ref[page] = 0
                continue
            self.page_tier[page] = "host"
            self.metrics.evictions += 1
