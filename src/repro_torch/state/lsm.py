"""Columnar delta LSM state backend on torch tensors — the RocksDB
analogue Justin observes.  Port of ``repro.state.lsm`` (columnar store).

Structure and every charge follow the reference store line for line:

* **MemTable** — an append-only stack of sorted-unique delta runs
  (keys, per-key occurrence weights, newest payloads) over collapsed
  tiers; every ``MEMTABLE_RUNS`` runs are consolidated by one stable sort
  and a per-key weight segment sum (``window_agg``).
* **Block cache** — set-associative CLOCK cache, bit-identical to the
  sequential scan (its hit rate is Justin's θ).
* **Levels** — sorted-unique runs with size-tiered compaction; merges add
  weights of duplicate keys and let the newer payload win.  Probes are
  batched sorted-run ranks (``sorted_probe``).

All arrays live on the store's device.  On CUDA every sorted-run probe
goes through the hand-written ``sorted_probe`` kernel — the level probes,
the per-run memtable fallback and the packed source-major memtable probe
— and every weight segment sum through ``window_agg``; on the CPU both
run their plain PyTorch versions.  Weight sums stay int64 end to end.
``make_store`` builds the store ``set_store_impl`` selects: this
one, or the frozen pre-columnar ``state.legacy.LegacyLSMStore``.

Host arithmetic (every metric charge, θ and τ inputs) stays Python
float64/int in the reference's order.  Where the reference relies on
numpy specifics the port keeps the semantics:

* ``np.unique(..., return_index)`` becomes a stable sort plus group
  boundaries (a stable sort's permutation is unique, so it equals
  numpy's);
* bool ``argmax`` becomes a ``uint8`` argmax (ties go to the first index);
* every scatter has unique indices (the reference dedupes before each
  one), so CUDA's unordered ``index_put_`` cannot pick another winner;
* the reference's uint16 radix casts are plain stable sorts — same
  permutation.

``int(...)``, ``.any()``, ``.all()`` and boolean indexing on device
tensors synchronise the host with the card; ``get_batch`` pays a handful
of these per call.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.sorted_probe.ops import probe
from repro_torch.kernels.window_agg.ops import aggregate
from repro_torch.streaming.events import mix_hash

LOGICAL_ENTRY_BYTES = 1_000          # paper §3: 1000 B events
MEMTABLE_GRANULARITY_MB = 64         # first-level SSTable size (paper §3)
CACHE_OVERHEAD = 2.5                 # block granularity + index/filter share
                                     # (RocksDB caches blocks, not entries)
MEMTABLE_RUNS = 8                    # delta runs absorbed before a
                                     # consolidation pass

# CLOCK-scan lookup tables for the 8-way cache: ref bits of one set pack
# into a byte, so "first zero way at/after the hand" and "unpack ref byte
# to the [W] int8 row" become O(1) table gathers per set.
_CLOCK_POW2 = (1 << np.arange(8)).astype(np.int32)
_CLOCK_UNPACK = ((np.arange(256)[:, None] >> np.arange(8)) & 1).astype(np.int8)
_CLOCK_FIRST_ZERO = np.where(np.arange(256) == 255, 8,
                             np.argmin(_CLOCK_UNPACK, axis=1)).astype(np.int64)
_CLOCK_TABLES: dict[str, tuple[torch.Tensor, ...]] = {}


def _clock_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    key = str(device)
    t = _CLOCK_TABLES.get(key)
    if t is None:
        t = tuple(torch.from_numpy(a).to(device) for a in
                  (_CLOCK_POW2, _CLOCK_UNPACK, _CLOCK_FIRST_ZERO))
        _CLOCK_TABLES[key] = t
    return t


def stable_argsort_keys(a: torch.Tensor) -> torch.Tensor:
    """Stable argsort of an int64 key tensor.  The reference radix-sorts
    non-negative keys below 2^32 in two 16-bit passes, a numpy speed-up
    whose permutation equals the stable sort's; so this is the stable
    sort."""
    return torch.sort(a, stable=True).indices


def _nz(mask: torch.Tensor) -> torch.Tensor:
    """Indices where ``mask`` holds (``np.flatnonzero``)."""
    return torch.nonzero(mask).reshape(-1)


def _group_bounds(sk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """For a non-empty sorted key tensor: (first-of-group mask, group
    start indices, group last indices)."""
    n = sk.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=sk.device)
    torch.ne(sk[1:], sk[:-1], out=first[1:])
    starts = _nz(first)
    last = torch.empty_like(starts)
    last[:-1] = starts[1:] - 1
    last[-1] = n - 1
    return first, starts, last


def merge_delta_runs(k1: torch.Tensor, w1: torch.Tensor, v1: torch.Tensor,
                     k2: torch.Tensor, w2: torch.Tensor, v2: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge two sorted-unique delta runs: weights of duplicate keys ADD
    (Z-set delta addition), side-1 (newer) payloads win.  O(n) scatter
    instead of re-sorting the concatenation.  Inputs are never mutated,
    so published runs stay frozen."""
    if not len(k1):
        return k2, w2, v2
    if not len(k2):
        return k1, w1, v1
    pos, dup = probe(k1, k2)
    pos = pos.long()
    if bool(dup.any()):
        w1 = w1.clone()
        pd = pos[dup]
        w1[pd] = w1[pd] + w2[dup]     # k2 unique => conflict-free scatter
        keep = ~dup
        pos = pos[keep]
        k2, w2, v2 = k2[keep], w2[keep], v2[keep]
    n1, n2 = len(k1), len(k2)
    dev = k1.device
    out_k = torch.empty(n1 + n2, dtype=k1.dtype, device=dev)
    out_w = torch.empty(n1 + n2, dtype=w1.dtype, device=dev)
    out_v = torch.empty((n1 + n2,) + tuple(v1.shape[1:]), dtype=v1.dtype,
                        device=dev)
    i1, i2 = _interleave_slots(pos, n1)
    out_k[i1], out_w[i1], out_v[i1] = k1, w1, v1
    out_k[i2], out_w[i2], out_v[i2] = k2, w2, v2
    return out_k, out_w, out_v


def _interleave_slots(pos: torch.Tensor, n1: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Output slots of merging a sorted run of ``n1`` keys with sorted
    keys none of which it holds, given their insertion points ``pos``
    into it (one probe gives both maps): such a key lands at its rank
    plus its insertion point, and a run key shifts by the count of keys
    inserted at or before it (a bincount running sum)."""
    dev = pos.device
    i2 = torch.arange(len(pos), device=dev) + pos
    cum = torch.cumsum(torch.bincount(pos, minlength=n1 + 1), 0)
    i1 = torch.arange(n1, device=dev) + cum[:n1]
    return i1, i2


@dataclass
class LSMMetrics:
    reads: int = 0
    writes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    memtable_hits: int = 0
    level_probes: int = 0            # SSTable lookups (slow tier)
    flushes: int = 0
    compactions: int = 0
    access_latency_total_ms: float = 0.0

    def snapshot(self) -> dict:
        return dict(self.__dict__)

    def counters(self) -> tuple:
        """O(1) hot-path view for the engine's per-task charge marks:
        (reads, writes, cache_hits, cache_misses, level_probes,
        access_latency_total_ms)."""
        return (self.reads, self.writes, self.cache_hits, self.cache_misses,
                self.level_probes, self.access_latency_total_ms)

    def maintenance(self) -> tuple[int, int]:
        """(flushes, compactions) — the background-work counters."""
        return (self.flushes, self.compactions)

    def reset(self) -> None:
        for k in self.__dict__:
            setattr(self, k, 0 if not k.startswith("access") else 0.0)

    @property
    def cache_hit_rate(self) -> float:
        tot = self.cache_hits + self.cache_misses
        return self.cache_hits / tot if tot else 1.0

    @property
    def avg_access_latency_ms(self) -> float:
        tot = self.reads + self.writes
        return self.access_latency_total_ms / tot if tot else 0.0


@dataclass(frozen=True)
class LatencyModel:
    """Calibrated per-access costs (ms); see ``repro.state.lsm``."""
    memtable_ms: float = 0.002
    cache_ms: float = 0.002
    level_ms: float = 0.5            # per level probed on a miss
    bloom_ms: float = 0.001          # bloom check for an absent key
    bloom_fp: float = 0.01           # bloom false-positive rate
    meta_ratio: float = 8.0          # data entries per filter/index-block
                                     # cache-entry-equivalent
    meta_read_frac: float = 0.5      # cost of a filter-block disk read,
                                     # as a fraction of a data-block read
    write_ms: float = 0.07           # WAL append share
    flush_ms: float = 0.14           # per entry flushed to L0
    compact_ms: float = 0.05         # per entry rewritten in a merge
    flush_fixed_ms: float = 150.0    # write-stall per flush


Run = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class LSMStore:
    """Columnar delta LSM over int64 keys -> fixed-width int32 payloads,
    with per-key int64 weights (write-occurrence counts)."""

    _MEM_SHIFT = 45                  # source-major probe prefix width

    def __init__(self, memory_mb: float, *, value_words: int = 4,
                 fanout: int = 8, latency: LatencyModel | None = None,
                 entry_bytes: int = LOGICAL_ENTRY_BYTES, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.value_words = value_words
        self.entry_bytes = entry_bytes            # logical entry size
        self._wscale = entry_bytes / LOGICAL_ENTRY_BYTES  # IO-cost scaling
        self.latency = latency or LatencyModel()
        self.metrics = LSMMetrics()
        self.compact_filter = None                # optional keys->keep mask
        self.annihilated = 0          # weight dropped by compaction filters
        self._configure_memory(memory_mb)
        # sorted-unique (keys, weights, vals) runs, newest first
        self.levels: list[Run] = []
        self.fanout = fanout
        self._empty()

    # -- memory layout (§3: memtable <= 64 MB, > half to cache, pow2) --
    def _configure_memory(self, memory_mb: float) -> None:
        self.memory_mb = float(memory_mb)
        mem_budget = memory_mb * 1024 * 1024
        memtable_b = MEMTABLE_GRANULARITY_MB * 1024 * 1024
        while memtable_b >= mem_budget / 2:    # cache gets MORE than half
            memtable_b //= 2                   # (paper §3: 128 -> 32+96)
        cache_b = mem_budget - memtable_b
        self.memtable_cap = max(64, int(memtable_b // self.entry_bytes))
        n_cache = max(64, int(cache_b // (self.entry_bytes
                                          * CACHE_OVERHEAD)))
        self.cache_ways = 8      # the CLOCK scans pack a set's refs in a byte
        self.cache_sets = max(8, n_cache // self.cache_ways)

    def _empty(self) -> None:
        dev = self.device
        self.mem_n = 0                # RAW write count (flush cadence key)
        self._runs: list[Run] = []
        # collapsed delta tiers, newest first, geometrically merged
        self._tiers: list[Run] = []
        self.cache_keys = torch.full((self.cache_sets, self.cache_ways), -1,
                                     dtype=torch.int64, device=dev)
        self.cache_vals = torch.zeros(
            (self.cache_sets, self.cache_ways, self.value_words),
            dtype=torch.int32, device=dev)
        self.cache_ref = torch.zeros((self.cache_sets, self.cache_ways),
                                     dtype=torch.int8, device=dev)
        self.cache_hand = torch.zeros(self.cache_sets, dtype=torch.int32,
                                      device=dev)
        self._cache_virgin = True        # enables the closed-form first fill
        self._mbt = None                 # batched memtable probe cache

    def _empty_run(self) -> Run:
        dev = self.device
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty((0, self.value_words), dtype=torch.int32,
                            device=dev))

    # ------------------------------------------------------------------ util
    @property
    def entry_count(self) -> int:
        return self.mem_n + sum(len(k) for k, _, _ in self.levels)

    @property
    def state_mb(self) -> float:
        """Logical state footprint — what migration planning prices."""
        return self.entry_count * self.entry_bytes / 2**20

    def total_weight(self) -> int:
        """Live delta weight across memtable + levels (diagnostic)."""
        w = sum(int(r[1].sum()) for r in self._runs)
        w += sum(int(t[1].sum()) for t in self._tiers)
        return w + sum(int(lw.sum()) for _, lw, _ in self.levels)

    def resize(self, memory_mb: float) -> None:
        """Vertical rescale: rebuild memtable/cache under the new budget,
        spilling the consolidated memtable into level 0."""
        if self.mem_n:
            self._push_run(*self._memtable_merged())
        self._configure_memory(memory_mb)
        self._empty()

    def items(self) -> tuple[torch.Tensor, torch.Tensor]:
        """All live (key, value) pairs, newest write winning — exactly
        what ``get_batch`` returns."""
        k, _, v = self._items_weighted()
        return k, v

    def _items_weighted(self) -> Run:
        # one N-way collapse over every live run, ordered oldest -> newest
        sources = [s for s in (self.levels[::-1] + self._tiers[::-1]
                               + self._runs) if len(s[0])]
        acc = self._collapse(sources)
        if len(sources) == 1:
            # single live source: hand the caller copies, not the live run
            acc = tuple(a.clone() for a in acc)
        return acc

    # ---------------------------------------------------------- kernel hooks
    def _probe_run(self, run_keys: torch.Tensor, queries: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched sorted-run rank (``sorted_probe``): (clipped position,
        hit mask).  Positions are only meaningful where ``hit``."""
        pos, hit = probe(run_keys, queries)
        return pos.long().clamp_(max=len(run_keys) - 1), hit

    def _segment_sum(self, sorted_w: torch.Tensor, starts: torch.Tensor,
                     first_mask: torch.Tensor) -> torch.Tensor:
        """Per-unique-key int64 weight sum over key-sorted deltas — the
        consolidation reduction (``window_agg``)."""
        gids = torch.cumsum(first_mask, 0) - 1
        sums, _ = aggregate(gids, sorted_w[:, None], len(starts))
        return sums[:, 0]

    # ------------------------------------------------------------- write path
    @staticmethod
    def _delta_of(keys: torch.Tensor, vals: torch.Tensor) -> Run:
        """One write batch as a delta run: sorted unique keys, per-key
        occurrence weight, newest (last-written) payload — ``np.unique``
        over the reversed batch with ``return_index``/``return_counts``."""
        if not len(keys):
            return keys[:0], torch.zeros(0, dtype=torch.int64,
                                         device=keys.device), vals[:0]
        sk, order = torch.sort(keys, stable=True)
        _, starts, last = _group_bounds(sk)
        # the stable sort keeps arrival order within a key group, so the
        # group's last slot holds the newest write
        return sk[starts], last - starts + 1, vals[order[last]]

    def put_batch(self, keys: torch.Tensor, vals: torch.Tensor) -> Run:
        """Apply one write batch; returns its delta decomposition
        (sorted unique keys, occurrence weights, newest payloads) so a
        caller probing a monotone transform of the same key batch can
        reuse the sort via ``get_batch``'s ``uhint``."""
        n = len(keys)
        self.metrics.writes += n
        self.metrics.access_latency_total_ms += \
            n * self.latency.write_ms * self._wscale
        uq, w, uv = self._delta_of(keys, vals)   # shared by runs + cache
        if n <= self.memtable_cap - self.mem_n:  # fast path: fits in room
            self.mem_n += n
            self._append_delta(uq, w, uv)
            if self.mem_n >= self.memtable_cap:
                self._flush()
        else:                                    # crosses flush boundaries
            off = 0
            while off < n:
                room = self.memtable_cap - self.mem_n
                take = min(room, n - off)
                self.mem_n += take
                self._append_delta(*self._delta_of(keys[off:off + take],
                                                   vals[off:off + take]))
                off += take
                if self.mem_n >= self.memtable_cap:
                    self._flush()
        # write-through invalidate/update of cached copies
        self._cache_apply(uq, uv)
        return uq, w, uv

    def _append_delta(self, uq: torch.Tensor, w: torch.Tensor,
                      uv: torch.Tensor) -> None:
        self._runs.append((uq, w, uv))
        if len(self._runs) >= MEMTABLE_RUNS:
            self._consolidate()

    def _collapse(self, sources: list[Run]) -> Run:
        """N-way collapse of delta runs ordered OLDEST -> NEWEST: one stable
        sort over the concatenation, segment weight-sum per unique key
        (``window_agg``), newest payload wins (last in each key group
        under the stable sort)."""
        sources = [s for s in sources if len(s[0])]
        if not sources:
            return self._empty_run()
        if len(sources) == 1:
            return sources[0]
        keys = torch.cat([r[0] for r in sources])
        wts = torch.cat([r[1] for r in sources])
        vals = torch.cat([r[2] for r in sources])
        sk, order = torch.sort(keys, stable=True)   # ties oldest->newest
        first, starts, last = _group_bounds(sk)
        out_w = self._segment_sum(wts[order], starts, first)
        return sk[starts], out_w, vals[order[last]]

    def _consolidate(self) -> None:
        """Collapse the delta-run stack into one tier, then geometrically
        merge tiers (a tier absorbs its neighbor once it has grown to at
        least half its size)."""
        if not self._runs:
            return
        self._tiers.insert(0, self._collapse(self._runs))
        self._runs = []
        while (len(self._tiers) > 1
               and 2 * len(self._tiers[0][0]) >= len(self._tiers[1][0])):
            newer = self._tiers.pop(0)
            self._tiers[0] = merge_delta_runs(*newer, *self._tiers[0])

    def _memtable_merged(self) -> Run:
        """Full memtable content: sorted unique keys, summed weights, newest
        payloads.  Commits the pending consolidation."""
        if self._runs or len(self._tiers) > 1:
            merged = self._collapse(self._tiers[::-1] + self._runs)
            self._runs = []
            self._tiers = [merged]
        return self._tiers[0] if self._tiers else self._empty_run()

    def bulk_load(self, keys: torch.Tensor, vals: torch.Tensor,
                  weights: torch.Tensor | None = None) -> None:
        """Pre-population fast path: dedupe (newest wins) and install
        everything as one sorted run, bypassing the memtable.  No latency
        is charged and no metrics are touched.  ``weights`` (for
        already-deduped input) preserves delta weights across
        snapshot/restore; without it each occurrence weighs 1."""
        if len(keys) == 0:
            return
        if weights is not None:
            self.levels.insert(0, (keys, torch.as_tensor(
                weights, dtype=torch.int64, device=self.device), vals))
            return
        self.levels.insert(0, self._delta_of(keys, vals))

    def install_run(self, keys: torch.Tensor, vals: torch.Tensor,
                    weights: torch.Tensor | None = None) -> None:
        """Engine state-install entry point: ``keys`` already key-sorted,
        installed as one run with size-tiered compaction applied."""
        if weights is None:
            weights = torch.ones(len(keys), dtype=torch.int64,
                                 device=self.device)
        self._push_run(keys, weights, vals)

    def _flush(self) -> None:
        if self.mem_n == 0:
            return
        uniq, wts, fvals = self._memtable_merged()
        if self.compact_filter is not None and len(uniq):
            keep = self.compact_filter(uniq)
            if not bool(keep.all()):
                self.annihilated += int(wts[~keep].sum())
                uniq, wts, fvals = uniq[keep], wts[keep], fvals[keep]
        self._push_run(uniq, wts, fvals)
        self.mem_n = 0
        self._runs = []
        self._tiers = []
        self.metrics.flushes += 1
        self.metrics.access_latency_total_ms += \
            (len(uniq) * self.latency.flush_ms
             + self.latency.flush_fixed_ms) * self._wscale

    def _push_run(self, keys: torch.Tensor, weights: torch.Tensor,
                  vals: torch.Tensor) -> None:
        self.levels.insert(0, (keys, weights, vals))
        # size-tiered compaction: merge while a level outgrows fanout^i
        base = max(self.memtable_cap, 1)
        i = 0
        while i < len(self.levels) - 1:
            if len(self.levels[i][0]) >= base * (self.fanout ** i):
                self._merge_levels(i)
                self.metrics.compactions += 1
            else:
                i += 1

    def _merge_levels(self, i: int) -> None:
        k1, w1, v1 = self.levels[i]          # newer
        k2, w2, v2 = self.levels[i + 1]      # older
        n_in = len(k1) + len(k2)
        uniq, wts, vals = merge_delta_runs(k1, w1, v1, k2, w2, v2)
        if self.compact_filter is not None and len(uniq):
            keep = self.compact_filter(uniq)
            if not bool(keep.all()):
                self.annihilated += int(wts[~keep].sum())
                uniq, wts, vals = uniq[keep], wts[keep], vals[keep]
        self.levels[i + 1] = (uniq, wts, vals)
        del self.levels[i]
        self.metrics.access_latency_total_ms += \
            n_in * self.latency.compact_ms * self._wscale

    # -------------------------------------------------------------- read path
    def get_batch(self, keys: torch.Tensor,
                  uhint: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (values [n, V], found mask [n]) and updates θ/τ metrics.

        ``uhint`` is an optional precomputed ``(unique_keys, counts)`` for
        ``keys`` (it MUST equal ``torch.unique(keys, return_counts=True)``);
        the inverse map is then recovered with one probe.  Duplicate-probe
        accounting is the reference's: the block cache is probed once per
        *unique* key; duplicates of a resolved key are charged as hits,
        duplicates of absent keys re-walk the bloom filters."""
        n = len(keys)
        lat_model = self.latency
        dev = self.device
        self.metrics.reads += n
        lat = 0.0
        # every tier below works on unique keys: probe once and scatter
        # through ``inv`` at the end
        if uhint is None:
            uq, inv, cnts = torch.unique(keys, sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
        else:
            uq, cnts = uhint
            inv = probe(uq, keys)[0].long()
        nu = len(uq)
        uvals = torch.zeros((nu, self.value_words), dtype=torch.int32,
                            device=dev)
        ufound = torch.zeros(nu, dtype=torch.bool, device=dev)

        # 1. memtable: the first run (newest first) containing a key holds
        # its newest payload.  One source-major probe covers every run at
        # once (see _mem_concat); the per-run loop serves query keys
        # outside [0, 2^45), which would alias another source's band.
        if self.mem_n:
            T, tvals, srcs = self._mem_concat()
            fast = False
            if T is not None and len(T) and nu:
                lim = 1 << self._MEM_SHIFT
                fast = bool(((uq[0] >= 0) & (uq[-1] < lim)).item())
            if fast:
                R = len(srcs)
                assert R < (1 << 18)   # source ids share the 63-45 headroom
                qq = ((torch.arange(R, dtype=torch.int64, device=dev)[:, None]
                       << self._MEM_SHIFT) + uq[None, :]).reshape(-1)
                pos, hitf = probe(T, qq)
                hit = hitf.reshape(R, nu).flip(0)          # newest first
                si = hit.to(torch.uint8).argmax(0)
                fnd = hit[si, torch.arange(nu, device=dev)]
                fidx = _nz(fnd)
                if len(fidx):
                    ufound[fidx] = True
                    self.metrics.memtable_hits += int(cnts[fidx].sum())
                    # the concat position indexes the concatenated payloads
                    # directly (source i's slice starts at its offset)
                    src = R - 1 - si[fidx]                 # undo the flip
                    uvals[fidx] = tvals[pos.reshape(R, nu)[src, fidx].long()]
            else:
                mem_hits = 0
                pending = None               # None => every key outstanding
                for rk, _w, rv in self._mem_probe_order():
                    if not len(rk):
                        continue
                    if pending is None:
                        tk = uq
                    else:
                        if not len(pending):
                            break
                        tk = uq[pending]
                    pos, hit = self._probe_run(rk, tk)
                    hidx = _nz(hit)
                    if len(hidx):
                        idx = hidx if pending is None else pending[hidx]
                        uvals[idx] = rv[pos[hidx]]
                        ufound[idx] = True
                        mem_hits += int(cnts[idx].sum())   # per-occurrence
                    pending = _nz(~hit) if pending is None \
                        else pending[~hit]
                self.metrics.memtable_hits += mem_hits
        lat += n * lat_model.memtable_ms

        # 2. block cache — probed once per *unique* key.
        if not bool(ufound.all()):
            sub = _nz(~ufound)
            uk = uq[sub]
            n_todo = n - int(cnts[ufound].sum())   # unfound occurrences
            sets = self._sets(uk)
            match = self.cache_keys[sets] == uk[:, None]        # [u, ways]
            # argmax-then-gather: an all-False row argmaxes to way 0,
            # where the gather reads False
            way = match.to(torch.uint8).argmax(1)
            hit = match[torch.arange(len(uk), device=dev), way]
            hi = _nz(hit)
            sh, wh = sets[hi], way[hi]
            ckvals = torch.zeros((len(uk), self.value_words),
                                 dtype=torch.int32, device=dev)
            ckvals[hi] = self.cache_vals[sh, wh]
            ckfound = hit.clone()
            self.cache_ref[sh, wh] = 1
            self.metrics.cache_hits += len(hi)
            self.metrics.cache_misses += len(uk) - len(hi)
            lat += len(uk) * lat_model.cache_ms

            # 3. levels (slow tier) for cache misses.  Bloom filters guard
            # each SSTable: absent keys cost a filter check (plus the
            # false-positive rate of real probes) instead of a full read.
            rem = _nz(~hit)
            if len(rem):
                probe_keys = uk[rem]
                got = torch.zeros(len(rem), dtype=torch.bool, device=dev)
                gvals = torch.zeros((len(rem), self.value_words),
                                    dtype=torch.int32, device=dev)
                probes = 0.0
                blooms = 0
                for (lk, _lw, lv) in self.levels:
                    lidx = _nz(~got)
                    n_live = len(lidx)
                    if not n_live:
                        break
                    if len(lk):
                        pos, h = self._probe_run(lk, probe_keys[lidx])
                        n_hit = int(h.sum())
                    else:
                        n_hit = 0
                    # present keys pass the bloom filter and read the block;
                    # absent keys mostly stop at the filter — but the filter/
                    # index blocks themselves need block-cache residency
                    meta_ws = max(1.0, len(lk) / lat_model.meta_ratio)
                    meta_cover = min(1.0, self.cache_capacity / meta_ws)
                    probes += n_hit + lat_model.bloom_fp * (n_live - n_hit)
                    probes += (1.0 - meta_cover) \
                        * lat_model.meta_read_frac * n_live
                    blooms += n_live
                    if n_hit:
                        hh = _nz(h)
                        tgt = lidx[hh]
                        gvals[tgt] = lv[pos[hh]]
                        got[tgt] = True
                rg = rem[got]
                ckvals[rg] = gvals[got]
                ckfound[rg] = True
                self.metrics.level_probes += int(probes)
                lat += (probes * lat_model.level_ms
                        + blooms * lat_model.bloom_ms)
                # admit fetched entries into the cache (probe_keys is
                # sorted-unique, so the deduping _cache_update is skipped)
                if len(rg):
                    self._cache_apply(probe_keys[got], gvals[got],
                                      fresh=True)

            uvals[sub] = ckvals
            ufound[sub] = ckfound
            n_dup = n_todo - len(uk)
            if n_dup:
                res_dups = int((cnts[sub][ckfound] - 1).sum())
                unres_dups = n_dup - res_dups
                # resolved duplicates hit the (possibly just-admitted) block
                self.metrics.cache_hits += res_dups
                self.metrics.cache_misses += unres_dups
                lat += n_dup * lat_model.cache_ms
                if unres_dups:
                    probes = 0.0
                    for (lk, _lw, _lv) in self.levels:
                        meta_ws = max(1.0, len(lk) / lat_model.meta_ratio)
                        meta_cover = min(1.0, self.cache_capacity / meta_ws)
                        probes += (lat_model.bloom_fp + (1.0 - meta_cover)
                                   * lat_model.meta_read_frac) * unres_dups
                    self.metrics.level_probes += int(probes)
                    lat += (probes * lat_model.level_ms + unres_dups
                            * len(self.levels) * lat_model.bloom_ms)

        self.metrics.access_latency_total_ms += lat
        return uvals[inv], ufound[inv]

    def _mem_probe_order(self):
        """Memtable runs in read-priority order: newest delta run first,
        then the collapsed tiers (themselves newest-first)."""
        for i in range(len(self._runs) - 1, -1, -1):
            yield self._runs[i]
        yield from self._tiers

    def _mem_concat(self):
        """Source-major concat of every memtable source, oldest first:
        ``(i << 45) | key`` per source i keeps the concat globally sorted,
        so ONE probe covers all runs and tiers at once; the payloads are
        concatenated in the same order.  Priority is the prefix: the
        highest hitting source is the newest.  Cached across gets; a
        single appended run extends the concat incrementally.  Returns
        Nones (=> per-run fallback) for stored keys outside [0, 2^45)."""
        srcs = self._tiers[::-1] + self._runs
        ids = tuple(id(s[0]) for s in srcs)
        c = self._mbt
        if c is not None and c[0] == ids:
            return c[1], c[2], c[3]
        lim = 1 << self._MEM_SHIFT
        n_src = len(srcs)
        assert n_src < (1 << 18)         # source ids must fit 63-45 bits

        def in_band(rk: torch.Tensor) -> bool:
            return not len(rk) or bool(((rk[0] >= 0) & (rk[-1] < lim))
                                       .item())

        if c is not None and len(ids) == len(c[0]) + 1 \
                and c[0] == ids[:-1]:
            rk, _w, rv = srcs[-1]        # one new run appended at the end
            if not in_band(rk):
                self._mbt = None
                return None, None, None
            nprev = len(c[0])
            T = torch.cat([c[1], (nprev << self._MEM_SHIFT) + rk])
            tv = torch.cat([c[2], rv])
        else:
            parts = []
            for i, (rk, _w, _v) in enumerate(srcs):
                if not in_band(rk):
                    self._mbt = None
                    return None, None, None
                parts.append((i << self._MEM_SHIFT) + rk)
            if parts:
                T = torch.cat(parts)
                tv = torch.cat([s[2] for s in srcs])
            else:
                T, _, tv = self._empty_run()
        self._mbt = (ids, T, tv, srcs)
        return T, tv, srcs

    # ----------------------------------------------------------------- cache
    def _sets(self, keys: torch.Tensor) -> torch.Tensor:
        return mix_hash(keys, 29) % self.cache_sets

    def _cache_update(self, keys: torch.Tensor, vals: torch.Tensor) -> None:
        """Insert/overwrite entries (CLOCK eviction within each set)."""
        if len(keys) == 0:
            return
        # dedupe (last wins) to avoid write conflicts in the scatter
        uq, _, nv = self._delta_of(keys, vals)
        self._cache_apply(uq, nv)

    def _cache_apply(self, keys: torch.Tensor, vals: torch.Tensor,
                     fresh: bool = False) -> None:
        """``_cache_update`` for already-deduped sorted (keys, vals).

        ``fresh=True`` asserts no key is currently cached (the level-read
        admission path), skipping the hit scan."""
        if len(keys) == 0:
            return
        sets = self._sets(keys)
        if self._cache_virgin:           # first fill: no hits possible and
            self._cache_virgin = False   # every CLOCK scan lands instantly
            self._clock_fill_virgin(sets, keys, vals)
            return
        if fresh:
            ms, mk, mv = sets, keys, vals
        else:
            match = self.cache_keys[sets] == keys[:, None]
            way = match.to(torch.uint8).argmax(1)
            hit = match[torch.arange(len(keys), device=self.device), way]
            hi = _nz(hit)
            sh, wh = sets[hi], way[hi]
            self.cache_vals[sh, wh] = vals[hi]
            self.cache_ref[sh, wh] = 1
            # misses: CLOCK — evict first way with ref=0, clearing refs as
            # we pass.  Misses are grouped by set (stable, so ascending-key
            # insertion order is preserved) and inserted in rounds —
            # bit-for-bit the sequential per-entry CLOCK scan.
            miss = _nz(~hit)
            if not len(miss):
                return
            ms, mk, mv = sets[miss], keys[miss], vals[miss]
        order = torch.sort(ms, stable=True).indices
        ms, mk, mv = ms[order], mk[order], mv[order]
        if len(ms) == 1 or bool((ms[1:] != ms[:-1]).all()):
            self._clock_insert(ms, mk, mv)   # all sets distinct: one round
            return
        self._clock_insert_multi(ms, mk, mv)

    def _clock_fill_virgin(self, sets: torch.Tensor, keys: torch.Tensor,
                           vals: torch.Tensor) -> None:
        """Closed-form CLOCK state after inserting into an all-empty cache:
        the r-th insert into a set goes to way ``r % W``, leaving hand =
        count % W and ref = 1 exactly for the ways of the last incomplete
        pass (all ways when the count divides evenly)."""
        assert bool(((sets.min() >= 0) & (sets.max() < self.cache_sets))
                    .item())
        order = torch.sort(sets, stable=True).indices  # key order in set
        self._fill_virgin_sorted(sets[order], keys[order], vals[order])

    def _fill_virgin_sorted(self, s: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> None:
        """_clock_fill_virgin body for input already sorted by (set, key)."""
        W = self.cache_ways
        n = len(s)
        dev = self.device
        _, change, last = _group_bounds(s)
        cnt = last - change + 1
        ar = torch.arange(n, device=dev)
        rank = ar - torch.repeat_interleave(change, cnt, output_size=n)
        way = rank % W
        # winners per (set, way) are exactly the last min(count, W) entries
        # of each set group (their ways are distinct by construction)
        mask = (torch.repeat_interleave(change + cnt, cnt, output_size=n)
                - ar) <= W
        sm, wm = s[mask], way[mask]
        self.cache_keys[sm, wm] = k[mask]
        self.cache_vals[sm, wm] = v[mask]
        us = s[change]
        m = (cnt % W).to(torch.int32)
        self.cache_hand[us] = m
        self.cache_ref[us] = ((torch.arange(W, device=dev)[None, :]
                               < m[:, None])
                              | (m[:, None] == 0)).to(torch.int8)

    def _clock_insert(self, s: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> None:
        """One CLOCK insertion per (distinct) set in ``s``.

        Per set: scan ways from the hand, clearing ref bits as we pass,
        until a way with ref=0 is found (if all refs were set, the full
        pass clears them and the original hand position is the victim).
        """
        W = self.cache_ways
        hand = self.cache_hand[s].long()
        if not bool(self.cache_ref[s, hand].any()):
            # every hand already points at a ref=0 victim: insert at the
            # hand and advance it
            self.cache_keys[s, hand] = k
            self.cache_vals[s, hand] = v
            self.cache_ref[s, hand] = 1
            self.cache_hand[s] = ((hand + 1) % W).to(torch.int32)
            return
        pow2, unpack, first_zero = _clock_tables(self.device)
        # pack each set's ref row into a byte; the scan (find first
        # zero from the hand, clearing passed refs) becomes rotate +
        # two table lookups
        bits = (self.cache_ref[s].to(torch.int32) * pow2).sum(1)
        rot_bits = ((bits >> hand) | (bits << (8 - hand))) & 0xFF
        j = first_zero[rot_bits]
        has0 = j < 8
        j = torch.where(has0, j, 0)
        slot = (hand + j) % W
        # cleared prefix in the rotated frame, rotated back
        pre = torch.where(has0, (1 << j) - 1, 0xFF)
        mask = ((pre << hand) | (pre >> (8 - hand))) & 0xFF
        new_bits = (bits & ~mask) | (1 << slot)
        self.cache_ref[s] = unpack[new_bits & 0xFF]
        self.cache_keys[s, slot] = k
        self.cache_vals[s, slot] = v
        self.cache_hand[s] = ((slot + 1) % W).to(torch.int32)

    def _clock_insert_multi(self, ms: torch.Tensor, mk: torch.Tensor,
                            mv: torch.Tensor) -> None:
        """Sequential CLOCK insertions with repeated sets.

        ``ms`` is sorted by set (stable, so per-set insertion order is the
        arrival order).  The packed ref byte and hand of every touched set
        live in local tensors across rounds — round r does every set's
        r-th pending insert."""
        W = self.cache_ways
        n = len(ms)
        pow2, unpack, first_zero = _clock_tables(self.device)
        _, change, last = _group_bounds(ms)
        us = ms[change]
        cnt = last - change + 1
        bits = (self.cache_ref[us].to(torch.int32) * pow2).sum(1)
        hand = self.cache_hand[us].long()
        slots = torch.empty(n, dtype=torch.int64, device=self.device)
        for r in range(int(cnt.max())):
            act = _nz(cnt > r)
            b, h = bits[act], hand[act]
            rot = ((b >> h) | (b << (8 - h))) & 0xFF
            j = first_zero[rot]
            has0 = j < 8
            j = torch.where(has0, j, 0)
            slot = (h + j) % W
            pre = torch.where(has0, (1 << j) - 1, 0xFF)
            mask = ((pre << h) | (pre >> (8 - h))) & 0xFF
            bits[act] = (((b & ~mask) | (1 << slot)) & 0xFF).to(bits.dtype)
            hand[act] = (slot + 1) % W
            slots[change[act] + r] = slot
        self.cache_ref[us] = unpack[bits & 0xFF]
        self.cache_hand[us] = hand.to(torch.int32)
        lin = ms * W + slots
        if bool((cnt > W).any()):
            # > W inserts into one set can revisit a slot; keep the last
            # write per (set, way) so the scatter below is conflict-free
            ll, order = torch.sort(lin, stable=True)
            lastw = torch.ones(len(ll), dtype=torch.bool, device=self.device)
            torch.ne(ll[1:], ll[:-1], out=lastw[:-1])
            keep = order[lastw]
            lin, mk, mv = lin[keep], mk[keep], mv[keep]
        self.cache_keys.view(-1)[lin] = mk
        self.cache_vals.view(-1, self.cache_vals.shape[-1])[lin] = mv

    @property
    def cache_capacity(self) -> int:
        return self.cache_sets * self.cache_ways

    def prewarm_cache(self, keys: torch.Tensor, vals: torch.Tensor,
                      rng: np.random.Generator | None = None) -> None:
        """Fill the cache to capacity with a uniform sample of the live
        entries — steady-state emulation.  The sample is drawn on the host
        from ``rng`` (the reference's PCG64 stream) and moved over."""
        if len(keys) == 0:
            return
        cap = self.cache_capacity
        if len(keys) > cap:
            rng = rng or np.random.default_rng(0)
            idx = torch.from_numpy(rng.choice(len(keys), cap, replace=False))
            idx = idx.to(self.device)
            keys, vals = keys[idx], vals[idx]
        # a fresh cache takes the closed-form virgin fill: one stable sort
        # of (set << 47) | key gives the (set, key) order it needs
        if (self._cache_virgin and len(keys) > 1
                and self.cache_sets <= (1 << 15)
                and bool(((keys.min() >= 0) & (keys.max() < (1 << 47)))
                         .item())):
            sets = self._sets(keys)
            comb = (sets << 47) | keys
            ck, order = torch.sort(comb, stable=True)
            if not bool((ck[1:] == ck[:-1]).any()):
                self._cache_virgin = False
                self._fill_virgin_sorted(sets[order], keys[order],
                                         vals[order])
                self.metrics.reset()
                return
        # store-derived keys are unique, so sorting alone reproduces
        # _cache_update's dedup ordering; fall back to the deduping path
        # if a caller hands us duplicates
        sk, order = torch.sort(keys, stable=True)
        if len(sk) > 1 and bool((sk[1:] == sk[:-1]).any()):
            self._cache_update(keys, vals)
        else:
            self._cache_apply(sk, vals[order])
        self.metrics.reset()

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """Epoch-barrier snapshot; carries the delta weights so a restore
        preserves the Z-set, not just the last-write-wins view."""
        keys, weights, vals = self._items_weighted()
        return {"keys": keys, "vals": vals, "weights": weights,
                "memory_mb": self.memory_mb, "value_words": self.value_words}

    @classmethod
    def restore(cls, snap: dict, *, memory_mb: float | None = None,
                **kw) -> "LSMStore":
        store = cls(memory_mb if memory_mb is not None else snap["memory_mb"],
                    value_words=snap["value_words"], **kw)
        if len(snap["keys"]):
            dev = store.device
            w = snap.get("weights")
            keys = torch.as_tensor(snap["keys"], dtype=torch.int64,
                                   device=dev)
            store._push_run(
                keys,
                torch.ones(len(keys), dtype=torch.int64, device=dev)
                if w is None else torch.as_tensor(w, dtype=torch.int64,
                                                  device=dev),
                torch.as_tensor(snap["vals"], dtype=torch.int32, device=dev))
        return store


# ------------------------------------------------------------- store factory
# The engine and operators build state through here, so the frozen
# pre-columnar store (``repro_torch.state.legacy``) can be swapped in
# in-process and the two compared like for like.
_ACTIVE_STORE_IMPL = "columnar"


def set_store_impl(name: str) -> None:
    global _ACTIVE_STORE_IMPL
    if name not in ("columnar", "legacy"):
        raise ValueError(f"unknown store impl {name!r}")
    _ACTIVE_STORE_IMPL = name


def get_store_impl() -> str:
    return _ACTIVE_STORE_IMPL


def store_class(name: str | None = None):
    if (name or _ACTIVE_STORE_IMPL) == "columnar":
        return LSMStore
    from repro_torch.state.legacy import LegacyLSMStore
    return LegacyLSMStore


def make_store(memory_mb: float, **kw) -> LSMStore:
    """The engine and operators build state through here."""
    return store_class()(memory_mb, **kw)
