// Batched rank of query keys in a sorted run: the LSM store's read probe.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sorted_probe/kernel.py
// (_probe_kernel / sorted_probe).  The TPU version computes ranks as dense
// compare-and-sum tiles because a scalar binary search is hostile to its
// vector unit.
//
// Bound on an H100: the latency of dependent loads, not bytes.  A probe
// must move its key, a 4-byte position, a 1-byte flag and the table
// sectors around its answer, but a search waits for each load before it
// can choose the next.  The store's probes are small (a q8 episode's
// median call is under a thousand queries), so a thread per query leaves
// the card nearly empty and bisects with ~log2(T) loads in a chain.  Two
// routes instead, chosen on the host by the wrapper's plan from N:
//   - cooperative (small batches): the 32 lanes of a warp serve one query.
//     At each step lane j reads the splitter lo + (j+1)(hi-lo)/33; a
//     ballot of `splitter < q` and its popcount pick the part, so the
//     range shrinks 33-fold per step: 5 dependent loads at T = 2.4 M
//     instead of 22, and 32 times the threads in flight.  The first
//     splitter does not depend on the query, so it is loaded beside it.  A
//     ballot of `splitter == q` keeps whether the entry at the upper end
//     is the query, so `found` needs no load of its own.
//   - indexed (large batches, where 32 loads a step per query cost more
//     than the latency they save): one thread per query.  Each block
//     first loads kIndex evenly spaced splitters into shared memory, all
//     in flight beside the queries; a thread bisects them there, then
//     bisects the T / (kIndex + 1) entries between its two splitters in
//     device memory.  The levels that every query of a bisection of the
//     whole run would share become one round of loads.
//
// pos   = number of table entries strictly less than the query (the
//         leftmost insertion point),
// found = pos < T && table[pos] == query.
// No padding is involved, so an absent dtype-max query is never found and
// an empty table gives pos 0, not found.  Unsorted queries and duplicate
// table entries (the leftmost is found) need nothing of their own.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIndex = 512;                   // indexed route: splitters
constexpr unsigned kFull = 0xffffffffu;

template <typename K>
__global__ void __launch_bounds__(kThreads)
    probe_warps(const K* __restrict__ table, int64_t t,
                const K* __restrict__ queries, int64_t n,
                int32_t* __restrict__ pos, uint8_t* __restrict__ found) {
  constexpr int64_t kParts = 33;
  const int j = threadIdx.x & 31;             // this lane's splitter
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (i >= n) return;                         // the whole warp
  const K q = queries[i];
  // the answer lies in [lo, hi]; `hit`: hi < t and table[hi] == q
  int64_t lo = 0, hi = t;
  bool hit = false;
  // the first splitter does not depend on the query: loaded beside it
  K x = t > 0 ? table[(j + 1) * t / kParts] : K(0);
  while (lo < hi) {
    const unsigned lt = __ballot_sync(kFull, x < q);
    const unsigned eq = __ballot_sync(kFull, x == q);
    // splitters 0..c-1 are below q, c..31 are not
    const int c = __popc(lt);
    const int64_t start = lo, m = hi - lo;
    if (c > 0) lo = start + c * m / kParts + 1;
    if (c < 32) {
      hi = start + (c + 1) * m / kParts;
      hit = (eq >> c) & 1u;
    }
    if (lo < hi) x = table[lo + (j + 1) * (hi - lo) / kParts];
  }
  if (j == 0) {
    pos[i] = static_cast<int32_t>(lo);
    found[i] = hit ? 1 : 0;
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    probe_indexed(const K* __restrict__ table, int64_t t,
                  const K* __restrict__ queries, int64_t n,
                  int32_t* __restrict__ pos, uint8_t* __restrict__ found) {
  __shared__ K splitters[kIndex];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const K q = i < n ? queries[i] : K(0);   // in flight with the splitters
  for (int s = threadIdx.x; s < kIndex; s += kThreads)
    splitters[s] = table[(s + 1) * t / (kIndex + 1)];
  __syncthreads();
  if (i >= n) return;
  // c = the splitters below q, which bound the range
  int c = 0;
  for (int len = kIndex; len > 0;) {
    const int half = len >> 1;
    if (splitters[c + half] < q) {
      c += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  int64_t lo = c > 0 ? c * t / (kIndex + 1) + 1 : 0;
  int64_t hi = c < kIndex ? (c + 1) * t / (kIndex + 1) : t;
  bool hit = c < kIndex && splitters[c] == q;     // table[hi] == q
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const K v = table[mid];
    if (v < q) {
      lo = mid + 1;
    } else {
      hi = mid;
      hit = v == q;
    }
  }
  pos[i] = static_cast<int32_t>(lo);
  found[i] = hit ? 1 : 0;
}

template <typename K>
int launch(const void* table, int64_t t, const void* queries, int64_t n,
           void* pos, void* found, int64_t lanes, int64_t blocks,
           void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tb = static_cast<const K*>(table);
  const auto* qs = static_cast<const K*>(queries);
  auto* ps = static_cast<int32_t*>(pos);
  auto* fs = static_cast<uint8_t*>(found);
  if (n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (lanes == 32) {
    probe_warps<K><<<grid, kThreads, 0, st>>>(tb, t, qs, n, ps, fs);
  } else if (lanes == 1 && t > 0) {
    probe_indexed<K><<<grid, kThreads, 0, st>>>(tb, t, qs, n, ps, fs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sorted_probe_i32(const void* table, int64_t t,
                                const void* queries, int64_t n, void* pos,
                                void* found, int64_t lanes, int64_t blocks,
                                void* stream) {
  return launch<int32_t>(table, t, queries, n, pos, found, lanes, blocks,
                         stream);
}

extern "C" int sorted_probe_i64(const void* table, int64_t t,
                                const void* queries, int64_t n, void* pos,
                                void* found, int64_t lanes, int64_t blocks,
                                void* stream) {
  return launch<int64_t>(table, t, queries, n, pos, found, lanes, blocks,
                         stream);
}
