// Batched rank of query keys in a sorted run: the LSM store's read probe.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sorted_probe/kernel.py
// (_probe_kernel / sorted_probe).  The TPU version computes ranks as dense
// compare-and-sum tiles because a scalar binary search is hostile to its
// vector unit.  On Hopper a thread runs its own lower-bound search, so one
// probe touches log2(T) table entries instead of T.
//
// Bound on an H100: the latency of dependent loads, not bytes.  A probe
// must move its key, a 4-byte position, a 1-byte flag and the table
// sectors around its answer; the bisection reads a few sectors more, but
// each of its ~log2(T) steps waits for the load before it.  Neighbouring
// threads carry neighbouring queries, and the store passes sorted
// queries, so the first search steps of a warp hit the same table lines,
// which stay in L2 (a 2.4 M-entry int64 run is 19 MB of the 50 MB L2).
//
// pos   = number of table entries strictly less than the query (the
//         leftmost insertion point),
// found = pos < T && table[pos] == query.
// No padding is involved, so an absent dtype-max query is never found and
// an empty table gives pos 0, not found.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename K>
__global__ void sorted_probe_kernel(const K* __restrict__ table, int64_t t,
                                    const K* __restrict__ queries, int64_t n,
                                    int32_t* __restrict__ pos,
                                    uint8_t* __restrict__ found) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const K q = queries[i];
  int64_t lo = 0, hi = t;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (table[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  pos[i] = static_cast<int32_t>(lo);
  found[i] = (lo < t && table[lo] == q) ? 1 : 0;
}

template <typename K>
int launch(const void* table, int64_t t, const void* queries, int64_t n,
           void* pos, void* found, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    sorted_probe_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const K*>(table), t, static_cast<const K*>(queries), n,
        static_cast<int32_t*>(pos), static_cast<uint8_t*>(found));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sorted_probe_i32(const void* table, int64_t t,
                                const void* queries, int64_t n, void* pos,
                                void* found, void* stream) {
  return launch<int32_t>(table, t, queries, n, pos, found, stream);
}

extern "C" int sorted_probe_i64(const void* table, int64_t t,
                                const void* queries, int64_t n, void* pos,
                                void* found, void* stream) {
  return launch<int64_t>(table, t, queries, n, pos, found, stream);
}
