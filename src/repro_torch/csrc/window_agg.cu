// Segment sum: per-segment sums of value rows and per-segment counts.
//
// Replaces the Pallas TPU kernel src/repro/kernels/window_agg/kernel.py
// (_agg_kernel / window_agg).  The TPU has no per-lane atomics, so its
// kernel forms a one-hot matrix and runs the sum as a matmul on the MXU.
//
// Bound on an H100: bytes (N ids and N*V values read once, S*V sums and S
// counts written once).  The LSM store calls it with key-sorted ids, int64
// from a cumsum, and about one row per segment.  One atomic per value and
// per row (the first port) spent two L2 atomics on every row.  Here the
// reduction is segmented, a warp over 32 consecutive rows, one a lane
// (every load coalesced):
//   - a ballot of the run heads (a lane whose id differs from the lane
//     before) gives each lane the start of its run; a segmented scan
//     (shuffles) sums each run;
//   - only the lane where a run ends writes it: one atomic add per column
//     into sums, and one into counts carrying the run's length.  Lanes
//     that end runs hold neighbouring ids, so one atomic instruction of
//     the warp touches one or two cache lines.
// Sorted ids give one atomic pair per run per warp (a run cut by a warp
// edge takes one pair on each side); a warp of 64 or 128 rows cut fewer
// runs but was slower on the store's ~1-2 rows a segment.  Unsorted ids
// stay right: every run, however short, is added once.  Nothing tells the
// kernel the ids are sorted, and nothing needs to.
//
// Ids are int32 or int64, read as given; ids outside [0, S) (-1 is the
// padding id) are skipped.  Two value types:
//   f32   -> f32 sums and f32 counts, the JAX kernel's contract;
//   int64 -> int64 sums and counts, added as unsigned 64-bit words, which
//            wrap exactly as int64 does: integer addition is associative,
//            so the sums equal numpy's add.reduceat in any order.
// sums [S, V] and counts [S] are two buffers (a caller that keeps the sums
// does not keep the counts alive); one small kernel zeroes both, so a call
// is two launches.  The reduction is a programmatic dependent launch: it
// starts beside the zero fill, loads its ids and values, and waits for the
// fill only before its first atomic, so the loads and its launch latency
// overlap the fill.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
// two blocks an SM of the H100's 132: the fill leaves room beside it for
// the reduction's blocks
constexpr int64_t kZeroBlocks = 264;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add_to(float* p, float x) { atomicAdd(p, x); }

__device__ __forceinline__ void add_to(int64_t* p, int64_t x) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(x));
}

template <typename I, typename V>
__global__ void __launch_bounds__(kThreads)
    window_agg_kernel(const I* __restrict__ seg, const V* __restrict__ values,
                      int64_t n, int64_t v, int64_t s, V* __restrict__ sums,
                      V* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  // rows past n carry the skipped id -1; every lane stays for the shuffles
  const bool live = row < n;
  const int64_t g = live ? static_cast<int64_t>(__ldg(seg + row)) : -1;
  const int64_t id = (g >= 0 && g < s) ? g : -1;
  V x = live ? __ldg(values + row * v) : V(0);
  const int64_t prev = __shfl_up_sync(kFull, id, 1);
  const int64_t next = __shfl_down_sync(kFull, id, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != id);
  const int start = 31 - __clz(heads & ((2u << lane) - 1u));
  const bool ends = (lane == 31 || next != id) && id >= 0;
  hopper::wait_for_prior_grid();    // the zero fill's stores
  if (ends) add_to(counts + id, static_cast<V>(lane - start + 1));
  for (int64_t col = 0; col < v; ++col) {
    if (col > 0) x = live ? __ldg(values + row * v + col) : V(0);
    // segmented inclusive scan: lane l adds lane l - d while both are in
    // its run
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V below = __shfl_up_sync(kFull, x, d);
      if (lane - d >= start) x += below;
    }
    if (ends) add_to(sums + id * v + col, x);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    window_agg_zero(V* __restrict__ sums, int64_t n_sums,
                    V* __restrict__ counts, int64_t s) {
  hopper::launch_dependents();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_sums + s; i += stride) {
    if (i < n_sums) sums[i] = V(0);
    else counts[i - n_sums] = V(0);
  }
}

template <typename I, typename V>
int launch(const void* seg, const void* values, int64_t n, int64_t v,
           int64_t s, void* sums_out, void* counts_out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  V* sums = static_cast<V*>(sums_out);
  V* counts = static_cast<V*>(counts_out);
  // with no segment every id is skipped: nothing to zero or add (and the
  // reduction must not be a dependent launch of the kernel before it,
  // which may be writing its ids)
  if (s <= 0) return 0;
  const int64_t need = (s * v + s + kThreads - 1) / kThreads;
  window_agg_zero<V><<<static_cast<unsigned>(need < kZeroBlocks
                                                  ? need : kZeroBlocks),
                       kThreads, 0, st>>>(sums, s * v, counts, s);
  if (n > 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, window_agg_kernel<I, V>, static_cast<const I*>(seg),
        static_cast<const V*>(values), n, v, s, sums, counts);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_ids(const void* seg, int64_t id_bytes, const void* values,
               int64_t n, int64_t v, int64_t s, void* sums, void* counts,
               void* stream) {
  if (id_bytes == 4)
    return launch<int32_t, V>(seg, values, n, v, s, sums, counts, stream);
  if (id_bytes == 8)
    return launch<int64_t, V>(seg, values, n, v, s, sums, counts, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int window_agg_f32(const void* seg, int64_t id_bytes,
                              const void* values, int64_t n, int64_t v,
                              int64_t s, void* sums, void* counts,
                              void* stream) {
  return launch_ids<float>(seg, id_bytes, values, n, v, s, sums, counts,
                         stream);
}

extern "C" int window_agg_i64(const void* seg, int64_t id_bytes,
                              const void* values, int64_t n, int64_t v,
                              int64_t s, void* sums, void* counts,
                              void* stream) {
  return launch_ids<int64_t>(seg, id_bytes, values, n, v, s, sums, counts,
                         stream);
}
