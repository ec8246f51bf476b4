// Segment sum: per-segment sums of value rows and per-segment counts.
//
// Replaces the Pallas TPU kernel src/repro/kernels/window_agg/kernel.py
// (_agg_kernel / window_agg).  The TPU has no per-lane atomics, so its
// kernel forms a one-hot matrix and runs the sum as a matmul on the MXU.
// Hopper has atomics in L2: one thread per value element adds it into its
// segment's slot, and the thread of column 0 adds the row to the count.
//
// Bound on an H100: bytes (N ids and N*V values read, S*V sums and S
// counts written; one add per value).  The LSM store calls it with sorted
// ids and mostly one-row segments, so the atomics rarely contend.  A
// segmented reduction over the sorted ids is the faster design, left for
// later work.
//
// Ids outside [0, S) (-1 is the padding id) are skipped.  Two value types:
//   f32   -> f32 sums and f32 counts, the JAX kernel's contract;
//   int64 -> int64 sums and counts, added as unsigned 64-bit words, which
//            wrap exactly as int64 does: integer addition is associative,
//            so the sums equal numpy's add.reduceat in any order.
// Outputs must be zeroed by the caller.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add_to(float* p, float x) { atomicAdd(p, x); }

__device__ __forceinline__ void add_to(int64_t* p, int64_t x) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(x));
}

template <typename V>
__global__ void window_agg_kernel(const int32_t* __restrict__ seg,
                                  const V* __restrict__ values, int64_t n,
                                  int64_t v, int64_t s, V* __restrict__ sums,
                                  V* __restrict__ counts) {
  int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * v) return;
  int64_t row = e / v;
  int64_t col = e - row * v;
  int32_t g = seg[row];
  if (g < 0 || g >= s) return;
  add_to(sums + static_cast<int64_t>(g) * v + col, values[e]);
  if (col == 0) add_to(counts + g, static_cast<V>(1));
}

template <typename V>
int launch(const void* seg, const void* values, int64_t n, int64_t v,
           int64_t s, void* sums, void* counts, void* stream) {
  int64_t total = n * v;
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    window_agg_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(seg), static_cast<const V*>(values), n, v,
        s, static_cast<V*>(sums), static_cast<V*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int window_agg_f32(const void* seg, const void* values, int64_t n,
                              int64_t v, int64_t s, void* sums, void* counts,
                              void* stream) {
  return launch<float>(seg, values, n, v, s, sums, counts, stream);
}

extern "C" int window_agg_i64(const void* seg, const void* values, int64_t n,
                              int64_t v, int64_t s, void* sums, void* counts,
                              void* stream) {
  return launch<int64_t>(seg, values, n, v, s, sums, counts, stream);
}
