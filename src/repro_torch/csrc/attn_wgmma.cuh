// What the attention kernels on wgmma + TMA share (csrc/flash_attn.cu,
// the forward, and csrc/flash_attn_bwd.cu, its backward): the masks as key
// and tile ranges, the four bf16 wgmma forms they issue (two with both
// operands in shared memory, two with A from registers), ex2 and the bf16
// packing of an accumulator into an A operand, and the 4-D TMA tensor maps
// over a [B, H, S, D] operand with any strides.  Header only: _build.py
// hashes it with the sources, so an edit rebuilds both includers.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include "hopper.cuh"

namespace attn {

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, h, s;                // element strides; the last dim is unit
};

// ------------------------------------------------------------------ masks
// floor(a / c) * c for c > 0: the first position of a's chunk
__device__ __forceinline__ int chunk_start(int a, int c) {
  const int q = a / c;
  return (q - (a % c < 0)) * c;
}

// The keys [lo, hi) that the query at position pos keeps: every mask is
// one range, and both ends only grow with pos
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange key_range(int pos, int skv, int causal,
                                              int window, int chunk) {
  KeyRange r{0, skv};
  if (causal) r.hi = min(r.hi, pos + 1);
  if (window > 0) r.lo = max(r.lo, pos - window + 1);
  if (chunk > 0) {
    const int c = chunk_start(pos, chunk);
    r.lo = max(r.lo, c);
    r.hi = min(r.hi, c + chunk);
  }
  return r;
}

// the KV tiles [t_begin, t_end) of kBK keys that some row of the query
// tile [q0, q0 + q_rows) may see (the rest are skipped), and the bounds
// that every row keeps: a tile within [lo_last, hi_first) needs no mask
struct TileRange {
  int t_begin, t_end, lo_last, hi_first;
};

__device__ __forceinline__ TileRange tile_range(int q0, int q_rows, int sq,
                                                int skv, int causal,
                                                int window, int chunk,
                                                int kBK) {
  const int shift = skv - sq;
  const KeyRange first = key_range(q0 + shift, skv, causal, window, chunk);
  const KeyRange last = key_range(q0 + q_rows - 1 + shift, skv, causal,
                                  window, chunk);
  TileRange r;
  r.t_begin = first.lo / kBK;
  r.t_end = last.hi > first.lo ? (last.hi + kBK - 1) / kBK : r.t_begin;
  r.lo_last = last.lo;
  r.hi_first = first.hi;
  return r;
}

// ------------------------------------------------------------ wgmma forms
// d (+)= A B over k16: A [64 x 16] and B [128 x 16], both K-major in shared
// memory with the 128-byte swizzle; ``accumulate`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64],
                                                uint64_t desc_a,
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A B over k16: A [64 x 16] and B [64 x 16], both K-major in shared
// memory with the 128-byte swizzle; ``accumulate`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32],
                                               uint64_t desc_a,
                                               uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[O .. O + 32) += A B over k16: A [64 x 16] bf16 from registers
// a[0..3] (the accumulator layout packed in pairs), B [16 x 64] MN-major
// in shared memory with the 128-byte swizzle (the transpose bit set)
template <int O, int N>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[N],
                                                const uint32_t* a,
                                                uint64_t desc_b) {
  static_assert(O + 32 <= N, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[O .. O + 64) += A B over k16: A [64 x 16] bf16 from registers
// a[0..3] (the accumulator layout packed in pairs), B [16 x 128] MN-major
// in shared memory with the 128-byte swizzle (the transpose bit set)
template <int O, int N>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[N],
                                                const uint32_t* a,
                                                uint64_t desc_b) {
  static_assert(O + 64 <= N, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]),
        "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]),
        "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]),
        "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]),
        "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]),
        "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the box at (d0, s, h, b) of a map whose dims 1..3 follow ``order``
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         int order, int d0, int s, int h,
                                         int b, uint64_t* bar) {
  const int ps = order & 3, ph = (order >> 2) & 3;
  auto at = [&](int dim) { return dim == ps ? s : dim == ph ? h : b; };
  hopper::tma_load_4d(dst, map, d0, at(1), at(2), at(3), bar);
}

// ------------------------------------------------------------ tensor maps
constexpr int kPanel = 64;         // columns of a 128-byte swizzled panel
constexpr int kNoEncoder = -1;     // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = -2;  // it refused the operand

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A 4-D map over a bf16 tensor [B, H, S, D] with element strides
// st = (b, h, s): dim 0 is D (unit stride), dims 1..3 are S, H and B
// ordered by stride; the box is 64 columns of ``rows`` positions of one
// (b, head), with the 128-byte swizzle.  *order gets where S, H and B
// went (two bits each).
inline int encode(CUtensorMap* map, const void* ptr, int64_t b, int64_t h,
                  int64_t s, int64_t d, const int64_t* st, int rows,
                  int* order) {
  const PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (enc == nullptr) return kNoEncoder;
  const int64_t ext[3] = {s, h, b};
  const int64_t stride[3] = {st[2], st[1], st[0]};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(rows), 1u, 1u};
  int idx[3] = {0, 1, 2};                 // S, H, B sorted by stride
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && stride[idx[j]] < stride[idx[j - 1]]; --j) {
      const int tmp = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = tmp;
    }
  }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t bdim[4] = {static_cast<cuuint32_t>(kPanel), 0, 0, 0};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  int pos[3];
  for (int k = 0; k < 3; ++k) {
    gdim[k + 1] = static_cast<cuuint64_t>(ext[idx[k]]);
    gstride[k] = static_cast<cuuint64_t>(stride[idx[k]]) * sizeof(bf16);
    bdim[k + 1] = box[idx[k]];
    pos[idx[k]] = k + 1;
  }
  *order = pos[0] | pos[1] << 2 | pos[2] << 4;
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
      gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

}  // namespace attn
