// Forward attention over q [B, Hq, Sq, D] and k/v [B, Hk, Skv, D]:
// prefill attention of the model substrate.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// (_attn_kernel / flash_attention).  The TPU version walks KV blocks as a
// sequential grid axis and carries the online-softmax statistics m, l and
// the accumulator in VMEM scratch from one grid step to the next.  Blocks
// of a CUDA grid run in no order, so here one block owns one (b, q-head,
// 64-row query tile) and loops over the 64-key KV tiles itself, with m and
// l in registers and the accumulator in shared memory.
//
// Bound on an H100: operations.  At the serving path's prefill (B 8,
// Hq 24, Sq = Skv = 2048, D 128, causal, bf16) the two products take
// 4*B*Hq*D*Sq*(Sq+1)/2 = 2.06e11 FLOP, 0.21 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 268 MB of q/k/v/o, 0.08 ms at 3.35 TB/s.
// So the design puts both products on the tensor cores (WMMA 16x16x16
// bf16 tiles, f32 accumulation) and spends no FLOP on masked-out work:
// KV tiles wholly above the causal diagonal or outside the sliding window
// are skipped, as the TPU kernel skips them with pl.when.  This is a first
// version: loads are not overlapped with the products (no cp.async/TMA
// pipeline) and the products are warp-level mma, not Hopper's wgmma.  The
// float32 instantiation runs both products on CUDA cores in full f32.
//
// Semantics, as the TPU kernel: scores in f32 from the inputs, scaled by
// D^-0.5; query row i sits at position i + (Skv - Sq) (suffix alignment);
// causal keeps keys <= that position, a window w keeps keys > position - w;
// the output is acc / max(l, 1e-30) in q's dtype.  A row with no key left
// by the mask (causal with Sq > Skv, rows before position 0) gives zeros.
// That is a choice: the TPU kernel gives zeros there only where it skips
// every KV block of the row's 256-row query block; inside a block it runs,
// such a row weighs each of the block's keys (padding included) equally,
// and the pure-jnp oracle averages every key.  GQA by indexing: q-head h
// reads KV head
// h / (Hq / Hk); the caller never repeats K or V.  Every tensor is taken
// with the element strides it has (batch, head, sequence); only the last
// dimension must be contiguous.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 256;     // 8 warps; 4 threads per query row
constexpr int kMaxD = 128;
constexpr int kLd = kMaxD + 8;    // row stride (elements) of Q/K/V tiles
constexpr int kLdS = kBK + 4;     // row stride of the f32 score tile
constexpr int kLdP = kBK + 8;     // row stride of the bf16 probability tile
constexpr int kLdO = kMaxD + 4;   // row stride of the f32 accumulator
constexpr int kColsPerThread = kBK / 4;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;                // element strides; the last dim is unit
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int hq, hk, sq, skv, d;
  int causal, window;             // window <= 0: no window
  float scale;
  int vec;                        // 16-byte loads are aligned
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
constexpr size_t smem_bytes() {
  return 3 * size_t(kBQ) * kLd * sizeof(T)          // Q, K, V tiles
         + size_t(kBQ) * kLdS * sizeof(float)       // scores / f32 probs
         + size_t(kBQ) * kLdO * sizeof(float)       // accumulator
         + (sizeof(T) == 2 ? size_t(kBQ) * kLdP * sizeof(bf16) : 0);
}

// rows [0, rows_valid) of a [kRows, d] tile from global into shared memory
// (row stride kLd); rows past rows_valid are zero, so a masked key never
// brings a non-finite value into the products.
template <typename T, int kRows>
__device__ void load_tile(T* dst, const T* src, int64_t row_stride,
                          int rows_valid, int d, int vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int chunks = d / kVec;
    for (int i = threadIdx.x; i < kRows * chunks; i += blockDim.x) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) {
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      }
      *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i - r * d;
      dst[r * kLd + c] = r < rows_valid ? src[r * row_stride + c]
                                        : from_f<T>(0.f);
    }
  }
}

// S = Q K^T for one tile (unscaled), into Ss.
__device__ void tile_scores(const bf16* Qs, const bf16* Ks, float* Ss,
                            int d) {
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1;               // 16-row slice of the tile
  const int ct = (warp & 1) * 2;          // first of two 16-key slices
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
  wmma::fill_fragment(c0, 0.f);
  wmma::fill_fragment(c1, 0.f);
  for (int kk = 0; kk < d; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
    wmma::load_matrix_sync(a, Qs + rt * 16 * kLd + kk, kLd);
    wmma::load_matrix_sync(b0, Ks + ct * 16 * kLd + kk, kLd);
    wmma::load_matrix_sync(b1, Ks + (ct + 1) * 16 * kLd + kk, kLd);
    wmma::mma_sync(c0, a, b0, c0);
    wmma::mma_sync(c1, a, b1, c1);
  }
  wmma::store_matrix_sync(Ss + rt * 16 * kLdS + ct * 16, c0, kLdS,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(Ss + rt * 16 * kLdS + (ct + 1) * 16, c1, kLdS,
                          wmma::mem_row_major);
}

__device__ void tile_scores(const float* Qs, const float* Ks, float* Ss,
                            int d) {
  const int row = threadIdx.x >> 2, quad = threadIdx.x & 3;
  float acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0.f;
  for (int dd = 0; dd < d; ++dd) {
    const float qd = Qs[row * kLd + dd];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      acc[j] += qd * Ks[(quad + 4 * j) * kLd + dd];
    }
  }
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    Ss[row * kLdS + quad + 4 * j] = acc[j];
  }
}

// O += P V over one tile.  bf16: P from Ps (bf16), tensor cores.
__device__ void tile_pv(const bf16* Ps, const float* /*Ss*/, const bf16* Vs,
                        float* Os, int d) {
  const int warp = threadIdx.x >> 5;
  const int n_tiles = 4 * (d / 16);
  for (int idx = warp; idx < n_tiles; idx += kThreads / 32) {
    const int rt = idx & 3, ct = idx >> 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, Os + rt * 16 * kLdO + ct * 16, kLdO,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + rt * 16 * kLdP + kk, kLdP);
      wmma::load_matrix_sync(b, Vs + kk * kLd + ct * 16, kLd);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(Os + rt * 16 * kLdO + ct * 16, c, kLdO,
                            wmma::mem_row_major);
  }
}

// f32: P from Ss, CUDA cores; each thread adds into its own row's columns.
__device__ void tile_pv(const bf16* /*Ps*/, const float* Ss, const float* Vs,
                        float* Os, int d) {
  const int row = threadIdx.x >> 2, quad = threadIdx.x & 3;
  constexpr int kMaxCols = kMaxD / 4;
  float acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) acc[j] = 0.f;
  for (int kv = 0; kv < kBK; ++kv) {
    const float pk = Ss[row * kLdS + kv];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = quad + 4 * j;
      if (c < d) acc[j] += pk * Vs[kv * kLd + c];
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int c = quad + 4 * j;
    if (c < d) Os[row * kLdO + c] += acc[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * kLd;
  T* Vs = Ks + kBK * kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * kLd);
  float* Os = Ss + kBQ * kLdS;
  bf16* Ps = reinterpret_cast<bf16*>(Os + kBQ * kLdO);

  const int n_qt = (p.sq + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.hq / p.hk);
  const int q0 = qt * kBQ;
  const int shift = p.skv - p.sq;
  const int tid = threadIdx.x, row = tid >> 2, quad = tid & 3;
  const int q_rows = min(kBQ, p.sq - q0);

  const T* qg = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h
                + static_cast<int64_t>(q0) * p.qs.s;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  load_tile<T, kBQ>(Qs, qg, p.qs.s, q_rows, p.d, p.vec);
  for (int i = tid; i < kBQ * kLdO; i += kThreads) Os[i] = 0.f;

  // the KV range any row of this tile may see; whole tiles outside it
  // are skipped
  const int q_first = q0 + shift, q_last = q0 + q_rows - 1 + shift;
  int kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, q_first - p.window + 1);
  const int t_begin = kv_lo / kBK;
  const int t_end = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK : t_begin;

  const bool row_ok = row < q_rows;
  const int my_pos = q0 + row + shift;
  float m = kNegInf, l = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, p.skv - k0);
    __syncthreads();                      // last tile's readers are done
    load_tile<T, kBK>(Ks, kg + static_cast<int64_t>(k0) * p.ks.s, p.ks.s,
                      k_rows, p.d, p.vec);
    load_tile<T, kBK>(Vs, vg + static_cast<int64_t>(k0) * p.vs.s, p.vs.s,
                      k_rows, p.d, p.vec);
    __syncthreads();
    tile_scores(Qs, Ks, Ss, p.d);
    __syncthreads();

    // online softmax over this thread's 16 columns of its row
    float sv[kColsPerThread];
    unsigned ok = 0u;
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int kp = k0 + quad + 4 * j;
      const bool keep = row_ok && kp < p.skv
                        && (!p.causal || kp <= my_pos)
                        && (p.window <= 0 || kp > my_pos - p.window);
      sv[j] = Ss[row * kLdS + quad + 4 * j] * p.scale;
      if (keep) {
        ok |= 1u << j;
        tmax = fmaxf(tmax, sv[j]);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float pj = (ok >> j) & 1u ? expf(sv[j] - m_new) : 0.f;
      psum += pj;
      if constexpr (sizeof(T) == 2) {
        Ps[row * kLdP + quad + 4 * j] = __float2bfloat16(pj);
      } else {
        Ss[row * kLdS + quad + 4 * j] = pj;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    for (int c = quad; c < p.d; c += 4) Os[row * kLdO + c] *= alpha;
    __syncthreads();
    tile_pv(Ps, Ss, Vs, Os, p.d);
  }
  __syncthreads();

  if (row_ok) {
    T* og = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h
            + static_cast<int64_t>(q0 + row) * p.os.s;
    const float denom = fmaxf(l, 1e-30f);
    for (int c = quad; c < p.d; c += 4) {
      og[c] = from_f<T>(Os[row * kLdO + c] / denom);
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t hq, int64_t hk, int64_t sq, int64_t skv, int64_t d,
           const int64_t* st, int64_t causal, int64_t window, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs = {st[0], st[1], st[2]};
  p.ks = {st[3], st[4], st[5]};
  p.vs = {st[6], st[7], st[8]};
  p.os = {st[9], st[10], st[11]};
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.d = static_cast<int>(d);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.scale = static_cast<float>(std::pow(static_cast<double>(d), -0.5));
  bool vec = aligned16(q) && aligned16(k) && aligned16(v)
             && (d * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  for (int i = 0; i < 9; ++i) {
    vec = vec && (st[i] * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  }
  p.vec = vec;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
            static_cast<unsigned>(hq), static_cast<unsigned>(b));
  flash_fwd_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) of q, k, v, out.
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int64_t b, int64_t hq, int64_t hk,
                               int64_t sq, int64_t skv, int64_t d,
                               const int64_t* strides, int64_t causal,
                               int64_t window, void* stream) {
  return launch<bf16>(q, k, v, o, b, hq, hk, sq, skv, d, strides, causal,
                      window, stream);
}

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int64_t b, int64_t hq, int64_t hk,
                              int64_t sq, int64_t skv, int64_t d,
                              const int64_t* strides, int64_t causal,
                              int64_t window, void* stream) {
  return launch<float>(q, k, v, o, b, hq, hk, sq, skv, d, strides, causal,
                       window, stream);
}
