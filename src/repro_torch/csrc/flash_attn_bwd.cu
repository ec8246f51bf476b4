// Backward of the forward attention in flash_attn.cu: given q, k, v, the
// forward's output o and the rows' log-sum-exp lse, and the output's
// gradient dO, computes dQ, dK and dV.
//
// No TPU kernel: the JAX package never differentiates its Pallas
// flash_attention (src/repro/kernels/flash_attn/kernel.py has no
// custom_vjp); it trains through the pure-jnp chunked_attention
// (src/repro/models/layers.py) and lets autodiff give the gradient.  The
// port's counterpart of that function on the card is the hand-written
// forward, which autograd cannot see through, so training needs this
// backward beside it (kernels/flash_attn/ops.py: FlashAttention).  It
// computes the gradient autodiff gives, step by step as
// kernels/flash_attn/ref.py:flash_attention_bwd_ref does:
//   P = exp(S * scale - lse)  (0 where masked, and on a row with no key,
//                              whose lse is +inf)
//   dV = P^T dO,  dP = dO V^T,  Delta = rowsum(dO * O),
//   dS = P (dP - Delta),  dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over each KV head's group of q-heads.
//
// Bound on an H100: operations.  At llama3.2-3b's training shape (B 2,
// Hq 24, Hk 8, S 2,048, D 128, causal) the five products take
// 10 * B * Hq * D * (attended pairs) = 1.29e11 FLOP, 0.13 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 75 MB of q/k/v/o/dO/dq/dk/dv.
//
// Design (simple and deterministic; wgmma/TMA is later work).  Three
// launches (four with GQA), no atomics, so the results repeat bit for bit:
//  1. delta: Delta = rowsum(dO * O) in float32, one warp a row;
//  2. dkdv: one block a (b, q-head, tile of R keys of its KV head).  K and
//     V stay in shared memory; the block walks every query tile that can
//     see its keys (whole tiles outside the causal, window or chunk range
//     are skipped), recomputes S^T = K Q^T and dP^T = V dO^T, forms P^T
//     and dS^T in shared memory and accumulates dV += P^T dO and
//     dK += dS^T Q in float32 registers.  With one q-head per KV head it
//     writes dK and dV; with a group it writes its float32 share to a
//     scratch buffer, and
//     2b. group_sum adds the group's shares in head order.  (A block per
//     KV head walking the whole group ran 64 blocks for recurrentgemma's
//     MQA, half the card idle, and 3x the walk for llama's groups of 3);
//  3. dq: one block a (b, q-head, tile of R query rows), Q and dO in
//     shared memory, walking the KV tiles its rows see (tile_range, as the
//     forward), recomputing S = Q K^T and dP = dO V^T, dS in shared memory,
//     dQ += dS K in float32 registers.
// Both walking kernels put the tile index in the grid's slowest dimension
// so the longest walks (the causal mask's first KV tiles and last query
// tiles) start first, and bf16 up to D 128 fits two blocks an SM (128
// registers a thread; a block's 8 warps alone leave the tensor cores
// waiting on the synchronous tile loads).
// S and dP are computed twice (7 products instead of 5) so that no
// gradient needs a sum across blocks.  Eight warps a block: in the score
// products each warp owns 16 of the R keys (or rows) and R / (8 / (R /
// 16)) of the other side, in the gradient products 16 rows and a share of
// D's 8-column tiles.  bf16 products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, float32 accumulate), operands from shared
// memory through ldmatrix (.trans where the operand is N-major); P and dS
// are rounded to bf16 for the gradient products, as the forward rounds P.
// float32 runs the same tiles and fragment layout on CUDA cores in full
// f32 (tests; no training path takes it at full size).  R is 64, or 32
// for float32 above D 128 (shared memory).
//
// Takes exactly what the forward takes: bf16 and float32; D a multiple of
// 16 up to 256; Hq % Hk == 0 (KV head h / (Hq / Hk)); causal, a sliding
// window, llama4's chunk (floor division) or no mask; Sq != Skv with
// query row i at position i + Skv - Sq.  Any (batch, head, seq) strides
// with a contiguous last dimension.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, h, s;                // element strides; the last dim is unit
};

// ----------------------------------------------------- masks (as forward)
__device__ __forceinline__ int chunk_start(int a, int c) {
  const int q = a / c;
  return (q - (a % c < 0)) * c;
}

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

// ------------------------------------------------------------- geometry
constexpr int kThreads = 256;
constexpr int kWarps = 8;

template <typename T, int MD>
struct Geo {
  static constexpr int R = (sizeof(T) == 4 && MD > 128) ? 32 : 64;
  static constexpr int kSlabs = R / 16;          // 16-row slabs of a tile
  static constexpr int kParts = kWarps / kSlabs; // warps sharing a slab
  static constexpr int kNT1 = R / kParts / 8;    // score n8-tiles a warp
  static constexpr int kNTD = (MD / 8 + kParts - 1) / kParts;  // of D
  static constexpr int kPad = 16 / sizeof(T);    // 16 bytes a row
  static constexpr int LD = MD + kPad;           // Q/K/V/dO tile rows
  static constexpr int LDP = R + kPad;           // P / dS tile rows
  // blocks an SM: two for bf16 up to D 128 (at most 128 registers a
  // thread), one above (the D 256 accumulators) and for float32
  static constexpr int kMinBlocks = (sizeof(T) == 2 && MD <= 128) ? 2 : 1;
  static constexpr size_t kSmemKV =              // dkdv: K V Q dO P dS
      (4 * size_t(R) * LD + 2 * size_t(R) * LDP) * sizeof(T)
      + 2 * R * sizeof(float);
  static constexpr size_t kSmemQ =               // dq: Q dO K V dS
      (4 * size_t(R) * LD + size_t(R) * LDP) * sizeof(T)
      + 2 * R * sizeof(float);
};
static_assert(Geo<float, 256>::kSmemKV <= 232448, "f32 tiles at D 256");
static_assert(Geo<float, 128>::kSmemKV <= 232448, "f32 tiles at D 128");
static_assert(Geo<bf16, 256>::kSmemKV <= 232448, "bf16 tiles at D 256");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;               // [B, Hq, Sq] contiguous
  const float* delta;             // [B, Hq, Sq] contiguous
  void* dq;
  void* dk;
  void* dv;
  float* dkv_part;                // [2, B, Hq, Skv, D] when Hq > Hk, or null
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int b, hq, hk, sq, skv, d;
  int causal, window, chunk;      // window, chunk <= 0: none
  float scale, scale_log2;
  int vec;                        // 16-byte loads are aligned
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// rows [0, rows) of a [rows, d] matrix (row stride ``stride``) into shared
// memory with row stride LD; rows from ``valid`` on are zero, so a padding
// row never brings a non-finite value into the products
template <typename T, int LD>
__device__ void load_rows(T* dst, const T* src, int64_t stride, int rows,
                          int valid, int d, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int chunks = d / kVec;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) {
        val = *reinterpret_cast<const uint4*>(src + r * stride + c);
      }
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      dst[r * LD + c] = r < valid ? src[r * stride + c] : from_f<T>(0.f);
    }
  }
}

// ------------------------------------------------- warp matrix products
// c[j] (+)= A B over this warp's 16 rows and n8-tiles j < nt, K = k_len
// (a multiple of 16).  A: the warp's first row of a row-major [m][k] tile
// (lda).  B: with kBT its transpose Bt [n][k] row-major (ldb), pointing at
// the first tile's row n; else B [k][n] row-major, pointing at column n0.
// c[j] holds the mma accumulator layout: c[j][0..1] at row lane/4,
// columns 8 j + 2 (lane % 4) + {0, 1}; c[j][2..3] eight rows below.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: tensor cores, fragments by ldmatrix
template <int NT, bool kBT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const bf16* A,
                                         int lda, const bf16* B, int ldb,
                                         int k_len, int nt) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < k_len; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j + 1 < nt) {
        uint32_t b[4];
        if constexpr (kBT) {
          ldsm_x4(b, B + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * ldb
                         + k0 + ((lane >> 3) & 1) * 8);
        } else {
          ldsm_x4_t(b, B + (k0 + (lane & 15)) * ldb + j * 8
                           + (lane >> 4) * 8);
        }
        mma_bf16(c[j], a, b[0], b[1]);
        if constexpr (NT > 1) mma_bf16(c[j + 1 < NT ? j + 1 : j], a, b[2],
                                       b[3]);
      } else if (j < nt) {
        uint32_t b[2];
        if constexpr (kBT) {
          ldsm_x2(b, B + (j * 8 + (lane & 7)) * ldb + k0
                         + ((lane >> 3) & 1) * 8);
        } else {
          ldsm_x2_t(b, B + (k0 + (lane & 15)) * ldb + j * 8);
        }
        mma_bf16(c[j], a, b[0], b[1]);
      }
    }
  }
}

// float32: CUDA cores, the same layout
template <int NT, bool kBT>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int k_len, int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0p = A + g * lda;
  const float* a1p = A + (g + 8) * lda;
  for (int k = 0; k < k_len; ++k) {
    const float a0 = a0p[k], a1 = a1p[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int n = j * 8 + 2 * t;
        float b0, b1;
        if constexpr (kBT) {
          b0 = B[n * ldb + k];
          b1 = B[(n + 1) * ldb + k];
        } else {
          b0 = B[k * ldb + n];
          b1 = B[k * ldb + n + 1];
        }
        c[j][0] = fmaf(a0, b0, c[j][0]);
        c[j][1] = fmaf(a0, b1, c[j][1]);
        c[j][2] = fmaf(a1, b0, c[j][2]);
        c[j][3] = fmaf(a1, b1, c[j][3]);
      }
    }
  }
}

// 2^x: bf16 takes the approximate instruction the forward takes (P is
// rounded to bf16 anyway), float32 the accurate library call
__device__ __forceinline__ float exp2_t(float x, bf16*) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp2_t(float x, float*) { return exp2f(x); }

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  }
}

// ---------------------------------------------------------------- delta
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const Params p, float* delta) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps
                      + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(p.b) * p.hq * p.sq) return;
  const int i = static_cast<int>(row % p.sq);
  const int h = static_cast<int>((row / p.sq) % p.hq);
  const int b = static_cast<int>(row / (static_cast<int64_t>(p.sq) * p.hq));
  const T* o = static_cast<const T*>(p.o) + b * p.os.b + h * p.os.h
               + i * p.os.s;
  const T* dout = static_cast<const T*>(p.dout) + b * p.dos.b
                  + h * p.dos.h + i * p.dos.s;
  float s = 0.f;
  for (int c = lane; c < p.d; c += 32) s = fmaf(to_f(o[c]), to_f(dout[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) delta[row] = s;
}

// ----------------------------------------------------------------- dK dV
template <typename T, int MD>
__global__ void __launch_bounds__(kThreads, (Geo<T, MD>::kMinBlocks))
flash_bwd_dkdv(const Params p) {
  using G = Geo<T, MD>;
  constexpr int R = G::R, LD = G::LD, LDP = G::LDP;
  constexpr int NT1 = G::kNT1, NTD = G::kNTD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + R * LD;
  T* Qs = Vs + R * LD;
  T* dOs = Qs + R * LD;
  T* Ps = dOs + R * LD;          // P^T [key][row]
  T* dSs = Ps + R * LDP;         // dS^T [key][row]
  float* lse_s = reinterpret_cast<float*>(dSs + R * LDP);  // log2 domain
  float* delta_s = lse_s + R;

  // blocks of the longest walks (the first KV tiles under the causal
  // mask) are dispatched first: the tile index varies slowest
  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int kvh = h / (p.hq / p.hk);
  const int k0 = blockIdx.y * R;
  const int k_rows = min(R, p.skv - k0);
  const int shift = p.skv - p.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ms = (warp % G::kSlabs) * 16;     // this warp's keys
  const int part = warp / G::kSlabs;
  const int ns = part * (R / G::kParts);      // its rows in S^T
  const int tiles = p.d / 8;                  // D's 8-column tiles
  const int per = (tiles + G::kParts - 1) / G::kParts;
  const int nt_d = max(0, min(per, tiles - part * per));
  const int c0 = part * per * 8;              // its first D column

  load_rows<T, LD>(Ks, static_cast<const T*>(p.k) + b * p.ks.b
                       + kvh * p.ks.h + static_cast<int64_t>(k0) * p.ks.s,
                   p.ks.s, R, k_rows, p.d, p.vec);
  load_rows<T, LD>(Vs, static_cast<const T*>(p.v) + b * p.vs.b
                       + kvh * p.vs.h + static_cast<int64_t>(k0) * p.vs.s,
                   p.vs.s, R, k_rows, p.d, p.vec);

  // the query rows [r_lo, r_hi) whose masks can keep a key of this tile:
  // positions from the first key on (causal) and from its chunk's start,
  // below the last key's chunk's end and the last key + window
  auto lmax = [](int64_t a, int64_t b) { return a > b ? a : b; };
  auto lmin = [](int64_t a, int64_t b) { return a < b ? a : b; };
  int64_t pmin = -(int64_t{1} << 40), pmax = int64_t{1} << 40;
  const int k_last = k0 + k_rows - 1;
  if (p.causal) pmin = lmax(pmin, k0);
  if (p.chunk > 0) {
    pmin = lmax(pmin, chunk_start(k0, p.chunk));
    pmax = lmin(pmax, int64_t{chunk_start(k_last, p.chunk)} + p.chunk);
  }
  if (p.window > 0) pmax = lmin(pmax, int64_t{k_last} + p.window);
  const int64_t r_lo = lmax(0, pmin - shift);
  const int64_t r_hi = lmin(p.sq, pmax - shift);
  const int qt_begin = static_cast<int>(r_lo / R);
  const int qt_end = r_hi > r_lo ? static_cast<int>((r_hi + R - 1) / R)
                                 : qt_begin;

  float dk[NTD][4], dv[NTD][4];
  zero(dk);
  zero(dv);

  {
    const float* lse_g = p.lse + (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    const float* delta_g = p.delta
                           + (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * R;
      const int q_rows = min(R, p.sq - q0);
      __syncthreads();          // the last tile's readers are done
      load_rows<T, LD>(Qs, static_cast<const T*>(p.q) + b * p.qs.b
                           + h * p.qs.h + static_cast<int64_t>(q0) * p.qs.s,
                       p.qs.s, R, q_rows, p.d, p.vec);
      load_rows<T, LD>(dOs, static_cast<const T*>(p.dout) + b * p.dos.b
                            + h * p.dos.h
                            + static_cast<int64_t>(q0) * p.dos.s,
                       p.dos.s, R, q_rows, p.d, p.vec);
      for (int i = threadIdx.x; i < R; i += kThreads) {
        lse_s[i] = i < q_rows ? lse_g[q0 + i] * 1.4426950408889634f
                              : INFINITY;
        delta_s[i] = i < q_rows ? delta_g[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys ms.., rows ns..
      float st[NT1][4], dpt[NT1][4];
      zero(st);
      zero(dpt);
      warp_mma<NT1, true>(st, Ks + ms * LD, LD, Qs + ns * LD, LD, p.d, NT1);
      warp_mma<NT1, true>(dpt, Vs + ms * LD, LD, dOs + ns * LD, LD, p.d,
                          NT1);
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = ms + gid + 8 * (e >> 1);
          const int rl = ns + j * 8 + 2 * tig + (e & 1);
          const KeyRange kr = key_range(q0 + rl + shift, p.skv, p.causal,
                                        p.window, p.chunk);
          const int kp = k0 + kl;
          const bool keep = kl < k_rows && rl < q_rows && kp >= kr.lo
                            && kp < kr.hi;
          const float pv = keep ? exp2_t(fmaf(st[j][e], p.scale_log2,
                                              -lse_s[rl]), Ks)
                                : 0.f;
          Ps[kl * LDP + rl] = from_f<T>(pv);
          dSs[kl * LDP + rl] = from_f<T>(pv * (dpt[j][e] - delta_s[rl]));
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's R rows
      warp_mma<NTD, false>(dv, Ps + ms * LDP, LDP, dOs + c0, LD, R, nt_d);
      warp_mma<NTD, false>(dk, dSs + ms * LDP, LDP, Qs + c0, LD, R, nt_d);
    }
  }

  // one q-head per KV head: the gradients themselves; a group: this
  // q-head's share, float32, summed over the group by flash_bwd_group_sum
  T* dkg = static_cast<T*>(p.dk) + b * p.dks.b + kvh * p.dks.h;
  T* dvg = static_cast<T*>(p.dv) + b * p.dvs.b + kvh * p.dvs.h;
  const int64_t part_n = static_cast<int64_t>(p.b) * p.hq * p.skv * p.d;
  float* pkg = p.dkv_part == nullptr ? nullptr
               : p.dkv_part + (static_cast<int64_t>(b) * p.hq + h) * p.skv
                                  * p.d;
#pragma unroll
  for (int j = 0; j < NTD; ++j) {
    if (j < nt_d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = ms + gid + 8 * (e >> 1);
        const int c = c0 + j * 8 + 2 * tig + (e & 1);
        if (kl < k_rows) {
          const int64_t row = static_cast<int64_t>(k0 + kl);
          if (p.dkv_part == nullptr) {
            dkg[row * p.dks.s + c] = from_f<T>(dk[j][e] * p.scale);
            dvg[row * p.dvs.s + c] = from_f<T>(dv[j][e]);
          } else {
            pkg[row * p.d + c] = dk[j][e] * p.scale;
            pkg[part_n + row * p.d + c] = dv[j][e];
          }
        }
      }
    }
  }
}

// dK and dV of a group: each element the sum of its q-heads' shares in
// head order (deterministic), written in the operands' dtype
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_group_sum(const Params p) {
  const int group = p.hq / p.hk;
  const int64_t n = static_cast<int64_t>(p.b) * p.hk * p.skv * p.d;
  const int64_t part_n = static_cast<int64_t>(p.b) * p.hq * p.skv * p.d;
  const int64_t head = static_cast<int64_t>(p.skv) * p.d;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % p.d);
    const int64_t row = (i / p.d) % p.skv;
    const int64_t bk = i / head;                 // b * Hk + kvh
    const int kvh = static_cast<int>(bk % p.hk);
    const int b = static_cast<int>(bk / p.hk);
    const float* src = p.dkv_part + (bk * group) * head + row * p.d + c;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < group; ++g) {
      sk += src[g * head];
      sv += src[part_n + g * head];
    }
    static_cast<T*>(p.dk)[b * p.dks.b + kvh * p.dks.h + row * p.dks.s + c] =
        from_f<T>(sk);
    static_cast<T*>(p.dv)[b * p.dvs.b + kvh * p.dvs.h + row * p.dvs.s + c] =
        from_f<T>(sv);
  }
}

// -------------------------------------------------------------------- dQ
template <typename T, int MD>
__global__ void __launch_bounds__(kThreads, (Geo<T, MD>::kMinBlocks))
flash_bwd_dq(const Params p) {
  using G = Geo<T, MD>;
  constexpr int R = G::R, LD = G::LD, LDP = G::LDP;
  constexpr int NT1 = G::kNT1, NTD = G::kNTD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + R * LD;
  T* Ks = dOs + R * LD;
  T* Vs = Ks + R * LD;
  T* dSs = Vs + R * LD;          // dS [row][key]
  float* lse_s = reinterpret_cast<float*>(dSs + R * LDP);  // log2 domain
  float* delta_s = lse_s + R;

  // the last query tiles, the longest walks under the causal mask, are
  // dispatched first: the tile index varies slowest
  const int n_qt = (p.sq + R - 1) / R;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * R;
  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int kvh = h / (p.hq / p.hk);
  const int q_rows = min(R, p.sq - q0);
  const int shift = p.skv - p.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ms = (warp % G::kSlabs) * 16;     // this warp's rows
  const int part = warp / G::kSlabs;
  const int ns = part * (R / G::kParts);      // its keys in S
  const int tiles = p.d / 8;
  const int per = (tiles + G::kParts - 1) / G::kParts;
  const int nt_d = max(0, min(per, tiles - part * per));
  const int c0 = part * per * 8;

  load_rows<T, LD>(Qs, static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h
                       + static_cast<int64_t>(q0) * p.qs.s,
                   p.qs.s, R, q_rows, p.d, p.vec);
  load_rows<T, LD>(dOs, static_cast<const T*>(p.dout) + b * p.dos.b
                        + h * p.dos.h + static_cast<int64_t>(q0) * p.dos.s,
                   p.dos.s, R, q_rows, p.d, p.vec);
  const float* lse_g = p.lse + (static_cast<int64_t>(b) * p.hq + h) * p.sq;
  const float* delta_g = p.delta + (static_cast<int64_t>(b) * p.hq + h)
                                   * p.sq;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    lse_s[i] = i < q_rows ? lse_g[q0 + i] * 1.4426950408889634f : INFINITY;
    delta_s[i] = i < q_rows ? delta_g[q0 + i] : 0.f;
  }

  // this thread's two rows' key ranges, and the KV tiles any row sees
  const KeyRange kr0 = key_range(q0 + ms + gid + shift, p.skv, p.causal,
                                 p.window, p.chunk);
  const KeyRange kr1 = key_range(q0 + ms + gid + 8 + shift, p.skv, p.causal,
                                 p.window, p.chunk);
  const KeyRange first = key_range(q0 + shift, p.skv, p.causal, p.window,
                                   p.chunk);
  const KeyRange last = key_range(q0 + q_rows - 1 + shift, p.skv, p.causal,
                                  p.window, p.chunk);
  const int t_begin = first.lo / R;
  const int t_end = last.hi > first.lo ? (last.hi + R - 1) / R : t_begin;

  float dq[NTD][4];
  zero(dq);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * R;
    const int k_rows = min(R, p.skv - k0);
    __syncthreads();            // the last tile's readers are done
    load_rows<T, LD>(Ks, static_cast<const T*>(p.k) + b * p.ks.b
                         + kvh * p.ks.h + static_cast<int64_t>(k0) * p.ks.s,
                     p.ks.s, R, k_rows, p.d, p.vec);
    load_rows<T, LD>(Vs, static_cast<const T*>(p.v) + b * p.vs.b
                         + kvh * p.vs.h + static_cast<int64_t>(k0) * p.vs.s,
                     p.vs.s, R, k_rows, p.d, p.vec);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows ms.., keys ns..
    float s[NT1][4], dp[NT1][4];
    zero(s);
    zero(dp);
    warp_mma<NT1, true>(s, Qs + ms * LD, LD, Ks + ns * LD, LD, p.d, NT1);
    warp_mma<NT1, true>(dp, dOs + ms * LD, LD, Vs + ns * LD, LD, p.d, NT1);
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = ms + gid + 8 * (e >> 1);
        const int kl = ns + j * 8 + 2 * tig + (e & 1);
        const KeyRange& kr = (e >> 1) ? kr1 : kr0;
        const int kp = k0 + kl;
        const bool keep = rl < q_rows && kl < k_rows && kp >= kr.lo
                          && kp < kr.hi;
        const float pv = keep ? exp2_t(fmaf(s[j][e], p.scale_log2,
                                            -lse_s[rl]), Ks)
                              : 0.f;
        dSs[rl * LDP + kl] = from_f<T>(pv * (dp[j][e] - delta_s[rl]));
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's R keys
    warp_mma<NTD, false>(dq, dSs + ms * LDP, LDP, Ks + c0, LD, R, nt_d);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int j = 0; j < NTD; ++j) {
    if (j < nt_d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = ms + gid + 8 * (e >> 1);
        const int c = c0 + j * 8 + 2 * tig + (e & 1);
        if (rl < q_rows) {
          dqg[static_cast<int64_t>(q0 + rl) * p.dqs.s + c] =
              from_f<T>(dq[j][e] * p.scale);
        }
      }
    }
  }
}

// --------------------------------------------------------------- launch
template <typename T, int MD>
int launch_md(const Params& p, float* delta, cudaStream_t stream) {
  using G = Geo<T, MD>;
  const int64_t rows = static_cast<int64_t>(p.b) * p.hq * p.sq;
  flash_bwd_delta<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                       kThreads, 0, stream>>>(p, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, MD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::kSmemKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>(p.b * p.hq),
                     static_cast<unsigned>((p.skv + G::R - 1) / G::R));
  flash_bwd_dkdv<T, MD><<<grid_kv, kThreads, G::kSmemKV, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.dkv_part != nullptr) {
    const int64_t n = static_cast<int64_t>(p.b) * p.hk * p.skv * p.d;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    flash_bwd_group_sum<T><<<static_cast<unsigned>(
                                 blocks < 4096 ? blocks : 4096),
                             kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  err = cudaFuncSetAttribute(flash_bwd_dq<T, MD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::kSmemQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>(p.b * p.hq),
                    static_cast<unsigned>((p.sq + G::R - 1) / G::R));
  flash_bwd_dq<T, MD><<<grid_q, kThreads, G::kSmemQ, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* dkv_part, int64_t b, int64_t hq,
           int64_t hk, int64_t sq, int64_t skv, int64_t d, const int64_t* st,
           int64_t causal, int64_t window, int64_t chunk, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dkv_part = dkv_part;
  Strides* all[8] = {&p.qs, &p.ks, &p.vs, &p.os, &p.dos, &p.dqs, &p.dks,
                     &p.dvs};
  for (int i = 0; i < 8; ++i) {
    *all[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  }
  p.b = static_cast<int>(b);
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.d = static_cast<int>(d);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.chunk = static_cast<int>(chunk);
  const double scale = std::pow(static_cast<double>(d), -0.5);
  p.scale = static_cast<float>(scale);
  p.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  // 16-byte loads where every operand the tiles read allows them
  constexpr int64_t kVec = 16 / sizeof(T);
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  const int loaded[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14};
  for (int i : loaded) vec = vec && st[i] % kVec == 0;
  p.vec = vec;
  if (d % 16 != 0 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (hk <= 0 || hq % hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((hq != hk) != (dkv_part != nullptr) || b * hq >= (int64_t{1} << 31)
      || (sq + 31) / 32 > 65535 || (skv + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_md<T, 64>(p, delta, s);
  if (d <= 128) return launch_md<T, 128>(p, delta, s);
  return launch_md<T, 256>(p, delta, s);
}

}  // namespace

// strides: 24 int64 element strides, (batch, head, seq) of q, k, v, o, dO,
// dq, dk, dv; lse float32 [B, Hq, Sq] contiguous (the forward's), delta
// float32 [B, Hq, Sq] scratch; dkv_part float32 [2, B, Hq, Skv, D] scratch
// when Hq > Hk, null when Hq == Hk; window and chunk: 0 for none.  dq, dk,
// dv are written whole.  Returns 0 or a CUDA error code.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   float* dkv_part, int64_t b, int64_t hq,
                                   int64_t hk,
                                   int64_t sq, int64_t skv, int64_t d,
                                   const int64_t* strides, int64_t causal,
                                   int64_t window, int64_t chunk,
                                   void* stream) {
  return launch<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, dkv_part, b,
                      hq, hk, sq, skv, d, strides, causal, window, chunk,
                      stream);
}

extern "C" int flash_attn_bwd_f32(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const float* lse,
                                  float* delta, void* dq, void* dk, void* dv,
                                  float* dkv_part, int64_t b, int64_t hq,
                                  int64_t hk,
                                  int64_t sq, int64_t skv, int64_t d,
                                  const int64_t* strides, int64_t causal,
                                  int64_t window, int64_t chunk,
                                  void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, dkv_part,
                       b, hq, hk, sq, skv, d, strides, causal, window, chunk,
                       stream);
}
