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
// The two kernels below compute S and dP twice (7 products, 1.81e11
// FLOP) so that no gradient needs atomics or a sum across blocks: every
// sum runs in a fixed order, and a second backward repeats bit for bit.
//
// Two routes, chosen by the wrapper's plan (kernels/flash_attn/kernel.py:
// bwd_plan) by dtype:
//
// wgmma (namespace wg; bf16 at every D up to 256), FlashAttention-3's
// backward without its atomics.
// Three or four launches (two or three above D 128):
//  1. prep: Delta = rowsum(dO * O) and lse * log2(e), float32, into one
//     [2, B * Hq, Sq_pad] scratch (Sq_pad = Sq rounded up to 128; the pad
//     rows get lse +inf and Delta 0, so their P and dS are 0), 16-byte
//     loads.  Folding it into the dq kernel's prologue (run first) and
//     making its loads 16 bytes wide were each timed in turns against the
//     same earlier build (kernel_ab.py on an H100, PERF.md §6), never
//     against each other; the wide loads saved more, so it stays a launch
//     of its own;
//  2. dkdv: one block of three warpgroups a (b, KV head, share of its
//     group, tile of keys).  Warpgroup 0 is the producer: it gives up
//     its registers (setmaxnreg), and one thread loads the K and V tile
//     once, then keeps a ring of 64-row Q and dO tiles and their lse and
//     Delta rows full, with TMA (cp.async.bulk.tensor, 128-byte swizzle,
//     out-of-bounds rows zero-filled) behind full/empty mbarriers, walking
//     the share's q-heads in head order and, for each, the query tiles
//     that can see the block's keys.  At D <= 128 (flash_bwd_dkdv_wg) the
//     tile is 128 keys and warpgroups 1 and 2 own 64 keys each:
//     S^T = K Q^T and dP^T = V dO^T with wgmma from shared memory (both
//     operands K-major), P^T and dS^T in registers on the accumulator's
//     layout, packed to bf16 as the A operand of dV += P^T dO and
//     dK += dS^T Q (wgmma with A from registers, B MN-major: the
//     forward's P V form).  dK and dV stay in float32 registers for the
//     whole walk (128 a thread at D 128), so a group is summed in
//     registers: no scratch and no further launch.  Above D 128 that
//     would be 256 registers a thread, and a 128-key tile with a 3-stage
//     ring 320 KB of shared memory, so dkdv_wide_walk takes 64 keys and a
//     2-stage ring (217 KB), and its two consumers split the work instead
//     of the keys: one computes S^T and P^T, the other dP^T and dS^T,
//     each handing its result to the other through shared memory, and
//     each keeps dK and dV for half of D's columns (128 registers).
//     Where the blocks' walks leave SMs of the card idle (an MQA, or a
//     small causal grid whose late key tiles walk few query tiles), the
//     plan cuts each group into the shares its model of the walks and of
//     the partials' traffic finds fastest; each share then writes float32
//     partials and
//  2b. group_sum adds them in share order;
//  3. dq: one block of three warpgroups a (b, q-head, 128 query rows),
//     the forward's structure plus one product: Q and dO loaded once, K
//     and V tiles (64 keys; 32 above D 128, so that three stages fit
//     beside Q and dO) streamed through a TMA ring; S = Q K^T and
//     dP = dO V^T from shared memory, dS in registers, dQ += dS K with A
//     from registers and K MN-major.  dQ stays in registers (128 a thread
//     at D 256) and is scaled and written once.  Above D 128 the dkdv
//     and dq blocks run in one launch (flash_bwd_wide), dkdv's first, so
//     that the SMs one walk leaves idle take the other's blocks; the
//     group sum follows it.
// D 129..256 runs as four 64-column panels: TMA fills the columns past D
// with zeros, and they are not written back.  Both walking kernels skip
// whole tiles outside the causal, window or chunk range and run the
// per-element mask only on tiles that straddle an edge (the diagonal, a
// window or chunk edge, the ragged end); llama4's chunk is a template
// flag, so the unchunked launches carry none of its divisions.  The
// longest walks are dispatched first (the first key tiles and the last
// query tiles under the causal mask).  q, k, v, o and dO must be
// TMA-ready (16-byte aligned bases and strides; the wrapper copies one
// that is not): prep reads o and dO 16 bytes at a time.  P and dS are
// rounded to bf16 for the gradient products, as the forward rounds P.
//
// mma_sync (namespace ms; float32 at any D): the first design, on
// CUDA cores, kept for the float32 tests and the float32-compute checks.
// Three launches (four with GQA): Delta; dkdv, one block a (b, q-head,
// tile of R keys), K and V in shared memory, walking the query tiles that
// see its keys with synchronous loads, P^T and dS^T through shared memory;
// each q-head's float32 share of dK and dV to scratch where Hq > Hk, added
// by group_sum in head order; dq, one block a (b, q-head, tile of R
// query rows).  Eight warps a block, the mma.sync m16n8k16 tiles and
// fragment layout on CUDA cores in full f32.  R is 64, or 32 above D 128
// (shared memory).
//
// Takes exactly what the forward takes: bf16 and float32; D a multiple of
// 16 up to 256; Hq % Hk == 0 (KV head h / (Hq / Hk)); causal, a sliding
// window, llama4's chunk (floor division) or no mask; Sq != Skv with
// query row i at position i + Skv - Sq.  Any (batch, head, seq) strides
// with a contiguous last dimension.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;    // masks, wgmma forms, tensor maps

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// dK and dV from float32 partials [shares, 2, B, Hk, Skv, D] (dK scaled,
// then dV): each element the sum of its shares in share order
// (deterministic), written in the operands' dtype with their strides
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_group_sum(const float* part, int shares, void* dk, void* dv,
                    Strides dks, Strides dvs, int hk, int skv, int d,
                    int64_t n) {
  const int64_t head = static_cast<int64_t>(skv) * d;
  for (int64_t i = blockIdx.x * int64_t{256} + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * 256) {
    const int c = static_cast<int>(i % d);
    const int64_t row = (i / d) % skv;
    const int64_t bk = i / head;                 // b * Hk + kvh
    const int kvh = static_cast<int>(bk % hk);
    const int b = static_cast<int>(bk / hk);
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < shares; ++s) {
      sk += part[2 * s * n + i];
      sv += part[(2 * s + 1) * n + i];
    }
    static_cast<T*>(dk)[b * dks.b + kvh * dks.h + row * dks.s + c] =
        from_f<T>(sk);
    static_cast<T*>(dv)[b * dvs.b + kvh * dvs.h + row * dvs.s + c] =
        from_f<T>(sv);
  }
}

template <typename T>
cudaError_t group_sum(const float* part, int shares, void* dk, void* dv,
                      Strides dks, Strides dvs, int b, int hk, int skv,
                      int d, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(b) * hk * skv * d;
  const int64_t blocks = (n + 255) / 256;
  flash_bwd_group_sum<T><<<static_cast<unsigned>(
                               blocks < 4096 ? blocks : 4096),
                           256, 0, stream>>>(part, shares, dk, dv, dks, dvs,
                                             hk, skv, d, n);
  return cudaGetLastError();
}

// ======================= mma_sync route (ms): the first design, float32
namespace ms {

// ------------------------------------------------------------- geometry
constexpr int kThreads = 256;
constexpr int kWarps = 8;

template <int MD>
struct Geo {
  static constexpr int R = MD > 128 ? 32 : 64;
  static constexpr int kSlabs = R / 16;          // 16-row slabs of a tile
  static constexpr int kParts = kWarps / kSlabs; // warps sharing a slab
  static constexpr int kNT1 = R / kParts / 8;    // score n8-tiles a warp
  static constexpr int kNTD = (MD / 8 + kParts - 1) / kParts;  // of D
  static constexpr int kPad = 4;                 // 16 bytes a row
  static constexpr int LD = MD + kPad;           // Q/K/V/dO tile rows
  static constexpr int LDP = R + kPad;           // P / dS tile rows
  static constexpr size_t kSmemKV =              // dkdv: K V Q dO P dS
      (4 * size_t(R) * LD + 2 * size_t(R) * LDP) * sizeof(float)
      + 2 * R * sizeof(float);
  static constexpr size_t kSmemQ =               // dq: Q dO K V dS
      (4 * size_t(R) * LD + size_t(R) * LDP) * sizeof(float)
      + 2 * R * sizeof(float);
};
static_assert(Geo<256>::kSmemKV <= 232448, "f32 tiles at D 256");
static_assert(Geo<128>::kSmemKV <= 232448, "f32 tiles at D 128");

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;               // [B, Hq, Sq] contiguous
  const float* delta;             // [B, Hq, Sq] contiguous
  float* dq;
  float* dk;
  float* dv;
  float* dkv_part;     // [Hq / Hk, 2, B, Hk, Skv, D] when Hq > Hk, or null
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int b, hq, hk, sq, skv, d;
  int causal, window, chunk;      // window, chunk <= 0: none
  float scale, scale_log2;
  int vec;                        // 16-byte loads are aligned
};

// rows [0, rows) of a [rows, d] matrix (row stride ``stride``) into shared
// memory with row stride LD; rows from ``valid`` on are zero, so a padding
// row never brings a non-finite value into the products
template <int LD>
__device__ void load_rows(float* dst, const float* src, int64_t stride,
                          int rows, int valid, int d, int vec) {
  if (vec) {
    const int chunks = d / 4;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid) {
        val = *reinterpret_cast<const float4*>(src + r * stride + c);
      }
      *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      dst[r * LD + c] = r < valid ? src[r * stride + c] : 0.f;
    }
  }
}

// ------------------------------------------------- warp matrix products
// c[j] (+)= A B over this warp's 16 rows and n8-tiles j < nt, K = k_len,
// on CUDA cores in full float32.  A: the warp's first row of a row-major
// [m][k] tile (lda).  B: with kBT its transpose Bt [n][k] row-major (ldb),
// pointing at the first tile's row n; else B [k][n] row-major, pointing at
// column n0.  c[j] holds the mma.sync accumulator layout: c[j][0..1] at
// row lane/4, columns 8 j + 2 (lane % 4) + {0, 1}; c[j][2..3] eight rows
// below.
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

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  }
}

// ---------------------------------------------------------------- delta
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const Params p, float* delta) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps
                      + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(p.b) * p.hq * p.sq) return;
  const int i = static_cast<int>(row % p.sq);
  const int h = static_cast<int>((row / p.sq) % p.hq);
  const int b = static_cast<int>(row / (static_cast<int64_t>(p.sq) * p.hq));
  const float* o = p.o + b * p.os.b + h * p.os.h + i * p.os.s;
  const float* dout = p.dout + b * p.dos.b + h * p.dos.h + i * p.dos.s;
  float s = 0.f;
  for (int c = lane; c < p.d; c += 32) s = fmaf(o[c], dout[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) delta[row] = s;
}

// ----------------------------------------------------------------- dK dV
template <int MD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const Params p) {
  using G = Geo<MD>;
  constexpr int R = G::R, LD = G::LD, LDP = G::LDP;
  constexpr int NT1 = G::kNT1, NTD = G::kNTD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + R * LD;
  float* Qs = Vs + R * LD;
  float* dOs = Qs + R * LD;
  float* Ps = dOs + R * LD;          // P^T [key][row]
  float* dSs = Ps + R * LDP;         // dS^T [key][row]
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

  load_rows<LD>(Ks, p.k + b * p.ks.b + kvh * p.ks.h
                    + static_cast<int64_t>(k0) * p.ks.s,
                    p.ks.s, R, k_rows, p.d, p.vec);
  load_rows<LD>(Vs, p.v + b * p.vs.b + kvh * p.vs.h
                    + static_cast<int64_t>(k0) * p.vs.s,
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
      load_rows<LD>(Qs, p.q + b * p.qs.b + h * p.qs.h
                        + static_cast<int64_t>(q0) * p.qs.s,
                        p.qs.s, R, q_rows, p.d, p.vec);
      load_rows<LD>(dOs, p.dout + b * p.dos.b + h * p.dos.h
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
          const float pv = keep ? exp2f(fmaf(st[j][e], p.scale_log2,
                                              -lse_s[rl]))
                                : 0.f;
          Ps[kl * LDP + rl] = (pv);
          dSs[kl * LDP + rl] = (pv * (dpt[j][e] - delta_s[rl]));
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's R rows
      warp_mma<NTD, false>(dv, Ps + ms * LDP, LDP, dOs + c0, LD, R, nt_d);
      warp_mma<NTD, false>(dk, dSs + ms * LDP, LDP, Qs + c0, LD, R, nt_d);
    }
  }

  // one q-head per KV head: the gradients themselves; a group: this
  // q-head's share, float32, share h % group of the [group, 2, B, Hk, Skv,
  // D] scratch, summed over the group by flash_bwd_group_sum
  float* dkg = p.dk + b * p.dks.b + kvh * p.dks.h;
  float* dvg = p.dv + b * p.dvs.b + kvh * p.dvs.h;
  const int64_t part_n = static_cast<int64_t>(p.b) * p.hk * p.skv * p.d;
  float* pkg = p.dkv_part == nullptr ? nullptr
               : p.dkv_part + 2 * (h % (p.hq / p.hk)) * part_n
                     + (static_cast<int64_t>(b) * p.hk + kvh) * p.skv * p.d;
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
            dkg[row * p.dks.s + c] = (dk[j][e] * p.scale);
            dvg[row * p.dvs.s + c] = (dv[j][e]);
          } else {
            pkg[row * p.d + c] = dk[j][e] * p.scale;
            pkg[part_n + row * p.d + c] = dv[j][e];
          }
        }
      }
    }
  }
}

// -------------------------------------------------------------------- dQ
template <int MD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const Params p) {
  using G = Geo<MD>;
  constexpr int R = G::R, LD = G::LD, LDP = G::LDP;
  constexpr int NT1 = G::kNT1, NTD = G::kNTD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + R * LD;
  float* Ks = dOs + R * LD;
  float* Vs = Ks + R * LD;
  float* dSs = Vs + R * LD;          // dS [row][key]
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

  load_rows<LD>(Qs, p.q + b * p.qs.b + h * p.qs.h
                    + static_cast<int64_t>(q0) * p.qs.s,
                    p.qs.s, R, q_rows, p.d, p.vec);
  load_rows<LD>(dOs, p.dout + b * p.dos.b + h * p.dos.h
                     + static_cast<int64_t>(q0) * p.dos.s,
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
    load_rows<LD>(Ks, p.k + b * p.ks.b + kvh * p.ks.h
                      + static_cast<int64_t>(k0) * p.ks.s,
                      p.ks.s, R, k_rows, p.d, p.vec);
    load_rows<LD>(Vs, p.v + b * p.vs.b + kvh * p.vs.h
                      + static_cast<int64_t>(k0) * p.vs.s,
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
        const float pv = keep ? exp2f(fmaf(s[j][e], p.scale_log2,
                                            -lse_s[rl]))
                              : 0.f;
        dSs[rl * LDP + kl] = (pv * (dp[j][e] - delta_s[rl]));
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's R keys
    warp_mma<NTD, false>(dq, dSs + ms * LDP, LDP, Ks + c0, LD, R, nt_d);
  }

  float* dqg = p.dq + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int j = 0; j < NTD; ++j) {
    if (j < nt_d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = ms + gid + 8 * (e >> 1);
        const int c = c0 + j * 8 + 2 * tig + (e & 1);
        if (rl < q_rows) {
          dqg[static_cast<int64_t>(q0 + rl) * p.dqs.s + c] =
              (dq[j][e] * p.scale);
        }
      }
    }
  }
}

// --------------------------------------------------------------- launch
template <int MD>
int launch_md(const Params& p, float* delta, cudaStream_t stream) {
  using G = Geo<MD>;
  const int64_t rows = static_cast<int64_t>(p.b) * p.hq * p.sq;
  flash_bwd_delta<<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                    kThreads, 0, stream>>>(p, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dkdv<MD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::kSmemKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>(p.b * p.hq),
                     static_cast<unsigned>((p.skv + G::R - 1) / G::R));
  flash_bwd_dkdv<MD><<<grid_kv, kThreads, G::kSmemKV, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.dkv_part != nullptr) {
    err = group_sum<float>(p.dkv_part, p.hq / p.hk, p.dk, p.dv, p.dks,
                           p.dvs, p.b, p.hk, p.skv, p.d, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  err = cudaFuncSetAttribute(flash_bwd_dq<MD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::kSmemQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>(p.b * p.hq),
                    static_cast<unsigned>((p.sq + G::R - 1) / G::R));
  flash_bwd_dq<MD><<<grid_q, kThreads, G::kSmemQ, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* dkv_part, int64_t b, int64_t hq,
           int64_t hk, int64_t sq, int64_t skv, int64_t d, const int64_t* st,
           int64_t causal, int64_t window, int64_t chunk, int64_t shares,
           int64_t delta_n, int64_t part_n, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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
  constexpr int64_t kVec = 4;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  const int loaded[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14};
  for (int i : loaded) vec = vec && st[i] % kVec == 0;
  p.vec = vec;
  if (d % 16 != 0 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (hk <= 0 || hq % hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((hq != hk) != (dkv_part != nullptr) || shares != hq / hk
      || delta_n < b * hq * sq
      || part_n < (hq != hk ? 2 * b * hq * skv * d : 0)
      || b * hq >= (int64_t{1} << 31)
      || (sq + 31) / 32 > 65535 || (skv + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_md<64>(p, delta, s);
  if (d <= 128) return launch_md<128>(p, delta, s);
  return launch_md<256>(p, delta, s);
}

}  // namespace ms

// ================================ wgmma route (wg): wgmma + TMA, bf16
namespace wg {

constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kKeys = 128;            // dkdv: keys a block, 64 a consumer
constexpr int kRows = 64;             // dkdv: query rows of a ring tile
constexpr int kQRows = 128;           // dq: query rows a block, 64 a consumer
constexpr int kKvKeys = 64;           // dq: keys of a ring tile
constexpr int kStages = 3;            // depth of the rings (dkdv_wide: 2)
constexpr int kPad = 128;             // Sq_pad: Sq rounded up to this
constexpr float kLog2e = 1.4426950408889634f;
// D 129..256 (four panels; the columns past D arrive as zeros)
constexpr int kWideNP = 4;
constexpr int kWKeys = 64;            // dkdv_wide: keys a block
constexpr int kWStages = 2;           // dkdv_wide: depth of its ring
constexpr int kWKvKeys = 32;          // dq at D > 128: keys of a ring tile
constexpr int kBarP = 1;              // dkdv_wide: P^T is in the exchange
constexpr int kBarDS = 2;             // dkdv_wide: dS^T is in the exchange

struct Params {
  const void* o;
  const void* dout;
  const float* lse;               // [B, Hq, Sq] contiguous
  float* stats;                   // [2, B * Hq, sq_pad]: lse * log2 e, Delta
  void* dq;
  void* dk;
  void* dv;
  float* part;                    // [shares, 2, B, Hk, Skv, D], or null
  Strides os, dos, dqs, dks, dvs;
  int b, hq, hk, sq, skv, d, sq_pad;
  int causal, window, chunk;      // window, chunk <= 0: none
  int shares;                     // of each group (1: no partials)
  float scale, scale_log2;
  // for each tensor map, the dimension (1..3) that holds S, H and B,
  // two bits each: dims 1..3 are ordered by stride on the host
  int q_order, do_order, k_order, v_order;
};

// dkdv: the K and V tiles (NP panels of kKeys rows), a ring of Q and dO
// tiles (NP panels of kRows rows) with their lse and Delta rows
template <int NP>
constexpr size_t dkdv_smem() {
  return 1024                                        // room to align to 1 KB
         + 2 * size_t(NP) * kKeys * 128              // K and V
         + 2 * size_t(kStages) * NP * kRows * 128    // Q and dO ring
         + size_t(kStages) * 2 * kRows * sizeof(float)
         + 8 * (2 * kStages + 1);                    // mbarriers
}
// dkdv_wide: the K and V tiles (kWideNP panels of kWKeys rows), a ring of
// Q and dO tiles (kWideNP panels of kRows rows) with their lse and Delta
// rows, and the exchange between its warpgroups: P^T in float32 and dS^T
// in bf16, each in the accumulator layout, thread-major
constexpr size_t dkdv_wide_smem() {
  return 1024 + 2 * size_t(kWideNP) * kWKeys * 128
         + 2 * size_t(kWStages) * kWideNP * kRows * 128
         + 128 * 32 * sizeof(float) + 128 * 16 * sizeof(uint32_t)
         + size_t(kWStages) * 2 * kRows * sizeof(float)
         + 8 * (2 * kWStages + 1);
}
// dq: Q and dO (NP panels of kQRows rows), a ring of K and V tiles of
// kDqKeys<NP> keys
template <int NP>
constexpr int kDqKeys = NP > 2 ? kWKvKeys : kKvKeys;
template <int NP>
constexpr size_t dq_smem() {
  return 1024 + 2 * size_t(NP) * kQRows * 128
         + 2 * size_t(kStages) * NP * kDqKeys<NP> * 128
         + 8 * (2 * kStages + 1);
}
static_assert(dkdv_smem<2>() <= 232448, "dkdv tiles at D 128");
static_assert(dq_smem<2>() <= 232448, "dq tiles at D 128");
static_assert(dkdv_wide_smem() <= 232448, "dkdv tiles at D 256");
static_assert(dq_smem<kWideNP>() <= 232448, "dq tiles at D 256");

// d (+)= A B over k16: A [64 x 16] and B [32 x 16], both K-major in shared
// memory with the 128-byte swizzle; ``accumulate`` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n32(float (&d)[16],
                                               uint64_t desc_a,
                                               uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// arrive at named barrier ``id`` without waiting: ``threads`` counts the
// arriving and the waiting (hopper::named_barrier) threads, whole warps
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The query positions [lo, hi) whose masks keep key kp: every mask is one
// range of positions, and both ends only grow with kp
struct PosRange {
  int lo, hi;
};

__device__ __forceinline__ PosRange pos_range(int kp, int causal, int window,
                                              int chunk) {
  int64_t lo = INT_MIN, hi = INT_MAX;
  if (causal) lo = kp;
  if (window > 0) hi = int64_t{kp} + window < hi ? int64_t{kp} + window : hi;
  if (chunk > 0) {
    const int c = chunk_start(kp, chunk);
    lo = c > lo ? c : lo;
    hi = int64_t{c} + chunk < hi ? int64_t{c} + chunk : hi;
  }
  return {static_cast<int>(lo), static_cast<int>(hi)};
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// ------------------------------------------------------------------ prep
// half a warp a row of [B * Hq, sq_pad], 8 columns a lane (16-byte
// loads) in each 128 of D: lse * log2 e and Delta = rowsum(dO * O); a pad
// row gets +inf and 0
__global__ void __launch_bounds__(256) flash_bwd_prep(const Params p) {
  const int64_t rows = static_cast<int64_t>(p.b) * p.hq * p.sq_pad;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 16 + threadIdx.x / 16;
  const int l16 = threadIdx.x & 15;
  const bool live = row < rows;
  const int i = live ? static_cast<int>(row % p.sq_pad) : 0;
  const int64_t bh = live ? row / p.sq_pad : 0;
  const bool real = live && i < p.sq;
  float s = 0.f;
  if (real) {
    const int h = static_cast<int>(bh % p.hq);
    const int b = static_cast<int>(bh / p.hq);
    const bf16* o = static_cast<const bf16*>(p.o) + b * p.os.b + h * p.os.h
                    + i * p.os.s;
    const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.dos.b
                       + h * p.dos.h + i * p.dos.s;
    for (int c = 8 * l16; c < p.d; c += 128) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 gf = __bfloat1622float2(g2[e]);
        s = fmaf(of.x, gf.x, s);
        s = fmaf(of.y, gf.y, s);
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (live && l16 == 0) {
    p.stats[row] = real ? p.lse[bh * p.sq + i] * kLog2e : INFINITY;
    p.stats[rows + row] = s;
  }
}

// ----------------------------------------------------------------- dK dV
// kChunk: whether p.chunk is set (only chunked launches carry its
// divisions)
template <int NP, bool kChunk>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Params p) {
  constexpr int kKV = kKeys * 128;       // one panel of the K or V tile
  constexpr int kTile = kRows * 128;     // one panel of a Q or dO tile
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: tiles start on 1 KB
  unsigned char* Ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Vs = Ks + NP * kKV;
  unsigned char* Qs = Vs + NP * kKV;
  unsigned char* dOs = Qs + kStages * NP * kTile;
  float* stat = reinterpret_cast<float*>(dOs + kStages * NP * kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + kStages * 2 * kRows);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  // the block: (b, KV head, share of its group), key tile; the tile index
  // varies slowest, so the first key tiles (the longest walks under the
  // causal mask) are dispatched first
  const int share = blockIdx.x % p.shares;
  const int bk = blockIdx.x / p.shares;
  const int kvh = bk % p.hk, b = bk / p.hk;
  const int group = p.hq / p.hk;
  const int h_begin = kvh * group + share * group / p.shares;
  const int h_end = kvh * group + (share + 1) * group / p.shares;
  const int k0 = blockIdx.y * kKeys;
  const int k_rows = min(kKeys, p.skv - k0);
  const int chunk = kChunk ? p.chunk : 0;
  const int shift = p.skv - p.sq;
  // the query rows [r_lo, r_hi) whose masks can keep a key of the tile,
  // walked in tiles of kRows for every q-head of the share
  const PosRange first = pos_range(k0, p.causal, p.window, chunk);
  const PosRange last = pos_range(k0 + k_rows - 1, p.causal, p.window,
                                  chunk);
  int64_t r_lo = int64_t{first.lo} - shift, r_hi = int64_t{last.hi} - shift;
  r_lo = r_lo > 0 ? r_lo : 0;
  r_hi = r_hi < p.sq ? r_hi : p.sq;
  const int qt_begin = static_cast<int>(r_lo / kRows);
  const int n_qt = r_hi > r_lo
                       ? static_cast<int>((r_hi + kRows - 1) / kRows) - qt_begin
                       : 0;
  const int n_tiles = (h_end - h_begin) * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);     // one arrival per consumer warp
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------- producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(kv_bar, 2 * NP * kKV);
      for (int pn = 0; pn < NP; ++pn) {
        load_box(Ks + pn * kKV, &kmap, p.k_order, pn * kPanel, k0, kvh, b,
                 kv_bar);
        load_box(Vs + pn * kKV, &vmap, p.v_order, pn * kPanel, k0, kvh, b,
                 kv_bar);
      }
      const int64_t plane = static_cast<int64_t>(p.b) * p.hq * p.sq_pad;
      int h = h_begin, qt = qt_begin;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st],
                                      2 * NP * kTile + 2 * kRows * 4);
        for (int pn = 0; pn < NP; ++pn) {
          load_box(Qs + (st * NP + pn) * kTile, &qmap, p.q_order,
                   pn * kPanel, qt * kRows, h, b, &full[st]);
          load_box(dOs + (st * NP + pn) * kTile, &domap, p.do_order,
                   pn * kPanel, qt * kRows, h, b, &full[st]);
        }
        const float* src = p.stats
                           + (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad
                           + qt * kRows;
        hopper::bulk_load(stat + st * 2 * kRows, src, kRows * 4, &full[st]);
        hopper::bulk_load(stat + st * 2 * kRows + kRows, src + plane,
                          kRows * 4, &full[st]);
        if (++qt == qt_begin + n_qt) {
          qt = qt_begin;
          ++h;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1;       // 64-key half of the tile
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  // this thread's two keys (rows of the accumulator layout), and its
  // query rows 8 j + col + {0, 1} of every 8-row chunk j
  const int kw0 = k0 + wg * 64;
  const int ka = kw0 + warp * 16 + lane / 4, kb = ka + 8;
  const int col = 2 * (lane & 3);
  const PosRange ra = pos_range(ka, p.causal, p.window, chunk);
  const PosRange rb = pos_range(kb, p.causal, p.window, chunk);
  // a query tile whose positions every key of the warpgroup keeps, within
  // the keys that exist, runs no mask
  const int wlo = pos_range(kw0 + 63, p.causal, p.window, chunk).lo;
  const int whi = pos_range(kw0, p.causal, p.window, chunk).hi;
  const bool keys_in = kw0 + 64 <= p.skv;
  const float sl2 = p.scale_log2;

  float dk[NP * 32], dv[NP * 32], s[32], dp[32];
  zero(dk);
  zero(dv);
  zero(s);
  zero(dp);
  uint32_t pt[16], dst[16];

  hopper::mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int p0 = (qt_begin + i % n_qt) * kRows + shift;  // first position
    hopper::mbar_wait(&full[st], (i / kStages) & 1);

    // S^T = K Q^T, then dP^T = V dO^T: two groups, over NP panels of D
    hopper::fence_operand(s);
    hopper::fence_operand(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint64_t da = hopper::smem_desc_sw128(
          Ks + (kk / 4) * kKV + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::smem_desc_sw128(
          Qs + (st * NP + kk / 4) * kTile + (kk % 4) * 32, 16, 1024);
      wgmma_ss_m64n64(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint64_t da = hopper::smem_desc_sw128(
          Vs + (kk / 4) * kKV + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::smem_desc_sw128(
          dOs + (st * NP + kk / 4) * kTile + (kk % 4) * 32, 16, 1024);
      wgmma_ss_m64n64(dp, da, db, kk > 0);
    }
    hopper::wgmma_commit();

    const float* lse2 = stat + st * 2 * kRows;
    const float* delta = lse2 + kRows;
    const bool edge = !(keys_in && p0 >= wlo && p0 + kRows <= whi);
    hopper::wgmma_wait<1>();                    // S^T is in
    hopper::fence_operand(s);
    // P^T = exp2(S^T scale log2 e - lse log2 e), masked on edge tiles; a
    // pad row's lse is +inf, so its P is 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + col + e;
        const float l = lse2[r];
        float pa = ex2(fmaf(s[4 * j + e], sl2, -l));
        float pb = ex2(fmaf(s[4 * j + 2 + e], sl2, -l));
        if (edge) {
          const int pos = p0 + r;
          if (!(pos >= ra.lo && pos < ra.hi && ka < p.skv)) pa = 0.f;
          if (!(pos >= rb.lo && pos < rb.hi && kb < p.skv)) pb = 0.f;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pt[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pt[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    // dV += P^T dO over the tile's 64 rows (dO MN-major)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t db = hopper::smem_desc_sw128(
          dOs + st * NP * kTile + kk * 16 * 128, kTile, 1024);
      if constexpr (NP == 1) {
        wgmma_rs_m64n64<0>(dv, pt + 4 * kk, db);
      } else {
        wgmma_rs_m64n128<0>(dv, pt + 4 * kk, db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                    // dP^T is in
    hopper::fence_operand(dp);
    // dS^T = P^T (dP^T - Delta), while dV runs
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = delta[8 * j + col + e];
        s[4 * j + e] *= dp[4 * j + e] - dl;
        s[4 * j + 2 + e] *= dp[4 * j + 2 + e] - dl;
      }
      dst[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      dst[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    // dK += dS^T Q (Q MN-major)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t db = hopper::smem_desc_sw128(
          Qs + st * NP * kTile + kk * 16 * 128, kTile, 1024);
      if constexpr (NP == 1) {
        wgmma_rs_m64n64<0>(dk, dst + 4 * kk, db);
      } else {
        wgmma_rs_m64n128<0>(dk, dst + 4 * kk, db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(dv);
    hopper::fence_operand(dk);
    hopper::fence_operand(pt);
    hopper::fence_operand(dst);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // epilogue: dK * scale and dV, bf16 to the gradients, or float32 to the
  // share's partials
  const float sc = p.scale;
  if (p.part == nullptr) {
    bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dks.b + kvh * p.dks.h;
    bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dvs.b + kvh * p.dvs.h;
#pragma unroll
    for (int j = 0; j < NP * 8; ++j) {
      const int c = 8 * j + col;
      if (c < p.d && ka < p.skv) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + ka * p.dks.s + c) =
            __floats2bfloat162_rn(dk[4 * j] * sc, dk[4 * j + 1] * sc);
        *reinterpret_cast<__nv_bfloat162*>(dvg + ka * p.dvs.s + c) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      }
      if (c < p.d && kb < p.skv) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + kb * p.dks.s + c) =
            __floats2bfloat162_rn(dk[4 * j + 2] * sc, dk[4 * j + 3] * sc);
        *reinterpret_cast<__nv_bfloat162*>(dvg + kb * p.dvs.s + c) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  } else {
    const int64_t n = static_cast<int64_t>(p.b) * p.hk * p.skv * p.d;
    float* pk = p.part + 2 * share * n
                + (static_cast<int64_t>(b) * p.hk + kvh) * p.skv * p.d;
    float* pv = pk + n;
#pragma unroll
    for (int j = 0; j < NP * 8; ++j) {
      const int c = 8 * j + col;
      if (c < p.d && ka < p.skv) {
        const int64_t at = static_cast<int64_t>(ka) * p.d + c;
        *reinterpret_cast<float2*>(pk + at) =
            make_float2(dk[4 * j] * sc, dk[4 * j + 1] * sc);
        *reinterpret_cast<float2*>(pv + at) =
            make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (c < p.d && kb < p.skv) {
        const int64_t at = static_cast<int64_t>(kb) * p.d + c;
        *reinterpret_cast<float2*>(pk + at) =
            make_float2(dk[4 * j + 2] * sc, dk[4 * j + 3] * sc);
        *reinterpret_cast<float2*>(pv + at) =
            make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------------- dK dV, D > 128
// One block of three warpgroups a (b, KV head, share of its group, tile of
// kWKeys keys): the producer as above (K and V once, a 2-stage ring of Q
// and dO tiles), and two consumers over the same 64 keys that split the
// work instead of the keys.  At D 256 a thread holding dK and dV for all
// of D would need 256 float32 registers; here each holds them for its
// half of D's columns (128).  Warpgroup 0 computes S^T = K Q^T, then
// P^T, and hands P^T in float32 to warpgroup 1 through shared memory;
// warpgroup 1 computes dP^T = V dO^T and, from P^T, dS^T = P^T (dP^T -
// Delta), and hands it back in bf16.  Both exchanges are thread-major in
// the accumulator layout (each thread reads what its twin wrote), behind
// named barriers.  Then both run dV += P^T dO and dK += dS^T Q over their
// halves of the columns with A from registers.
// (bx, by): the block's (b, KV head, share) and key tile, as a grid's
template <bool kChunk>
__device__ __forceinline__ void dkdv_wide_walk(
    const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* kmap, const CUtensorMap* vmap, const Params p,
    int bx, int by) {
  constexpr int NP = kWideNP;
  constexpr int kKV = kWKeys * 128;      // one panel of the K or V tile
  constexpr int kTile = kRows * 128;     // one panel of a Q or dO tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Vs = Ks + NP * kKV;
  unsigned char* Qs = Vs + NP * kKV;
  unsigned char* dOs = Qs + kWStages * NP * kTile;
  float4* px = reinterpret_cast<float4*>(dOs + kWStages * NP * kTile);
  uint4* sx = reinterpret_cast<uint4*>(px + 8 * 128);
  float* stat = reinterpret_cast<float*>(sx + 4 * 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + kWStages * 2 * kRows);
  uint64_t* empty = full + kWStages;
  uint64_t* kv_bar = empty + kWStages;

  const int share = bx % p.shares;
  const int bk = bx / p.shares;
  const int kvh = bk % p.hk, b = bk / p.hk;
  const int group = p.hq / p.hk;
  const int h_begin = kvh * group + share * group / p.shares;
  const int h_end = kvh * group + (share + 1) * group / p.shares;
  const int k0 = by * kWKeys;
  const int k_rows = min(kWKeys, p.skv - k0);
  const int chunk = kChunk ? p.chunk : 0;
  const int shift = p.skv - p.sq;
  const PosRange first = pos_range(k0, p.causal, p.window, chunk);
  const PosRange last = pos_range(k0 + k_rows - 1, p.causal, p.window,
                                  chunk);
  int64_t r_lo = int64_t{first.lo} - shift, r_hi = int64_t{last.hi} - shift;
  r_lo = r_lo > 0 ? r_lo : 0;
  r_hi = r_hi < p.sq ? r_hi : p.sq;
  const int qt_begin = static_cast<int>(r_lo / kRows);
  const int n_qt = r_hi > r_lo
                       ? static_cast<int>((r_hi + kRows - 1) / kRows) - qt_begin
                       : 0;
  const int n_tiles = (h_end - h_begin) * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);     // one arrival per consumer warp
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------- producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(kv_bar, 2 * NP * kKV);
      for (int pn = 0; pn < NP; ++pn) {
        load_box(Ks + pn * kKV, kmap, p.k_order, pn * kPanel, k0, kvh, b,
                 kv_bar);
        load_box(Vs + pn * kKV, vmap, p.v_order, pn * kPanel, k0, kvh, b,
                 kv_bar);
      }
      const int64_t plane = static_cast<int64_t>(p.b) * p.hq * p.sq_pad;
      int h = h_begin, qt = qt_begin;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kWStages;
        hopper::mbar_wait(&empty[st], ((i / kWStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st],
                                      2 * NP * kTile + 2 * kRows * 4);
        for (int pn = 0; pn < NP; ++pn) {
          load_box(Qs + (st * NP + pn) * kTile, qmap, p.q_order,
                   pn * kPanel, qt * kRows, h, b, &full[st]);
          load_box(dOs + (st * NP + pn) * kTile, domap, p.do_order,
                   pn * kPanel, qt * kRows, h, b, &full[st]);
        }
        const float* src = p.stats
                           + (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad
                           + qt * kRows;
        hopper::bulk_load(stat + st * 2 * kRows, src, kRows * 4, &full[st]);
        hopper::bulk_load(stat + st * 2 * kRows + kRows, src + plane,
                          kRows * 4, &full[st]);
        if (++qt == qt_begin + n_qt) {
          qt = qt_begin;
          ++h;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1;       // 0: P^T, 1: dS^T
  const int t = threadIdx.x & 127;
  const int warp = t / 32, lane = t & 31;
  // this thread's two keys (rows of the accumulator layout), and its
  // query rows 8 j + col + {0, 1} of every 8-row chunk j
  const int ka = k0 + warp * 16 + lane / 4, kb = ka + 8;
  const int col = 2 * (lane & 3);
  const PosRange ra = pos_range(ka, p.causal, p.window, chunk);
  const PosRange rb = pos_range(kb, p.causal, p.window, chunk);
  // a query tile whose positions every key of the block keeps, within the
  // keys that exist, runs no mask
  const int wlo = pos_range(k0 + kWKeys - 1, p.causal, p.window, chunk).lo;
  const int whi = pos_range(k0, p.causal, p.window, chunk).hi;
  const bool keys_in = k0 + kWKeys <= p.skv;
  const float sl2 = p.scale_log2;
  // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1) over the whole of D;
  // then the products over this warpgroup's two panels of D
  const unsigned char* a_op = wg == 0 ? Ks : Vs;
  const unsigned char* b_op = wg == 0 ? Qs : dOs;
  const int half = 2 * wg;

  float dk[64], dv[64], acc[32];
  zero(dk);
  zero(dv);
  zero(acc);
  uint32_t pt[16], dst[16];

  hopper::mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kWStages;
    const int p0 = (qt_begin + i % n_qt) * kRows + shift;  // first position
    hopper::mbar_wait(&full[st], (i / kWStages) & 1);

    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint64_t da = hopper::smem_desc_sw128(
          a_op + (kk / 4) * kKV + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::smem_desc_sw128(
          b_op + (st * NP + kk / 4) * kTile + (kk % 4) * 32, 16, 1024);
      wgmma_ss_m64n64(acc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc);

    const float* lse2 = stat + st * 2 * kRows;
    const float* delta = lse2 + kRows;
    if (wg == 0) {
      // P^T = exp2(S^T scale log2 e - lse log2 e), masked on edge tiles; a
      // pad row's lse is +inf, so its P is 0
      const bool edge = !(keys_in && p0 >= wlo && p0 + kRows <= whi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + col + e;
          const float l = lse2[r];
          float pa = ex2(fmaf(acc[4 * j + e], sl2, -l));
          float pb = ex2(fmaf(acc[4 * j + 2 + e], sl2, -l));
          if (edge) {
            const int pos = p0 + r;
            if (!(pos >= ra.lo && pos < ra.hi && ka < p.skv)) pa = 0.f;
            if (!(pos >= rb.lo && pos < rb.hi && kb < p.skv)) pb = 0.f;
          }
          acc[4 * j + e] = pa;
          acc[4 * j + 2 + e] = pb;
        }
        px[j * 128 + t] = make_float4(acc[4 * j], acc[4 * j + 1],
                                      acc[4 * j + 2], acc[4 * j + 3]);
        pt[2 * j] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        pt[2 * j + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      bar_arrive(kBarP, 256);
    } else {
      // dS^T = P^T (dP^T - Delta), from warpgroup 0's P^T
      hopper::named_barrier(kBarP, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pv = px[j * 128 + t];
        const float d0 = delta[8 * j + col], d1 = delta[8 * j + col + 1];
        pt[2 * j] = pack_bf16(pv.x, pv.y);
        pt[2 * j + 1] = pack_bf16(pv.z, pv.w);
        dst[2 * j] = pack_bf16(pv.x * (acc[4 * j] - d0),
                               pv.y * (acc[4 * j + 1] - d1));
        dst[2 * j + 1] = pack_bf16(pv.z * (acc[4 * j + 2] - d0),
                                   pv.w * (acc[4 * j + 3] - d1));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        sx[m * 128 + t] = make_uint4(dst[4 * m], dst[4 * m + 1],
                                     dst[4 * m + 2], dst[4 * m + 3]);
      }
      bar_arrive(kBarDS, 256);
    }
    // dV += P^T dO over the tile's 64 rows (dO MN-major), this
    // warpgroup's columns
    hopper::fence_operand(pt);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t db = hopper::smem_desc_sw128(
          dOs + (st * NP + half) * kTile + kk * 16 * 128, kTile, 1024);
      wgmma_rs_m64n128<0>(dv, pt + 4 * kk, db);
    }
    hopper::wgmma_commit();
    if (wg == 0) {
      hopper::named_barrier(kBarDS, 256);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint4 sv = sx[m * 128 + t];
        dst[4 * m] = sv.x;
        dst[4 * m + 1] = sv.y;
        dst[4 * m + 2] = sv.z;
        dst[4 * m + 3] = sv.w;
      }
    }
    // dK += dS^T Q (Q MN-major)
    hopper::fence_operand(dst);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t db = hopper::smem_desc_sw128(
          Qs + (st * NP + half) * kTile + kk * 16 * 128, kTile, 1024);
      wgmma_rs_m64n128<0>(dk, dst + 4 * kk, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(dv);
    hopper::fence_operand(dk);
    hopper::fence_operand(pt);
    hopper::fence_operand(dst);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // epilogue: dK * scale and dV over this warpgroup's columns, bf16 to the
  // gradients, or float32 to the share's partials
  const float sc = p.scale;
  const int c0 = half * kPanel;
  if (p.part == nullptr) {
    bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dks.b + kvh * p.dks.h;
    bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dvs.b + kvh * p.dvs.h;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + col;
      if (c < p.d && ka < p.skv) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + ka * p.dks.s + c) =
            __floats2bfloat162_rn(dk[4 * j] * sc, dk[4 * j + 1] * sc);
        *reinterpret_cast<__nv_bfloat162*>(dvg + ka * p.dvs.s + c) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      }
      if (c < p.d && kb < p.skv) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + kb * p.dks.s + c) =
            __floats2bfloat162_rn(dk[4 * j + 2] * sc, dk[4 * j + 3] * sc);
        *reinterpret_cast<__nv_bfloat162*>(dvg + kb * p.dvs.s + c) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  } else {
    const int64_t n = static_cast<int64_t>(p.b) * p.hk * p.skv * p.d;
    float* pk = p.part + 2 * share * n
                + (static_cast<int64_t>(b) * p.hk + kvh) * p.skv * p.d;
    float* pv = pk + n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + col;
      if (c < p.d && ka < p.skv) {
        const int64_t at = static_cast<int64_t>(ka) * p.d + c;
        *reinterpret_cast<float2*>(pk + at) =
            make_float2(dk[4 * j] * sc, dk[4 * j + 1] * sc);
        *reinterpret_cast<float2*>(pv + at) =
            make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (c < p.d && kb < p.skv) {
        const int64_t at = static_cast<int64_t>(kb) * p.d + c;
        *reinterpret_cast<float2*>(pk + at) =
            make_float2(dk[4 * j + 2] * sc, dk[4 * j + 3] * sc);
        *reinterpret_cast<float2*>(pv + at) =
            make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// -------------------------------------------------------------------- dQ
// NP panels of D; above two (D > 128) the ring's tiles are 32 keys, so that
// Q, dO and three stages fit, and dQ (64 x 256 float32 a warpgroup) is two
// 128-column halves
// (bx, by): the block's (b, q-head) and query tile, as a grid's
template <int NP, bool kChunk>
__device__ __forceinline__ void dq_walk(
    const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* kmap, const CUtensorMap* vmap, const Params p,
    int bx, int by) {
  constexpr int BK = kDqKeys<NP>;      // keys of a ring tile
  constexpr int kQT = kQRows * 128;      // one panel of Q or dO
  constexpr int kKT = BK * 128;          // one panel of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* dOs = Qs + NP * kQT;
  unsigned char* Ks = dOs + NP * kQT;
  unsigned char* Vs = Ks + kStages * NP * kKT;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * NP * kKT);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  // the last query tiles, the longest walks under the causal mask, are
  // dispatched first: the tile index varies slowest
  const int n_qt = (p.sq + kQRows - 1) / kQRows;
  const int h = bx % p.hq, b = bx / p.hq;
  const int kvh = h / (p.hq / p.hk);
  const int q0 = (n_qt - 1 - by) * kQRows;
  const int q_rows = min(kQRows, p.sq - q0);
  const int chunk = kChunk ? p.chunk : 0;
  const TileRange tr = tile_range(q0, q_rows, p.sq, p.skv, p.causal,
                                  p.window, chunk, BK);
  const int n_tiles = tr.t_end - tr.t_begin;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);     // one arrival per consumer warp
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------- producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_bar, 2 * NP * kQT);
      for (int pn = 0; pn < NP; ++pn) {
        load_box(Qs + pn * kQT, qmap, p.q_order, pn * kPanel, q0, h, b,
                 q_bar);
        load_box(dOs + pn * kQT, domap, p.do_order, pn * kPanel, q0, h, b,
                 q_bar);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int k0 = (tr.t_begin + i) * BK;
        hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * NP * kKT);
        for (int pn = 0; pn < NP; ++pn) {
          load_box(Ks + (st * NP + pn) * kKT, kmap, p.k_order, pn * kPanel,
                   k0, kvh, b, &full[st]);
          load_box(Vs + (st * NP + pn) * kKT, vmap, p.v_order, pn * kPanel,
                   k0, kvh, b, &full[st]);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int half = threadIdx.x / 128 - 1;     // 64-row half of the tile
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  // this thread's two rows of the accumulator layout, and its keys
  // 8 j + col + {0, 1} of every 8-key chunk j
  const int row0 = half * 64 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int col = 2 * (lane & 3);
  const int shift = p.skv - p.sq;
  const KeyRange keys0 = key_range(q0 + row0 + shift, p.skv, p.causal,
                                   p.window, chunk);
  const KeyRange keys1 = key_range(q0 + row1 + shift, p.skv, p.causal,
                                   p.window, chunk);
  // the keys every row of this warpgroup keeps: a tile within them runs
  // no mask
  const int wq = q0 + half * 64 + shift;
  const int lo_last = key_range(wq + 63, p.skv, p.causal, p.window,
                                chunk).lo;
  const int hi_first = key_range(wq, p.skv, p.causal, p.window, chunk).hi;
  // the rows' lse * log2 e and Delta (a pad row: +inf and 0)
  const float* rows = p.stats + (static_cast<int64_t>(b) * p.hq + h)
                                    * p.sq_pad + q0;
  const int64_t plane = static_cast<int64_t>(p.b) * p.hq * p.sq_pad;
  const float l0 = rows[row0], l1 = rows[row1];
  const float d0 = rows[plane + row0], d1 = rows[plane + row1];
  const float sl2 = p.scale_log2;

  float dq[NP * 32], s[BK / 2], dp[BK / 2];
  zero(dq);
  zero(s);
  zero(dp);
  uint32_t dsa[BK / 4];

  hopper::mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = (tr.t_begin + i) * BK;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);

    // S = Q K^T, then dP = dO V^T: two groups, over NP panels of D
    hopper::fence_operand(s);
    hopper::fence_operand(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint64_t da = hopper::smem_desc_sw128(
          Qs + (kk / 4) * kQT + half * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::smem_desc_sw128(
          Ks + (st * NP + kk / 4) * kKT + (kk % 4) * 32, 16, 1024);
      if constexpr (BK == 64) {
        wgmma_ss_m64n64(s, da, db, kk > 0);
      } else {
        wgmma_ss_m64n32(s, da, db, kk > 0);
      }
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint64_t da = hopper::smem_desc_sw128(
          dOs + (kk / 4) * kQT + half * 64 * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = hopper::smem_desc_sw128(
          Vs + (st * NP + kk / 4) * kKT + (kk % 4) * 32, 16, 1024);
      if constexpr (BK == 64) {
        wgmma_ss_m64n64(dp, da, db, kk > 0);
      } else {
        wgmma_ss_m64n32(dp, da, db, kk > 0);
      }
    }
    hopper::wgmma_commit();

    const bool edge = !(k0 >= lo_last && k0 + BK <= hi_first);
    hopper::wgmma_wait<1>();                    // S is in
    hopper::fence_operand(s);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = ex2(fmaf(s[4 * j + e], sl2, -l0));
        float p1 = ex2(fmaf(s[4 * j + 2 + e], sl2, -l1));
        if (edge) {
          const int kp = k0 + 8 * j + col + e;
          if (!(kp >= keys0.lo && kp < keys0.hi)) p0 = 0.f;
          if (!(kp >= keys1.lo && kp < keys1.hi)) p1 = 0.f;
        }
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
      }
    }
    hopper::wgmma_wait<0>();                    // dP is in
    hopper::fence_operand(dp);
    // dS = P (dP - Delta), packed as the A operand of dS K
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      dsa[2 * j] = pack_bf16(s[4 * j] * (dp[4 * j] - d0),
                             s[4 * j + 1] * (dp[4 * j + 1] - d0));
      dsa[2 * j + 1] = pack_bf16(s[4 * j + 2] * (dp[4 * j + 2] - d1),
                                 s[4 * j + 3] * (dp[4 * j + 3] - d1));
    }
    // dQ += dS K over the tile's keys (K MN-major)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = hopper::smem_desc_sw128(
          Ks + st * NP * kKT + kk * 16 * 128, kKT, 1024);
      if constexpr (NP == 1) {
        wgmma_rs_m64n64<0>(dq, dsa + 4 * kk, db);
      } else {
        wgmma_rs_m64n128<0>(dq, dsa + 4 * kk, db);
      }
      if constexpr (NP == kWideNP) {              // columns 128..255
        wgmma_rs_m64n128<64>(dq, dsa + 4 * kk, hopper::smem_desc_sw128(
            Ks + (st * NP + 2) * kKT + kk * 16 * 128, kKT, 1024));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(dq);
    hopper::fence_operand(dsa);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // epilogue: dQ * scale -> bf16 -> global
  const float sc = p.scale;
  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dqs.b + h * p.dqs.h;
  bf16* out0 = dqg + static_cast<int64_t>(q0 + row0) * p.dqs.s;
  bf16* out1 = dqg + static_cast<int64_t>(q0 + row1) * p.dqs.s;
#pragma unroll
  for (int j = 0; j < NP * 8; ++j) {
    const int c = 8 * j + col;
    if (c < p.d && row0 < q_rows) {
      *reinterpret_cast<__nv_bfloat162*>(out0 + c) =
          __floats2bfloat162_rn(dq[4 * j] * sc, dq[4 * j + 1] * sc);
    }
    if (c < p.d && row1 < q_rows) {
      *reinterpret_cast<__nv_bfloat162*>(out1 + c) =
          __floats2bfloat162_rn(dq[4 * j + 2] * sc, dq[4 * j + 3] * sc);
    }
  }
}

template <int NP, bool kChunk>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Params p) {
  dq_walk<NP, kChunk>(&qmap, &domap, &kmap, &vmap, p, blockIdx.x,
                      blockIdx.y);
}

// ------------------------------------------------------ D > 128, fused
// Above D 128 the dK/dV and dQ walks run in one launch: its first blocks
// are the dK/dV grid's (key tile slowest, as above), the rest the dQ
// grid's, so that the SMs one walk leaves idle (recurrentgemma-2b on a
// rank: 96 dK/dV and 48 dQ blocks for 132 SMs) take the other's blocks.
// The two share nothing but prep's rows.
template <bool kChunk>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide(const __grid_constant__ CUtensorMap kv_q,
               const __grid_constant__ CUtensorMap kv_do,
               const __grid_constant__ CUtensorMap kv_k,
               const __grid_constant__ CUtensorMap kv_v,
               const __grid_constant__ CUtensorMap q_q,
               const __grid_constant__ CUtensorMap q_do,
               const __grid_constant__ CUtensorMap q_k,
               const __grid_constant__ CUtensorMap q_v, const Params p) {
  const int kv_x = p.b * p.hk * p.shares;
  const int kv_blocks = kv_x * ((p.skv + kWKeys - 1) / kWKeys);
  const int i = static_cast<int>(blockIdx.x);
  if (i < kv_blocks) {
    dkdv_wide_walk<kChunk>(&kv_q, &kv_do, &kv_k, &kv_v, p, i % kv_x,
                           i / kv_x);
  } else {
    const int q_x = p.b * p.hq;
    dq_walk<kWideNP, kChunk>(&q_q, &q_do, &q_k, &q_v, p,
                             (i - kv_blocks) % q_x, (i - kv_blocks) / q_x);
  }
}

// --------------------------------------------------------------- launch
// maps: Q, dO (box kRows), K, V (box kKeys; kWKeys above D 128) for dkdv;
// Q, dO (box kQRows), K, V (box kDqKeys<NP>) for dq
template <int NP, bool kChunk>
int launch_np(const CUtensorMap (&kv)[4], const CUtensorMap (&qm)[4],
              const Params& p, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem<NP>(), smem_q = dq_smem<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wg<NP, kChunk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>(p.b * p.hk * p.shares),
                     static_cast<unsigned>((p.skv + kKeys - 1) / kKeys));
  flash_bwd_dkdv_wg<NP, kChunk><<<grid_kv, kThreads, smem_kv, stream>>>(
      kv[0], kv[1], kv[2], kv[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.part != nullptr) {
    err = group_sum<bf16>(p.part, p.shares, p.dk, p.dv, p.dks, p.dvs, p.b,
                          p.hk, p.skv, p.d, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(
      flash_bwd_dq_wg<NP, kChunk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>(p.b * p.hq),
                    static_cast<unsigned>((p.sq + kQRows - 1) / kQRows));
  flash_bwd_dq_wg<NP, kChunk><<<grid_q, kThreads, smem_q, stream>>>(
      qm[0], qm[1], qm[2], qm[3], p);
  return static_cast<int>(cudaGetLastError());
}

// above D 128: the fused walks, then the group sum
template <bool kChunk>
int launch_wide(const CUtensorMap (&kv)[4], const CUtensorMap (&qm)[4],
                const Params& p, int64_t blocks, cudaStream_t stream) {
  constexpr size_t smem = dkdv_wide_smem() > dq_smem<kWideNP>()
                              ? dkdv_wide_smem() : dq_smem<kWideNP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wide<kChunk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_wide<kChunk><<<static_cast<unsigned>(blocks), kThreads, smem,
                           stream>>>(kv[0], kv[1], kv[2], kv[3], qm[0], qm[1],
                                     qm[2], qm[3], p);
  err = cudaGetLastError();
  if (err == cudaSuccess && p.part != nullptr) {
    err = group_sum<bf16>(p.part, p.shares, p.dk, p.dv, p.dks, p.dvs, p.b,
                          p.hk, p.skv, p.d, stream);
  }
  return static_cast<int>(err);
}

int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* stats, void* dq,
           void* dk, void* dv, float* part, int64_t b, int64_t hq, int64_t hk,
           int64_t sq, int64_t skv, int64_t d, const int64_t* st,
           int64_t causal, int64_t window, int64_t chunk, int64_t shares,
           int64_t stats_n, int64_t part_n, void* stream) {
  if (d % 16 != 0 || d > kWideNP * kPanel || hk <= 0 || hq % hk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int np = d <= kPanel ? 1 : d <= 2 * kPanel ? 2 : kWideNP;
  const int kv_keys = np == kWideNP ? kWKeys : kKeys;
  const int q_keys = np == kWideNP ? kDqKeys<kWideNP> : kDqKeys<2>;
  const int64_t sq_pad = (sq + kPad - 1) / kPad * kPad;
  // the fused launch's blocks above D 128
  const int64_t wide_blocks = b * hk * shares * ((skv + kWKeys - 1) / kWKeys)
                              + b * hq * ((sq + kQRows - 1) / kQRows);
  if (shares < 1 || shares > hq / hk || (shares > 1) != (part != nullptr)
      || stats_n < 2 * b * hq * sq_pad
      || part_n < (shares > 1 ? shares * 2 * b * hk * skv * d : 0)
      || b * hq * sq_pad / 8 >= (int64_t{1} << 31)
      || b * hk * shares >= (int64_t{1} << 31)
      || (sq + kQRows - 1) / kQRows > 65535
      || (skv + kv_keys - 1) / kv_keys > 65535
      || wide_blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  Params p;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.stats = stats;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.part = part;
  p.os = {st[9], st[10], st[11]};
  p.dos = {st[12], st[13], st[14]};
  p.dqs = {st[15], st[16], st[17]};
  p.dks = {st[18], st[19], st[20]};
  p.dvs = {st[21], st[22], st[23]};
  p.b = static_cast<int>(b);
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.d = static_cast<int>(d);
  p.sq_pad = static_cast<int>(sq_pad);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.chunk = static_cast<int>(chunk);
  p.shares = static_cast<int>(shares);
  const double scale = std::pow(static_cast<double>(d), -0.5);
  p.scale = static_cast<float>(scale);
  p.scale_log2 = static_cast<float>(scale * 1.4426950408889634);

  CUtensorMap kv[4], qm[4];
  int err = encode(&kv[0], q, b, hq, sq, d, st, kRows, &p.q_order);
  if (err == 0) err = encode(&kv[1], dout, b, hq, sq, d, st + 12, kRows,
                             &p.do_order);
  if (err == 0) err = encode(&kv[2], k, b, hk, skv, d, st + 3, kv_keys,
                             &p.k_order);
  if (err == 0) err = encode(&kv[3], v, b, hk, skv, d, st + 6, kv_keys,
                             &p.v_order);
  // the same operands with the dq kernel's boxes: the orders do not change
  int unused;
  if (err == 0) err = encode(&qm[0], q, b, hq, sq, d, st, kQRows, &unused);
  if (err == 0) err = encode(&qm[1], dout, b, hq, sq, d, st + 12, kQRows,
                             &unused);
  if (err == 0) err = encode(&qm[2], k, b, hk, skv, d, st + 3, q_keys,
                             &unused);
  if (err == 0) err = encode(&qm[3], v, b, hk, skv, d, st + 6, q_keys,
                             &unused);
  if (err != 0) return err;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = b * hq * sq_pad;
  flash_bwd_prep<<<static_cast<unsigned>((rows + 15) / 16), 256, 0, s>>>(p);
  const cudaError_t perr = cudaGetLastError();
  if (perr != cudaSuccess) return static_cast<int>(perr);
  if (np == 1) {
    return p.chunk > 0 ? launch_np<1, true>(kv, qm, p, s)
                       : launch_np<1, false>(kv, qm, p, s);
  }
  if (np == 2) {
    return p.chunk > 0 ? launch_np<2, true>(kv, qm, p, s)
                       : launch_np<2, false>(kv, qm, p, s);
  }
  return p.chunk > 0 ? launch_wide<true>(kv, qm, p, wide_blocks, s)
                     : launch_wide<false>(kv, qm, p, wide_blocks, s);
}

}  // namespace wg

}  // namespace

// strides: 24 int64 element strides, (batch, head, seq) of q, k, v, o, dO,
// dq, dk, dv; lse float32 [B, Hq, Sq] contiguous (the forward's); window
// and chunk: 0 for none; dq, dk, dv are written whole.  The route, the
// scratch and ``shares`` come from kernels/flash_attn/kernel.py:bwd_plan,
// which alone picks the route; delta_n and part_n are the elements of
// the two scratch buffers, and a launch that would write past either
// returns an error:
//  - route 1, wgmma (bf16): delta float32 [2, B * Hq, Sq_pad],
//    Sq_pad = Sq rounded up to 128; shares: how many parts each group of
//    q-heads is cut into, 1 <= shares <= Hq / Hk, with dkv_part float32
//    [shares, 2, B, Hk, Skv, D] when shares > 1, null when 1;
//  - route 0, mma_sync (float32): delta float32 [B, Hq, Sq]; shares =
//    Hq / Hk, with dkv_part float32 [Hq / Hk, 2, B, Hk, Skv, D] when
//    Hq > Hk.
// Returns 0, a CUDA error code (cudaErrorInvalidValue for a route that
// does not take the dtype or D), or (route wgmma) -1 when
// cuTensorMapEncodeTiled is not found and -2 when it refuses an operand.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   float* dkv_part, int64_t b, int64_t hq,
                                   int64_t hk,
                                   int64_t sq, int64_t skv, int64_t d,
                                   const int64_t* strides, int64_t causal,
                                   int64_t window, int64_t chunk,
                                   int64_t route, int64_t shares,
                                   int64_t delta_n, int64_t part_n,
                                   void* stream) {
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  return wg::launch(q, k, v, o, dout, lse, delta, dq, dk, dv, dkv_part, b,
                    hq, hk, sq, skv, d, strides, causal, window, chunk,
                    shares, delta_n, part_n, stream);
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
                                  int64_t route, int64_t shares,
                                  int64_t delta_n, int64_t part_n,
                                  void* stream) {
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  return ms::launch(q, k, v, o, dout, lse, delta, dq, dk, dv, dkv_part, b,
                    hq, hk, sq, skv, d, strides, causal, window, chunk,
                    shares, delta_n, part_n, stream);
}
