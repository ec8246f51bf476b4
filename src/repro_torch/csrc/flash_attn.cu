// Forward attention over q [B, Hq, Sq, D] and k/v [B, Hk, Skv, D]:
// prefill attention of the model substrate.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// (_attn_kernel / flash_attention).  The TPU version walks KV blocks as a
// sequential grid axis and carries the online-softmax statistics m, l and
// the accumulator in VMEM scratch from one grid step to the next.  Blocks
// of a CUDA grid run in no order, so here one block owns one (b, q-head,
// query tile) and loops over the KV tiles itself.
//
// Bound on an H100: operations.  At the serving path's prefill (B 8,
// Hq 24, Sq = Skv = 2048, D 128, causal, bf16) the two products take
// 4*B*Hq*D*Sq*(Sq+1)/2 = 2.06e11 FLOP, 0.21 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 268 MB of q/k/v/o, 0.08 ms at 3.35 TB/s.
//
// bf16, FlashAttention-3 style: a block of three warpgroups owns a
// 128-row query tile.  Warpgroup 0 is the producer: one thread loads the
// Q tile once and keeps a three-stage ring of 128-key K and V tiles full
// with TMA (cp.async.bulk.tensor, 128-byte swizzle, out-of-bounds rows
// and columns zero-filled), behind full/empty mbarriers, and gives its
// registers to the consumers (setmaxnreg).  Warpgroups 1 and 2 own 64
// query rows each: S = Q K^T with wgmma from shared memory, the online
// softmax in registers on the accumulator's known layout, P converted to
// bf16 in registers and O += P V with wgmma taking P from registers and V
// from shared memory (MN-major, the descriptor's transpose).  O stays in
// registers for the whole walk, and each tile's softmax runs while the
// tensor cores do the previous tile's P V.  The tensor maps take every
// operand with its own strides, so the serve path's [B, S, H, D] q view
// is read with no copy; D <= 256 is covered as NP = ceil(D / 64)
// 64-column panels.  Up to D 128 a K/V tile holds 128 keys in a ring of
// three stages.  Above it (recurrentgemma's D 256) the Q tile alone takes
// NP * 16 KB and O takes NP * 32 accumulator floats a thread, so a tile
// holds 64 keys (S is an m64n64 product) in a ring of two stages: at NP 4,
// 64 KB of Q and 2 * (32 + 32) KB of K/V, and O, S and P in 176 registers
// of the 232 a consumer has.  No FLOP goes to KV tiles wholly above the
// causal diagonal or outside the sliding window or the local chunk: they
// are skipped, as the TPU kernel skips them with pl.when, and only tiles
// on the diagonal, the window's or a chunk's edge or the ragged end run
// the mask.  The
// float32 instantiation keeps a plain route on CUDA cores (64-row tiles,
// 32-row ones above D 128, synchronous loads) in full f32; it serves
// tests, never the serve path.
//
// Semantics, as the TPU kernel: scores in f32 from the inputs, scaled by
// D^-0.5; query row i sits at position i + (Skv - Sq) (suffix alignment);
// causal keeps keys <= that position, a window w keeps keys > position - w;
// and, which the TPU kernel lacks, a chunk width c (llama4's chunked local
// attention, as the JAX model layer's chunked_attention masks it) keeps
// keys k with floor(k / c) == floor(position / c), floor division since a
// position may be negative; masks are predicates, never sentinel scores;
// the output is acc / max(l, 1e-30) in q's dtype.  With ``lse`` given
// (training: the backward kernel, csrc/flash_attn_bwd.cu, reads it), each
// row's log-sum-exp of its scaled scores, m * scale + log l, goes to lse
// [B, Hq, Sq] float32, +inf for a row with no key; it is a template flag
// (kLse), so the serving launches (lse null) run the code they ran
// before.  A row with no key left
// by the mask (causal with Sq > Skv, rows before position 0) gives zeros.
// That is a choice: the TPU kernel gives zeros there only where it skips
// every KV block of the row's 256-row query block; inside a block it runs,
// such a row weighs each of the block's keys (padding included) equally,
// and the pure-jnp oracle averages every key.  GQA by indexing: q-head h
// reads KV head h / (Hq / Hk); the caller never repeats K or V.  Every
// tensor is taken with the element strides it has (batch, head, sequence);
// only the last dimension must be contiguous, and the bf16 route needs
// 16-byte aligned bases and strides (the wrapper copies an operand that is
// not).
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include "attn_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

constexpr float kNegInf = -1e30f;

// ===================================================== bf16: wgmma + TMA
namespace bf {

constexpr int kBQ = 128;              // query rows per block
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kQBytes = kBQ * 128;    // one panel of the Q tile
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Params {
  void* o;
  float* lse;                     // [B, Hq, Sq], written when kLse
  Strides os;
  int hq, hk, sq, skv, d, n_qt;
  int causal, window;             // window <= 0: no window
  int chunk;                      // chunk <= 0: no chunk
  float scale_log2;               // D^-0.5 * log2(e)
  // for each tensor map, the dimension (1..3) that holds S, H and B,
  // two bits each: dims 1..3 are ordered by stride on the host
  int q_order, k_order, v_order;
};

// the instantiations: NP panels of D, kBK keys per K/V tile (a panel of
// a tile is kBK * 128 bytes), kStages deep ring
template <int NP, int kBK, int kStages>
constexpr size_t smem_bytes() {
  return 1024                                   // room to align to 1 KB
         + size_t(NP) * kQBytes                 // Q
         + 2 * size_t(kStages) * NP * kBK * 128  // K and V rings
         + 8 * (3 * kStages + 1);               // mbarriers
}
static_assert(smem_bytes<2, 128, 3>() <= 232448, "D <= 128 tiles");
static_assert(smem_bytes<4, 64, 2>() <= 232448, "D <= 256 tiles");

// the keys per K/V tile and the ring's depth at NP panels
constexpr int tile_keys(int np) { return np <= 2 ? 128 : 64; }
constexpr int ring_stages(int np) { return np <= 2 ? 3 : 2; }

// kChunk: whether p.chunk is set.  Compiled into every launch, the
// chunk's floor divisions cost the unchunked ones ~4 % on an H100
// (kernel_ab.py), so only chunked launches carry them.  kLse: whether
// the rows' log-sum-exp goes to p.lse (training's forward).
template <int NP, int kBK, int kStages, bool kChunk, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const Params p) {
  constexpr int kTileBytes = kBK * 128;   // one panel of a K or V tile
  constexpr int kCols = kBK / 8;          // 8-key chunks of a score row
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: tiles start on 1 KB
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + NP * kQBytes;
  unsigned char* Vs = Ks + kStages * NP * kTileBytes;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + kStages * NP
                                                 * kTileBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  uint64_t* q_bar = empty + kStages;

  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int kvh = h / (p.hq / p.hk);
  const int q0 = (p.n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int q_rows = min(kBQ, p.sq - q0);
  const int chunk = kChunk ? p.chunk : 0;
  const TileRange tr = tile_range(q0, q_rows, p.sq, p.skv, p.causal,
                                  p.window, chunk, kBK);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full_k[i], 1);
      hopper::mbar_init(&full_v[i], 1);
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
      hopper::mbar_arrive_expect_tx(q_bar, NP * kQBytes);
      for (int pn = 0; pn < NP; ++pn) {
        load_box(Qs + pn * kQBytes, &qmap, p.q_order, pn * kPanel, q0, h, b,
                 q_bar);
      }
      for (int t = tr.t_begin, i = 0; t < tr.t_end; ++t, ++i) {
        const int st = i % kStages;
        hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full_k[st], NP * kTileBytes);
        for (int pn = 0; pn < NP; ++pn) {
          load_box(Ks + (st * NP + pn) * kTileBytes, &kmap, p.k_order,
                   pn * kPanel, t * kBK, kvh, b, &full_k[st]);
        }
        hopper::mbar_arrive_expect_tx(&full_v[st], NP * kTileBytes);
        for (int pn = 0; pn < NP; ++pn) {
          load_box(Vs + (st * NP + pn) * kTileBytes, &vmap, p.v_order,
                   pn * kPanel, t * kBK, kvh, b, &full_v[st]);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int half = threadIdx.x / 128 - 1;     // 64-row half of the tile
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  // this thread's two rows of the accumulator layout, and its columns
  // 8 j + col + {0, 1} of every 8-column chunk j
  const int row0 = half * 64 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int col = 2 * (lane & 3);
  const int pos0 = q0 + row0 + p.skv - p.sq;
  const KeyRange keys0 = key_range(pos0, p.skv, p.causal, p.window, chunk);
  const KeyRange keys1 = key_range(pos0 + 8, p.skv, p.causal, p.window,
                                   chunk);
  const float sl2 = p.scale_log2;

  float o[NP * 32], s[kBK / 2];
#pragma unroll
  for (int i = 0; i < NP * 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max, scaled by sl2
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the sums

  // S = Q K^T of the tile in stage st, over ceil(D / 64) panels of four
  // k16 steps; committed as one group, not waited for
  auto issue_qk = [&](int st) {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint64_t da = hopper::smem_desc_sw128(
          Qs + (kk / 4) * kQBytes + half * 64 * 128 + (kk % 4) * 32, 16,
          1024);
      const uint64_t db = hopper::smem_desc_sw128(
          Ks + (st * NP + kk / 4) * kTileBytes + (kk % 4) * 32, 16, 1024);
      if constexpr (kBK == 128) {
        wgmma_ss_m64n128(s, da, db, kk > 0);
      } else {
        wgmma_ss_m64n64(s, da, db, kk > 0);
      }
    }
    hopper::wgmma_commit();
  };

  // O += P V of the tile in stage st over kBK / 16 k16 steps of keys, two
  // 64-column panels of O a product (one where NP is odd)
  auto issue_pv = [&](int st, uint32_t (&pa)[kBK / 4]) {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // B at panel pn of V: 16 keys, the panels kTileBytes apart
      auto db = [&](int pn) {
        return hopper::smem_desc_sw128(
            Vs + (st * NP + pn) * kTileBytes + kk * 16 * 128, kTileBytes,
            1024);
      };
      if constexpr (NP == 1) {
        wgmma_rs_m64n64<0>(o, pa + 4 * kk, db(0));
      } else {
        wgmma_rs_m64n128<0>(o, pa + 4 * kk, db(0));
      }
      if constexpr (NP == 3) {
        wgmma_rs_m64n64<64>(o, pa + 4 * kk, db(2));
      } else if constexpr (NP == 4) {
        wgmma_rs_m64n128<64>(o, pa + 4 * kk, db(2));
      }
    }
    hopper::wgmma_commit();
  };

  // online softmax of tile t's scores in s, rows row0 and row1, in
  // registers: P (f32) in place of the scores, the factor that rescales O
  // into alpha0/alpha1
  auto softmax = [&](int t, float& alpha0, float& alpha1) {
    // which keys each row keeps: all of them, except on the diagonal,
    // the window's or a chunk's edge and the ragged end
    const int k0 = t * kBK;
    uint32_t keep0 = 0xffffffffu, keep1 = 0xffffffffu;
    if (k0 < tr.lo_last || k0 + kBK > tr.hi_first) {
      keep0 = keep1 = 0u;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + col + e;
          const bool ok0 = kp >= keys0.lo && kp < keys0.hi;
          const bool ok1 = kp >= keys1.lo && kp < keys1.hi;
          keep0 |= static_cast<uint32_t>(ok0) << (2 * j + e);
          keep1 |= static_cast<uint32_t>(ok1) << (2 * j + e);
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if ((keep0 >> (2 * j + e)) & 1u) mx0 = fmaxf(mx0, s[4 * j + e]);
        if ((keep1 >> (2 * j + e)) & 1u) mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    alpha0 = ex2(m0 - mn0);
    alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[e] = (keep0 >> (2 * j + e)) & 1u
                    ? ex2(fmaf(s[4 * j + e], sl2, -mn0)) : 0.f;
        pr[2 + e] = (keep1 >> (2 * j + e)) & 1u
                        ? ex2(fmaf(s[4 * j + 2 + e], sl2, -mn1)) : 0.f;
      }
      sum0 += pr[0] + pr[1];
      sum1 += pr[2] + pr[3];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = pr[e];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  };
  // P to bf16, pairs of the accumulator layout: the A operand of P V
  auto pack = [&](uint32_t (&pa)[kBK / 4]) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      pa[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };
  auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int j = 0; j < NP * 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
  };

  // The walk overlaps each tile's softmax with the previous tile's P V on
  // the tensor cores (FlashAttention-3's intra-warpgroup order):
  // S_i = Q K_i^T is issued; O is rescaled to the running max of tile
  // i - 1 and O += P_{i-1} V_{i-1} issued; once S_i is in, its softmax
  // runs while P V does; P_i is packed once P V is done.  The softmax only
  // writes registers no wgmma in flight reads, so ptxas keeps the two
  // products asynchronous.
  hopper::mbar_wait(q_bar, 0);
  const int n_tiles = tr.t_end - tr.t_begin;
  if (n_tiles > 0) {
    uint32_t pa[kBK / 4];
    float alpha0 = 1.f, alpha1 = 1.f;
    hopper::mbar_wait(&full_k[0], 0);
    hopper::fence_operand(s);
    issue_qk(0);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(s);
    softmax(tr.t_begin, alpha0, alpha1);
    pack(pa);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, prev = (i - 1) % kStages;
      hopper::mbar_wait(&full_k[st], (i / kStages) & 1);
      hopper::fence_operand(s);
      issue_qk(st);
      rescale(alpha0, alpha1);
      hopper::mbar_wait(&full_v[prev], ((i - 1) / kStages) & 1);
      issue_pv(prev, pa);
      hopper::wgmma_wait<1>();                   // S_i is in
      hopper::fence_operand(s);
      softmax(tr.t_begin + i, alpha0, alpha1);
      hopper::wgmma_wait<0>();                   // and P_{i-1} V_{i-1}
      hopper::fence_operand(o);
      hopper::fence_operand(pa);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      pack(pa);
    }
    const int last = (n_tiles - 1) % kStages;
    rescale(alpha0, alpha1);
    hopper::mbar_wait(&full_v[last], ((n_tiles - 1) / kStages) & 1);
    issue_pv(last, pa);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(o);
    hopper::fence_operand(pa);
  }

  // epilogue: O / max(l, 1e-30) -> bf16 -> global
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  if constexpr (kLse) {
    // m is in the log2 domain of the scaled scores: lse = m ln 2 + ln l
    if (col == 0) {
      float* lse = p.lse + (static_cast<int64_t>(b) * p.hq + h) * p.sq + q0;
      if (row0 < q_rows) {
        lse[row0] = l0 > 0.f ? m0 * 0.6931471805599453f + logf(l0)
                             : INFINITY;
      }
      if (row1 < q_rows) {
        lse[row1] = l1 > 0.f ? m1 * 0.6931471805599453f + logf(l1)
                             : INFINITY;
      }
    }
  }
  bf16* og = static_cast<bf16*>(p.o) + b * p.os.b + h * p.os.h;
  bf16* out0 = og + static_cast<int64_t>(q0 + row0) * p.os.s;
  bf16* out1 = og + static_cast<int64_t>(q0 + row1) * p.os.s;
#pragma unroll
  for (int j = 0; j < NP * 8; ++j) {
    const int c = 8 * j + col;
    if (c < p.d && row0 < q_rows) {
      *reinterpret_cast<__nv_bfloat162*>(out0 + c) =
          __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
    }
    if (c < p.d && row1 < q_rows) {
      *reinterpret_cast<__nv_bfloat162*>(out1 + c) =
          __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
    }
  }
}

template <int NP, bool kChunk, bool kLse>
int launch_np(const CUtensorMap& qm, const CUtensorMap& km,
              const CUtensorMap& vm, const Params& p, dim3 grid,
              cudaStream_t stream) {
  constexpr int bk = tile_keys(NP), stages = ring_stages(NP);
  constexpr size_t smem = smem_bytes<NP, bk, stages>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<NP, bk, stages, kChunk, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16<NP, bk, stages, kChunk, kLse>
      <<<grid, kThreads, smem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NP, bool kLse>
int launch_chunk(const CUtensorMap& qm, const CUtensorMap& km,
                 const CUtensorMap& vm, const Params& p, dim3 grid,
                 cudaStream_t stream) {
  return p.chunk > 0
             ? launch_np<NP, true, kLse>(qm, km, vm, p, grid, stream)
             : launch_np<NP, false, kLse>(qm, km, vm, p, grid, stream);
}

template <int NP>
int launch_lse(const CUtensorMap& qm, const CUtensorMap& km,
               const CUtensorMap& vm, const Params& p, dim3 grid,
               cudaStream_t stream) {
  return p.lse != nullptr
             ? launch_chunk<NP, true>(qm, km, vm, p, grid, stream)
             : launch_chunk<NP, false>(qm, km, vm, p, grid, stream);
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t b, int64_t hq, int64_t hk, int64_t sq, int64_t skv,
           int64_t d, const int64_t* st, int64_t causal, int64_t window,
           int64_t chunk, void* stream) {
  Params p;
  p.o = o;
  p.lse = lse;
  p.os = {st[9], st[10], st[11]};
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.d = static_cast<int>(d);
  p.n_qt = static_cast<int>((sq + kBQ - 1) / kBQ);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.chunk = static_cast<int>(chunk);
  p.scale_log2 = static_cast<float>(std::pow(static_cast<double>(d), -0.5)
                                    * 1.4426950408889634);
  if (p.n_qt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (d > 4 * kPanel) return static_cast<int>(cudaErrorInvalidValue);
  const int np = static_cast<int>((d + kPanel - 1) / kPanel);
  const int bk = tile_keys(np);           // the box rows of K and V
  CUtensorMap qm, km, vm;
  int err = encode(&qm, q, b, hq, sq, d, st, kBQ, &p.q_order);
  if (err == 0) err = encode(&km, k, b, hk, skv, d, st + 3, bk, &p.k_order);
  if (err == 0) err = encode(&vm, v, b, hk, skv, d, st + 6, bk, &p.v_order);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(b * hq),
                  static_cast<unsigned>(p.n_qt));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 1: return launch_lse<1>(qm, km, vm, p, grid, s);
    case 2: return launch_lse<2>(qm, km, vm, p, grid, s);
    case 3: return launch_lse<3>(qm, km, vm, p, grid, s);
    default: return launch_lse<4>(qm, km, vm, p, grid, s);
  }
}

}  // namespace bf

// ========================================== float32: CUDA cores, in full f32
namespace f32 {

// the tiles of the instantiation for D <= MD (128 or 256): at 256, 32-row
// tiles keep Q, K, V, the scores and the accumulator in 138 KB
template <int MD>
struct Geom {
  static constexpr int kBQ = MD <= 128 ? 64 : 32;   // query rows per block
  static constexpr int kBK = kBQ;                   // keys per KV tile
  static constexpr int kThreads = 4 * kBQ;          // 4 threads a query row
  static constexpr int kLd = MD + 4;    // row stride (elements) of Q/K/V
  static constexpr int kLdS = kBK + 4;  // row stride of the score tile
  static constexpr int kLdO = MD + 4;   // row stride of the accumulator
  static constexpr int kColsPerThread = kBK / 4;
  static constexpr size_t kSmem = (3 * size_t(kBQ) * kLd + size_t(kBQ) * kLdS
                                   + size_t(kBQ) * kLdO) * sizeof(float);
};
static_assert(Geom<256>::kSmem <= 232448, "f32 tiles at D 256");

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;                     // [B, Hq, Sq], written when kLse
  Strides qs, ks, vs, os;
  int b, hq, hk, sq, skv, d;
  int causal, window;             // window <= 0: no window
  int chunk;                      // chunk <= 0: no chunk
  float scale;
  int vec;                        // 16-byte loads are aligned
};

// rows [0, rows_valid) of a [kRows, d] tile from global into shared memory
// (row stride kLd); rows past rows_valid are zero, so a masked key never
// brings a non-finite value into the products.
template <int kRows, int kLd>
__device__ void load_tile(float* dst, const float* src, int64_t row_stride,
                          int rows_valid, int d, int vec) {
  if (vec) {
    const int chunks = d / 4;
    for (int i = threadIdx.x; i < kRows * chunks; i += blockDim.x) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows_valid) {
        val = *reinterpret_cast<const float4*>(src + r * row_stride + c);
      }
      *reinterpret_cast<float4*>(dst + r * kLd + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i - r * d;
      dst[r * kLd + c] = r < rows_valid ? src[r * row_stride + c] : 0.f;
    }
  }
}

template <int MD, bool kLse>
__global__ void __launch_bounds__(Geom<MD>::kThreads, 2)
flash_fwd_f32(Params p) {
  using G = Geom<MD>;
  constexpr int kBQ = G::kBQ, kBK = G::kBK, kThreads = G::kThreads;
  constexpr int kLd = G::kLd, kLdS = G::kLdS, kLdO = G::kLdO;
  constexpr int kColsPerThread = G::kColsPerThread;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* Ss = Vs + kBK * kLd;
  float* Os = Ss + kBQ * kLdS;

  const int n_qt = (p.sq + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.hq / p.hk);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, row = tid >> 2, quad = tid & 3;
  const int q_rows = min(kBQ, p.sq - q0);

  const float* qg = p.q + b * p.qs.b + h * p.qs.h
                    + static_cast<int64_t>(q0) * p.qs.s;
  const float* kg = p.k + b * p.ks.b + kvh * p.ks.h;
  const float* vg = p.v + b * p.vs.b + kvh * p.vs.h;

  load_tile<kBQ, kLd>(Qs, qg, p.qs.s, q_rows, p.d, p.vec);
  for (int i = tid; i < kBQ * kLdO; i += kThreads) Os[i] = 0.f;
  __syncthreads();                        // a block with no tile reads Os
  const TileRange tr = tile_range(q0, q_rows, p.sq, p.skv, p.causal,
                                  p.window, p.chunk, kBK);

  const bool row_ok = row < q_rows;
  const KeyRange keys = key_range(q0 + row + p.skv - p.sq, p.skv, p.causal,
                                  p.window, p.chunk);
  float m = kNegInf, l = 0.f;

  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, p.skv - k0);
    __syncthreads();                      // last tile's readers are done
    load_tile<kBK, kLd>(Ks, kg + static_cast<int64_t>(k0) * p.ks.s, p.ks.s,
                        k_rows, p.d, p.vec);
    load_tile<kBK, kLd>(Vs, vg + static_cast<int64_t>(k0) * p.vs.s, p.vs.s,
                        k_rows, p.d, p.vec);
    __syncthreads();

    // scores of this thread's kColsPerThread columns of its row
    float sv[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) sv[j] = 0.f;
    for (int dd = 0; dd < p.d; ++dd) {
      const float qd = Qs[row * kLd + dd];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        sv[j] += qd * Ks[(quad + 4 * j) * kLd + dd];
      }
    }

    // online softmax over those columns
    unsigned ok = 0u;
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int kp = k0 + quad + 4 * j;
      const bool keep = row_ok && kp >= keys.lo && kp < keys.hi;
      sv[j] *= p.scale;
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
      Ss[row * kLdS + quad + 4 * j] = pj;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // O = O * alpha + P V, this thread's columns quad + 4 c of its row
    for (int c = quad; c < p.d; c += 4) {
      float acc = Os[row * kLdO + c] * alpha;
      for (int kv = 0; kv < kBK; ++kv) {
        acc += Ss[row * kLdS + kv] * Vs[kv * kLd + c];
      }
      Os[row * kLdO + c] = acc;
    }
  }

  if (row_ok) {
    float* og = p.o + b * p.os.b + h * p.os.h
                + static_cast<int64_t>(q0 + row) * p.os.s;
    const float denom = fmaxf(l, 1e-30f);
    for (int c = quad; c < p.d; c += 4) og[c] = Os[row * kLdO + c] / denom;
    if (kLse && quad == 0) {
      p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.sq + q0 + row] =
          l > 0.f ? m + logf(l) : INFINITY;
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <int MD, bool kLse>
int launch_md(const Params& p, cudaStream_t stream) {
  using G = Geom<MD>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<MD, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.sq + G::kBQ - 1) / G::kBQ),
                  static_cast<unsigned>(p.hq), static_cast<unsigned>(p.b));
  flash_fwd_f32<MD, kLse><<<grid, G::kThreads, G::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MD>
int launch_lse(const Params& p, cudaStream_t stream) {
  return p.lse != nullptr ? launch_md<MD, true>(p, stream)
                          : launch_md<MD, false>(p, stream);
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t b, int64_t hq, int64_t hk, int64_t sq, int64_t skv,
           int64_t d, const int64_t* st, int64_t causal, int64_t window,
           int64_t chunk, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.qs = {st[0], st[1], st[2]};
  p.ks = {st[3], st[4], st[5]};
  p.vs = {st[6], st[7], st[8]};
  p.os = {st[9], st[10], st[11]};
  p.b = static_cast<int>(b);
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.d = static_cast<int>(d);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.chunk = static_cast<int>(chunk);
  p.scale = static_cast<float>(std::pow(static_cast<double>(d), -0.5));
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && d % 4 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 4 == 0;
  p.vec = vec;
  if (d > 256) return static_cast<int>(cudaErrorInvalidValue);
  return d <= 128 ? launch_lse<128>(p, static_cast<cudaStream_t>(stream))
                  : launch_lse<256>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace f32

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) of q, k, v, out;
// lse: null, or float32 [B, Hq, Sq] contiguous for the rows' log-sum-exp;
// window and chunk: 0 for none.  Returns 0, a CUDA error code, or (bf16)
// -1 when cuTensorMapEncodeTiled is not found and -2 when it refuses an
// operand's tensor map.
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, float* lse, int64_t b, int64_t hq,
                               int64_t hk, int64_t sq, int64_t skv, int64_t d,
                               const int64_t* strides, int64_t causal,
                               int64_t window, int64_t chunk, void* stream) {
  return bf::launch(q, k, v, o, lse, b, hq, hk, sq, skv, d, strides, causal,
                    window, chunk, stream);
}

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, float* lse, int64_t b, int64_t hq,
                              int64_t hk, int64_t sq, int64_t skv, int64_t d,
                              const int64_t* strides, int64_t causal,
                              int64_t window, int64_t chunk, void* stream) {
  return f32::launch(q, k, v, o, lse, b, hq, hk, sq, skv, d, strides, causal,
                     window, chunk, stream);
}
