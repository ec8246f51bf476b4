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
// is read with no copy; D <= 128 is covered as ceil(D / 64) 64-column
// panels.  No FLOP goes to KV tiles wholly above the causal diagonal or
// outside the sliding window: they are skipped, as the TPU kernel skips
// them with pl.when, and only tiles on the diagonal, the window's edge or
// the ragged end run the mask.  The float32 instantiation keeps a plain
// route on CUDA cores (64-row tiles, synchronous loads) in full f32; it
// serves tests, never the serve path.
//
// Semantics, as the TPU kernel: scores in f32 from the inputs, scaled by
// D^-0.5; query row i sits at position i + (Skv - Sq) (suffix alignment);
// causal keeps keys <= that position, a window w keeps keys > position - w;
// masks are predicates, never sentinel scores; the output is
// acc / max(l, 1e-30) in q's dtype.  A row with no key left by the mask
// (causal with Sq > Skv, rows before position 0) gives zeros.  That is a
// choice: the TPU kernel gives zeros there only where it skips every KV
// block of the row's 256-row query block; inside a block it runs, such a
// row weighs each of the block's keys (padding included) equally, and the
// pure-jnp oracle averages every key.  GQA by indexing: q-head h reads KV
// head h / (Hq / Hk); the caller never repeats K or V.  Every tensor is
// taken with the element strides it has (batch, head, sequence); only the
// last dimension must be contiguous, and the bf16 route needs 16-byte
// aligned bases and strides (the wrapper copies an operand that is not).
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;                // element strides; the last dim is unit
};

// the KV tiles [t_begin, t_end) of kBK keys that some row of the query
// tile [q0, q0 + q_rows) may see; the rest are skipped
struct TileRange {
  int t_begin, t_end, q_first, q_last;
};

__device__ __forceinline__ TileRange tile_range(int q0, int q_rows, int sq,
                                                int skv, int causal,
                                                int window, int kBK) {
  const int shift = skv - sq;
  TileRange r;
  r.q_first = q0 + shift;
  r.q_last = q0 + q_rows - 1 + shift;
  int kv_hi = skv;
  if (causal) kv_hi = min(kv_hi, r.q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, r.q_first - window + 1);
  r.t_begin = kv_lo / kBK;
  r.t_end = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK : r.t_begin;
  return r;
}

// ===================================================== bf16: wgmma + TMA
namespace bf {

constexpr int kBQ = 128;              // query rows per block
constexpr int kBK = 128;              // keys per K/V tile
constexpr int kStages = 3;            // depth of the K/V ring
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kPanel = 64;            // columns of a 128-byte swizzled panel
constexpr int kQBytes = kBQ * 128;    // one panel of the Q tile
constexpr int kTileBytes = kBK * 128; // one panel of a K or V tile
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Params {
  void* o;
  Strides os;
  int hq, hk, sq, skv, d, n_qt;
  int causal, window;             // window <= 0: no window
  float scale_log2;               // D^-0.5 * log2(e)
  // for each tensor map, the dimension (1..3) that holds S, H and B,
  // two bits each: dims 1..3 are ordered by stride on the host
  int q_order, k_order, v_order;
};

template <int NP>
constexpr size_t smem_bytes() {
  return 1024                                   // room to align to 1 KB
         + size_t(NP) * kQBytes                 // Q
         + 2 * size_t(kStages) * NP * kTileBytes  // K and V rings
         + 8 * (3 * kStages + 1);               // mbarriers
}

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

// d += A B over k16: A [64 x 16] bf16 from registers a[0..3] (the
// accumulator layout packed in pairs), B [16 x 64] MN-major in shared
// memory with the 128-byte swizzle (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B over k16: A [64 x 16] bf16 from registers a[0..3] (the
// accumulator layout packed in pairs), B [16 x 128] MN-major in shared
// memory with the 128-byte swizzle (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const Params p) {
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
  const TileRange tr = tile_range(q0, q_rows, p.sq, p.skv, p.causal,
                                  p.window, kBK);

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
  const int pos0 = q0 + row0 + p.skv - p.sq, pos1 = pos0 + 8;
  const float sl2 = p.scale_log2;

  float o[NP * 32], s[64];
#pragma unroll
  for (int i = 0; i < NP * 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
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
      wgmma_ss_m64n128(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };

  // O += P V of the tile in stage st over eight k16 steps of keys
  auto issue_pv = [&](int st, uint32_t (&pa)[32]) {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = hopper::smem_desc_sw128(
          Vs + st * NP * kTileBytes + kk * 16 * 128, kTileBytes, 1024);
      if constexpr (NP == 1) {
        wgmma_rs_m64n64(o, pa + 4 * kk, db);
      } else {
        wgmma_rs_m64n128(o, pa + 4 * kk, db);
      }
    }
    hopper::wgmma_commit();
  };

  // online softmax of tile t's scores in s, rows row0 and row1, in
  // registers: P (f32) in place of the scores, the factor that rescales O
  // into alpha0/alpha1
  auto softmax = [&](int t, float& alpha0, float& alpha1) {
    // which keys each row keeps: all of them, except on the diagonal,
    // the window's edge and the ragged end
    const int k0 = t * kBK;
    uint32_t keep0 = 0xffffffffu, keep1 = 0xffffffffu;
    if (k0 + kBK > p.skv || (p.causal && k0 + kBK - 1 > tr.q_first)
        || (p.window > 0 && k0 <= tr.q_last - p.window)) {
      keep0 = keep1 = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + col + e;
          const bool in = kp < p.skv;
          const bool ok0 = in && (!p.causal || kp <= pos0)
                           && (p.window <= 0 || kp > pos0 - p.window);
          const bool ok1 = in && (!p.causal || kp <= pos1)
                           && (p.window <= 0 || kp > pos1 - p.window);
          keep0 |= static_cast<uint32_t>(ok0) << (2 * j + e);
          keep1 |= static_cast<uint32_t>(ok1) << (2 * j + e);
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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
    for (int j = 0; j < 16; ++j) {
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
  auto pack = [&](uint32_t (&pa)[32]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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
    uint32_t pa[32];
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

constexpr int kNoEncoder = -1;     // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = -2;  // it refused the operand

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
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
int encode(CUtensorMap* map, const void* ptr, int64_t b, int64_t h,
           int64_t s, int64_t d, const int64_t* st, int rows, int* order) {
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

template <int NP>
int launch_np(const CUtensorMap& qm, const CUtensorMap& km,
              const CUtensorMap& vm, const Params& p, dim3 grid,
              cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16<NP><<<grid, kThreads, smem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t hq, int64_t hk, int64_t sq, int64_t skv, int64_t d,
           const int64_t* st, int64_t causal, int64_t window,
           void* stream) {
  Params p;
  p.o = o;
  p.os = {st[9], st[10], st[11]};
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.d = static_cast<int>(d);
  p.n_qt = static_cast<int>((sq + kBQ - 1) / kBQ);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.scale_log2 = static_cast<float>(std::pow(static_cast<double>(d), -0.5)
                                    * 1.4426950408889634);
  if (p.n_qt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap qm, km, vm;
  int err = encode(&qm, q, b, hq, sq, d, st, kBQ, &p.q_order);
  if (err == 0) err = encode(&km, k, b, hk, skv, d, st + 3, kBK, &p.k_order);
  if (err == 0) err = encode(&vm, v, b, hk, skv, d, st + 6, kBK, &p.v_order);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(b * hq),
                  static_cast<unsigned>(p.n_qt));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= kPanel ? launch_np<1>(qm, km, vm, p, grid, s)
                     : launch_np<2>(qm, km, vm, p, grid, s);
}

}  // namespace bf

// ========================================== float32: CUDA cores, in full f32
namespace f32 {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 256;     // 8 warps; 4 threads per query row
constexpr int kMaxD = 128;
constexpr int kLd = kMaxD + 4;    // row stride (elements) of Q/K/V tiles
constexpr int kLdS = kBK + 4;     // row stride of the score tile
constexpr int kLdO = kMaxD + 4;   // row stride of the accumulator
constexpr int kColsPerThread = kBK / 4;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  Strides qs, ks, vs, os;
  int hq, hk, sq, skv, d;
  int causal, window;             // window <= 0: no window
  float scale;
  int vec;                        // 16-byte loads are aligned
};

constexpr size_t smem_bytes() {
  return (3 * size_t(kBQ) * kLd + size_t(kBQ) * kLdS
          + size_t(kBQ) * kLdO) * sizeof(float);
}

// rows [0, rows_valid) of a [kRows, d] tile from global into shared memory
// (row stride kLd); rows past rows_valid are zero, so a masked key never
// brings a non-finite value into the products.
template <int kRows>
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

__global__ void __launch_bounds__(kThreads, 2) flash_fwd_f32(Params p) {
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

  load_tile<kBQ>(Qs, qg, p.qs.s, q_rows, p.d, p.vec);
  for (int i = tid; i < kBQ * kLdO; i += kThreads) Os[i] = 0.f;
  __syncthreads();                        // a block with no tile reads Os
  const TileRange tr = tile_range(q0, q_rows, p.sq, p.skv, p.causal,
                                  p.window, kBK);

  const bool row_ok = row < q_rows;
  const int my_pos = q0 + row + p.skv - p.sq;
  float m = kNegInf, l = 0.f;

  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, p.skv - k0);
    __syncthreads();                      // last tile's readers are done
    load_tile<kBK>(Ks, kg + static_cast<int64_t>(k0) * p.ks.s, p.ks.s,
                   k_rows, p.d, p.vec);
    load_tile<kBK>(Vs, vg + static_cast<int64_t>(k0) * p.vs.s, p.vs.s,
                   k_rows, p.d, p.vec);
    __syncthreads();

    // scores of this thread's 16 columns of its row
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
      const bool keep = row_ok && kp < p.skv
                        && (!p.causal || kp <= my_pos)
                        && (p.window <= 0 || kp > my_pos - p.window);
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
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t hq, int64_t hk, int64_t sq, int64_t skv, int64_t d,
           const int64_t* st, int64_t causal, int64_t window, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && d % 4 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 4 == 0;
  p.vec = vec;
  constexpr size_t smem = smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  flash_fwd_f32<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// strides: 12 int64 element strides, (batch, head, seq) of q, k, v, out.
// Returns 0, a CUDA error code, or (bf16) -1 when cuTensorMapEncodeTiled
// is not found and -2 when it refuses an operand's tensor map.
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int64_t b, int64_t hq, int64_t hk,
                               int64_t sq, int64_t skv, int64_t d,
                               const int64_t* strides, int64_t causal,
                               int64_t window, void* stream) {
  return bf::launch(q, k, v, o, b, hq, hk, sq, skv, d, strides, causal,
                    window, stream);
}

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int64_t b, int64_t hq, int64_t hk,
                              int64_t sq, int64_t skv, int64_t d,
                              const int64_t* strides, int64_t causal,
                              int64_t window, void* stream) {
  return f32::launch(q, k, v, o, b, hq, hk, sq, skv, d, strides, causal,
                     window, stream);
}
