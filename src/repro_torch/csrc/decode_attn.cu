// Decode attention: one query token per (b, q-head) against a KV cache
// [B, Hk, S, D], attending to the slots [lo[b], valid_len[b]) only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn/kernel.py
// (_decode_kernel / decode_attention).  The TPU version walks the cache's
// KV blocks as a sequential grid axis per (b, head), carrying m, l and the
// accumulator in VMEM scratch, and skips blocks past valid_len.  On Hopper
// a sequential walk per (b, head) would leave most of the 132 SMs idle at
// serving batch sizes, so the attended span [lo, valid_len) is split
// (FlashDecoding): one block per (split, b, KV head) walks its share and
// writes a partial (m, l, acc); the last block of each (b, KV head) to
// finish, found by an atomic ticket that it restores to 0, merges the
// partials and writes the output, in the same launch.  A plan of one split
// writes the output directly.  The model's sliding window is the span's
// first slot lo: a block's share starts at lo + split * chunk, so no slot
// below lo is ever loaded (for a byte-bound kernel that is the window's
// whole gain); the upper edge, valid_len, is masked.
//
// Bound on an H100: bytes.  At the serving path's decode (B 8, Hk 8,
// D 128, bf16, valid_len ~2112) the kernel must read 2*B*Hk*valid_len*D*2
// = 69 MB of cache, 0.021 ms at 3.35 TB/s, for ~1 FLOP per byte; the TPU
// route repeats K/V per q-head, this one reads each cache byte of a (b, KV
// head, split) once, for the whole GQA group.
//
// bf16 (namespace tc): the tensor cores.  A block serves the group of up
// to 16 q-heads as the 16 rows of mma.sync.m16n8k16 (bf16 in, f32
// accumulate; a smaller group's missing rows are zeros and write nothing;
// a group above 16 is cut into ceil(G / 16) sub-groups, each its own block
// column).  wgmma's 64-row minimum would pad recurrentgemma's 10 heads to
// 64 for a kernel the bytes bound anyway.  A producer warp streams 64-slot
// K and V tiles through a 3-stage ring with TMA (a 4-D tensor map over
// each cache, any 16-byte strides; 64-column panels with the 128-byte
// swizzle, so ldmatrix meets no bank conflict; rows past S arrive as
// zeros).  Four consumer warps each own 16 slots of every tile: S = Q K^T
// over ldmatrix'd K, then the online softmax of its 16 x 16 scores in
// registers, then O += P V over ldmatrix.trans'd V, P entering as a
// bf16 hi + lo pair (two mma: ~16 bits of p, near the TPU kernel's f32
// P V, where one bf16 P errs 2-4 times more; the extra mma costs a
// kernel the bytes bound 0-4 % at the served rows).  Q enters
// unscaled (exact in bf16); the D^-0.5 scale goes on the f32 scores, so
// every product of Q K^T is exact.  The kernel is compiled for 1, 2 and
// 4 panels (D <= 64, 128, 256) and runs over the whole width with no
// branch, the columns past D arriving as zeros.  O is
// 16 x 64 * panels / 32 floats a thread whatever the group: 32, 64, 128,
// and an SM holds 4, 2, 1 blocks (48, 96, 192 KB rings).  The warps'
// states are merged once per block through the ring.
//
// float32 (namespace cc): CUDA cores in full f32, the first design.  One
// block per (split, b, KV head, sub-group) of at most 8 q-heads at D 128
// and 4 at D 256, whose per-head arrays (2 * heads * D / 16 floats a
// thread) live in registers; 8 consumer warps each own an eighth of every
// 32-slot tile (16 at D 256) and reduce their dot products with warp
// shuffles; one cp.async.bulk per tile when the slots are contiguous,
// 16-byte cp.async per row otherwise.  A larger group is cut into n_sub
// sub-groups of ceil(G / n_sub) heads, each its own block column (which
// reads the span again, mostly from L2).
//
// Semantics, as the TPU kernel: scores and statistics in f32 (q scaled by
// D^-0.5), output acc / max(l, 1e-30) in q's dtype; an empty span gives
// zeros.  valid_len is clamped to [0, S] and lo to [0, valid_len].  A
// slot outside [lo, valid_len) is never read by the f32 route; the bf16
// route may load the rest of its last tile, whose scores it masks and
// whose V rows it zeroes, so garbage there (NaN included) changes nothing.
#include <cmath>
#include <cstdint>
#include <mutex>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_wgmma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* valid;           // [B] span ends
  const int32_t* lo;              // [B] span starts
  void* out;
  float* part_m;                  // [B, Hq, n_splits]
  float* part_l;                  // [B, Hq, n_splits]
  float* part_acc;                // [B, Hq, n_splits, D]
  int32_t* counter;               // [B, Hk, n_sub] tickets, 0 between calls
  int64_t q_sb, q_sh;             // element strides of q [B, Hq, D]
  int64_t k_sb, k_sh, k_ss;       // of the caches [B, Hk, S, D]
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh;             // of out [B, Hq, D]
  int hq, hk, s, d, chunk, n_splits;
  int group, n_sub;               // G = Hq / Hk, and the blocks it takes
  float scale;                    // D^-0.5
  float scale_log2;               // D^-0.5 * log2(e)
  int bulk;                       // f32: slots contiguous, one copy a tile
  int k_order, v_order;           // bf16: the tensor maps' dims of S, H, B
};

// the span [s0, s1) of a (b, split): the last split runs to valid_len, so
// a plan cut for a shorter span than a row's is slower, never wrong
struct Span {
  int s0, s1;
};

__device__ __forceinline__ Span split_span(const Params& p, int b,
                                           int split) {
  const int vl = max(0, min(p.valid[b], p.s));
  const int lo = max(0, min(p.lo[b], vl));
  const int s0 = lo + split * p.chunk;
  return {s0, split == p.n_splits - 1 ? vl : min(s0 + p.chunk, vl)};
}

// the ticket of this block's (b, KV head, sub-group): true in the last of
// its n_splits blocks to take it, which restores it to 0 for the next
// call.  The caller's barrier orders the block's partial writes before
// thread 0's atomic, whose release makes them visible to the last block
// and whose acquire there makes the others' visible to it (and, through
// the barrier below, to its threads).
__device__ __forceinline__ bool take_ticket(const Params& p, int b, int tid,
                                            int* is_last, int threads) {
  int32_t* ticket = p.counter + b * gridDim.y + blockIdx.y;
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(ticket) : "memory");
    *is_last = prev == p.n_splits - 1;
    if (*is_last) *ticket = 0;
  }
  hopper::named_barrier(1, threads);
  return *is_last;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

void fill_params(Params* p, const void* q, const void* k, const void* v,
                 const void* valid, const void* lo, void* out, void* part_m,
                 void* part_l, void* part_acc, void* counter, int64_t hq,
                 int64_t hk, int64_t s, int64_t d, const int64_t* st,
                 int64_t chunk, int64_t n_splits, int64_t n_sub) {
  p->q = q;
  p->k = k;
  p->v = v;
  p->valid = static_cast<const int32_t*>(valid);
  p->lo = static_cast<const int32_t*>(lo);
  p->out = out;
  p->part_m = static_cast<float*>(part_m);
  p->part_l = static_cast<float*>(part_l);
  p->part_acc = static_cast<float*>(part_acc);
  p->counter = static_cast<int32_t*>(counter);
  p->q_sb = st[0];
  p->q_sh = st[1];
  p->k_sb = st[2];
  p->k_sh = st[3];
  p->k_ss = st[4];
  p->v_sb = st[5];
  p->v_sh = st[6];
  p->v_ss = st[7];
  p->o_sb = st[8];
  p->o_sh = st[9];
  p->hq = static_cast<int>(hq);
  p->hk = static_cast<int>(hk);
  p->s = static_cast<int>(s);
  p->d = static_cast<int>(d);
  p->chunk = static_cast<int>(chunk);
  p->n_splits = static_cast<int>(n_splits);
  p->group = static_cast<int>(hq / hk);
  p->n_sub = static_cast<int>(n_sub);
  const double scale = std::pow(static_cast<double>(d), -0.5);
  p->scale = static_cast<float>(scale);
  p->scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  p->bulk = 0;
  p->k_order = p->v_order = 0;
}

// ====================================== bf16: the tensor cores, whole group
namespace tc {

constexpr int kWarps = 4;                    // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kRows = 64;                    // slots a tile
constexpr int kSlots = kRows / kWarps;       // a warp's: one k16 of P V
constexpr int kStages = 3;                   // depth of the K/V ring
constexpr int kHeads = 16;                   // the mma's rows
constexpr int kPanelBytes = kRows * 128;     // 64 columns of a tile
constexpr int kDevices = 64;                 // devices a process prepares
constexpr int kMaps = 256;                   // tensor maps kept

// the instantiation for D <= 64 * NP (NP 1, 2 or 4 panels): a stage is NP
// panels of K, then NP of V; an SM holds 4, 2 or 1 blocks (their rings and
// registers)
constexpr int blocks_per_sm_of(int np) {
  return np == 1 ? 4 : np == 2 ? 2 : 1;
}

template <int NP>
struct Geom {
  static constexpr int kMD = 64 * NP;
  // the most splits: the last block stages a head's partials and the
  // splits' statistics in the ring
  static constexpr int kMaxSplits = NP == 1 ? 64 : 128;
  static constexpr int kStageBytes = 2 * NP * kPanelBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr size_t kSmem = 1024 + kRing;   // room to align to 1 KB
  // Q's row pitch in elements: 16 bytes past the row, so the 8 rows an
  // ldmatrix reads start in 8 different 16-byte bank groups
  static constexpr int kQPitch = kMD + 8;
  static_assert(kWarps * kHeads * (kMD + 4) * 4 <= kRing, "warps' merge");
  static_assert((3 * kHeads + kMD) * kMaxSplits * 4 <= kRing,
                "the splits' merge");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b over m16 n8 k16: a the A fragment (rows g, g + 8; k 2t.., 2t +
// 8..), b0 b1 the B fragment (k 2t.., 2t + 8..; column g), c the
// accumulator (c[0..1] at row g, columns 2t, 2t + 1; c[2..3] at row g + 8).
// Registers only, so not volatile: the compiler may issue the next
// ldmatrix ahead of it
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 16-byte chunk c of row r of a 128-byte swizzled panel at ``panel``
__device__ __forceinline__ uint32_t swizzled(uint32_t panel, int r, int c) {
  return panel + r * 128 + ((c ^ (r & 7)) << 4);
}

// x rounded to bf16, as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// start fetching the tensor map at ``map`` (a __grid_constant__
// parameter) for the TMA unit
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// start bringing the line of ``ptr`` into L2
__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(ptr));
}

// wait for this thread's cp.async
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a[0..7] / den as 8 bf16 at dst (16-byte aligned), in one store
__device__ __forceinline__ void store8(bf16* dst, const float (&a)[8],
                                       float den) {
  uint4 u;
  u.x = attn::pack_bf16(a[0] / den, a[1] / den);
  u.y = attn::pack_bf16(a[2] / den, a[3] / den);
  u.z = attn::pack_bf16(a[4] / den, a[5] / den);
  u.w = attn::pack_bf16(a[6] / den, a[7] / den);
  *reinterpret_cast<uint4*>(dst) = u;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, blocks_per_sm_of(NP))
decode_tc(const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const Params p) {
  using G_ = Geom<NP>;
  constexpr int MD = G_::kMD, kQP = G_::kQPitch;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: the ring starts on 1 KB
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ __align__(16) bf16 qs[kHeads * kQP];
  // per warp and head: running max and sum
  __shared__ float warp_m[kWarps][kHeads], warp_l[kWarps][kHeads];
  __shared__ float blk_l[kHeads];   // the block's sum, then the splits'
  __shared__ int is_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.n_sub, sub = blockIdx.y - kvh * p.n_sub;
  const int per = (p.group + p.n_sub - 1) / p.n_sub;
  const int h0 = kvh * p.group + sub * per;        // this block's q-heads
  const int ng = min(per, p.group - sub * per);
  const Span sp = split_span(p, b, split);
  const int n_tiles = sp.s1 > sp.s0 ? (sp.s1 - sp.s0 + kRows - 1) / kRows
                                    : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;

  // the cold reads start at once: the tensor maps, the ticket's line (a
  // plan of splits takes it after the walk) and Q's 16 rows (the block's
  // heads, then zeros; unscaled), 16 bytes a load into registers (the
  // wrapper aligns q's rows)
  constexpr int kRowChunks = MD / 8;
  constexpr int kQPer = kHeads * kRowChunks / (32 * kWarps);
  uint4 qr[kQPer];
  if (warp == kWarps) {
    if (lane == 0) {
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
    } else if (lane == 1 && p.n_splits > 1) {
      prefetch_l2(p.counter + b * gridDim.y + blockIdx.y);
    }
  } else {
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb
                     + h0 * p.q_sh;
#pragma unroll
    for (int j = 0; j < kQPer; ++j) {
      const int i = tid + j * 32 * kWarps;
      const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
      qr[j] = r < ng && c < p.d
          ? __ldg(reinterpret_cast<const uint4*>(qg + r * p.q_sh + c))
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kWarps);
    }
    hopper::mbar_init_fence();
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ------------------------------------------------------- producer
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, t0 = sp.s0 + i * kRows;
        unsigned char* ks = ring + st * G_::kStageBytes;
        hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        // every panel, the columns past D (all of them, past 64 * ceil(D /
        // 64)) arriving as zeros: the products run over the instantiation's
        // whole width with no branch
        hopper::mbar_arrive_expect_tx(&full[st], 2 * NP * kPanelBytes);
        for (int pn = 0; pn < NP; ++pn) {
          attn::load_box(ks + pn * kPanelBytes, &kmap, p.k_order, pn * 64,
                         t0, kvh, b, &full[st]);
          attn::load_box(ks + (NP + pn) * kPanelBytes, &vmap, p.v_order,
                         pn * 64, t0, kvh, b, &full[st]);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * 32 * kWarps;
    const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
    *reinterpret_cast<uint4*>(qs + r * kQP + c) = qr[j];
  }
  hopper::named_barrier(1, 32 * kWarps);

  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;   // row of matrix lm of an x4
  // ldmatrix rows: Q's A fragment (matrix lm: rows 8 (lm & 1), columns
  // 8 (lm >> 1)); K's B fragments of the warp's two n8 slot tiles
  // (matrix lm: slots 8 (lm >> 1), the 8 columns lm & 1 of a k16); V's
  // (trans; matrix lm: slots 8 (lm & 1), columns 8 (lm >> 1) of a 16)
  const uint32_t q_row = hopper::smem_u32(
      qs + ((lm & 1) * 8 + lr) * kQP + (lm >> 1) * 8);
  const int k_slot = warp * kSlots + (lm >> 1) * 8 + lr, k_c = lm & 1;
  const int v_slot = warp * kSlots + (lm & 1) * 8 + lr, v_c = lm >> 1;

  float o[MD / 8][4];
#pragma unroll
  for (int j = 0; j < MD / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  // rows g and g + 8: running max (log2 units) and this lane's share of
  // the sum
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int mine = min(kSlots, sp.s1 - (sp.s0 + i * kRows)
                                 - warp * kSlots);   // the warp's slots
    const uint32_t kb = hopper::smem_u32(ring + st * G_::kStageBytes);
    const uint32_t vb = kb + NP * kPanelBytes;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    if (mine > 0) {
      // scores of the 16 heads x the warp's 16 slots: s[j] is slot tile j,
      // summed over even and odd k16 steps apart (two chains of mma)
      float s[2][4], s2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < MD / 16; ++kk) {
        uint32_t a[4], kf[4];
        ldmatrix_x4(a, q_row + kk * 32);
        ldmatrix_x4(kf, swizzled(kb + (kk >> 2) * kPanelBytes, k_slot,
                                 ((kk & 3) << 1) + k_c));
        float (&acc)[2][4] = kk & 1 ? s2 : s;
        mma_bf16(acc[0], a, kf[0], kf[1]);
        mma_bf16(acc[1], a, kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
      }
      // online softmax in log2 units; a slot past the span scores -1e30,
      // whose p is 0 (the warp has a slot in the span, so the max is one)
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = 8 * j + 2 * t + e < mine;
          s[j][e] = ok ? s[j][e] * p.scale_log2 : kNegInf;
          s[j][2 + e] = ok ? s[j][2 + e] * p.scale_log2 : kNegInf;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = attn::ex2(m0 - mn0), al1 = attn::ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = attn::ex2(s[j][e] - mn0);
          s[j][2 + e] = attn::ex2(s[j][2 + e] - mn1);
          r0 += s[j][e];
          r1 += s[j][2 + e];
        }
      }
      l0 = l0 * al0 + r0;
      l1 = l1 * al1 + r1;
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
        for (int j = 0; j < MD / 8; ++j) {
          o[j][0] *= al0;
          o[j][1] *= al0;
          o[j][2] *= al1;
          o[j][3] *= al1;
        }
      }
      // P as the A fragment (k = the warp's slots), and its remainder
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x0 = s[j][2 * r], x1 = s[j][2 * r + 1];
          ph[2 * j + r] = attn::pack_bf16(x0, x1);
          pl[2 * j + r] = attn::pack_bf16(x0 - bf16_round(x0),
                                          x1 - bf16_round(x1));
        }
      }
      // V rows past the span (a partial last tile) read as zeros, so that
      // 0 * garbage is no NaN: the lane's slots 2t, 2t + 1 and 8 above
      uint32_t vm0 = 0xffffffffu, vm1 = 0xffffffffu;
      if (mine < kSlots) {
        vm0 = (2 * t < mine ? 0xffffu : 0u)
              | (2 * t + 1 < mine ? 0xffff0000u : 0u);
        vm1 = (2 * t + 8 < mine ? 0xffffu : 0u)
              | (2 * t + 9 < mine ? 0xffff0000u : 0u);
      }
#pragma unroll
      for (int dc = 0; dc < MD / 16; ++dc) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, swizzled(vb + (dc >> 2) * kPanelBytes,
                                       v_slot, ((dc & 3) << 1) + v_c));
        vf[0] &= vm0;
        vf[1] &= vm1;
        vf[2] &= vm0;
        vf[3] &= vm1;
        mma_bf16(o[2 * dc], ph, vf[0], vf[1]);
        mma_bf16(o[2 * dc + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * dc], pl, vf[0], vf[1]);
        mma_bf16(o[2 * dc + 1], pl, vf[2], vf[3]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // the quad's lanes summed different slots under the same max
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // merge the warps' states through the ring, once every warp is done
  // with its tiles (the ring was last written by the copies): each warp's
  // (m, l) of each head, then its O weighted by ex2(m_w - m) of the
  // block's max m
  hopper::named_barrier(1, 32 * kWarps);
  hopper::fence_proxy_async();
  if (t == 0) {
    warp_m[warp][g] = m0;
    warp_m[warp][g + 8] = m1;
    warp_l[warp][g] = l0;
    warp_l[warp][g + 8] = l1;
  }
  hopper::named_barrier(1, 32 * kWarps);
  float bm0 = kNegInf, bm1 = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    bm0 = fmaxf(bm0, warp_m[w][g]);
    bm1 = fmaxf(bm1, warp_m[w][g + 8]);
  }
  const float w0 = attn::ex2(m0 - bm0), w1 = attn::ex2(m1 - bm1);
  // [kWarps][16][kRed]: 4 floats past a row, so the 8 rows of a store
  // land in 8 bank groups
  constexpr int kRed = MD + 4;
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < MD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(red + (warp * kHeads + g) * kRed + col) =
        make_float2(o[j][0] * w0, o[j][1] * w0);
    *reinterpret_cast<float2*>(red + (warp * kHeads + g + 8) * kRed + col) =
        make_float2(o[j][2] * w1, o[j][3] * w1);
  }
  // this split's (m, l) per head
  const int64_t head0 = static_cast<int64_t>(b) * p.hq + h0;
  if (tid < ng) {
    float mx = kNegInf, sum = 0.f;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_m[w][tid]);
    for (int w = 0; w < kWarps; ++w) {
      sum += warp_l[w][tid] * attn::ex2(warp_m[w][tid] - mx);
    }
    blk_l[tid] = sum;
    if (p.n_splits > 1) {
      p.part_m[(head0 + tid) * p.n_splits + split] = mx;
      p.part_l[(head0 + tid) * p.n_splits + split] = sum;
    }
  }
  hopper::named_barrier(1, 32 * kWarps);
  // the block's acc: the warps' rows summed, 8 columns a thread; with one
  // split it is the output (16 bytes a store: the wrapper's out is
  // aligned), else this split's partial
  bf16* og = static_cast<bf16*>(p.out) + b * p.o_sb;
  const int d8 = p.d / 8;
  for (int idx = tid; idx < ng * d8; idx += 32 * kWarps) {
    const int hh = idx / d8, c = (idx - hh * d8) * 8;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* r = red + (w * kHeads + hh) * kRed + c;
      const float4 x0 = *reinterpret_cast<const float4*>(r);
      const float4 x1 = *reinterpret_cast<const float4*>(r + 4);
      a[0] += x0.x;
      a[1] += x0.y;
      a[2] += x0.z;
      a[3] += x0.w;
      a[4] += x1.x;
      a[5] += x1.y;
      a[6] += x1.z;
      a[7] += x1.w;
    }
    if (p.n_splits == 1) {
      store8(og + (h0 + hh) * p.o_sh + c, a, fmaxf(blk_l[hh], 1e-30f));
    } else {
      float* dst = p.part_acc + ((head0 + hh) * p.n_splits + split) * p.d
                   + c;
      *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(a[4], a[5], a[6],
                                                        a[7]);
    }
  }
  if (p.n_splits == 1) return;

  // the last block of this (b, KV head, sub-group) to finish merges the
  // splits
  hopper::named_barrier(1, 32 * kWarps);
  if (!take_ticket(p, b, tid, &is_last, 32 * kWarps)) return;
  // out = sum_i w_i acc_i / den over the splits, in split order, with
  // w_i = ex2(m_i - M) (0 for a split with no slot) and den = sum_i w_i
  // l_i.  The partials of as many heads as the ring holds at a time come
  // in with 16-byte cp.async, all in flight at once; the first heads' are
  // issued before the (m, l) are read, so the block waits on L2 about once.
  // Heads [h0, h0 + ng) have contiguous rows [ng][n_splits][D] of
  // part_acc; the ring holds the weights [16][n_splits] and the splits'
  // (m, l) [2][ng][n_splits], then the rows.
  float* wts = red;
  const int wts_floats = (3 * kHeads * p.n_splits + 3) / 4 * 4;
  const int per_head = p.n_splits * p.d;           // floats
  const int hb = min(ng, (G_::kRing / 4 - wts_floats) / per_head);
  float* stage = red + wts_floats;
  auto fetch = [&](int hh0) {
    const float* src = p.part_acc + (head0 + hh0) * per_head;
    const int n16 = min(hb, ng - hh0) * per_head / 4;
    for (int c = tid; c < n16; c += 32 * kWarps) {
      hopper::cp_async_16(stage + 4 * c, src + 4 * c);
    }
  };
  fetch(0);
  // the (m, l) of every split of the block's heads, contiguous in
  // part_m / part_l, one load each, to the ring after the weights; then
  // one warp a head, its lanes over the splits
  float* sm_m = wts + kHeads * p.n_splits;
  float* sm_l = sm_m + ng * p.n_splits;
  for (int e = tid; e < ng * p.n_splits; e += 32 * kWarps) {
    const float mi = __ldcg(p.part_m + head0 * p.n_splits + e);
    const float li = __ldcg(p.part_l + head0 * p.n_splits + e);
    sm_m[e] = mi;
    sm_l[e] = li;
  }
  hopper::named_barrier(1, 32 * kWarps);
  for (int hh = warp; hh < ng; hh += kWarps) {
    const float* mh = sm_m + hh * p.n_splits;
    const float* lh = sm_l + hh * p.n_splits;
    float mx = kNegInf;
    for (int i = lane; i < p.n_splits; i += 32) {
      if (lh[i] > 0.f) mx = fmaxf(mx, mh[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    float den = 0.f;
    for (int i = lane; i < p.n_splits; i += 32) {
      const float w = lh[i] > 0.f ? attn::ex2(mh[i] - mx) : 0.f;
      wts[hh * p.n_splits + i] = w;
      den += lh[i] * w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      den += __shfl_xor_sync(0xffffffffu, den, off);
    }
    if (lane == 0) blk_l[hh] = den;
  }
  for (int hh0 = 0; hh0 < ng; hh0 += hb) {
    if (hh0 > 0) {
      // no thread reads the last heads' rows any more
      hopper::named_barrier(1, 32 * kWarps);
      fetch(hh0);
    }
    cp_async_wait_all();
    hopper::named_barrier(1, 32 * kWarps);
    const int nh = min(hb, ng - hh0);
    for (int idx = tid; idx < nh * d8; idx += 32 * kWarps) {
      const int hl = idx / d8, c = (idx - hl * d8) * 8;
      const float* w = wts + (hh0 + hl) * p.n_splits;
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < p.n_splits; ++i) {
        const float* r = stage + (hl * p.n_splits + i) * p.d + c;
        const float4 x0 = *reinterpret_cast<const float4*>(r);
        const float4 x1 = *reinterpret_cast<const float4*>(r + 4);
        a[0] += w[i] * x0.x;
        a[1] += w[i] * x0.y;
        a[2] += w[i] * x0.z;
        a[3] += w[i] * x0.w;
        a[4] += w[i] * x1.x;
        a[5] += w[i] * x1.y;
        a[6] += w[i] * x1.z;
        a[7] += w[i] * x1.w;
      }
      store8(og + (h0 + hh0 + hl) * p.o_sh + c, a,
             fmaxf(blk_l[hh0 + hl], 1e-30f));
    }
  }
}

// the ring's shared memory granted to the instantiation, once a device
template <int NP>
int prepare() {
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  err = cudaFuncSetAttribute(
      decode_tc<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Geom<NP>::kSmem));
  done[dev] = err == cudaSuccess;
  return static_cast<int>(err);
}

// The tensor maps of the caches last seen (a serve run's layers take the
// same caches every step), so that a call on a cache seen before skips
// cuTensorMapEncodeTiled, which costs the host more than the launch.  The
// key is all the map is made of.
struct MapKey {
  const void* ptr;
  int64_t b, h, s, d, sb, sh, ss;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && b == o.b && h == o.h && s == o.s && d == o.d
           && sb == o.sb && sh == o.sh && ss == o.ss;
  }
};

struct MapEntry {
  MapKey key;
  CUtensorMap map;
  int order;
  bool used;
};

int cached_map(CUtensorMap* map, int* order, const void* ptr, int64_t b,
               int64_t h, int64_t s, int64_t d, const int64_t* st) {
  static std::mutex mu;
  static MapEntry cache[kMaps];
  static int next = 0;
  const MapKey key{ptr, b, h, s, d, st[0], st[1], st[2]};
  const std::lock_guard<std::mutex> lock(mu);
  for (const MapEntry& e : cache) {
    if (e.used && e.key == key) {
      *map = e.map;
      *order = e.order;
      return 0;
    }
  }
  const int err = attn::encode(map, ptr, b, h, s, d, st, kRows, order);
  if (err == 0) {
    cache[next] = {key, *map, *order, true};
    next = (next + 1) % kMaps;
  }
  return err;
}

template <int NP>
int launch_np(const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
              dim3 grid, cudaStream_t stream) {
  const int err = prepare<NP>();
  if (err != 0) return err;
  decode_tc<NP><<<grid, kThreads, Geom<NP>::kSmem, stream>>>(km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, const void* valid,
           const void* lo, void* out, void* part_m, void* part_l,
           void* part_acc, void* counter, int64_t b, int64_t hq, int64_t hk,
           int64_t s, int64_t d, const int64_t* st, int64_t chunk,
           int64_t n_splits, int64_t n_sub, void* stream) {
  Params p;
  fill_params(&p, q, k, v, valid, lo, out, part_m, part_l, part_acc, counter,
              hq, hk, s, d, st, chunk, n_splits, n_sub);
  // the group in sub-groups of at most 16 heads; tiles that a split's
  // chunk holds whole; a head's partials within the ring; q's and out's
  // rows 16-byte aligned
  if (d % 16 || d > 256 || n_sub != (p.group + kHeads - 1) / kHeads
      || chunk % kRows || chunk <= 0
      || n_splits > (d <= 64 ? Geom<1>::kMaxSplits
                             : d <= 128 ? Geom<2>::kMaxSplits
                                        : Geom<4>::kMaxSplits)
      || !aligned16(q) || st[0] % 8 || st[1] % 8 || !aligned16(out)
      || st[8] % 8 || st[9] % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap km, vm;
  int err = cached_map(&km, &p.k_order, k, b, hk, s, d, st + 2);
  if (err == 0) err = cached_map(&vm, &p.v_order, v, b, hk, s, d, st + 5);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(n_splits),
                  static_cast<unsigned>(hk * n_sub),
                  static_cast<unsigned>(b));
  const cudaStream_t s_ = static_cast<cudaStream_t>(stream);
  return d <= 64 ? launch_np<1>(km, vm, p, grid, s_)
         : d <= 128 ? launch_np<2>(km, vm, p, grid, s_)
                    : launch_np<4>(km, vm, p, grid, s_);
}

// the blocks an SM holds of the instantiation of NP panels
template <int NP>
int occupancy(int* out) {
  const int err = prepare<NP>();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, decode_tc<NP>, kThreads, Geom<NP>::kSmem));
}

// the blocks an SM holds of the instantiation for head dim d
int blocks_per_sm(int64_t d, int* out) {
  return d <= 64 ? occupancy<1>(out) : d <= 128 ? occupancy<2>(out)
                                                : occupancy<4>(out);
}

}  // namespace tc

// =================================== float32: CUDA cores, in full f32
namespace cc {

constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kStages = 3;                   // depth of the K/V ring
constexpr int kStageBytes = 32 * 1024;       // one K and one V tile

// the most q-heads one block serves at a largest D of MD
constexpr int max_heads(int md) { return md <= 128 ? 8 : 4; }

// a tile is kRows slots of K and of V at D <= MD (128 or 256); a
// half-warp reads one slot, lane l16 its 16-byte chunks l16 + 16 c,
// c < kChunks
template <int MD>
struct Tile {
  static constexpr int kRows = 32 * 128 / MD;
  static constexpr int kVec = 4;                       // floats a chunk
  static constexpr int kChunks = MD / kVec / 16;
  static constexpr int kSlots = kRows / kWarps;        // slots a warp owns
  static_assert(2 * kRows * MD * 4 == kStageBytes, "stage");
};

// the 16 bytes at src (shared memory, 16-byte aligned), or zeros when !ok
__device__ __forceinline__ void load16(const float* src, bool ok,
                                       float* out) {
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) u = *reinterpret_cast<const float4*>(src);
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}

// this block's q-heads [h0, h0 + ng) of the row's Hq: without kSub the
// KV head blockIdx.y's whole group of G; with it, sub-group
// blockIdx.y % n_sub of KV head blockIdx.y / n_sub.  Computed where
// needed.  With a sub-group the block index is read again through an asm
// ptxas cannot merge, so nothing of it is held across the walk: there
// the kernel is at its register cap (168, or 96 with two blocks an SM, a
// thread on an SM's four register files) and holding it spilled.
struct Heads {
  int h0, ng;
};

template <int G, bool kSub>
__device__ __forceinline__ Heads block_heads(const Params& p) {
  unsigned y = blockIdx.y;
  if constexpr (kSub) asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  if constexpr (!kSub) {
    return {static_cast<int>(y) * G, G};
  } else {
    const int kvh = static_cast<int>(y) / p.n_sub;
    const int sub = static_cast<int>(y) - kvh * p.n_sub;
    return {kvh * p.group + sub * G, min(G, p.group - sub * G)};
  }
}

// G: the q-heads one block serves (its sub-group's, at most); kSub: the
// group is cut into sub-groups (n_sub > 1).  Two blocks an SM up to 4
// heads' worth of per-head arrays (G * MD <= 4 * 128).
template <int MD, int G, bool kSub>
__global__ void __launch_bounds__(kThreads, G * MD <= 4 * 128 ? 2 : 1)
decode_kernel(Params p) {
  using L = Tile<MD>;
  constexpr int kVec = L::kVec, kChunks = L::kChunks, kSlots = L::kSlots;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float sc[kWarps][G][kSlots];   // a warp's scores, then p
  // per warp and head: running max (then the merge's weight) and sum
  __shared__ float warp_m[kWarps][G], warp_l[kWarps][G];
  __shared__ int is_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = kSub ? blockIdx.y / p.n_sub : blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const Span sp = split_span(p, b, split);
  const int s0 = sp.s0, s1 = sp.s1;
  const int n_tiles = s1 > s0 ? (s1 - s0 + L::kRows - 1) / L::kRows : 0;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb
                    + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb
                    + kvh * p.v_sh;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      // bulk: the producer's expect_tx arrival; rows: one per lane
      hopper::mbar_init(&full[i], p.bulk ? 1 : 32);
      hopper::mbar_init(&empty[i], kWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ------------------------------------------------------- producer
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int t0 = s0 + i * L::kRows, rows = min(L::kRows, s1 - t0);
      float* ks = reinterpret_cast<float*>(ring + st * kStageBytes);
      float* vs = ks + L::kRows * p.d;
      hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      if (p.bulk) {
        if (lane == 0) {
          const uint32_t bytes = rows * p.d * sizeof(float);
          hopper::mbar_arrive_expect_tx(&full[st], 2 * bytes);
          hopper::bulk_load(ks, kg + static_cast<int64_t>(t0) * p.k_ss,
                            bytes, &full[st]);
          hopper::bulk_load(vs, vg + static_cast<int64_t>(t0) * p.v_ss,
                            bytes, &full[st]);
        }
      } else {
        const int per_row = p.d / kVec;
        for (int c = lane; c < rows * per_row; c += 32) {
          const int r = c / per_row, e = (c - r * per_row) * kVec;
          hopper::cp_async_16(ks + r * p.d + e,
                              kg + static_cast<int64_t>(t0 + r) * p.k_ss + e);
          hopper::cp_async_16(vs + r * p.d + e,
                              vg + static_cast<int64_t>(t0 + r) * p.v_ss + e);
        }
        hopper::cp_async_arrive(&full[st]);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int half = lane >> 4, l16 = lane & 15;
  // q of the block's heads at this lane's chunks, scaled (a short last
  // sub-group's missing heads: zeros)
  float qf[G][kChunks][kVec];
  const Heads hq = block_heads<G, kSub>(p);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb
                    + hq.h0 * p.q_sh;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (l16 + 16 * c) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        qf[g][c][e] = col < p.d && g < hq.ng
            ? qg[g * p.q_sh + col + e] * p.scale : 0.f;
      }
    }
  }
  float acc[G][kChunks][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][c][e] = 0.f;
    }
  }
  // the softmax runs all heads at once, lane = (head, slot): this lane's
  // head in pass ps is ps * kHeads + lane / kSlots, whose running max and
  // sum it keeps
  constexpr int kHeads = 32 / kSlots;                  // heads per pass
  constexpr int kPasses = (G + kHeads - 1) / kHeads;
  float m_own[kPasses], l_own[kPasses];
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
    m_own[ps] = kNegInf;
    l_own[ps] = 0.f;
  }
  float* sc_w = &sc[warp][0][0];                       // [G][kSlots]

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int rows = min(L::kRows, s1 - (s0 + i * L::kRows));
    // this warp's slots [r0, r0 + mine) of the tile
    const int r0 = warp * kSlots, mine = min(kSlots, rows - r0);
    const float* ks = reinterpret_cast<const float*>(ring + st * kStageBytes);
    const float* vs = ks + L::kRows * p.d;
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    if (mine > 0) {
      // scores, one slot per half-warp at a time; a slot past the tile's
      // rows is read (it lies in the ring) but never stored
#pragma unroll
      for (int j = 0; j < kSlots / 2; ++j) {
        const int r = 2 * j + half;
        float dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = (l16 + 16 * c) * kVec;
          float kf[kVec];
          load16(ks + (r0 + r) * p.d + col, col < p.d, kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) dot[g] += qf[g][c][e] * kf[e];
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
          }
          if (l16 == g && r < mine) sc_w[g * kSlots + r] = dot[g];
        }
      }
      __syncwarp();

      // online softmax of every head over the warp's slots
      float alpha[G];
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int g = ps * kHeads + lane / kSlots, slot = lane % kSlots;
        const bool ok = g < G && slot < mine;
        const float x = ok ? sc_w[g * kSlots + slot] : 0.f;
        float mx = ok ? x : kNegInf;
#pragma unroll
        for (int off = kSlots / 2; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float mn = fmaxf(m_own[ps], mx);
        const float pr = ok ? expf(x - mn) : 0.f;
        if (ok) sc_w[g * kSlots + slot] = pr;
        float sum = pr;
#pragma unroll
        for (int off = kSlots / 2; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        const float a = expf(m_own[ps] - mn);
        l_own[ps] = l_own[ps] * a + sum;
        m_own[ps] = mn;
#pragma unroll
        for (int gg = 0; gg < kHeads; ++gg) {
          if (ps * kHeads + gg < G) {
            alpha[ps * kHeads + gg] = __shfl_sync(0xffffffffu, a,
                                                  gg * kSlots);
          }
        }
      }
      __syncwarp();

      // acc = acc * alpha + P V over the warp's slots
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][c][e] *= alpha[g];
        }
      }
#pragma unroll
      for (int j = 0; j < kSlots / 2; ++j) {
        const int r = 2 * j + half;
        const bool ok = r < mine;    // a slot past the rows is never read
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = (l16 + 16 * c) * kVec;
          float vf[kVec];
          load16(vs + (r0 + r) * p.d + col, ok && col < p.d, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pr = ok ? sc_w[g * kSlots + r] : 0.f;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[g][c][e] += pr * vf[e];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // the two half-warps summed different slots under the same m
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc[g][c][e] += __shfl_xor_sync(0xffffffffu, acc[g][c][e], 16);
      }
    }
  }

  // merge the warps' states through the ring, once every warp is
  // done with its tiles (the ring was last written by the copies)
  hopper::named_barrier(1, 32 * kWarps);
  hopper::fence_proxy_async();
  float* red = reinterpret_cast<float*>(ring);     // [kWarps][G][MD]
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = (l16 + 16 * c) * kVec;
        if (col < p.d) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            red[(warp * G + g) * MD + col + e] = acc[g][c][e];
          }
        }
      }
    }
  }
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
    const int g = ps * kHeads + lane / kSlots;
    if (g < G && lane % kSlots == 0) {
      warp_m[warp][g] = m_own[ps];
      warp_l[warp][g] = l_own[ps];
    }
  }
  hopper::named_barrier(1, 32 * kWarps);

  // this split's (m, l) per head, and each warp's weight exp(m_w - m)
  const int tid = threadIdx.x;
  const Heads hd = block_heads<G, kSub>(p);
  const int h0 = hd.h0, ng = hd.ng;
  const int64_t head0 = static_cast<int64_t>(b) * p.hq + h0;
  if (tid < ng) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_m[w][tid]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(warp_m[w][tid] - mx);
      warp_m[w][tid] = wt;
      sum += warp_l[w][tid] * wt;
    }
    p.part_m[(head0 + tid) * p.n_splits + split] = mx;
    p.part_l[(head0 + tid) * p.n_splits + split] = sum;
  }
  hopper::named_barrier(1, 32 * kWarps);
  for (int idx = tid; idx < ng * p.d; idx += 32 * kWarps) {
    const int g = idx / p.d, dd = idx - g * p.d;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[(w * G + g) * MD + dd] * warp_m[w][g];
    }
    p.part_acc[((head0 + g) * p.n_splits + split) * p.d + dd] = a;
  }

  // the last block of this (b, KV head, sub-group) to finish merges the
  // splits
  hopper::named_barrier(1, 32 * kWarps);
  if (!take_ticket(p, b, tid, &is_last, 32 * kWarps)) return;
  float* og = static_cast<float*>(p.out) + b * p.o_sb;
  for (int idx = tid; idx < ng * p.d; idx += 32 * kWarps) {
    const int g = idx / p.d, dd = idx - g * p.d;
    const int64_t base = (head0 + g) * p.n_splits;
    // one pass in split order, rescaled to the running max; a split's
    // loads do not wait on the previous split's arithmetic, so the
    // unrolled loop keeps several in flight.  A split with no slot
    // (l = 0) carries nothing.
    float mx = kNegInf, den = 0.f, a = 0.f;
#pragma unroll 4
    for (int i = 0; i < p.n_splits; ++i) {
      const float li = __ldcg(p.part_l + base + i);
      const float mi = __ldcg(p.part_m + base + i);
      const float ai = __ldcg(p.part_acc + (base + i) * p.d + dd);
      if (li > 0.f) {
        const float mn = fmaxf(mx, mi);
        const float old_w = expf(mx - mn), new_w = expf(mi - mn);
        den = den * old_w + li * new_w;
        a = a * old_w + ai * new_w;
        mx = mn;
      }
    }
    og[(h0 + g) * p.o_sh + dd] = a / fmaxf(den, 1e-30f);
  }
}

// the kernel for G q-heads a block at D <= MD (its arrays are sized by
// both)
template <int MD, int G, bool kSub>
int launch_g(const Params& p, dim3 grid, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<MD, G, kSub>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kStages * kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<MD, G, kSub><<<grid, kThreads, kStages * kStageBytes,
                               stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// a whole group of 1..max_heads(MD) heads a block; or, cut into n_sub =
// ceil(group / max_heads(MD)) > 1 sub-groups, ceil(group / n_sub) heads
// a block, which is above max_heads(MD) / 2
template <int MD>
int launch_md(const Params& p, int heads, dim3 grid, cudaStream_t s) {
  constexpr int kMax = max_heads(MD);
  if (p.n_sub == 1) {
    switch (heads) {
      case 1: return launch_g<MD, 1, false>(p, grid, s);
      case 2: return launch_g<MD, 2, false>(p, grid, s);
      case 3: return launch_g<MD, 3, false>(p, grid, s);
      case 4: return launch_g<MD, 4, false>(p, grid, s);
    }
    if constexpr (kMax > 4) {
      switch (heads) {
        case 5: return launch_g<MD, 5, false>(p, grid, s);
        case 6: return launch_g<MD, 6, false>(p, grid, s);
        case 7: return launch_g<MD, 7, false>(p, grid, s);
        case 8: return launch_g<MD, 8, false>(p, grid, s);
      }
    }
  } else if constexpr (kMax > 4) {
    switch (heads) {
      case 5: return launch_g<MD, 5, true>(p, grid, s);
      case 6: return launch_g<MD, 6, true>(p, grid, s);
      case 7: return launch_g<MD, 7, true>(p, grid, s);
      case 8: return launch_g<MD, 8, true>(p, grid, s);
    }
  } else {
    switch (heads) {
      case 3: return launch_g<MD, 3, true>(p, grid, s);
      case 4: return launch_g<MD, 4, true>(p, grid, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch(const void* q, const void* k, const void* v, const void* valid,
           const void* lo, void* out, void* part_m, void* part_l,
           void* part_acc, void* counter, int64_t b, int64_t hq, int64_t hk,
           int64_t s, int64_t d, const int64_t* st, int64_t chunk,
           int64_t n_splits, int64_t n_sub, void* stream) {
  Params p;
  fill_params(&p, q, k, v, valid, lo, out, part_m, part_l, part_acc, counter,
              hq, hk, s, d, st, chunk, n_splits, n_sub);
  // the copies need 16-byte aligned rows (the wrapper copies caches
  // that are not); whole-tile copies also need contiguous slots
  bool vec = aligned16(k) && aligned16(v) && d * sizeof(float) % 16 == 0;
  for (int i = 2; i < 8; ++i) vec = vec && st[i] * sizeof(float) % 16 == 0;
  // the group cut into the fewest sub-groups of at most max_heads(MD)
  const int md = d <= 128 ? 128 : 256;
  const int heads = n_sub > 0 ? static_cast<int>((p.group + n_sub - 1)
                                                 / n_sub) : 0;
  if (!vec || d > 256
      || n_sub != (p.group + max_heads(md) - 1) / max_heads(md)
      || chunk % (md == 128 ? Tile<128>::kRows : Tile<256>::kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bulk = st[4] == d && st[7] == d;
  const dim3 grid(static_cast<unsigned>(n_splits),
                  static_cast<unsigned>(hk * n_sub),
                  static_cast<unsigned>(b));
  const cudaStream_t s_ = static_cast<cudaStream_t>(stream);
  return md == 128 ? launch_md<128>(p, heads, grid, s_)
                   : launch_md<256>(p, heads, grid, s_);
}

}  // namespace cc

}  // namespace

// valid and lo: int32 [B] span ends and starts.  strides: 10 int64 element
// strides: q (batch, head), k and v (batch, head, slot), out (batch, head).
// Scratch part_m/part_l [B, Hq, n_splits] and part_acc [B, Hq, n_splits, D]
// are float32; counter is int32 [>= B * Hk * n_sub], zero on entry and left
// zero on exit.  chunk: slots a split, a multiple of 64.  n_sub: the blocks
// (sub-groups) each KV head's group of Hq / Hk q-heads is cut into, of
// ceil(group / n_sub) heads each: in bf16 ceil(group / 16); in float32
// ceil(group / 8) at D <= 128 and ceil(group / 4) at D <= 256.  bf16
// caches need 16-byte aligned bases and positive strides that are
// multiples of 16 bytes (the tensor maps'); float32 caches 16-byte aligned
// rows.
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const void* valid, const void* lo, void* out,
                                void* part_m, void* part_l, void* part_acc,
                                void* counter, int64_t b, int64_t hq,
                                int64_t hk, int64_t s, int64_t d,
                                const int64_t* strides,
                                int64_t chunk, int64_t n_splits,
                                int64_t n_sub, void* stream) {
  return tc::launch(q, k, v, valid, lo, out, part_m, part_l, part_acc,
                    counter, b, hq, hk, s, d, strides, chunk, n_splits,
                    n_sub, stream);
}

// *out: the blocks of the bf16 kernel for head dim d that an SM holds
extern "C" int decode_attn_bf16_blocks_per_sm(int64_t d, void* out) {
  return tc::blocks_per_sm(d, static_cast<int*>(out));
}

extern "C" int decode_attn_f32(const void* q, const void* k, const void* v,
                               const void* valid, const void* lo, void* out,
                               void* part_m, void* part_l, void* part_acc,
                               void* counter, int64_t b, int64_t hq,
                               int64_t hk, int64_t s, int64_t d,
                               const int64_t* strides,
                               int64_t chunk, int64_t n_splits,
                               int64_t n_sub, void* stream) {
  return cc::launch(q, k, v, valid, lo, out, part_m, part_l, part_acc,
                    counter, b, hq, hk, s, d, strides, chunk, n_splits,
                    n_sub, stream);
}
