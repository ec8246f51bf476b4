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
// finish merges the partials and writes the output, in the same launch.
// The model's sliding window is the span's first slot lo: a block's share
// starts at lo + split * chunk, so no slot below lo is ever loaded (for a
// byte-bound kernel that is the window's whole gain), and no tile has a
// lower edge to mask; the upper edge, valid_len, is masked as before.
//
// Bound on an H100: bytes.  At the serving path's decode (B 8, Hk 8,
// D 128, bf16, valid_len ~2112) the kernel must read 2*B*Hk*valid_len*D*2
// = 69 MB of cache, 0.021 ms at 3.35 TB/s, for ~1 FLOP per byte.  The
// design reads each cache byte once and keeps loads in flight while it
// computes: one block serves the whole GQA group of Hq/Hk query heads
// (the TPU route repeats K/V per q-head); a producer warp streams K/V
// tiles of 64 slots (32 in f32) through a ring of three stages, each one
// cp.async.bulk per tile when the slots are contiguous (the serve cache's
// tile is 16 KB in one piece) and 16-byte cp.async per row otherwise,
// completing on the stage's mbarrier; tiles outside the span are never
// loaded.  Eight consumer warps each own an eighth of every tile and keep
// their own online-softmax state, so a tile costs no block-wide barrier:
// only the stage barriers and warp shuffles.  The kernel is compiled for
// each count of q-heads a block serves (1..8), so its per-head arrays stay
// in registers (9 warps on an SM's four register files leave a thread 168
// registers, two blocks 96).  The warps' states are merged once per
// block, and an atomic ticket per (b, KV head, sub-group) finds the last
// block, which merges the splits and restores the ticket to 0.
//
// Head dims up to 256 and groups of any size: the kernel is compiled for
// the largest D it takes, 128 or 256.  At 256 a tile holds half as many
// slots (32 in bf16, 16 in f32), so a stage stays 32 KB.  A block serves a
// sub-group of at most 8 q-heads at D 128 and 4 at D 256, which keeps the
// per-head arrays (2 * heads * D / 16 floats a thread) at 128 floats; a
// larger group is cut into n_sub sub-groups of ceil(G / n_sub) heads
// (recurrentgemma's G 10 at D 256: 4, 4 and 2), each its own block
// column, which reads the (b, KV head)'s span again, mostly from L2.  A
// short last sub-group computes its missing heads on q = 0 and writes
// nothing of them.  The kernel is compiled apart for a whole group (one
// block per (b, KV head), the code a group that fits one block always
// ran) and for a sub-group.
//
// Semantics, as the TPU kernel: q upcast to f32 and scaled by D^-0.5,
// scores and statistics in f32, output acc / max(l, 1e-30) in q's dtype;
// an empty span gives zeros.  valid_len is clamped to [0, S] and lo to
// [0, valid_len]; nothing outside [lo, valid_len) is read.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kStages = 3;                   // depth of the K/V ring
constexpr int kStageBytes = 32 * 1024;       // one K and one V tile
constexpr float kNegInf = -1e30f;

// the most q-heads one block serves at a largest D of MD
constexpr int max_heads(int md) { return md <= 128 ? 8 : 4; }

// a tile is kRows slots of K and of V at D <= MD (128 or 256); a
// half-warp reads one slot, lane l16 its 16-byte chunks l16 + 16 c,
// c < kChunks
template <typename T, int MD>
struct Tile {
  static constexpr int kRows = (sizeof(T) == 2 ? 64 : 32) * 128 / MD;
  static constexpr int kVec = 16 / sizeof(T);          // elements a chunk
  static constexpr int kChunks = MD / kVec / 16;
  static constexpr int kSlots = kRows / kWarps;        // slots a warp owns
  static_assert(2 * kRows * MD * sizeof(T) == kStageBytes, "stage");
};

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
  float scale;
  int bulk;                       // slots contiguous: one copy per tile
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes at u as 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const bf16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // a bf16 is the top half of its float
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the 8 bytes at u as 8 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint2& u, float* out,
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
}
__device__ __forceinline__ void unpack(const uint2& u, float* out,
                                       const bf16*) {
  out[0] = __uint_as_float(u.x << 16);
  out[1] = __uint_as_float(u.x & 0xffff0000u);
  out[2] = __uint_as_float(u.y << 16);
  out[3] = __uint_as_float(u.y & 0xffff0000u);
}

// the 16 bytes at src (shared memory, 16-byte aligned) as floats, or
// zeros when !ok
template <typename T>
__device__ __forceinline__ void load16(const T* src, bool ok, float* out) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (ok) u = *reinterpret_cast<const uint4*>(src);
  unpack(u, out, src);
}

// the 8 bytes at src (shared memory, 8-byte aligned) as floats, or zeros
// when !ok
template <typename T>
__device__ __forceinline__ void load8(const T* src, bool ok, float* out) {
  uint2 u = make_uint2(0u, 0u);
  if (ok) u = *reinterpret_cast<const uint2*>(src);
  unpack(u, out, src);
}

// kPer elements (16 or 8 bytes) at src as floats, or zeros when !ok
template <typename T, int kPer>
__device__ __forceinline__ void load_part(const T* src, bool ok,
                                          float* out) {
  if constexpr (kPer * sizeof(T) == 16) {
    load16(src, ok, out);
  } else {
    load8(src, ok, out);
  }
}

// this block's q-heads [h0, h0 + ng) of the row's Hq: without kSub the
// KV head blockIdx.y's whole group of G; with it, sub-group
// blockIdx.y % n_sub of KV head blockIdx.y / n_sub.  Computed where
// needed.  With a sub-group, and in bf16 at 4 heads, the block index is
// read again through an asm ptxas cannot merge, so nothing of it is held
// across the walk: there the kernel is at its register cap (168, or 96
// with two blocks an SM, a thread on an SM's four register files) and
// holding it spilled; elsewhere the plain read keeps the code it had.
struct Heads {
  int h0, ng;
};

template <typename T, int G, bool kSub>
__device__ __forceinline__ Heads block_heads(const Params& p) {
  constexpr bool kReread = kSub || (sizeof(T) == 2 && G == 4);
  unsigned y = blockIdx.y;
  if constexpr (kReread) asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
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
template <typename T, int MD, int G, bool kSub>
__global__ void __launch_bounds__(kThreads, G * MD <= 4 * 128 ? 2 : 1)
decode_kernel(Params p) {
  using L = Tile<T, MD>;
  constexpr int kVec = L::kVec, kChunks = L::kChunks, kSlots = L::kSlots;
  // a lane takes its 16-byte chunk of a K or V row in one load, or as two
  // 8-byte halves, each used before the next is loaded (the same
  // arithmetic in the same order), where fewer live floats keep the kernel
  // within its registers: bf16 at 4 heads' worth of per-head arrays, two
  // blocks an SM (96 registers a thread)
  constexpr int kPer = sizeof(T) == 2 && G * MD == 4 * 128 ? kVec / 2
                                                           : kVec;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float sc[kWarps][G][kSlots];   // a warp's scores, then p
  // per warp and head: running max (then the merge's weight) and sum
  __shared__ float warp_m[kWarps][G], warp_l[kWarps][G];
  __shared__ int is_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = kSub ? blockIdx.y / p.n_sub : blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int vl = max(0, min(p.valid[b], p.s));
  const int lo = max(0, min(p.lo[b], vl));
  // the last split runs to vl, so a plan cut for a shorter span than a
  // row's is slower, never wrong
  const int s0 = lo + split * p.chunk;
  const int s1 = split == p.n_splits - 1 ? vl : min(s0 + p.chunk, vl);
  const int n_tiles = s1 > s0 ? (s1 - s0 + L::kRows - 1) / L::kRows : 0;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

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
      T* ks = reinterpret_cast<T*>(ring + st * kStageBytes);
      T* vs = ks + L::kRows * p.d;
      hopper::mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      if (p.bulk) {
        if (lane == 0) {
          const uint32_t bytes = rows * p.d * sizeof(T);
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
  // q of the block's heads at this lane's chunks, upcast and scaled (a
  // short last sub-group's missing heads: zeros)
  float qf[G][kChunks][kVec];
  const Heads hq = block_heads<T, G, kSub>(p);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + hq.h0 * p.q_sh;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (l16 + 16 * c) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        qf[g][c][e] = col < p.d && g < hq.ng
            ? to_f(qg[g * p.q_sh + col + e]) * p.scale : 0.f;
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
    const T* ks = reinterpret_cast<const T*>(ring + st * kStageBytes);
    const T* vs = ks + L::kRows * p.d;
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
#pragma unroll
          for (int e0 = 0; e0 < kVec; e0 += kPer) {
            float kf[kPer];
            load_part<T, kPer>(ks + (r0 + r) * p.d + col + e0, col < p.d,
                               kf);
#pragma unroll
            for (int g = 0; g < G; ++g) {
#pragma unroll
              for (int e = 0; e < kPer; ++e) {
                dot[g] += qf[g][c][e0 + e] * kf[e];
              }
            }
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
#pragma unroll
          for (int e0 = 0; e0 < kVec; e0 += kPer) {
            float vf[kPer];
            load_part<T, kPer>(vs + (r0 + r) * p.d + col + e0,
                               ok && col < p.d, vf);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float pr = ok ? sc_w[g * kSlots + r] : 0.f;
#pragma unroll
              for (int e = 0; e < kPer; ++e) {
                acc[g][c][e0 + e] += pr * vf[e];
              }
            }
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
  const Heads hd = block_heads<T, G, kSub>(p);
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
  // splits: the barrier orders the block's partial writes before thread
  // 0's fence, which makes them visible before its ticket
  hopper::named_barrier(1, 32 * kWarps);
  int32_t* ticket = p.counter + b * gridDim.y + blockIdx.y;
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1) == p.n_splits - 1;
    if (is_last) {
      __threadfence();
      *ticket = 0;                      // zero again for the next call
    }
  }
  hopper::named_barrier(1, 32 * kWarps);
  if (!is_last) return;
  T* og = static_cast<T*>(p.out) + b * p.o_sb;
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
    og[(h0 + g) * p.o_sh + dd] = from_f<T>(a / fmaxf(den, 1e-30f));
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// the kernel for G q-heads a block at D <= MD (its arrays are sized by
// both)
template <typename T, int MD, int G, bool kSub>
int launch_g(const Params& p, dim3 grid, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, MD, G, kSub>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kStages * kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<T, MD, G, kSub><<<grid, kThreads, kStages * kStageBytes,
                                  stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// a whole group of 1..max_heads(MD) heads a block; or, cut into n_sub =
// ceil(group / max_heads(MD)) > 1 sub-groups, ceil(group / n_sub) heads
// a block, which is above max_heads(MD) / 2
template <typename T, int MD>
int launch_md(const Params& p, int heads, dim3 grid, cudaStream_t s) {
  constexpr int kMax = max_heads(MD);
  if (p.n_sub == 1) {
    switch (heads) {
      case 1: return launch_g<T, MD, 1, false>(p, grid, s);
      case 2: return launch_g<T, MD, 2, false>(p, grid, s);
      case 3: return launch_g<T, MD, 3, false>(p, grid, s);
      case 4: return launch_g<T, MD, 4, false>(p, grid, s);
    }
    if constexpr (kMax > 4) {
      switch (heads) {
        case 5: return launch_g<T, MD, 5, false>(p, grid, s);
        case 6: return launch_g<T, MD, 6, false>(p, grid, s);
        case 7: return launch_g<T, MD, 7, false>(p, grid, s);
        case 8: return launch_g<T, MD, 8, false>(p, grid, s);
      }
    }
  } else if constexpr (kMax > 4) {
    switch (heads) {
      case 5: return launch_g<T, MD, 5, true>(p, grid, s);
      case 6: return launch_g<T, MD, 6, true>(p, grid, s);
      case 7: return launch_g<T, MD, 7, true>(p, grid, s);
      case 8: return launch_g<T, MD, 8, true>(p, grid, s);
    }
  } else {
    switch (heads) {
      case 3: return launch_g<T, MD, 3, true>(p, grid, s);
      case 4: return launch_g<T, MD, 4, true>(p, grid, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           const void* lo, void* out, void* part_m, void* part_l,
           void* part_acc, void* counter, int64_t b, int64_t hq, int64_t hk,
           int64_t s, int64_t d, const int64_t* st, int64_t chunk,
           int64_t n_splits, int64_t n_sub, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const int32_t*>(valid);
  p.lo = static_cast<const int32_t*>(lo);
  p.out = out;
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_acc = static_cast<float*>(part_acc);
  p.counter = static_cast<int32_t*>(counter);
  p.q_sb = st[0];
  p.q_sh = st[1];
  p.k_sb = st[2];
  p.k_sh = st[3];
  p.k_ss = st[4];
  p.v_sb = st[5];
  p.v_sh = st[6];
  p.v_ss = st[7];
  p.o_sb = st[8];
  p.o_sh = st[9];
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.s = static_cast<int>(s);
  p.d = static_cast<int>(d);
  p.chunk = static_cast<int>(chunk);
  p.n_splits = static_cast<int>(n_splits);
  p.group = static_cast<int>(hq / hk);
  p.n_sub = static_cast<int>(n_sub);
  p.scale = static_cast<float>(std::pow(static_cast<double>(d), -0.5));
  // the copies need 16-byte aligned rows (the wrapper copies caches
  // that are not); whole-tile copies also need contiguous slots
  bool vec = aligned16(k) && aligned16(v) && d * sizeof(T) % 16 == 0;
  for (int i = 2; i < 8; ++i) vec = vec && st[i] * sizeof(T) % 16 == 0;
  // the group cut into the fewest sub-groups of at most max_heads(MD)
  const int md = d <= 128 ? 128 : 256;
  const int heads = n_sub > 0 ? static_cast<int>((p.group + n_sub - 1)
                                                 / n_sub) : 0;
  if (!vec || d > 256
      || n_sub != (p.group + max_heads(md) - 1) / max_heads(md)
      || chunk % (md == 128 ? Tile<T, 128>::kRows : Tile<T, 256>::kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bulk = st[4] == d && st[7] == d;
  const dim3 grid(static_cast<unsigned>(n_splits),
                  static_cast<unsigned>(hk * n_sub),
                  static_cast<unsigned>(b));
  const cudaStream_t s_ = static_cast<cudaStream_t>(stream);
  return md == 128 ? launch_md<T, 128>(p, heads, grid, s_)
                   : launch_md<T, 256>(p, heads, grid, s_);
}

}  // namespace

// valid and lo: int32 [B] span ends and starts.  strides: 10 int64 element
// strides: q (batch, head), k and v (batch, head, slot), out (batch, head).
// Scratch part_m/part_l [B, Hq, n_splits] and part_acc [B, Hq, n_splits, D]
// are float32; counter is int32 [>= B * Hk * n_sub], zero on entry and left
// zero on exit.  n_sub: the blocks (sub-groups) each KV head's group of
// Hq / Hk q-heads is cut into, ceil(group / 8) at D <= 128 and
// ceil(group / 4) at D <= 256, of ceil(group / n_sub) heads each.
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const void* valid, const void* lo, void* out,
                                void* part_m, void* part_l, void* part_acc,
                                void* counter, int64_t b, int64_t hq,
                                int64_t hk, int64_t s, int64_t d,
                                const int64_t* strides,
                                int64_t chunk, int64_t n_splits,
                                int64_t n_sub, void* stream) {
  return launch<bf16>(q, k, v, valid, lo, out, part_m, part_l, part_acc,
                      counter, b, hq, hk, s, d, strides, chunk, n_splits,
                      n_sub, stream);
}

extern "C" int decode_attn_f32(const void* q, const void* k, const void* v,
                               const void* valid, const void* lo, void* out,
                               void* part_m, void* part_l, void* part_acc,
                               void* counter, int64_t b, int64_t hq,
                               int64_t hk, int64_t s, int64_t d,
                               const int64_t* strides,
                               int64_t chunk, int64_t n_splits,
                               int64_t n_sub, void* stream) {
  return launch<float>(q, k, v, valid, lo, out, part_m, part_l, part_acc,
                       counter, b, hq, hk, s, d, strides, chunk, n_splits,
                       n_sub, stream);
}
