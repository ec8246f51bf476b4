// Decode attention: one query token per (b, q-head) against a KV cache
// [B, Hk, S, D], slots >= valid_len[b] masked.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn/kernel.py
// (_decode_kernel / decode_attention).  The TPU version walks the cache's
// KV blocks as a sequential grid axis per (b, head), carrying m, l and the
// accumulator in VMEM scratch, and skips blocks past valid_len.  On Hopper
// a sequential walk per (b, head) would leave most of the 132 SMs idle at
// serving batch sizes, so the cache is split along S (FlashDecoding): one
// block per (split, b, KV head) walks its share in 64-slot tiles and
// writes a partial (m, l, acc); a small second kernel merges the partials
// of each (b, q-head).
//
// Bound on an H100: bytes.  At the serving path's decode (B 8, Hk 8,
// D 128, bf16, valid_len ~2112) the kernel must read 2*B*Hk*valid_len*D*2
// = 69 MB of cache, 0.021 ms at 3.35 TB/s, for ~1 FLOP per byte.  The
// design reads each cache byte once: one block serves the whole GQA group
// of Hq/Hk query heads (the TPU route repeats K/V per q-head), tiles past
// valid_len are never loaded, and K/V tiles are staged with 16-byte loads.
// This is a first version: a block's loads are not overlapped with its own
// arithmetic (other resident blocks hide the latency instead).
//
// Semantics, as the TPU kernel: q upcast to f32 and scaled by D^-0.5,
// scores and statistics in f32, output acc / max(l, 1e-30) in q's dtype;
// valid_len 0 gives zeros.  valid_len is clamped to [0, S].
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;     // 4 warps
constexpr int kMaxG = 8;          // q-heads per KV head
constexpr int kMaxD = 128;
constexpr int kLd = kMaxD + 8;    // row stride (elements) of the K/V tiles
constexpr int kMaxOwn = kMaxG * kMaxD / kThreads;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* valid;
  float* part_m;                  // [B, Hq, n_splits]
  float* part_l;                  // [B, Hq, n_splits]
  float* part_acc;                // [B, Hq, n_splits, D]
  int64_t q_sb, q_sh;             // element strides of q [B, Hq, D]
  int64_t k_sb, k_sh, k_ss;       // of the caches [B, Hk, S, D]
  int64_t v_sb, v_sh, v_ss;
  int hq, hk, s, d, chunk, n_splits;
  float scale;
  int vec;                        // 16-byte loads are aligned
};

template <typename T> struct TileRows { static constexpr int value = 64; };
template <> struct TileRows<float> { static constexpr int value = 32; };

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
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// rows [0, rows_valid) of a [kRows, d] tile into shared memory (row
// stride kLd), the rest zero: a slot past valid_len never brings a
// non-finite value into the sums.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(Params p) {
  constexpr int R = TileRows<T>::value;
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(16) T ks[R * kLd];
  __shared__ __align__(16) T vs[R * kLd];
  __shared__ float qs[kMaxG * kMaxD];
  __shared__ float ps[kMaxG * R];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g_n = p.hq / p.hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vl = max(0, min(p.valid[b], p.s));
  const int s0 = split * p.chunk;
  const int s1 = min(s0 + p.chunk, vl);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
  for (int i = tid; i < g_n * p.d; i += kThreads) {
    const int g = i / p.d, dd = i - g * p.d;
    qs[g * kMaxD + dd] = to_f(qg[(kvh * g_n + g) * p.q_sh + dd]) * p.scale;
  }
  if (tid < g_n) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int n_pairs = g_n * p.d;      // (head, dim) accumulators
  float acc[kMaxOwn];
#pragma unroll
  for (int o = 0; o < kMaxOwn; ++o) acc[o] = 0.f;

  for (int t0 = s0; t0 < s1; t0 += R) {
    const int rows = min(R, s1 - t0);
    __syncthreads();                      // last tile's readers are done
    load_tile<T, R>(ks, kg + static_cast<int64_t>(t0) * p.k_ss, p.k_ss,
                    rows, p.d, p.vec);
    load_tile<T, R>(vs, vg + static_cast<int64_t>(t0) * p.v_ss, p.v_ss,
                    rows, p.d, p.vec);
    __syncthreads();

    // scores of every (head, slot) of the tile
    for (int i = tid; i < g_n * R; i += kThreads) {
      const int g = i / R, r = i - g * R;
      const float* qv = qs + g * kMaxD;
      float dot = 0.f;
      for (int dd = 0; dd < p.d; dd += kVec) {
        float kf[kVec];
        unpack(*reinterpret_cast<const uint4*>(ks + r * kLd + dd), kf, ks);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot += qv[dd + e] * kf[e];
      }
      ps[g * R + r] = dot;
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int g = warp; g < g_n; g += kThreads / 32) {
      float mloc = kNegInf;
      for (int r = lane; r < rows; r += 32) mloc = fmaxf(mloc, ps[g * R + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mloc);
      float sum = 0.f;
      for (int r = lane; r < R; r += 32) {
        const float pr = r < rows ? expf(ps[g * R + r] - m_new) : 0.f;
        ps[g * R + r] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's (head, dim) pairs
#pragma unroll
    for (int o = 0; o < kMaxOwn; ++o) {
      const int idx = tid + o * kThreads;
      if (idx < n_pairs) {
        const int g = idx / p.d, dd = idx - g * p.d;
        float a = acc[o] * alpha_s[g];
        for (int r = 0; r < rows; ++r) {
          a += ps[g * R + r] * to_f(vs[r * kLd + dd]);
        }
        acc[o] = a;
      }
    }
  }
  __syncthreads();

  const int64_t head0 = static_cast<int64_t>(b) * p.hq + kvh * g_n;
#pragma unroll
  for (int o = 0; o < kMaxOwn; ++o) {
    const int idx = tid + o * kThreads;
    if (idx < n_pairs) {
      const int g = idx / p.d, dd = idx - g * p.d;
      p.part_acc[((head0 + g) * p.n_splits + split) * p.d + dd] = acc[o];
    }
  }
  if (tid < g_n) {
    p.part_m[(head0 + tid) * p.n_splits + split] = m_s[tid];
    p.part_l[(head0 + tid) * p.n_splits + split] = l_s[tid];
  }
}

// merge the n_splits partials of one (b, q-head)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* part_m, const float* part_l,
                      const float* part_acc, T* out, int64_t o_sb,
                      int64_t o_sh, int hq, int d, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t base = (static_cast<int64_t>(b) * hq + h) * n_splits;
  float mx = kNegInf;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, part_m[base + i]);
  float l = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    l += part_l[base + i] * expf(part_m[base + i] - mx);
  }
  const float denom = fmaxf(l, 1e-30f);
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i) {
      a += part_acc[(base + i) * d + dd] * expf(part_m[base + i] - mx);
    }
    out[b * o_sb + h * o_sh + dd] = from_f<T>(a / denom);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, void* part_m, void* part_l, void* part_acc, int64_t b,
           int64_t hq, int64_t hk, int64_t s, int64_t d,
           const int64_t* st, int64_t chunk, int64_t n_splits,
           void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const int32_t*>(valid);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_acc = static_cast<float*>(part_acc);
  p.q_sb = st[0];
  p.q_sh = st[1];
  p.k_sb = st[2];
  p.k_sh = st[3];
  p.k_ss = st[4];
  p.v_sb = st[5];
  p.v_sh = st[6];
  p.v_ss = st[7];
  p.hq = static_cast<int>(hq);
  p.hk = static_cast<int>(hk);
  p.s = static_cast<int>(s);
  p.d = static_cast<int>(d);
  p.chunk = static_cast<int>(chunk);
  p.n_splits = static_cast<int>(n_splits);
  p.scale = static_cast<float>(std::pow(static_cast<double>(d), -0.5));
  bool vec = aligned16(k) && aligned16(v)
             && (d * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  for (int i = 2; i < 8; ++i) {
    vec = vec && (st[i] * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  }
  p.vec = vec;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(n_splits), static_cast<unsigned>(hk),
            static_cast<unsigned>(b));
  decode_split_kernel<T><<<grid, kThreads, 0, st_>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2(static_cast<unsigned>(hq), static_cast<unsigned>(b));
  decode_combine_kernel<T><<<grid2, kThreads, 0, st_>>>(
      p.part_m, p.part_l, p.part_acc, static_cast<T*>(out), st[8], st[9],
      p.hq, p.d, p.n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 10 int64 element strides: q (batch, head), k and v (batch,
// head, slot), out (batch, head).  Scratch part_m/part_l [B, Hq, n_splits]
// and part_acc [B, Hq, n_splits, D] are float32.
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const void* valid, void* out, void* part_m,
                                void* part_l, void* part_acc, int64_t b,
                                int64_t hq, int64_t hk, int64_t s, int64_t d,
                                const int64_t* strides, int64_t chunk,
                                int64_t n_splits, void* stream) {
  return launch<bf16>(q, k, v, valid, out, part_m, part_l, part_acc, b, hq,
                      hk, s, d, strides, chunk, n_splits, stream);
}

extern "C" int decode_attn_f32(const void* q, const void* k, const void* v,
                               const void* valid, void* out, void* part_m,
                               void* part_l, void* part_acc, int64_t b,
                               int64_t hq, int64_t hk, int64_t s, int64_t d,
                               const int64_t* strides, int64_t chunk,
                               int64_t n_splits, void* stream) {
  return launch<float>(q, k, v, valid, out, part_m, part_l, part_acc, b, hq,
                       hk, s, d, strides, chunk, n_splits, stream);
}
