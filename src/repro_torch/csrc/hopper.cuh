// PTX wrappers for Hopper (sm_90a) that the kernels share: mbarriers,
// the async-proxy fence, bulk and tensor (TMA) copies into shared memory,
// cp.async with mbarrier completion, the wgmma fence/commit/wait
// instructions, the shared-memory matrix descriptor, setmaxnreg and the
// programmatic dependent launch controls.  Header only: _build.py compiles the .cu files that include
// it and hashes it with them.
#pragma once

#include <cstdint>
#include <cuda.h>   // CUtensorMap (a type only: nothing links libcuda)

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make mbarrier.init visible to the other threads and the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects ``bytes`` of async copies on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase of parity ``parity`` has completed (a fresh
// barrier is in phase 0, so waiting on parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_LOOP;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------- async copies
// ``bytes`` contiguous bytes (a multiple of 16, both ends 16-byte
// aligned) from global into shared memory; completes on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box of a 4-D tensor map at (c0, c1, c2, c3), innermost first;
// out-of-bounds elements arrive as zeros; completes on ``bar``
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes global -> shared (both 16-byte aligned), bypassing L1
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// one arrival on ``bar`` once this thread's earlier cp.async are done
// (the barrier's count must include it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pin registers that an in-flight wgmma reads or writes: the compiler
// sees the asm that issues the wgmma, not its completion, so without this
// it may read an accumulator or reuse an A register before wgmma_wait
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// shared-memory matrix descriptor of an operand stored with the 128-byte
// swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start
// address, leading and stride byte offsets, layout type 1 (128B)
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p,
                                                   uint32_t lbo_bytes,
                                                   uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32
         | 1ull << 62;
}

// ---------------------------------------------------- register budgets
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// barrier ``id`` (1..15) over ``threads`` threads, whole warps
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// programmatic dependent launch: a grid launched after this one with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of this grid has called this (or exited)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// wait until the grid this one was launched after has completed and its
// stores are visible
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

}  // namespace hopper
