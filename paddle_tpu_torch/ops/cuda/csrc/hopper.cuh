// Hopper (sm_90a) pieces shared by the kernels built from TMA copies,
// mbarriers and wgmma: fused_xent.cu (K2's forms) and the flash sources'
// head widths 192 and 256 (flash_wide.cuh, flash_short.cu). One copy of
// each: the phase waits that trap instead of hanging the card, the TMA
// boxes, the wgmma descriptor and group fences, named barriers, and the
// tensor-map encoder, looked up through the CUDA runtime.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a wait this long on one mbarrier is a hang: trap instead of holding
// the card
constexpr uint64_t kHangNs = 10000000000ull;

// mbarriers: ``count`` arrivals (the f32 form: one, the thread that
// starts the copies) plus the bytes the copies bring (expect_tx)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one try of a phase wait; CLUSTER: acquire at cluster scope, for bytes
// that peers' st.async completed on this CTA's barrier
template <bool CLUSTER>
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  if constexpr (CLUSTER)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// the 2-byte kernels' phase wait: a wait past kHangNs traps (a launch
// failure the wrapper reports) rather than hanging the card
template <bool CLUSTER = false>
__device__ __forceinline__ void ws_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try<CLUSTER>(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try<CLUSTER>(bar, parity))
    if (global_ns() - t0 > kHangNs) __trap();
}

// a 64 x 64 box (columns c0 .., rows r0 ..) of a tensor map into shared
// memory; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

// a box of a 1-D tensor map into shared memory (zeros past its end)
__device__ __forceinline__ void tma_row(uint32_t dst, const CUtensorMap* map,
                                        int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup's D (64 x N, f32, N / 2 registers a thread,
// warp k of the group holding rows 16 k .., the m16n8 C layout for each 8
// columns) += A (64 x 16) B (16 x N), B from shared memory through a
// descriptor (start address, leading and stride byte offsets in 16-byte
// units, 128-byte swizzle), A from shared memory the same way or from
// registers (the m16n8k16 A fragment of the warp's 16 rows).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed groups are pending
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins accumulator registers in place around a run of wgmma, so that the
// compiler moves none of them between two wgmma (which would serialize
// them)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads, before the barrier that publishes them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}


// cuTensorMapEncodeTiled, looked up through the CUDA runtime (so the
// library needs no link against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static void* fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
  }
  return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
}

// a 4-D box of a tensor map (coordinates c0 .. c3, innermost first) into
// shared memory; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_box4(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Named barriers (1 .. 15; 0 is __syncthreads) over ``n`` threads, a
// multiple of 32: sync waits for all of them, arrive counts this thread
// and goes on. Both order the thread's shared-memory accesses before it.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace
