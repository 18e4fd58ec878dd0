// Hopper's bulk async copy (global -> shared, no tensor map) completed on
// an mbarrier: the card's counterpart of the TPU kernels'
// pltpu.make_async_copy + DMA semaphore. One thread arms the barrier with
// the bytes it expects and issues the copies; every thread that reads the
// data waits on the barrier's phase. Shared by csrc/dma_probe.cu (P1-P3)
// and the compositing kernels' rings (K1-K4, tiles_common.cuh).
#pragma once

#include <stdint.h>

namespace c3dgs {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: a barrier that completes after `count` arrivals (and the
// bytes armed by expect_tx)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// after mbar_init, before any copy completes on the barrier: make the
// initialized barrier visible to the copy engine (the async proxy)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the issuing thread's arrival, arming the barrier with `bytes` to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase `parity` (0 for its first use, then
// alternating) has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// order this thread's earlier accesses of shared memory (ordered across the
// block by a barrier) before the copy engine's next writes into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// copy `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned; completion counts against `bar`'s armed bytes
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace c3dgs
