// One-dimensional bulk copies (cp.async.bulk, the TMA without a tensor
// map) from global into shared memory, completing on an mbarrier, for
// sm_90a: the attention template (ring_partial.cuh) and the int4 probe
// (int4_probe.cu) stage their rows with them. A copy's source, destination
// and size are multiples of 16 bytes; the thread that arms the barrier
// (mbar_expect_tx) starts the copies, and every thread that reads the
// stage waits on the barrier's phase (mbar_wait).

#pragma once

#include <stdint.h>

static __device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

static __device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 unsigned bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
