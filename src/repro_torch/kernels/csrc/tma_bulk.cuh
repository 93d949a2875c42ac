// Hopper's asynchronous bulk copy (TMA without a tensor map) and the
// shared-memory barriers (mbarrier) that report its completion, in PTX.
//
// A ring of stages in shared memory is filled by one producer thread and
// drained by consumer warps.  Each stage has two barriers:
//
// * full: initialised with a count of 1; the producer arrives once with
//   expect_tx(bytes) and issues the copy, whose bytes complete the phase as
//   they land;
// * empty: initialised with the consumers' count; each consumer arrives once
//   it no longer reads the stage, and the producer waits on it before it
//   fills the stage again.
//
// A barrier starts in phase 0; waiting with parity P returns once the phase
// of parity P has completed.  The u-th use of a stage (u = 0, 1, ...) waits
// on full with parity u & 1, and the producer's refill for use u >= 1 waits
// on empty with parity (u - 1) & 1.
//
// A bulk copy needs a 16-byte-aligned source and destination and a size
// that is a multiple of 16 bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises; the fence makes the barriers visible to the
// asynchronous proxy, and a __syncthreads() after it to the other threads.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` from global memory to this CTA's shared memory; the bytes
// complete on `bar`.  (bulk_copy_g2s_evict_first, below: the same with an
// L2 evict-first hint, for data streamed once.)
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s_evict_first(void* dst, const void* src,
                                                          uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
