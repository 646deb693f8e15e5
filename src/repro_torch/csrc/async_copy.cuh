// Asynchronous copies between device memory and shared memory on sm_90a,
// through inline PTX, for the kernels that stream their operands through a
// ring of shared-memory stages (trisolve.cu, diffusion.cu):
//  * mbarriers that count the bytes of a bulk copy (cp.async.bulk, the
//    Tensor Memory Accelerator's 1-D copy: one thread asks for a whole
//    contiguous chunk, 16-byte aligned, its size a multiple of 16);
//  * bulk stores from shared memory to device memory, tracked by bulk
//    groups;
//  * per-thread cp.async copies of 4, 8 or 16 bytes, tracked by commit
//    groups, for data that is not 16-byte aligned as a whole.
// Every helper is a thin wrapper around one PTX instruction, so a host
// build can replace this header with plain copies.
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace async_copy {

// The block's dynamic shared memory, 128-byte aligned.
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char smem[];
  return smem;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (the copy
// engine) and to the other threads after the next __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more bytes of copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// -- bulk copies (one thread issues each) -------------------------------------
// `bytes` of device memory at `src` into shared `dst`, completing on `bar`
// (the caller has announced the bytes with mbar_expect_tx).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}
// `bytes` of shared `src` into device memory at `dst`, in the current bulk
// group. The threads that wrote `src` run fence_async_shared() first, and a
// barrier orders their writes before this call.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until every bulk group of this thread has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's earlier shared-memory writes before later accesses
// of the async proxy (a bulk store reading them).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- per-thread cp.async ------------------------------------------------------
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(Bytes == 4 || Bytes == 8 || Bytes == 16, "4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "n"(Bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace async_copy
