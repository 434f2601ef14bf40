// Bulk copies from device memory into shared memory that complete on an
// mbarrier (the Tensor Memory Accelerator, sm_90: the 1-D form for a
// contiguous run of bytes, the 2-D form for a box of a matrix described by
// a tensor map), and the barrier operations around them.  Shared by multiround.cu and
// multiround_sym.cu, whose 2-byte rings stream A through them.
//
// A copy of `bytes` (a multiple of 16, both addresses 16-byte aligned) is
// counted on its barrier by `mbar_expect` (one arrival that also expects the
// bytes) and lands without a register or an instruction of the issuing
// thread; a wait on the barrier's phase makes the bytes visible to the
// threads that waited.  The L2 policy is the one a plain load would use
// (rowdot.cuh l2_evict_last / l2_evict_first).
#pragma once

#include <cuda_runtime.h>

namespace evt {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One arrival completes a phase (plus the bytes of its copies).
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// After the initialisations, before any thread or copy uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A copy that
// never lands (a fault of the kernel) traps after some 2^26 tries, seconds,
// rather than hold the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Orders this thread's earlier reads of shared memory (the generic proxy)
// before the bulk copies it issues next into the same bytes (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar,
                                          unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// The 2-D tile of a tensor map (`tmap`, a __grid_constant__ parameter)
// whose first element is column x, row y, into `dst` (128-byte aligned) in
// the map's box layout: its rows one after another.
// Asks the L2 for `bytes` (a multiple of 16) of device memory from src on,
// with an L2 policy; nothing waits for it.  The copy engine takes 16-byte
// units, so where src is only 8-byte aligned (a row of a 2-byte A) the unit
// that holds it is the first one asked for.
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, unsigned bytes,
                                                 unsigned long long policy) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(src);
  asm volatile("cp.async.bulk.prefetch.L2.global.L2::cache_hint [%0], %1, %2;" ::"l"(a & ~15ull),
               "r"(bytes + (a & 15u ? 16u : 0u)), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void tensor_copy_2d(void* dst, const void* tmap, int x, int y,
                                               unsigned long long* bar,
                                               unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(tmap)), "r"(x), "r"(y), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}

}  // namespace evt
