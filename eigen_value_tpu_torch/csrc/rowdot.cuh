// One row of A @ x, computed by one full warp.  Shared by matvec.cu, round.cu
// and multiround.cu: these kernels reduce every row with this routine,
// wherever the row's bytes lie, so the v-sequence of a multiround solve is
// bit-identical to a loop of matvec launches (the contract eigen_value_tpu
// pins between its `vpu` multiround formulation and its matvec kernel).
//
// Fixed reduction order, no atomics:
//   * a row is cut into chunks (a float4 when the row length is a multiple
//     of 4, else a single float: the scalar path for any n, e.g. the 3x3
//     anchor); lane l takes chunks l, l+32, l+64, ...;
//   * a float4 chunk is first reduced on its own (an fmaf chain over its
//     four products), then added to one of four accumulators per lane:
//     chunk l + 32*i goes to accumulator i % 4, in increasing i;
//   * the four accumulators are combined as (s0 + s1) + (s2 + s3), and the
//     32 lane partials by a __shfl_xor_sync butterfly.  Float addition is
//     commutative, so after the butterfly every lane holds the same value.
// Few additions into each accumulator keep the f32 rounding small: a long
// chain of adds into one large sum drifts on smooth rows (Hilbert), where
// consecutive roundings lean the same way.  At n = 65536 an accumulator
// takes 128 adds here, where one per lane would take 2048.
#pragma once

#include <cuda_runtime.h>

namespace evt {

__device__ __forceinline__ float dot4(float4 a, float4 x) {
  return fmaf(a.w, x.w, fmaf(a.z, x.z, fmaf(a.y, x.y, a.x * x.x)));
}

// Where a row's values come from.  The order of the sums never depends on
// it: a row kept in shared memory, or read with an L2 eviction hint, gives
// the bits of the same row read plainly from device memory.
struct FromGlobal {  // read-only for the kernel's lifetime: the non-coherent path
  __device__ __forceinline__ float4 operator()(const float4* p) const { return __ldg(p); }
  __device__ __forceinline__ float operator()(const float* p) const { return __ldg(p); }
};

struct FromShared {  // a resident copy in the block's shared memory
  __device__ __forceinline__ float4 operator()(const float4* p) const { return *p; }
  __device__ __forceinline__ float operator()(const float* p) const { return *p; }
};

// Read-only device memory with an L2 eviction policy: `evict_last` for the
// part of A that a persistent kernel wants to find in L2 in its next round,
// `evict_first` for what only streams through (so that it does not push the
// first kind out).
struct FromGlobalHinted {
  unsigned long long policy;
  __device__ __forceinline__ float4 operator()(const float4* p) const {
    float4 v;
    asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p), "l"(policy));
    return v;
  }
  __device__ __forceinline__ float operator()(const float* p) const {
    float v;
    asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
                 : "=f"(v)
                 : "l"(p), "l"(policy));
    return v;
  }
};

__device__ __forceinline__ unsigned long long l2_evict_last() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// `a` is read through `load`; `x` may live in global or shared memory.
// With n % 4 == 0 both must be 16-byte aligned: the host wrappers check
// that.
template <class Load = FromGlobal>
__device__ __forceinline__ float row_dot(const float* __restrict__ a,
                                         const float* __restrict__ x, int n,
                                         int lane, Load load = Load()) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if ((n & 3) == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = n >> 2;
    int k = lane;
    // four independent loads in flight per lane, one per accumulator
    for (; k + 96 < n4; k += 128) {
      const float4 a0 = load(a4 + k), a1 = load(a4 + k + 32);
      const float4 a2 = load(a4 + k + 64), a3 = load(a4 + k + 96);
      s0 += dot4(a0, x4[k]);
      s1 += dot4(a1, x4[k + 32]);
      s2 += dot4(a2, x4[k + 64]);
      s3 += dot4(a3, x4[k + 96]);
    }
    // at most three chunks are left, in slots 0, 1, 2
    if (k < n4) s0 += dot4(load(a4 + k), x4[k]);
    if (k + 32 < n4) s1 += dot4(load(a4 + k + 32), x4[k + 32]);
    if (k + 64 < n4) s2 += dot4(load(a4 + k + 64), x4[k + 64]);
  } else {
    int k = lane;
    for (; k + 96 < n; k += 128) {
      s0 = fmaf(load(a + k), x[k], s0);
      s1 = fmaf(load(a + k + 32), x[k + 32], s1);
      s2 = fmaf(load(a + k + 64), x[k + 64], s2);
      s3 = fmaf(load(a + k + 96), x[k + 96], s3);
    }
    if (k < n) s0 = fmaf(load(a + k), x[k], s0);
    if (k + 32 < n) s1 = fmaf(load(a + k + 32), x[k + 32], s1);
    if (k + 64 < n) s2 = fmaf(load(a + k + 64), x[k + 64], s2);
  }
  float acc = (s0 + s1) + (s2 + s3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

}  // namespace evt
