// One row's sum, computed by one full warp, over values the caller
// produces chunk by chunk.  Shared by rowsum.cu (the values are A's own, or
// A + bias) and scale.cu (the values are the scaled entries it has just
// stored), so the three summing kernels reduce in one order.
//
// The order is rowdot.cuh's, term for term:
//   * a row is cut into chunks (a float4 when the row length is a multiple
//     of 4, else a single float: the scalar path for any n, e.g. the 3x3
//     anchor); lane l takes chunks l, l+32, l+64, ...;
//   * a float4 chunk is first summed on its own, ((x + y) + z) + w, then
//     added to one of four accumulators per lane: chunk l + 32*i goes to
//     accumulator i % 4, in increasing i;
//   * the four accumulators are combined as (s0 + s1) + (s2 + s3), and the
//     32 lane partials by a __shfl_xor_sync butterfly.
// With x = 1 every fmaf(a, 1, s) of evt::row_dot is the plain sum a + s, so
// rowsum(A) equals matvec(A, ones) bit for bit: the iterated solve's first
// row sums are the power form's.
//
// Every addition is an explicit __fadd_rn.  The compiler contracts
// `a * s + acc` into one fmaf, which would sum the unrounded product; the
// callers that multiply use __fmul_rn, and the sums here can then never be
// fused with them: what is summed is what was stored.
#pragma once

#include <cuda_runtime.h>

namespace evt {

__device__ __forceinline__ float sum4(float4 c) {
  return __fadd_rn(__fadd_rn(__fadd_rn(c.x, c.y), c.z), c.w);
}

// `load4(k)` reads the k-th float4 of the row (called when n % 4 == 0,
// k < n/4) and `map4(k, raw)` turns it into the values to sum; `load1` and
// `map1` do the same for single floats (otherwise, k < n).  Each index is
// asked for exactly once, by the lane that owns it, so a map may also store
// what it returns.  The loads of a step are issued before its maps: four
// stay in flight per lane even when a map's store may alias the next load
// (an in-place update).  All 32 lanes must call; all get the sum.
template <class Load4, class Map4, class Load1, class Map1>
__device__ __forceinline__ float row_reduce(int n, int lane, Load4 load4,
                                            Map4 map4, Load1 load1, Map1 map1) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if ((n & 3) == 0) {
    const int n4 = n >> 2;
    int k = lane;
    for (; k + 96 < n4; k += 128) {
      const float4 r0 = load4(k), r1 = load4(k + 32);
      const float4 r2 = load4(k + 64), r3 = load4(k + 96);
      s0 = __fadd_rn(s0, sum4(map4(k, r0)));
      s1 = __fadd_rn(s1, sum4(map4(k + 32, r1)));
      s2 = __fadd_rn(s2, sum4(map4(k + 64, r2)));
      s3 = __fadd_rn(s3, sum4(map4(k + 96, r3)));
    }
    // at most three chunks are left, in slots 0, 1, 2
    if (k < n4) s0 = __fadd_rn(s0, sum4(map4(k, load4(k))));
    if (k + 32 < n4) s1 = __fadd_rn(s1, sum4(map4(k + 32, load4(k + 32))));
    if (k + 64 < n4) s2 = __fadd_rn(s2, sum4(map4(k + 64, load4(k + 64))));
  } else {
    int k = lane;
    for (; k + 96 < n; k += 128) {
      const float r0 = load1(k), r1 = load1(k + 32);
      const float r2 = load1(k + 64), r3 = load1(k + 96);
      s0 = __fadd_rn(s0, map1(k, r0));
      s1 = __fadd_rn(s1, map1(k + 32, r1));
      s2 = __fadd_rn(s2, map1(k + 64, r2));
      s3 = __fadd_rn(s3, map1(k + 96, r3));
    }
    if (k < n) s0 = __fadd_rn(s0, map1(k, load1(k)));
    if (k + 32 < n) s1 = __fadd_rn(s1, map1(k + 32, load1(k + 32)));
    if (k + 64 < n) s2 = __fadd_rn(s2, map1(k + 64, load1(k + 64)));
  }
  float acc = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

}  // namespace evt
