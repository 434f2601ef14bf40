// One row of A @ x, computed by one full warp.  Shared by matvec.cu, round.cu
// and multiround.cu: these kernels reduce every row with this routine,
// wherever the row's bytes lie, so the v-sequence of a multiround solve is
// bit-identical to a loop of matvec launches (the contract eigen_value_tpu
// pins between its `vpu` multiround formulation and its matvec kernel).
//
// Fixed reduction order, no atomics:
//   * a row is cut into chunks (four elements when the row length is a
//     multiple of 4, else a single one: the scalar path for any n, e.g. the
//     3x3 anchor); lane l takes chunks l, l+32, l+64, ...;
//   * a chunk of four is first reduced on its own (an fmaf chain over its
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace evt {

__device__ __forceinline__ float dot4(float4 a, float4 x) {
  return fmaf(a.w, x.w, fmaf(a.z, x.z, fmaf(a.y, x.y, a.x * x.x)));
}

// The types A may be stored in.  A chunk is four elements, loaded as one
// `Chunk` (16 bytes of f32, 8 bytes of bf16 or f16); a lone element (the
// scalar path) is a `Bits`.  `up` gives them as f32, exactly: every bf16 and
// every f16 value is an f32 value.  So a row of a 2-byte A goes through the
// same chunks, lanes, accumulators and fmaf chains as the f32 row of its
// values, and gives the same bits (reduced-precision storage: A in 2 bytes,
// every product and sum in f32 with the f32 ev).
template <class T>
struct Elem;

template <>
struct Elem<float> {
  using Chunk = float4;
  using Bits = float;
  static __device__ __forceinline__ float4 up(float4 c) { return c; }
  static __device__ __forceinline__ float up(float b) { return b; }
};

template <>
struct Elem<__nv_bfloat16> {  // a bf16 is the top half of its f32
  using Chunk = uint2;
  using Bits = unsigned short;
  static __device__ __forceinline__ float4 up(uint2 c) {
    return make_float4(__uint_as_float(c.x << 16), __uint_as_float(c.x & 0xffff0000u),
                       __uint_as_float(c.y << 16), __uint_as_float(c.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float up(unsigned short b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
};

template <>
struct Elem<__half> {
  using Chunk = uint2;
  using Bits = unsigned short;
  static __device__ __forceinline__ float up(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ float4 up(uint2 c) {
    return make_float4(up(static_cast<unsigned short>(c.x & 0xffffu)),
                       up(static_cast<unsigned short>(c.x >> 16)),
                       up(static_cast<unsigned short>(c.y & 0xffffu)),
                       up(static_cast<unsigned short>(c.y >> 16)));
  }
};

// Where a row's values come from.  The order of the sums never depends on
// it: a row kept in shared memory, or read with an L2 eviction hint, gives
// the bits of the same row read plainly from device memory.  The policies
// load raw chunks and elements; Elem<T>::up converts them.
struct FromGlobal {  // read-only for the kernel's lifetime: the non-coherent path
  __device__ __forceinline__ float4 operator()(const float4* p) const { return __ldg(p); }
  __device__ __forceinline__ float operator()(const float* p) const { return __ldg(p); }
  __device__ __forceinline__ uint2 operator()(const uint2* p) const { return __ldg(p); }
  __device__ __forceinline__ unsigned short operator()(const unsigned short* p) const {
    return __ldg(p);
  }
};

struct FromShared {  // a resident copy in the block's shared memory
  template <class C>
  __device__ __forceinline__ C operator()(const C* p) const { return *p; }
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
  __device__ __forceinline__ uint2 operator()(const uint2* p) const {
    uint2 v;
    asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
                 : "=r"(v.x), "=r"(v.y)
                 : "l"(p), "l"(policy));
    return v;
  }
  __device__ __forceinline__ unsigned short operator()(const unsigned short* p) const {
    unsigned short v;
    asm volatile("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
                 : "=h"(v)
                 : "l"(p), "l"(policy));
    return v;
  }
};

// FromGlobalHinted for the dot formulation's reads, which take 64 bytes of
// a row at a time (16 rows a warp): each load also asks the L2 to fetch the
// kBytes-byte unit around it from device memory (ld's prefetch-size hint),
// so the row's next pieces are found there.  The unit is the kernel's
// choice (measured at 8192^2: 128 for the stripes, 256 for the tiles).
template <int kBytes>
struct FromGlobalAhead {
  static_assert(kBytes == 128 || kBytes == 256, "an L2 prefetch size of 128 or 256 bytes");
  unsigned long long policy;
  __device__ __forceinline__ float4 operator()(const float4* p) const {
    float4 v;
    if constexpr (kBytes == 128)
      asm volatile("ld.global.nc.L2::cache_hint.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "l"(p), "l"(policy));
    else
      asm volatile("ld.global.nc.L2::cache_hint.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "l"(p), "l"(policy));
    return v;
  }
  __device__ __forceinline__ uint2 operator()(const uint2* p) const {
    uint2 v;
    if constexpr (kBytes == 128)
      asm volatile("ld.global.nc.L2::cache_hint.L2::128B.v2.u32 {%0, %1}, [%2], %3;"
                   : "=r"(v.x), "=r"(v.y)
                   : "l"(p), "l"(policy));
    else
      asm volatile("ld.global.nc.L2::cache_hint.L2::256B.v2.u32 {%0, %1}, [%2], %3;"
                   : "=r"(v.x), "=r"(v.y)
                   : "l"(p), "l"(policy));
    return v;
  }
};

// The element type codes of the C entries (kernels.py `_ELEM`), and a call
// of `f(Tag<T>())` with the type a code names; an unknown code gives
// cudaErrorInvalidValue.
template <class T>
struct Tag {
  using type = T;
};

template <class F>
int with_elem(int code, F f) {
  switch (code) {
    case 0: return f(Tag<float>());
    case 1: return f(Tag<__nv_bfloat16>());
    case 2: return f(Tag<__half>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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

// The end of a row: the four accumulators of a lane, then the 32 lane
// partials by the butterfly; every lane gets the row's sum.
__device__ __forceinline__ float row_finish(float s0, float s1, float s2, float s3) {
  float acc = (s0 + s1) + (s2 + s3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// `a` (element type T) is read through `load`; `x` may live in global or
// shared memory.  With n % 4 == 0 `x` must be 16-byte aligned and `a` must
// be aligned to its chunk (16 bytes for f32, 8 for bf16 / f16): the host
// wrappers check that.
template <class T = float, class Load = FromGlobal>
__device__ __forceinline__ float row_dot(const T* __restrict__ a,
                                         const float* __restrict__ x, int n,
                                         int lane, Load load = Load()) {
  using E = Elem<T>;
  using Chunk = typename E::Chunk;
  using Bits = typename E::Bits;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if ((n & 3) == 0) {
    const Chunk* a4 = reinterpret_cast<const Chunk*>(a);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = n >> 2;
    int k = lane;
    if constexpr (sizeof(Chunk) < sizeof(float4)) {
      // a 2-byte chunk is 8 bytes: eight loads in flight per lane keep as
      // many bytes in flight as four f32 chunks.  Chunk l + 32*i still goes
      // to accumulator i % 4, in increasing i: the f32 order.
      for (; k + 224 < n4; k += 256) {
        Chunk c[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) c[u] = load(a4 + k + 32 * u);
        s0 += dot4(E::up(c[0]), x4[k]);
        s1 += dot4(E::up(c[1]), x4[k + 32]);
        s2 += dot4(E::up(c[2]), x4[k + 64]);
        s3 += dot4(E::up(c[3]), x4[k + 96]);
        s0 += dot4(E::up(c[4]), x4[k + 128]);
        s1 += dot4(E::up(c[5]), x4[k + 160]);
        s2 += dot4(E::up(c[6]), x4[k + 192]);
        s3 += dot4(E::up(c[7]), x4[k + 224]);
      }
    }
    // four independent loads in flight per lane, one per accumulator
    for (; k + 96 < n4; k += 128) {
      const Chunk a0 = load(a4 + k), a1 = load(a4 + k + 32);
      const Chunk a2 = load(a4 + k + 64), a3 = load(a4 + k + 96);
      s0 += dot4(E::up(a0), x4[k]);
      s1 += dot4(E::up(a1), x4[k + 32]);
      s2 += dot4(E::up(a2), x4[k + 64]);
      s3 += dot4(E::up(a3), x4[k + 96]);
    }
    // at most three chunks are left, in slots 0, 1, 2
    if (k < n4) s0 += dot4(E::up(load(a4 + k)), x4[k]);
    if (k + 32 < n4) s1 += dot4(E::up(load(a4 + k + 32)), x4[k + 32]);
    if (k + 64 < n4) s2 += dot4(E::up(load(a4 + k + 64)), x4[k + 64]);
  } else {
    const Bits* ab = reinterpret_cast<const Bits*>(a);
    int k = lane;
    for (; k + 96 < n; k += 128) {
      s0 = fmaf(E::up(load(ab + k)), x[k], s0);
      s1 = fmaf(E::up(load(ab + k + 32)), x[k + 32], s1);
      s2 = fmaf(E::up(load(ab + k + 64)), x[k + 64], s2);
      s3 = fmaf(E::up(load(ab + k + 96)), x[k + 96], s3);
    }
    if (k < n) s0 = fmaf(E::up(load(ab + k)), x[k], s0);
    if (k + 32 < n) s1 = fmaf(E::up(load(ab + k + 32)), x[k + 32], s1);
    if (k + 64 < n) s2 = fmaf(E::up(load(ab + k + 64)), x[k + 64], s2);
  }
  return row_finish(s0, s1, s2, s3);
}

// One segment of a row whose chunks base .. base + cnt - 1 (base a multiple
// of kSegChunks, cnt <= kSegChunks) lie in shared memory from `seg` on: a
// stage of the persistent kernels' bulk-copy rings.  Lane l adds chunk
// base + l + 32u to accumulator u, which is where row_dot puts it (chunk
// l + 32i goes to accumulator i % 4, base / 32 being a multiple of 4), and
// a row's segments come in increasing order: the accumulators of a row
// read segment by segment hold the bits of row_dot's.
constexpr int kSegChunks = 128;

template <class T>
__device__ __forceinline__ void seg_dot(const typename Elem<T>::Chunk* seg,
                                        const float4* __restrict__ x4, int cnt, int lane,
                                        float& s0, float& s1, float& s2, float& s3) {
  using E = Elem<T>;
  if (cnt == kSegChunks) {
    const auto c0 = seg[lane], c1 = seg[lane + 32], c2 = seg[lane + 64], c3 = seg[lane + 96];
    s0 += dot4(E::up(c0), x4[lane]);
    s1 += dot4(E::up(c1), x4[lane + 32]);
    s2 += dot4(E::up(c2), x4[lane + 64]);
    s3 += dot4(E::up(c3), x4[lane + 96]);
  } else {
    if (lane < cnt) s0 += dot4(E::up(seg[lane]), x4[lane]);
    if (lane + 32 < cnt) s1 += dot4(E::up(seg[lane + 32]), x4[lane + 32]);
    if (lane + 64 < cnt) s2 += dot4(E::up(seg[lane + 64]), x4[lane + 64]);
    if (lane + 96 < cnt) s3 += dot4(E::up(seg[lane + 96]), x4[lane + 96]);
  }
}

}  // namespace evt
