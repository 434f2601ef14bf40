// The similarity update A'[r][c] = A[r][c] * ((1 / v[r]) * v[c]) in float32,
// alone (`scale`) and fused with the next round's row sums
// v'[r] = sum_c A'[r][c] (`scale_rowsum`): the per-round pass of the
// iterated (mutate-A) solve, one read and one write of A.
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `scale` / `_scale_kernel`
// and `scale_rowsum` / `_scale_rowsum_kernel` (each a (row-block x
// col-block) grid, A aliased to its output; the fused one with a VMEM
// row-sum accumulator revisited across the column blocks).
//
// Bound on the H100: bytes.  Two multiplies (and one add) per element
// against 8 bytes moved, so a call costs at least one read and one write of
// A (2*n*n*4 bytes) at device-memory bandwidth; v is 4n bytes and stays in
// L1/L2.
//
// Design: one warp per row, so 1/v[r] is computed once per row and the sum
// of a row needs no second pass and no atomics.  `out` may be A itself (in
// place) or another buffer: each element is read and written by the same
// lane, and A is read through ordinary loads, never the read-only path,
// because the kernel may be writing the memory it reads.  v is only read
// (v' is a different buffer: every warp reads all of v while others finish
// their rows), so it does go through __ldg.
//
// Arithmetic: a true IEEE reciprocal and two rounded products,
// right-associated as in the reference, by __fdiv_rn / __fmul_rn, which the
// compiler never contracts into an fmaf.  The fused kernel sums the values
// it stored (evt::row_reduce, __fadd_rn only), so scale_rowsum's v' equals
// rowsum(scale(A, v)) bit for bit and its A' equals scale's.
#include <cuda_runtime.h>

#include "rowsum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float scaled(float a, float inv, float vc) {
  return __fmul_rn(a, __fmul_rn(inv, vc));
}

template <bool kSum>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const float* A, const float* __restrict__ v, float* out,
                 float* __restrict__ v_out, int n) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(row) * n;
  const float* a = A + base;
  float* o = out + base;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* o4 = reinterpret_cast<float4*>(o);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float inv = __fdiv_rn(1.0f, __ldg(v + row));
  const float s = evt::row_reduce(
      n, lane, [&](int k) { return a4[k]; },
      [&](int k, float4 c) {
        const float4 f = __ldg(v4 + k);
        const float4 r = make_float4(scaled(c.x, inv, f.x), scaled(c.y, inv, f.y),
                                     scaled(c.z, inv, f.z), scaled(c.w, inv, f.w));
        o4[k] = r;
        return r;
      },
      [&](int k) { return a[k]; },
      [&](int k, float e) {
        const float r = scaled(e, inv, __ldg(v + k));
        o[k] = r;
        return r;
      });
  if (kSum && lane == 0) v_out[row] = s;
}

template <bool kSum>
int launch(const float* A, const float* v, float* out, float* v_out, int n,
           void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  scale_kernel<kSum><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, v, out, v_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A and out (n, n) row-major (out may be A), v and v_out (n,) (v_out must
// not be v), all float32 on the current device.  Launch on `stream` without
// synchronising; return the launch's cudaError_t (0 on success).
extern "C" int evt_scale(const float* A, const float* v, float* out, int n,
                         void* stream) {
  return launch<false>(A, v, out, nullptr, n, stream);
}

extern "C" int evt_scale_rowsum(const float* A, const float* v, float* out,
                                float* v_out, int n, void* stream) {
  return launch<true>(A, v, out, v_out, n, stream);
}
