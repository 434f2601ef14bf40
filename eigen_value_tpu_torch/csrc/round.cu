// One round of the matvec-form solve in one launch, in float32:
//
//   round_matvec:  ev' = ev * (v / m);  v' = (A @ ev') / ev'
//   round_fused:   m = max(v);  done = all_k |v[k] - v[(k+1) % n]| < eps;
//                  lambda = v[0];  then the same ev' and v'
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `round_matvec` /
// `_round_matvec_kernel` and `round_fused` / `_round_fused_kernel` (a
// sequential (row-block x col-block) grid that forms the updated ev chunk
// at every step, accumulates in VMEM across the column blocks and, in the
// fused kernel, writes max / done / lambda to SMEM scalars at grid step
// (0, 0) for every later step to read).
//
// Bound on the H100: bytes.  2 flops per 4-byte element of A, so a call
// costs at least one read of A (n*n*4 bytes) at device-memory bandwidth;
// ev, v and the two results are O(n).
//
// Design: both kernels are one template.  CUDA blocks run in no order, so
// nothing can be handed from a first grid step to the others, and no block
// may read an ev' that another block is still writing.  Every block
// therefore forms all of ev' itself, into its own shared memory, from the
// inputs ev, v and m, which no one writes during the launch; the fused
// kernel first reduces max(v) in every block (max is exact in any order,
// so all blocks get the same bits; NaN propagates as in torch.max), and
// block 0 alone writes done and lambda.  That is the O(n) prologue of
// multiround.cu for a single round, with no cooperative launch and no grid
// barrier.  ev' goes out to device memory from the shared copy, each
// element by exactly one thread of the grid.
//
// Bit identities: the update is __fmul_rn(ev, __fdiv_rn(v, m)), two rounded
// operations that no contraction can fuse, and every row is reduced by
// evt::row_dot, the matvec kernel's routine, then divided once.  So
// ev' == ev * (v / m) and v' == matvec(A, ev') / ev' bit for bit, and
// round_fused equals round_matvec with m = max(v).  v' and ev' are written
// even when done.
//
// Limit: ev' (n floats) must fit one block's shared memory, n <= 57856 on
// an H100, the multiround kernel's limit.  The wrappers raise above it.
#include <cuda_runtime.h>

#include <math.h>

#include "prologue.cuh"
#include "rowdot.cuh"

namespace {

using evt::kThreads;
using evt::kWarps;

template <bool kFused>
__global__ void __launch_bounds__(kThreads) round_kernel(
    const float* __restrict__ A, const float* __restrict__ ev,
    const float* __restrict__ v, const float* __restrict__ m_in, float eps,
    float* __restrict__ v_next, float* __restrict__ ev_new,
    unsigned char* __restrict__ done, float* __restrict__ lam, int n) {
  extern __shared__ float4 smem4[];
  float* ev_s = reinterpret_cast<float*>(smem4);
  __shared__ float red[3][kWarps];
  __shared__ float stats[3];

  const int tid = threadIdx.x, lane = tid & 31;
  float m;
  if constexpr (kFused) {
    float mx = -INFINITY, md = -INFINITY, unused = -INFINITY;
    for (int j = tid; j < n; j += kThreads) {
      const float vj = v[j], vn = v[j + 1 == n ? 0 : j + 1];
      mx = evt::nanmax(mx, vj);
      md = evt::nanmax(md, fabsf(vj - vn));
    }
    evt::block_max3(mx, md, unused, red, stats);
    m = mx;
    // max|d| < eps is all(|d| < eps), NaN included (prologue.cuh)
    if (blockIdx.x == 0 && tid == 0) {
      *done = md < eps ? 1 : 0;
      *lam = v[0];
    }
  } else {
    m = __ldg(m_in);
  }

  for (int j = tid; j < n; j += kThreads)
    ev_s[j] = __fmul_rn(ev[j], __fdiv_rn(v[j], m));
  __syncthreads();
  for (int j = blockIdx.x * kThreads + tid; j < n; j += gridDim.x * kThreads)
    ev_new[j] = ev_s[j];

  const int nwarps = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (tid >> 5); row < n; row += nwarps) {
    const float s = evt::row_dot(A + static_cast<size_t>(row) * n, ev_s, n, lane);
    if (lane == 0) v_next[row] = __fdiv_rn(s, ev_s[row]);
  }
}

template <bool kFused>
cudaError_t blocks_per_sm(int optin, size_t smem, int* per_sm) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, round_kernel<kFused>);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(round_kernel<kFused>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, round_kernel<kFused>, kThreads, smem);
  return e;
}

template <bool kFused>
int launch(const float* A, const float* ev, const float* v, const float* m,
           float eps, float* v_next, float* ev_new, unsigned char* done,
           float* lam, int n, int grid, void* stream) {
  if (n <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  round_kernel<kFused>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          A, ev, v, m, eps, v_next, ev_new, done, lam, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The grid of both kernels for dimension n on the current device, or a
// negated cudaError_t: one warp per row, at most the blocks that can be
// resident at once (each block pays the O(n) prologue once, so more blocks
// than that only repeat it).  Also raises the kernels' dynamic shared-
// memory limit to the most the card allows, so a grid computed once stays
// valid.
extern "C" int evt_round_grid(int n) {
  int dev = 0, sms = 0, optin = 0, a = 0, b = 0;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = blocks_per_sm<false>(optin, smem, &a);
  if (e == cudaSuccess) e = blocks_per_sm<true>(optin, smem, &b);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int per_sm = a < b ? a : b;
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const int want = (n + kWarps - 1) / kWarps;
  const int cap = per_sm * sms;
  return want < cap ? (want > 0 ? want : 1) : cap;
}

// A (n, n) row-major; ev, v, v_next, ev_new (n,); m, lam (1,); done one
// byte (a bool: 0 or 1); all float32 unless said, on the current device,
// 16-byte aligned A when n % 4 == 0.  v_next and ev_new must not overlap
// an input.  `grid` is what evt_round_grid(n) returned on this device.
// Launch on `stream` without synchronising; return the launch's
// cudaError_t (0 on success).
extern "C" int evt_round_matvec(const float* A, const float* ev,
                                const float* v, const float* m, float* v_next,
                                float* ev_new, int n, int grid, void* stream) {
  return launch<false>(A, ev, v, m, 0.0f, v_next, ev_new, nullptr, nullptr, n,
                       grid, stream);
}

extern "C" int evt_round_fused(const float* A, const float* ev, const float* v,
                               float eps, float* v_next, float* ev_new,
                               unsigned char* done, float* lam, int n, int grid,
                               void* stream) {
  return launch<true>(A, ev, v, nullptr, eps, v_next, ev_new, done, lam, n,
                      grid, stream);
}
