// v[r] = sum_c A[r][c], and the biased sum_c (A[r][c] + bias), in float32:
// the pre-loop pass of the iterated (mutate-A) solve, and the row-sum rung
// of the kernel ladder.
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `rowsum` /
// `_rowsum_kernel`, and eigen_value_tpu/bench/suite.py,
// `_rowsum_bias_pallas` (each a (row-block x col-block) grid with a VMEM
// accumulator revisited across the column blocks; the bias a (1,1) SMEM
// operand).
//
// Bound on the H100: bytes.  One add per 4-byte element of A, so a call
// costs at least one read of A (n*n*4 bytes) at device-memory bandwidth;
// the n sums written are noise beside it.
//
// Design: one warp per row, reduced by evt::row_reduce in the fixed order
// it shares with the matvec kernel's row dot (rowsum.cuh), 16-byte loads
// with four in flight per lane, no atomics.  The bias is read from device
// memory by the kernel, never by the host, so a chain of launches whose
// bias depends on the previous result stays asynchronous.  Both kernels are
// one template, with and without the add.
#include <cuda_runtime.h>

#include "rowsum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
    rowsum_kernel(const float* __restrict__ A, const float* __restrict__ bias,
                  float* __restrict__ out, int n) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const float* a = A + static_cast<size_t>(row) * n;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float b = kBias ? __ldg(bias) : 0.0f;
  const float s = evt::row_reduce(
      n, lane, [&](int k) { return __ldg(a4 + k); },
      [&](int, float4 c) {
        if (kBias) {
          c.x = __fadd_rn(c.x, b);
          c.y = __fadd_rn(c.y, b);
          c.z = __fadd_rn(c.z, b);
          c.w = __fadd_rn(c.w, b);
        }
        return c;
      },
      [&](int k) { return __ldg(a + k); },
      [&](int, float e) { return kBias ? __fadd_rn(e, b) : e; });
  if (lane == 0) out[row] = s;
}

template <bool kBias>
int launch(const float* A, const float* bias, float* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  rowsum_kernel<kBias><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, bias, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (n, n) row-major, out (n,), bias one float, all float32 on the current
// device.  Launch on `stream` without synchronising; return the launch's
// cudaError_t (0 on success).
extern "C" int evt_rowsum(const float* A, float* out, int n, void* stream) {
  return launch<false>(A, nullptr, out, n, stream);
}

extern "C" int evt_rowsum_bias(const float* A, const float* bias, float* out,
                               int n, void* stream) {
  return launch<true>(A, bias, out, n, stream);
}
