// y = A @ x in float32: the per-round operation of the matvec ("power")
// form solve, v_k = (A @ ev_k) / ev_k.
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `matvec` /
// `_matvec_kernel` (a (row-block x col-block) grid with a VMEM accumulator
// revisited across the column blocks).
//
// Bound on the H100: bytes.  A GEMV does 2 flops per 4-byte element of A,
// far below the card's flop:byte balance, so a call costs at least one read
// of A (n*m*4 bytes) at device-memory bandwidth; x and y are O(n) and stay
// in L2.
//
// Design: one warp per row (evt::row_dot), 16-byte loads with four in
// flight per lane, and a fixed-order warp reduction with no atomics, so the
// result is bitwise reproducible from launch to launch.  There are no
// column blocks: a whole row belongs to one warp, which removes the
// cross-block accumulation the TPU grid carried in VMEM.
#include <cuda_runtime.h>

#include "rowdot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    matvec_kernel(const float* __restrict__ A, const float* __restrict__ x,
                  float* __restrict__ y, int n, int m) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const float s = evt::row_dot(A + static_cast<size_t>(row) * m, x, m, lane);
  if (lane == 0) y[row] = s;
}

}  // namespace

// A (n, m) row-major, x (m,), y (n,), all float32 on the current device.
// Launches on `stream` and does not synchronise.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int evt_matvec(const float* A, const float* x, float* y, int n,
                          int m, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  matvec_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, x, y, n, m);
  return static_cast<int>(cudaGetLastError());
}
