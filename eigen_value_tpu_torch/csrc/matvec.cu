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
//
// A may be stored in bf16 or f16 (reduced-precision storage, the only
// single-card route past the multiround kernels' n <= 57856: 65536^2 is
// 8 GiB in bf16).  Then a chunk is four 2-byte elements in one 8-byte load
// (eight in flight per lane, the f32 kernel's bytes in flight), converted
// to f32 exactly and multiplied with the f32 x in the f32 order above, so
// matvec(A_q, x) is bit for bit matvec(A_q.float(), x), and the bound is
// half the bytes: n*m*2 (on an H100 at 65536^2, chip_smoke.py: 2.87 ms a
// call against 2.56 ms for the bytes; four loads in flight were slower).
//
// A is any row-major view: row r starts at A + r*ld, ld >= m.  The sharded
// solves multiply column blocks of a rank's row block (the ring's chunk
// products A_blk[:, s*m:(s+1)*m], the 2-D body's block of a whole matrix)
// in place, where a copy into contiguous blocks would double a rank's
// matrix memory.  The sums do not depend on ld: a view gives the bits of
// its contiguous copy.
#include <cuda_runtime.h>

#include "rowdot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <class T>
__global__ void __launch_bounds__(kThreads)
    matvec_kernel(const T* __restrict__ A, const float* __restrict__ x,
                  float* __restrict__ y, int n, int m, long long ld) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const float s = evt::row_dot(A + static_cast<size_t>(row) * ld, x, m, lane);
  if (lane == 0) y[row] = s;
}

}  // namespace

// A (n, m) row-major with rows `ld` elements apart, in the element type
// `elem` names (0 float32, 1 bfloat16, 2 float16); x (m,) and y (n,)
// float32; all on the current device.  With m % 4 == 0, A and ld must keep
// every row aligned to four elements (kernels.py checks).  Launches on
// `stream` and does not synchronise.  Returns the launch's cudaError_t (0
// on success).
extern "C" int evt_matvec(const void* A, const float* x, float* y, int n,
                          int m, long long ld, int elem, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  return evt::with_elem(elem, [&](auto tag) {
    using T = typename decltype(tag)::type;
    matvec_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(A), x, y, n, m, ld);
    return static_cast<int>(cudaGetLastError());
  });
}
