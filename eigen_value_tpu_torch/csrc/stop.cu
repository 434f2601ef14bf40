// done = all_i |v[i] - v[(i + 1) % n]| < eps, in float32: the wraparound stop
// criterion of every solve form, in one launch and one read of v.
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `stop` / `_stop_kernel`
// (v viewed as (rows, lanes) blocks, neighbours by lane and row rolls plus
// a prefetched side array of block boundaries, and a flag multiplied in
// across the steps of a sequential grid).
//
// Bound on the H100: bytes.  Two operations per 4-byte element, so a call
// costs at least one read of v (4n bytes) at device-memory bandwidth; at
// the sizes a solve has (n <= 65536, 256 KB) a launch's latency sets the
// time, not the bytes.
//
// Design: a grid-stride loop, 16-byte loads where n % 4 == 0.  A thread
// compares the four values of its chunk with each other and the last with
// the first value of the next chunk (of chunk 0 at the end: the wraparound
// pair); that neighbour is in a line another thread loads anyway, so
// device memory is read once.  Any n >= 1 is taken: the TPU kernel's
// divisibility rule was its tiling's, not the function's.  eps is read
// from device memory, so a chain of launches never waits for the host.
//
// CUDA blocks run in no order, so the per-block flags cannot be multiplied
// into the output one grid step after another.  They are combined with an
// integer atomic, which is exact in any order (the ban on atomics in the
// other kernels is about float sums): a block that saw a failing pair ORs
// 1 into `state[0]`, then every block takes a ticket from `state[1]`.  The
// block with the last ticket knows all others are done: it writes the
// result and puts both words back to 0.  So `state` is zero between
// launches and is never initialised by a launch of its own; launches that
// share a `state` must be ordered on one stream (the wrapper keeps one per
// device and stream).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// eight blocks for each of an H100's 132 SMs; the loop covers the rest
constexpr int kMaxBlocks = 1056;

__global__ void __launch_bounds__(kThreads)
    stop_kernel(const float* __restrict__ v, const float* __restrict__ eps,
                int n, unsigned int* state, unsigned char* __restrict__ out) {
  const float e = __ldg(eps);
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  int ok = 1;
  // strict <, written so that a NaN difference fails
  if ((n & 3) == 0) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const size_t n4 = static_cast<size_t>(n) >> 2;
#pragma unroll 4
    for (size_t k = first; k < n4; k += stride) {
      const float4 c = __ldg(v4 + k);
      const float next = __ldg(v + (k + 1 == n4 ? 0 : 4 * k + 4));
      ok &= (fabsf(c.x - c.y) < e) & (fabsf(c.y - c.z) < e) &
            (fabsf(c.z - c.w) < e) & (fabsf(c.w - next) < e);
    }
  } else {
    const size_t nn = static_cast<size_t>(n);
#pragma unroll 4
    for (size_t i = first; i < nn; i += stride) {
      const float next = __ldg(v + (i + 1 == nn ? 0 : i + 1));
      ok &= fabsf(__ldg(v + i) - next) < e;
    }
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) {
    if (!ok) atomicOr(state, 1u);
    __threadfence();  // the flag is visible before the ticket is taken
    const unsigned int ticket = atomicAdd(state + 1, 1u);
    if (ticket == gridDim.x - 1) {
      __threadfence();
      const unsigned int failed = atomicExch(state, 0u);
      atomicExch(state + 1, 0u);
      *out = failed ? 0 : 1;
    }
  }
}

}  // namespace

// v (n,) float32 and eps (1,) float32, out one byte (a bool: 0 or 1),
// state two zeroed 32-bit words that this stream's launches share, all on
// the current device; 16-byte aligned v when n % 4 == 0.  Launches on
// `stream` and does not synchronise.  Returns the launch's cudaError_t (0
// on success).
extern "C" int evt_stop(const float* v, const float* eps, int n,
                        unsigned int* state, unsigned char* out,
                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t chunks = (n & 3) == 0 ? static_cast<size_t>(n) >> 2 : n;
  const size_t want = (chunks + kThreads - 1) / kThreads;
  const int blocks = want < kMaxBlocks ? static_cast<int>(want) : kMaxBlocks;
  stop_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, eps, n, state, out);
  return static_cast<int>(cudaGetLastError());
}
