// The O(n) glue between two matvecs of the matvec-form solve, on the card:
// given y = A @ ev from the matvec kernel, in float32,
//
//   v = y / ev;  stop = all_k |v[k] - v[(k+1) % n]| < tol  (tol = eps, or
//   eps * max|v| in relative mode);  m = max(v);  lambda = v[0];
//   ev <- ev * (v / m);  rounds = stop ? i : i + 1;  converged = stop
//
// so that after round i's glue the buffers hold the solve's answer as
// solver._finish would give it, had the loop stopped there (at the stop,
// or at the cap when i + 1 == max_itr), and the next matvec reads the
// updated ev.
//
// Replaces no Pallas kernel.  The JAX package runs this glue inside its
// `lax.while_loop`, which XLA fuses into the loop's program; the port's
// host loop issued it as ~13 small PyTorch operations a round, the first
// of them only after the host had read the round's stop.  This kernel does
// all of it before the read, so the host's only step after a read is the
// next matvec launch.
//
// Bound on the H100: bytes, and in practice launch latency.  A round reads
// y and ev twice and writes ev once (4n bytes each; 0.8 MB at n = 65536,
// well under a microsecond at 3.35 TB/s, and y and ev sit in L2 after the
// matvec), so the two launches' latency sets the time.
//
// Design: two launches on the stream.  `round_glue_check` forms v and
// reduces max(v), max|v| and max|v[k] - v[k+1]| (NaN propagating, as
// torch.max; max is exact in any order) in each block, through the
// persistent kernels' evt::stats4 / stats1 (prologue.cuh), then combines
// the blocks as csrc/stop.cu does: each block writes its partials to its own
// slot of `scratch`, then takes a ticket from `ticket`; the block with the
// last ticket knows every slot is written, reduces them, writes m to
// scratch[0], lambda, rounds and converged, and puts the ticket back to 0.
// So `ticket` is zero between launches and is never initialised by a
// launch of its own; launches that share it must be ordered on one stream
// (the wrapper keeps one per device and stream).  `round_glue_update` then
// reads m and updates ev in place; every element of ev is read and
// written by one thread of it, after the check has read all of ev.
//
// Bit identities: v = __fdiv_rn(y, ev) is `matvec(A, ev) / ev`; the update
// is __fmul_rn(ev, __fdiv_rn(v, m)), two rounded operations that no
// contraction can fuse, as `ev * (v / m)` with a 0-d tensor m; the stop
// test is max|d| < tol, which is all(|d| < tol), NaN included
// (prologue.cuh); tol = eps * max|v| is one f32 product, as in
// solver.stop_check.  So rounds, converged, lambda and ev equal the host
// loop's solver._finish(_run_rounds(...)) bit for bit.
#include <cuda_runtime.h>

#include <math.h>

#include "prologue.cuh"

namespace {

constexpr int kT = 256;

__device__ __forceinline__ float4 quot4(float4 a, float4 b) {
  return make_float4(__fdiv_rn(a.x, b.x), __fdiv_rn(a.y, b.y), __fdiv_rn(a.z, b.z),
                     __fdiv_rn(a.w, b.w));
}

__global__ void __launch_bounds__(kT) round_glue_check(
    const float* __restrict__ y, const float* __restrict__ ev,
    const float* __restrict__ eps, int rel, int n, int round,
    unsigned int* ticket, float* scratch, float* __restrict__ lam,
    int* __restrict__ rounds, unsigned char* __restrict__ converged) {
  __shared__ float red[3][evt::kWarps];
  __shared__ float stats[3];
  __shared__ bool last;
  const size_t first = static_cast<size_t>(blockIdx.x) * kT + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kT;
  float mx = -INFINITY, mabs = -INFINITY, md = -INFINITY;
  if ((n & 3) == 0) {
    // a thread's chunk of four and the first value of the next chunk (of
    // chunk 0 at the end: the wraparound pair)
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const float4* ev4 = reinterpret_cast<const float4*>(ev);
    const size_t n4 = static_cast<size_t>(n) >> 2;
    for (size_t k = first; k < n4; k += stride) {
      const float4 w = quot4(__ldg(y4 + k), __ldg(ev4 + k));
      const size_t jn = k + 1 == n4 ? 0 : 4 * k + 4;
      const float next = __fdiv_rn(__ldg(y + jn), __ldg(ev + jn));
      evt::stats4(w, next, mx, mabs, md);
    }
  } else {
    const size_t nn = static_cast<size_t>(n);
    for (size_t j = first; j < nn; j += stride) {
      const size_t jn = j + 1 == nn ? 0 : j + 1;
      const float vj = __fdiv_rn(__ldg(y + j), __ldg(ev + j));
      const float vn = __fdiv_rn(__ldg(y + jn), __ldg(ev + jn));
      evt::stats1(vj, vn, mx, mabs, md);
    }
  }
  evt::block_max3<kT>(mx, mabs, md, red, stats);
  if (threadIdx.x == 0) {
    float* slot = scratch + 1 + 3 * static_cast<size_t>(blockIdx.x);
    slot[0] = mx;
    slot[1] = mabs;
    slot[2] = md;
    __threadfence();  // the slot is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  mx = mabs = md = -INFINITY;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kT) {
    const float* slot = scratch + 1 + 3 * static_cast<size_t>(b);
    mx = evt::nanmax(mx, __ldcg(slot));
    mabs = evt::nanmax(mabs, __ldcg(slot + 1));
    md = evt::nanmax(md, __ldcg(slot + 2));
  }
  evt::block_max3<kT>(mx, mabs, md, red, stats);
  if (threadIdx.x == 0) {
    const float e = __ldg(eps);
    const bool stop = md < (rel ? e * mabs : e);
    scratch[0] = mx;
    *lam = __fdiv_rn(__ldg(y), __ldg(ev));
    *rounds = stop ? round : round + 1;
    *converged = stop ? 1 : 0;
    atomicExch(ticket, 0u);
  }
}

__global__ void __launch_bounds__(kT) round_glue_update(
    const float* __restrict__ y, float* __restrict__ ev,
    const float* __restrict__ scratch, int n) {
  const float m = scratch[0];  // written by round_glue_check, launched before
  const size_t first = static_cast<size_t>(blockIdx.x) * kT + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kT;
  if ((n & 3) == 0) {
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* ev4 = reinterpret_cast<float4*>(ev);
    const size_t n4 = static_cast<size_t>(n) >> 2;
    for (size_t k = first; k < n4; k += stride) {
      const float4 e = ev4[k];
      const float4 w = quot4(__ldg(y4 + k), e);
      ev4[k] = make_float4(__fmul_rn(e.x, __fdiv_rn(w.x, m)), __fmul_rn(e.y, __fdiv_rn(w.y, m)),
                           __fmul_rn(e.z, __fdiv_rn(w.z, m)), __fmul_rn(e.w, __fdiv_rn(w.w, m)));
    }
  } else {
    const size_t nn = static_cast<size_t>(n);
    for (size_t j = first; j < nn; j += stride) {
      const float e = ev[j];
      ev[j] = __fmul_rn(e, __fdiv_rn(__fdiv_rn(__ldg(y + j), e), m));
    }
  }
}

}  // namespace

// y (n,) and ev (n,) float32, 16-byte aligned when n % 4 == 0, ev updated
// in place; eps (1,) float32, read on the card; rel 1 for the relative
// stop; round the 0-based index i of the round; ticket one zeroed 32-bit
// word and scratch 1 + 3 * slots floats, both shared by this stream's
// launches; lam (1,) float32, rounds (1,) int32 and converged one byte (a
// bool), written; all on the current device.  Launches both kernels on
// `stream`, each at most `slots` blocks, and does not synchronise.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int evt_round_glue(const float* y, float* ev, const float* eps, int rel, int n,
                              int round, unsigned int* ticket, float* scratch, int slots,
                              float* lam, int* rounds, unsigned char* converged,
                              void* stream) {
  if (n <= 0 || slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t chunks = (n & 3) == 0 ? static_cast<size_t>(n) >> 2 : n;
  const size_t want = (chunks + kT - 1) / kT;
  const int blocks = want < static_cast<size_t>(slots) ? static_cast<int>(want) : slots;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  round_glue_check<<<blocks, kT, 0, s>>>(y, ev, eps, rel, n, round, ticket, scratch, lam,
                                         rounds, converged);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  round_glue_update<<<blocks, kT, 0, s>>>(y, ev, scratch, n);
  return static_cast<int>(cudaGetLastError());
}
