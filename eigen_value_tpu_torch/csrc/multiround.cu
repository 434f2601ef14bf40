// Up to `chunk` rounds of the matvec-form solve in one launch, with the
// O(n) round state (ev, v, stop, max, lambda, freeze) kept on chip.
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `multiround` /
// `_multiround_kernel` with `_round_prologue` (a sequential (round,
// row-stripe) grid whose ev / v / raw row sums live in VMEM scratch and
// whose O(n) prologue runs at row-stripe 0 of every round).
//
// Bound on the H100: bytes.  Each round reads A once (n*n*4 bytes, 256 MiB
// at 8192^2, five times the 50 MB L2), so a round costs at least one pass
// over device memory; the O(n) prologue and the grid barrier are the
// overhead on top.
//
// Design: a persistent cooperative kernel.  The grid is at most as large
// as can be co-resident (the host clamps it to the occupancy limit times
// the SM count) and a cooperative_groups grid barrier ends every round.
// One barrier per round is enough because every block redoes the O(n)
// prologue for the whole vector, from the same global raw row sums, into
// its own shared-memory copy of ev:
//   * the prologue (prologue.cuh, shared with multiround_sym.cu) reproduces
//     _round_prologue expression for expression; every block computes
//     bit-identical ev, m and halt, and all blocks leave the round loop
//     together once the solve is frozen (the TPU grid had to stream the
//     rest of the chunk);
//   * the matvec of a round gives each global warp whole rows through the
//     same evt::row_dot as matvec.cu, reading ev from shared memory, so the
//     v-sequence is bit-identical to a loop of matvec launches;
//   * raw row sums are double-buffered in global memory: round r writes
//     buffer r & 1 while blocks may still read buffer (r - 1) & 1.
// No atomics anywhere: the results are bitwise reproducible.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "prologue.cuh"
#include "rowdot.cuh"

namespace cg = cooperative_groups;

namespace {

using evt::kThreads;
using evt::kWarps;

__global__ void __launch_bounds__(kThreads) multiround_kernel(
    const float* __restrict__ A, const float* __restrict__ ev_in,
    const float* __restrict__ v_in, const float* __restrict__ lam_in,
    int budget, float* __restrict__ ev_out, float* __restrict__ v_out,
    int* __restrict__ adv_out, float* __restrict__ lam_out,
    float* __restrict__ raw, int n, int chunk, float eps, int init, int rel) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* ev_s = reinterpret_cast<float*>(smem4);
  __shared__ float red[3][kWarps];
  __shared__ float stats[3];

  const int tid = threadIdx.x, lane = tid & 31;
  const int gwarp = blockIdx.x * kWarps + (tid >> 5);
  const int nwarps = gridDim.x * kWarps;

  for (int j = tid; j < n; j += kThreads) ev_s[j] = ev_in[j];
  __syncthreads();

  int adv = 0;
  float lam = *lam_in;
  int last = -1;  // raw buffer of the latest matvec, -1 before the first
  for (int r = 0; r < chunk; ++r) {
    // this round's v: the input at r == 0, else the previous matvec / ev
    const float* prev = raw + static_cast<size_t>((r + 1) & 1) * n;
    if (!init || r != 0) {
      if (evt::round_prologue(v_in, prev, r == 0, ev_s, n, eps, rel, budget,
                              adv, lam, red, stats))
        break;  // same decision in every block
    }
    float* out = raw + static_cast<size_t>(r & 1) * n;
    for (int row = gwarp; row < n; row += nwarps) {
      const float s = evt::row_dot(A + static_cast<size_t>(row) * n, ev_s, n, lane);
      if (lane == 0) __stcg(out + row, s);
    }
    last = r & 1;
    grid.sync();
  }

  // A frozen solve keeps the v it stopped on (the previous matvec / ev, or
  // the input if it stopped at r == 0); a running one leaves the division
  // of its last matvec to this epilogue.
  const float* fin = last < 0 ? nullptr : raw + static_cast<size_t>(last) * n;
  for (int j = blockIdx.x * kThreads + tid; j < n; j += gridDim.x * kThreads) {
    ev_out[j] = ev_s[j];
    v_out[j] = fin ? __ldcg(fin + j) / ev_s[j] : v_in[j];
  }
  if (blockIdx.x == 0 && tid == 0) {
    *adv_out = adv;
    *lam_out = lam;
  }
}

}  // namespace

// The co-resident grid for dimension n on the current device, or a negated
// cudaError_t.  Also raises the kernel's dynamic shared-memory limit to the
// most the card allows, so a grid computed once stays valid for every n.
extern "C" int evt_multiround_grid(int n) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, multiround_kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        multiround_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(attr.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, multiround_kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int want = (n + kWarps - 1) / kWarps;
  const int cap = per_sm * sms;
  return want < cap ? (want > 0 ? want : 1) : cap;
}

// A (n, n) row-major; ev_in, v_in, ev_out, v_out (n,); lam_in, lam_out (1,);
// adv_out (1,) int32; raw (2n,) scratch; all on the current device.  `grid`
// is what evt_multiround_grid(n) returned on this device.  Launches on
// `stream` and does not synchronise.  Returns the launch's cudaError_t (0
// on success; a card without cooperative launch fails here).
extern "C" int evt_multiround(const float* A, const float* ev_in,
                              const float* v_in, const float* lam_in,
                              int budget, float* ev_out, float* v_out,
                              int* adv_out, float* lam_out, float* raw, int n,
                              int chunk, float eps, int init, int rel,
                              int grid, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  void* args[] = {&A,      &ev_in, &v_in,    &lam_in, &budget, &ev_out,
                  &v_out,  &adv_out, &lam_out, &raw,  &n,      &chunk,
                  &eps,    &init,  &rel};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)multiround_kernel, dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
