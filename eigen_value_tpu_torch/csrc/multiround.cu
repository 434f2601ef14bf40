// Up to `chunk` rounds of the matvec-form solve in one launch, with the
// O(n) round state (ev, v, stop, max, lambda, freeze) kept on chip.
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `multiround` /
// `_multiround_kernel` with `_round_prologue` (a sequential (round,
// row-stripe) grid whose ev / v / raw row sums live in VMEM scratch and
// whose O(n) prologue runs at row-stripe 0 of every round).
//
// Bound on the H100: bytes.  A round needs every element of A once
// (n*n*4 bytes, 256 MiB at 8192^2, five times the 50 MB L2).  What a round
// costs beyond the bytes it must fetch from device memory is the time in
// which nothing of A is in flight: the grid barrier with the spread of the
// blocks before it, and the O(n) prologue (measured at 8192^2 before this
// design: 84.7 us of stream at 3.17 TB/s, 5.8 us of barrier, 8.0 us of
// prologue in a round of 98.5 us).
//
// Design: a persistent cooperative kernel, one block per SM, that spends
// the SM's 227 KB of shared memory and the card's L2 on A:
//   * block b owns rows b, b + G, b + 2G, ... (G blocks).  As many of them
//     as fit beside ev (`resident`: 6 at n = 8192, all of them at n <= 2048)
//     are copied into shared memory at the start of a launch and read from
//     there in every round of it: they cross device memory once a launch;
//   * the next `l2_rows` of a block's rows are read with an L2 evict_last
//     policy and the rest with evict_first, so that a band of A (3/8 of the
//     L2, or 5/8 where little streams by: device.l2_resident_bytes) is
//     found in L2 by every later round while the stream passes by it;
//   * the prologue (prologue.cuh, shared with multiround_sym.cu) asks for
//     all of a thread's values before it divides the first, so it costs one
//     L2 round trip and not one per element.  It reproduces
//     _round_prologue expression for expression; every block computes
//     bit-identical ev, m and halt from the same global raw row sums into
//     its own shared-memory copy of ev, so one barrier a round is enough,
//     and all blocks leave the round loop together once the solve is
//     frozen (the TPU grid had to stream the rest of the chunk);
//   * every row, wherever its bytes lie, is reduced by one warp through the
//     same evt::row_dot as matvec.cu, reading ev from shared memory, so the
//     v-sequence is bit-identical to a loop of matvec launches;
//   * raw row sums are double-buffered in global memory: round r writes
//     buffer r & 1 while blocks may still read buffer (r - 1) & 1.
// A may be stored in bf16 or f16 (reduced-precision storage, as the TPU
// kernel's row stripe cast up to f32 at kernels.py:556-561): the resident
// rows are copied in 2 bytes, so twice as many fit beside the f32 ev (12 a
// block at n = 8192), the L2 band is counted in 2-byte rows, and row_dot
// converts each chunk to f32 exactly before the f32 sums, so a launch on
// A_q gives the bits of a launch on A_q.float().  All O(n) state stays f32.
// Asking the L2 for the next round's first rows before the barrier
// (cp.async.bulk.prefetch.L2) was measured and is not here: it cost 3% at
// 8192^2, where it pushes kept rows out of L2.
// No atomics anywhere: the results are bitwise reproducible.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "prologue.cuh"
#include "rowdot.cuh"

namespace cg = cooperative_groups;

namespace {

using evt::kThreads;
using evt::kWarps;

constexpr int kBatch = 2;  // float4 chunks of v a thread holds in the prologue

// Dynamic shared memory: ev (n floats) | resident rows (resident * n
// elements of T).  device.multiround_smem_bytes mirrors this.
template <class T>
size_t smem_bytes(int n, int resident) {
  return static_cast<size_t>(n) * (sizeof(float) + static_cast<size_t>(resident) * sizeof(T));
}

template <class T>
__global__ void __launch_bounds__(kThreads) multiround_kernel(
    const T* __restrict__ A, const float* __restrict__ ev_in,
    const float* __restrict__ v_in, const float* __restrict__ lam_in,
    int budget, float* __restrict__ ev_out, float* __restrict__ v_out,
    int* __restrict__ adv_out, float* __restrict__ lam_out,
    float* __restrict__ raw, int n, int chunk, float eps, int init, int rel,
    int resident, int l2_rows, unsigned long long* stamps) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  using Chunk = typename evt::Elem<T>::Chunk;
  using Bits = typename evt::Elem<T>::Bits;
  float* ev_s = reinterpret_cast<float*>(smem4);
  T* rows_s = reinterpret_cast<T*>(ev_s + n);  // chunk-aligned: 4n bytes, n % 4 == 0
  __shared__ float red[3][kWarps];
  __shared__ float stats[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  // this block's rows: b + k * G; the first nres of them are resident, the
  // others streamed (work item m < nstream is row k = nres + m)
  const int nrows = b < n ? (n - 1 - b) / G + 1 : 0;
  const int nres = min(resident, nrows);
  const int nstream = nrows - nres;
  const evt::FromGlobalHinted keep{evt::l2_evict_last()};
  const evt::FromGlobalHinted pass{evt::l2_evict_first()};

  for (int j = tid; j < n; j += kThreads) ev_s[j] = ev_in[j];
  // fill the resident rows, once per launch
  if ((n & 3) == 0) {
    const int n4 = n >> 2;
    Chunk* dst = reinterpret_cast<Chunk*>(rows_s);
#pragma unroll 4
    for (int e = tid; e < nres * n4; e += kThreads) {
      const int k = e / n4;
      dst[e] = pass(reinterpret_cast<const Chunk*>(
                        A + static_cast<size_t>(b + k * G) * n) + (e - k * n4));
    }
  } else {
    Bits* dst = reinterpret_cast<Bits*>(rows_s);
    for (int e = tid; e < nres * n; e += kThreads) {
      const int k = e / n;
      dst[e] = pass(reinterpret_cast<const Bits*>(A + static_cast<size_t>(b + k * G) * n) +
                    (e - k * n));
    }
  }
  __syncthreads();

  int adv = 0;
  float lam = *lam_in;
  int last = -1;  // raw buffer of the latest matvec, -1 before the first
  for (int r = 0; r < chunk; ++r) {
    evt::stamp(stamps, r, 0, false);
    // this round's v: the input at r == 0, else the previous matvec / ev
    const float* prev = raw + static_cast<size_t>((r + 1) & 1) * n;
    if (!init || r != 0) {
      if (evt::round_prologue<kThreads, kBatch>(v_in, prev, r == 0, ev_s, n, eps, rel,
                                                budget, adv, lam, red, stats))
        break;  // same decision in every block
    }
    evt::stamp(stamps, r, 1, false);
    float* out = raw + static_cast<size_t>(r & 1) * n;
    for (int m = warp; m < nrows; m += kWarps) {
      float s;
      int row;
      if (m < nstream) {
        row = b + (nres + m) * G;
        s = evt::row_dot(A + static_cast<size_t>(row) * n, ev_s, n, lane,
                         m < l2_rows ? keep : pass);
      } else {
        const int k = m - nstream;
        row = b + k * G;
        s = evt::row_dot(rows_s + static_cast<size_t>(k) * n, ev_s, n, lane,
                         evt::FromShared());
      }
      if (lane == 0) __stcg(out + row, s);
    }
    last = r & 1;
    evt::stamp(stamps, r, 2, true);
    grid.sync();
    evt::stamp(stamps, r, 3, false);
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

template <class T>
int blocks(int n, int resident) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr;
  const size_t smem = smem_bytes<T>(n, resident);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, multiround_kernel<T>);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const size_t limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  if (smem > limit) return 0;
  e = cudaFuncSetAttribute(multiround_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(limit));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, multiround_kernel<T>,
                                                      kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

}  // namespace

// Co-resident blocks of the kernel at dimension n with `resident` rows of
// element type `elem` (0 float32, 1 bfloat16, 2 float16) a block on the
// current device, 0 if one block does not fit, or a negated cudaError_t.
// Also raises the kernel's dynamic shared-memory limit to the most the card
// allows.
extern "C" int evt_multiround_blocks(int n, int resident, int elem) {
  if (elem < 0 || elem > 2) return -static_cast<int>(cudaErrorInvalidValue);
  return evt::with_elem(elem, [&](auto tag) {
    return blocks<typename decltype(tag)::type>(n, resident);
  });
}

// A (n, n) row-major in the element type `elem` names (0 float32, 1
// bfloat16, 2 float16); ev_in, v_in, ev_out, v_out (n,); lam_in, lam_out (1,);
// adv_out (1,) int32; raw (2n,) scratch; all on the current device.  `grid`
// blocks with `resident` rows each must be co-resident
// (evt_multiround_blocks); the first `l2_rows` streamed rows of a block are
// kept in L2.  `stamps` is null, or kStampRounds * kStampPhases * grid
// words for the phase stamps.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t (0 on success; a card
// without cooperative launch fails here).
extern "C" int evt_multiround(const void* A, const float* ev_in,
                              const float* v_in, const float* lam_in,
                              int budget, float* ev_out, float* v_out,
                              int* adv_out, float* lam_out, float* raw, int n,
                              int chunk, float eps, int init, int rel,
                              int resident, int l2_rows, void* stamps,
                              int elem, int grid, void* stream) {
  return evt::with_elem(elem, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const size_t smem = smem_bytes<T>(n, resident);
    void* args[] = {&A,      &ev_in,   &v_in,    &lam_in,   &budget,  &ev_out,
                    &v_out,  &adv_out, &lam_out, &raw,      &n,       &chunk,
                    &eps,    &init,    &rel,     &resident, &l2_rows, &stamps};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)multiround_kernel<T>, dim3(grid),
        dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}
