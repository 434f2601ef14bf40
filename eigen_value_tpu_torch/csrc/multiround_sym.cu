// Up to `chunk` rounds of the matvec-form solve in one launch, reading A
// as square bt x bt tiles: for a symmetric A only the g(g+1)/2 tiles on or
// above the block diagonal (g = n / bt), or, in dense tiled mode, all g^2
// tiles.  Some tiles can stay resident in shared memory across the rounds
// of a launch (the tile cache).
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `multiround_sym` /
// `_multiround_sym_kernel` ("vpu" formulation, prologue fill, sym and
// dense modes), with `_round_prologue`.
//
// Bound on the H100: bytes.  At 8192^2 with bt = 128 a round streams the
// 2080 upper-triangle tiles, 2080 * 64 KiB = 136 MB (the dense pass reads
// 268 MB), minus 64 KiB for every resident tile; 2 flops per 4-byte
// element leave the card waiting on memory.  Design against that:
//   * each upper tile is read once per round and used twice: its row term
//     T . ev[j_blk] feeds rows i_blk, and off the diagonal its transpose
//     term T^T . ev[i_blk] feeds rows j_blk (A[j][i] == A[i][j]).  Diagonal
//     tiles are read whole and give the row term only.  Tiles strictly
//     below the block diagonal are never touched;
//   * a resident tile s lives in shared memory of block s % grid, loaded
//     once at the start of the launch and read from there in every round
//     of that launch, so it crosses device memory once per launch instead
//     of once per round.  Its budget comes from the card
//     (device.sym_auto_cache_tiles);
//   * one warp per tile, no block barrier inside a round's tile phase: a
//     block's work items (its streamed tiles, then its resident ones) go to
//     its 32 warps in turn.  In each 32-row group and 128-column chunk
//     lane l owns the float4 of columns 4l..4l+3, eight rows' loads in
//     flight at once.  The row term is a dot4 per lane and a
//     __shfl_xor_sync butterfly (lane r keeps row r's sum, in chunk
//     order); the transpose term is four column accumulators per lane
//     (an fmaf chain over the group's 32 rows), added group by group into
//     the warp's own column sums in shared memory.  A resident tile's warp
//     reads shared memory only, so a block's streamed tiles keep the
//     memory system busy while its resident ones are worked from on chip.
// The cross-block sum has no atomics.  On the TPU the row sums were carried
// across sequential grid steps in VMEM; here the tiles feeding one row
// block run in different blocks, in no order.  So:
//   1. tile (i, j) writes its row term to slot part[i][j] and its
//      transpose term to slot part[j][i] (bt floats each; slot [b][k] is
//      the share of column block k in row block b);
//   2. after a grid barrier the grid reduces rows in parallel, each row
//      over k = 0..g-1 in fixed order (four partial sums by k % 4, on four
//      lanes), into raw;
//   3. after a second barrier every block runs the redundant O(n) prologue
//      (prologue.cuh, shared with multiround.cu) on its own copy of ev.
// The sum depends neither on which block did a tile nor on whether it was
// resident, so results are bit-identical for every cache size, every
// chunking and whatever the lower block triangle holds.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "prologue.cuh"
#include "rowdot.cuh"

namespace cg = cooperative_groups;

namespace {

using evt::kThreads;
using evt::kWarps;

constexpr int kChunk = 128;  // columns per pass over a tile: a float4 a lane

// Dynamic shared memory: ev (n) | per-warp column sums (kWarps * bt) |
// resident tiles (slots * bt^2).  device.sym_smem_bytes mirrors this.
size_t smem_bytes(int n, int bt, int slots) {
  return (static_cast<size_t>(n) + static_cast<size_t>(kWarps) * bt +
          static_cast<size_t>(slots) * bt * bt) *
         sizeof(float);
}

template <bool kShared>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);  // A is read-only for the kernel's lifetime
  }
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// One warp's pass over tile (i, j), row r at src + r * stride (A in device
// memory, or a resident copy in shared memory).  Writes the row term
// T . ev[j_blk] to part[i][j] and, when `trans`, the transpose term
// T^T . ev[i_blk] to part[j][i].  colsum: the warp's own bt floats.
template <bool kShared>
__device__ void tile_terms(const float* src, size_t stride, int bt, int g,
                           int i, int j, bool trans, const float* ev_s,
                           float* colsum, float* part, int lane) {
  const float* evi = ev_s + static_cast<size_t>(i) * bt;
  const float4* evj4 = reinterpret_cast<const float4*>(ev_s + static_cast<size_t>(j) * bt);
  float* row_out = part + (static_cast<size_t>(i) * g + j) * bt;
  for (int r0 = 0; r0 < bt; r0 += 32) {
    float mine = 0.0f;  // row r0 + lane, summed over the chunks in order
    for (int q = 0; q < bt; q += kChunk) {
      const float4 x = evj4[q / 4 + lane];
      float4 col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r8 = 0; r8 < 32; r8 += 8) {
        float4 a[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          a[u] = load4<kShared>(reinterpret_cast<const float4*>(
                                    src + static_cast<size_t>(r0 + r8 + u) * stride + q) +
                                lane);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float d = warp_sum(evt::dot4(a[u], x));
          if (lane == r8 + u) mine = q == 0 ? d : mine + d;
          if (trans) {
            const float e = evi[r0 + r8 + u];
            col.x = fmaf(a[u].x, e, col.x);
            col.y = fmaf(a[u].y, e, col.y);
            col.z = fmaf(a[u].z, e, col.z);
            col.w = fmaf(a[u].w, e, col.w);
          }
        }
      }
      if (trans) {  // lane-private: no barrier
        float4* acc = reinterpret_cast<float4*>(colsum + q) + lane;
        if (r0 == 0) {
          *acc = col;
        } else {
          const float4 c = *acc;
          *acc = make_float4(c.x + col.x, c.y + col.y, c.z + col.z, c.w + col.w);
        }
      }
    }
    __stcg(row_out + r0 + lane, mine);
  }
  if (trans) {
    float4* col_out = reinterpret_cast<float4*>(part + (static_cast<size_t>(j) * g + i) * bt);
    const float4* acc = reinterpret_cast<const float4*>(colsum);
    for (int c = lane; c < bt / 4; c += 32) __stcg(col_out + c, acc[c]);
  }
}

// tiles: T streamed (i, j) pairs, then C resident ones.  part: g * n floats.
__global__ void __launch_bounds__(kThreads) multiround_sym_kernel(
    const float* __restrict__ A, const int2* __restrict__ tiles, int T, int C,
    int slots, const float* __restrict__ ev_in, const float* __restrict__ v_in,
    const float* __restrict__ lam_in, int budget, float* __restrict__ ev_out,
    float* __restrict__ v_out, int* __restrict__ adv_out,
    float* __restrict__ lam_out, float* raw, float* part, int n, int bt,
    int chunk, float eps, int init, int rel, int sym) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* ev_s = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* colsum = ev_s + n + static_cast<size_t>(warp) * bt;
  float* cache = ev_s + n + static_cast<size_t>(kWarps) * bt;
  __shared__ float red[3][kWarps];
  __shared__ float stats[3];

  const int g = n / bt;
  const size_t tile_floats = static_cast<size_t>(bt) * bt;
  // this block's work items: streamed tiles t = blockIdx.x + m * gridDim.x,
  // then its resident tiles s = blockIdx.x + k * gridDim.x (slot k)
  const int b = blockIdx.x, nb = gridDim.x;
  const int nstream = b < T ? (T - 1 - b) / nb + 1 : 0;
  const int ncached = b < C ? min(slots, (C - 1 - b) / nb + 1) : 0;

  for (int j = tid; j < n; j += kThreads) ev_s[j] = ev_in[j];
  // fill this block's resident tiles, once per launch
  for (int k = 0; k < ncached; ++k) {
    const int2 ij = tiles[T + b + k * nb];
    const float* src = A + static_cast<size_t>(ij.x) * bt * n +
                       static_cast<size_t>(ij.y) * bt;
    float4* dst = reinterpret_cast<float4*>(cache + k * tile_floats);
    const int q4 = bt / 4;
    for (int e = tid; e < bt * q4; e += kThreads) {
      const int r = e / q4;
      dst[e] = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * n) +
                     (e - r * q4));
    }
  }
  __syncthreads();

  int adv = 0;
  float lam = *lam_in;
  bool did = false;  // raw holds a matvec of this launch
  for (int r = 0; r < chunk; ++r) {
    if (!init || r != 0) {
      if (evt::round_prologue(v_in, raw, r == 0, ev_s, n, eps, rel, budget,
                              adv, lam, red, stats))
        break;  // same decision in every block
    }
    for (int m = warp; m < nstream + ncached; m += kWarps) {
      if (m < nstream) {
        const int2 ij = tiles[b + m * nb];
        tile_terms<false>(A + static_cast<size_t>(ij.x) * bt * n +
                              static_cast<size_t>(ij.y) * bt,
                          n, bt, g, ij.x, ij.y, sym && ij.x != ij.y, ev_s,
                          colsum, part, lane);
      } else {
        const int k = m - nstream;  // resident slot k: tile s = b + k * nb
        const int2 ij = tiles[T + b + k * nb];
        tile_terms<true>(cache + k * tile_floats, bt, bt, g, ij.x, ij.y,
                         sym && ij.x != ij.y, ev_s, colsum, part, lane);
      }
    }
    grid.sync();
    // raw[row] = sum over k of part[row_blk][k][row % bt]: a warp takes
    // eight rows, four lanes a row; lane p sums k = p, p + 4, ... in order
    // and the row is (s0 + s1) + (s2 + s3).  Each lane's loads are
    // independent, so a row costs a few L2 round trips, not g; consecutive
    // warps of the grid lie in different blocks, so every SM shares the work
    for (int base = (warp * nb + b) * 8; base < n; base += nb * kWarps * 8) {
      const int row = base + (lane & 7);  // n % 8 == 0: every lane has a row
      const int rb = row / bt;
      const float* p = part + static_cast<size_t>(rb) * g * bt + (row - rb * bt);
      float s = 0.0f;
#pragma unroll 8
      for (int k = lane >> 3; k < g; k += 4) s += __ldcg(p + static_cast<size_t>(k) * bt);
      const float s1 = __shfl_down_sync(0xffffffffu, s, 8);
      const float s2 = __shfl_down_sync(0xffffffffu, s, 16);
      const float s3 = __shfl_down_sync(0xffffffffu, s, 24);
      if (lane < 8) __stcg(raw + row, (s + s1) + (s2 + s3));
    }
    did = true;
    grid.sync();
  }

  // A frozen solve keeps the v it stopped on (the previous matvec / ev, or
  // the input if it stopped at r == 0); a running one leaves the division
  // of its last matvec to this epilogue.
  for (int j = blockIdx.x * kThreads + tid; j < n; j += gridDim.x * kThreads) {
    ev_out[j] = ev_s[j];
    v_out[j] = did ? __ldcg(raw + j) / ev_s[j] : v_in[j];
  }
  if (blockIdx.x == 0 && tid == 0) {
    *adv_out = adv;
    *lam_out = lam;
  }
}

}  // namespace

// Co-resident blocks of the kernel at (n, bt, slots resident tiles per
// block) on the current device, 0 if one block does not fit, or a negated
// cudaError_t.  Also raises the kernel's dynamic shared-memory limit to the
// most the card allows.
extern "C" int evt_multiround_sym_grid(int n, int bt, int slots) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr;
  const size_t smem = smem_bytes(n, bt, slots);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, multiround_sym_kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const size_t limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  if (smem > limit) return 0;
  e = cudaFuncSetAttribute(multiround_sym_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(limit));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multiround_sym_kernel, kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

// A (n, n) row-major; tiles (T + C) int32 pairs; ev_in, v_in, ev_out, v_out
// (n,); lam_in, lam_out (1,); adv_out (1,) int32; raw (n,) and part (g * n,)
// scratch; all on the current device.  `grid` blocks must be co-resident
// with `slots` resident tiles each (evt_multiround_sym_grid) and
// grid * slots >= C.  Launches on `stream` and does not synchronise.
// Returns the launch's cudaError_t (0 on success).
extern "C" int evt_multiround_sym(const float* A, const int* tiles, int T,
                                  int C, int slots, const float* ev_in,
                                  const float* v_in, const float* lam_in,
                                  int budget, float* ev_out, float* v_out,
                                  int* adv_out, float* lam_out, float* raw,
                                  float* part, int n, int bt, int chunk,
                                  float eps, int init, int rel, int sym,
                                  int grid, void* stream) {
  const size_t smem = smem_bytes(n, bt, slots);
  const int2* tiles2 = reinterpret_cast<const int2*>(tiles);
  void* args[] = {&A,      &tiles2, &T,     &C,       &slots, &ev_in,
                  &v_in,   &lam_in, &budget, &ev_out, &v_out, &adv_out,
                  &lam_out, &raw,   &part,  &n,       &bt,    &chunk,
                  &eps,    &init,   &rel,   &sym};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)multiround_sym_kernel, dim3(grid), dim3(kThreads), args,
      smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
