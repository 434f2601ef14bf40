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
// Bound on the H100: bytes.  At 8192^2 with bt = 128 a round needs the 2080
// upper-triangle tiles, 2080 * 64 KiB = 136 MB (the dense pass reads
// 268 MB); 2 flops per 4-byte element leave the card waiting on memory.
// What a round costs is the tiles it must fetch from device memory plus
// the time in which no tile is in flight: two grid barriers, the sum of
// the tile terms and the O(n) prologue (measured at 8192^2 before this
// design, 264 resident tiles: 45.5 us of stream at 2.6 TB/s, 3.5 + 1.8 us
// of barriers, 1.7 us of sum and 7.7 us of prologue in a round of 60.0 us).
// A block that fills its shared memory with tiles has next to no L1 left,
// so a register spilled anywhere in the round goes to L2, slows the stream
// and the prologue and pushes kept tiles out of L2.  Design against that:
//   * each upper tile is read once per round and used twice: its row term
//     T . ev[j_blk] feeds rows i_blk, and off the diagonal its transpose
//     term T^T . ev[i_blk] feeds rows j_blk (A[j][i] == A[i][j]).  Diagonal
//     tiles are read whole and give the row term only.  Tiles strictly
//     below the block diagonal are never touched;
//   * a resident tile s lives in shared memory of block s % grid, loaded
//     once at the start of the launch and read from there in every round
//     of that launch, so it crosses device memory once per launch instead
//     of once per round.  A block's shared memory holds ev and tiles and
//     nothing else (the column sums of a tile stay in registers), so three
//     64 KiB tiles fit a block at n = 8192: 396 tiles, 26 MB.  The budget
//     comes from the card (device.sym_auto_cache_tiles);
//   * a second resident level in L2: the first `l2_tiles` streamed tiles
//     are read with an evict_last policy, every other byte of A with
//     evict_first, so the stream passes by them (3/8 of the L2, or 5/8
//     where little streams by, device.l2_resident_bytes: 300 tiles at
//     8192^2);
//   * sixteen warps a block, 128 registers a thread, nothing spilled; one
//     warp per work item, no block barrier inside a round's tile phase: a
//     block's items (its streamed tiles, then its resident ones) go to its
//     warps in turn, one each at n = 8192.  An item is a whole tile or,
//     when the card has few tiles a block (`split`: small n), one 32-row
//     group of a tile, so that every warp has work.  In each group lane l
//     owns the float4 of columns 4l..4l+3 and has eight row segments in
//     flight.  The row term is a dot4 per lane and a __shfl_xor_sync
//     butterfly (lane r keeps row r's sum); the transpose term is four
//     column accumulators per lane (an fmaf chain over the group's 32
//     rows), the groups added in order.
// The cross-block sum has no atomics.  On the TPU the row sums were carried
// across sequential grid steps in VMEM; here the tiles feeding one row
// block run in different blocks, in no order.  So:
//   1. tile (i, j) writes its row term to slot part[i][j] (bt floats; slot
//      [b][k] is the share of column block k in row block b) and the
//      transpose term of each of its row groups to slot part_t[j][i][group]
//      (one group when the tile is one item);
//   2. after a grid barrier the grid reduces rows in parallel, each row
//      over k = 0..g-1 in fixed order (eight partial sums by k % 8, on
//      eight lanes, joined by a butterfly; a transpose slot's groups added
//      left to right first), into raw;
//   3. after a second barrier every block runs the redundant O(n) prologue
//      (shared with multiround.cu) on its own copy of ev.
// The sum depends neither on which block or warp did a tile or a group nor
// on where the tile lay, so results are bit-identical for every cache size,
// every chunking and whatever the lower block triangle holds.
// A may be stored in bf16 or f16 (reduced-precision storage, as the TPU
// kernel's tiles cast up to f32 at kernels.py:889, :947, :999): tiles stream
// and stay resident in 2 bytes, so a block holds twice the tiles beside ev
// (six 32 KiB tiles at n = 8192: 792), a lane reads its four columns of a
// row as one 8-byte load, and each chunk is converted to f32 exactly before
// the f32 row and transpose terms.  The work items, slots and sums are
// those of the f32 kernel (the split depends on n, bt and the card only),
// so a launch on A_q gives the bits of a launch on A_q.float(), for every
// cache size.  All O(n) state stays f32.
// Measured and not here: asking the L2 for the next round's first rows
// before the barriers (no gain); loading a warp's first eight row segments
// of the next round into registers before the barriers (32 more live
// registers spill: +9% at 8192^2); cutting tiles into groups at 8192^2
// (more slots to sum than warps gained: +15%).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "prologue.cuh"
#include "rowdot.cuh"

namespace cg = cooperative_groups;

namespace {

// Sixteen warps a block: at n = 8192 a block has 13 streamed and 3 resident
// tiles a round, one a warp, and 128 registers a thread hold a warp's row
// segments in flight, the column sums and the prologue's v without a spill.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // float4 chunks of v a thread holds in the prologue

constexpr int kChunk = 128;  // columns per pass over a tile: a float4 a lane
constexpr int kGroup = 32;   // rows whose sums one butterfly round leaves on the lanes
// rows of a tile whose loads a warp issues together (measured at 8192^2: 4
// cost 10% more, 16 spill and cost 3% more; with 2-byte tiles, whose eight
// rows put half the bytes in flight, 16 were slower too)
constexpr int kAhead = 8;
constexpr int kClasses = 8;  // lanes that share a row's sum over the column blocks
constexpr int kRowsPerWarp = 32 / kClasses;

// Dynamic shared memory: ev (n floats) | resident tiles (slots * bt^2
// elements of S, A's storage type).  device.sym_smem_bytes mirrors this.
template <class S>
size_t smem_bytes(int n, int bt, int slots) {
  return static_cast<size_t>(n) * sizeof(float) +
         static_cast<size_t>(slots) * bt * bt * sizeof(S);
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// One warp's pass over rows [r_lo, r_hi) (whole groups) of tile (i, j), row
// r at src + r * stride (A in device memory, or a resident copy in shared
// memory; element type S), read through `load`.  Writes the row term
// T . ev[j_blk] of these rows to `row_out` (the tile's slot) and, when
// `trans`, the transpose term T^T . ev[i_blk] of these rows to `col_out`
// (bt floats).
template <class S, class Load>
__device__ __forceinline__ void tile_terms(const S* src, size_t stride, int bt,
                                           int r_lo, int r_hi, bool trans,
                                           const float* evi, const float* evj,
                                           float* row_out, float* col_out, int lane,
                                           Load load) {
  using E = evt::Elem<S>;
  using Chunk = typename E::Chunk;
  const size_t stride4 = stride >> 2;  // chunks of four elements a row
  for (int q = 0; q < bt; q += kChunk) {
    const float4 x = reinterpret_cast<const float4*>(evj + q)[lane];
    const Chunk* p = reinterpret_cast<const Chunk*>(src + q) + lane + r_lo * stride4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the groups so far
    for (int g0 = r_lo; g0 < r_hi; g0 += kGroup) {
      float4 col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // this group's rows
      float mine = 0.0f;  // row g0 + lane of this chunk
#pragma unroll 1
      for (int r8 = 0; r8 < kGroup; r8 += kAhead) {
        Chunk c[kAhead];  // kAhead row segments in flight per lane
#pragma unroll
        for (int u = 0; u < kAhead; ++u) c[u] = load(p + u * stride4);
        p += kAhead * stride4;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const float4 a = E::up(c[u]);
          const float d = warp_sum(evt::dot4(a, x));
          if (lane == r8 + u) mine = d;
          if (trans) {
            const float e = evi[g0 + r8 + u];
            col.x = fmaf(a.x, e, col.x);
            col.y = fmaf(a.y, e, col.y);
            col.z = fmaf(a.z, e, col.z);
            col.w = fmaf(a.w, e, col.w);
          }
        }
      }
      // chunks in order; the same lane wrote the earlier ones
      float* out = row_out + g0 + lane;
      __stcg(out, q == 0 ? mine : __ldcg(out) + mine);
      acc = g0 == r_lo ? col
                       : make_float4(acc.x + col.x, acc.y + col.y, acc.z + col.z,
                                     acc.w + col.w);
    }
    if (trans) __stcg(reinterpret_cast<float4*>(col_out + q) + lane, acc);
  }
}

// One row's sum over the column blocks k = k0, k0 + kClasses, ... in that order.
// A slot below `below` is a transpose term, its `split` groups added left to
// right (kSplit: `split` at compile time, or 0 for any); the others are row
// terms.  The loads do not depend on the sums, so unrolling keeps them in
// flight together.
template <int kSplit>
__device__ __forceinline__ float slot_sum(const float* p, const float* pt, int k0,
                                          int below, int g, int bt, int split) {
  const int groups = kSplit ? kSplit : split;
  float s = 0.0f;
#pragma unroll 8
  for (int k = k0; k < g; k += kClasses) {
    const bool t = k < below;
    const float* slot = t ? pt + static_cast<size_t>(k) * groups * bt
                          : p + static_cast<size_t>(k) * bt;
    float term = __ldcg(slot);
    if (kSplit != 1 && t) {
      if (kSplit) {
#pragma unroll
        for (int c = 1; c < kSplit; ++c) term += __ldcg(slot + c * bt);
      } else {
        for (int c = 1; c < groups; ++c) term += __ldcg(slot + c * bt);
      }
    }
    s += term;
  }
  return s;
}

// tiles: T streamed (i, j) pairs, then C resident ones.  part: g * n floats;
// part_t: g * n * split floats (sym only).  split: 1 (an item is a tile) or
// bt / 32 (an item is a 32-row group).
template <class S>
__global__ void __launch_bounds__(kThreads) multiround_sym_kernel(
    const S* __restrict__ A, const int2* __restrict__ tiles, int T, int C,
    int slots, const float* __restrict__ ev_in, const float* __restrict__ v_in,
    const float* __restrict__ lam_in, int budget, float* __restrict__ ev_out,
    float* __restrict__ v_out, int* __restrict__ adv_out,
    float* __restrict__ lam_out, float* raw, float* part, float* part_t, int n,
    int bt, int chunk, float eps, int init, int rel, int sym, int split,
    int l2_tiles, unsigned long long* stamps) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* ev_s = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  using Chunk = typename evt::Elem<S>::Chunk;
  S* cache = reinterpret_cast<S*>(ev_s + n);  // 16-byte aligned: n % 128 == 0
  __shared__ float red[3][evt::kWarps];
  __shared__ float stats[3];

  const int g = n / bt;
  const size_t tile_elems = static_cast<size_t>(bt) * bt;
  // this block's tiles: streamed t = blockIdx.x + m * gridDim.x, then its
  // resident tiles s = blockIdx.x + k * gridDim.x (slot k); an item is one
  // of `split` row spans of a tile
  const int b = blockIdx.x, nb = gridDim.x;
  const int nstream = b < T ? (T - 1 - b) / nb + 1 : 0;
  const int ncached = b < C ? min(slots, (C - 1 - b) / nb + 1) : 0;
  const int span = bt / split;
  const evt::FromGlobalHinted keep{evt::l2_evict_last()};
  const evt::FromGlobalHinted pass{evt::l2_evict_first()};

  for (int j = tid; j < n; j += kThreads) ev_s[j] = ev_in[j];
  // fill this block's resident tiles, once per launch
  for (int k = 0; k < ncached; ++k) {
    const int2 ij = tiles[T + b + k * nb];
    const S* src = A + static_cast<size_t>(ij.x) * bt * n +
                   static_cast<size_t>(ij.y) * bt;
    Chunk* dst = reinterpret_cast<Chunk*>(cache + k * tile_elems);
    const int q4 = bt / 4;
#pragma unroll 4
    for (int e = tid; e < bt * q4; e += kThreads) {
      const int r = e / q4;
      dst[e] = pass(reinterpret_cast<const Chunk*>(src + static_cast<size_t>(r) * n) +
                    (e - r * q4));
    }
  }
  __syncthreads();

  int adv = 0;
  float lam = *lam_in;
  bool did = false;  // raw holds a matvec of this launch
  for (int r = 0; r < chunk; ++r) {
    evt::stamp(stamps, r, 0, false);
    if (!init || r != 0) {
      if (evt::round_prologue<kThreads, kBatch>(v_in, raw, r == 0, ev_s, n, eps, rel,
                                                budget, adv, lam, red, stats))
        break;  // same decision in every block
    }
    evt::stamp(stamps, r, 1, false);
    for (int e = warp; e < (nstream + ncached) * split; e += kWarps) {
      const int m = e / split, lo = (e - m * split) * span;
      const bool streamed = m < nstream;
      const int t = streamed ? b + m * nb : T + b + (m - nstream) * nb;
      const int2 ij = tiles[t];
      const bool trans = sym && ij.x != ij.y;
      const float* evi = ev_s + static_cast<size_t>(ij.x) * bt;
      const float* evj = ev_s + static_cast<size_t>(ij.y) * bt;
      float* row_out = part + (static_cast<size_t>(ij.x) * g + ij.y) * bt;
      float* col_out =
          part_t + ((static_cast<size_t>(ij.y) * g + ij.x) * split + lo / span) * bt;
      if (streamed) {
        const S* src = A + static_cast<size_t>(ij.x) * bt * n +
                       static_cast<size_t>(ij.y) * bt;
        tile_terms(src, n, bt, lo, lo + span, trans, evi, evj, row_out, col_out,
                   lane, t < l2_tiles ? keep : pass);
      } else {
        tile_terms(cache + (m - nstream) * tile_elems, bt, bt, lo, lo + span,
                   trans, evi, evj, row_out, col_out, lane, evt::FromShared());
      }
    }
    evt::stamp(stamps, r, 2, true);
    grid.sync();
    evt::stamp(stamps, r, 3, false);
    // raw[row] = sum over k of slot [row_blk][k][row % bt]: a warp takes
    // kRowsPerWarp rows, kClasses lanes a row; lane c sums k = c, c +
    // kClasses, ... in order and a butterfly over the row's lanes adds the
    // classes.  A slot below the diagonal of a symmetric A is a transpose
    // term, its groups added left to right.  A lane's loads do not depend on
    // each other, so a row costs one L2 round trip; consecutive warps of the
    // grid lie in different blocks, so every SM shares the work
    for (int base = (warp * nb + b) * kRowsPerWarp; base < n;
         base += nb * kWarps * kRowsPerWarp) {
      const int row = base + lane / kClasses;  // n % 128 == 0: every lane has a row
      const int rb = row / bt;
      const int below = sym ? rb : 0;  // column blocks whose slot is a transpose term
      const float* p = part + static_cast<size_t>(rb) * g * bt + (row - rb * bt);
      const float* pt =
          part_t + static_cast<size_t>(rb) * g * split * bt + (row - rb * bt);
      const int c = lane % kClasses;
      float s = split == 1   ? slot_sum<1>(p, pt, c, below, g, bt, split)
                : split == 4 ? slot_sum<4>(p, pt, c, below, g, bt, split)
                             : slot_sum<0>(p, pt, c, below, g, bt, split);
#pragma unroll
      for (int off = kClasses / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (c == 0) __stcg(raw + row, s);
    }
    did = true;
    evt::stamp(stamps, r, 4, true);
    grid.sync();
    evt::stamp(stamps, r, 5, false);
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

template <class S>
int grid_of(int n, int bt, int slots) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr;
  const size_t smem = smem_bytes<S>(n, bt, slots);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, multiround_sym_kernel<S>);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const size_t limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  if (smem > limit) return 0;
  e = cudaFuncSetAttribute(multiround_sym_kernel<S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(limit));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multiround_sym_kernel<S>, kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

}  // namespace

// Co-resident blocks of the kernel at (n, bt, slots resident tiles per
// block, element type `elem`: 0 float32, 1 bfloat16, 2 float16) on the
// current device, 0 if one block does not fit, or a negated cudaError_t.
// Also raises the kernel's dynamic shared-memory limit to the most the card
// allows.
extern "C" int evt_multiround_sym_grid(int n, int bt, int slots, int elem) {
  if (elem < 0 || elem > 2) return -static_cast<int>(cudaErrorInvalidValue);
  return evt::with_elem(elem, [&](auto tag) {
    return grid_of<typename decltype(tag)::type>(n, bt, slots);
  });
}

// A (n, n) row-major in the element type `elem` names (0 float32, 1
// bfloat16, 2 float16); tiles (T + C) int32 pairs; ev_in, v_in, ev_out, v_out
// (n,); lam_in, lam_out (1,); adv_out (1,) int32; raw (n,), part (g * n,)
// and part_t (g * n * split,; one float when not sym) scratch; all on the
// current device.  `grid` blocks must be co-resident with `slots` resident
// tiles each (evt_multiround_sym_grid) and grid * slots >= C.  `split` is 1
// or bt / 32; the first `l2_tiles` streamed tiles are kept in L2.  `stamps`
// is null, or kStampRounds * kStampPhases * grid words for the phase
// stamps.  Launches on `stream` and does not synchronise.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int evt_multiround_sym(const void* A, const int* tiles, int T,
                                  int C, int slots, const float* ev_in,
                                  const float* v_in, const float* lam_in,
                                  int budget, float* ev_out, float* v_out,
                                  int* adv_out, float* lam_out, float* raw,
                                  float* part, float* part_t, int n, int bt,
                                  int chunk, float eps, int init, int rel,
                                  int sym, int split, int l2_tiles,
                                  void* stamps, int elem, int grid, void* stream) {
  const int2* tiles2 = reinterpret_cast<const int2*>(tiles);
  void* args[] = {&A,       &tiles2,   &T,        &C,      &slots,  &ev_in,
                  &v_in,    &lam_in,   &budget,   &ev_out, &v_out,  &adv_out,
                  &lam_out, &raw,      &part,     &part_t, &n,      &bt,
                  &chunk,   &eps,      &init,     &rel,    &sym,    &split,
                  &l2_tiles, &stamps};
  return evt::with_elem(elem, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)multiround_sym_kernel<E>, dim3(grid), dim3(kThreads), args,
        smem_bytes<E>(n, bt, slots), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}
