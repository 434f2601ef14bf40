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
//
// The bulk-copy ring (`ring` > 0 stages a warp; the plan's choice,
// device.multiround_plan, from n, A's element size and the card): the
// streamed rows do not pass through registers.  Each warp owns `ring`
// stages of kSegChunks chunks (1 KB of a bf16 row, 2 KB of an f32 one) and
// one mbarrier per stage in shared memory, after the resident rows.  Lane 0
// issues 1-D cp.async.bulk copies of its warp's streamed rows, a segment a
// copy, with the L2 policy of the load it replaces (evict_last for the
// first l2_rows streamed rows, evict_first for the rest), `ring` copies
// ahead of the warp's reads; the warp reads a stage from shared memory in
// row_dot's lane order (evt::seg_dot: the same chunks, accumulators and
// fmaf chains, so the same bits), and only then issues the copy that reuses
// the stage.  A is the same in every round, so the copy sequence is cyclic:
// the copies ahead of the warp's last segment of round r are the first
// segments of round r + 1, in flight across the grid barrier and the
// prologue with no register holding them.  Measured at 8192^2 (PERF.md):
// one stage a warp takes 1% off the bf16 launch (the barrier, not the
// stream: a ring byte costs a resident byte) and cost 15% at 4096^2, where
// every row stays on the chip; any depth cost the f32 launch 12%.  So the
// plan gives one stage to a 2-byte A whose rows stream from device memory,
// and none otherwise.  Constraints:
//   * shared memory: the stages take resident rows (32 warps x 1 KB a stage
//     is two 16 KB bf16 rows at n = 8192); the plan counts both;
//   * threads and registers: 1024 threads of 64 registers leave no room for
//     a producer warp, so an elected lane of each consumer warp issues;
//   * no empty barriers, no wait across warps: a warp's stages are its own,
//     and copy t waits on stage t % ring with parity (t / ring) & 1 only
//     after copy t - ring was read, so no wait can be a phase ahead;
//   * no copy in flight at exit: a block that leaves the round loop (the
//     solve froze, or the chunk ended) waits for every copy it issued;
//   * A must be 16-byte aligned and n * sizeof(T) a multiple of 16 (the
//     plan gives no ring otherwise; the wrapper checks A's address).
//
// The "dot" formulation (kDot; `dot` = 1, the plan gives it no ring): the
// row sums on the tensor cores in 3xTF32 (mma_tf32.cuh) instead of
// row_dot's fmaf chains, as the TPU kernel's formulation="dot" contracts a
// row stripe on its matrix unit (kernels.py:546-554).  It reads the same
// resident rows, L2 band and streamed rows with the same policies, so it
// moves the same bytes as the register path.  A work item is 16 of a
// block's rows (k = 16 grp .. 16 grp + 15, the m16 of the unit; rows past
// the block's last give zeros and are not read) times one of kDotSegments
// column segments (n / 8 columns: at n = 8192 the 4 row groups of a block
// make 32 items for its 16 warps; the dot instance runs kDotThreads
// threads of up to 128 registers).  The groups that hold a block's resident
// rows are its own; where a block has a row group's worth of rows from
// device memory, every other item is in one pool for the grid, claimed by
// an atomic counter a round, because at 8192^2 the blocks' stream times
// were fixed by where they ran (95.7-111.0 us a round, the slowest in runs
// of four block indices, the same in two launches; PERF.md §6), and the
// round waited for the slowest.  A lane reads four consecutive columns of
// its rows g and g + 8 (16 bytes of f32, 8 of bf16 / f16), two f32 or four
// 2-byte 16-column regions a batch; the warp chains the unit's
// products over each 128 columns in four interleaved chains and adds the
// 128-column sums in order in f32 (dot_segment says why).  A warp holds
// few loads in flight (16 warps of 128 registers) and waits on memory
// more than it issues, so: each load asks the L2 for its 128-byte
// unit (ld's prefetch-size hint), the warp asks the L2 for its rows' next
// 128-column block while it works on one (a bulk prefetch a row, with the
// row's policy), and in f32 the next batch's loads go out before this
// batch's products.  Lanes 4g write the segment's
// sums of rows g and g + 8 to `part` (kDotSegments * n floats); after a
// grid barrier (a block barrier without the pool) each block adds the
// segments of each of its rows in order,
// s = 0 .. 7, into the raw row sums, and the round goes on as in the other
// instances.  Every row's sum is the same chain of products and the same
// order of segments whichever block, warp or group holds it and wherever
// its bytes lie (an output row of the unit depends on its own row of A
// only), so the results do not depend on the plan: a launch on A_q gives
// the bits of a launch on A_q.float(), and any chunking the bits of one
// launch.  The unit's order of the 8 products inside a step is its own, so
// the sums are not row_dot's: a dot solve agrees with a vpu solve in rounds
// and within rounding (the TPU kernel's contract between its formulations).
// n % 128 == 0 (the TPU kernel's "dot" stripe alignment; the wrapper checks).
// The only atomic is the dot pool's counter, which decides who computes an
// item and not how: the results are bitwise reproducible.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "mma_tf32.cuh"
#include "prologue.cuh"
#include "rowdot.cuh"

namespace cg = cooperative_groups;

namespace {

using evt::kThreads;
using evt::kWarps;

constexpr int kBatch = 2;  // float4 chunks of v a thread holds in the prologue

using evt::kSegChunks;

constexpr int kDotSegments = 8;  // column segments of a row in the dot formulation
constexpr int kDotRows = 16;     // rows of a work item: the unit's m16
constexpr int kDotBlock = 128;   // columns of one chain of the unit's products
constexpr int kDotAcc = 4;       // chains in flight: a 128-column block's region r goes to r % 4
// The dot instance's block: sixteen warps of up to 128 registers (its loads
// in flight, four accumulators and the splits do not fit 64 without spills)
constexpr int kDotThreads = 512;

// Where a row of a dot work item comes from: nowhere (past the block's
// rows: zeros), the block's shared memory, or device memory with an L2
// policy.
template <class T>
struct DotRow {
  using Chunk = typename evt::Elem<T>::Chunk;
  const Chunk* p;  // the row's chunks
  int where;       // 0 none, 1 shared, 2 device memory
  unsigned long long policy;

  __device__ __forceinline__ Chunk operator()(int c) const {
    if (where == 0) return Chunk{};
    return where == 1 ? p[c] : evt::FromGlobalAhead<128>{policy}(p + c);
  }

  // Asks the L2 for the 128 elements from chunk c on, with the row's policy,
  // where the row lies in device memory.
  __device__ __forceinline__ void prefetch(int c) const {
    if (where == 2) evt::bulk_prefetch_l2(p + c, 128 * sizeof(T), policy);
  }
};

// The dot formulation's work item: rows k = 16 rg + g and 16 rg + g + 8 of
// the block (lane (g, t)), columns [c0, c1) (a segment; c1 - c0 a multiple
// of 16); the segment's sums of the two rows land in s[0] and s[1] of lane
// 4g.  The unit's accumulator truncates where a rounding adder would round
// (on the H100 one chain over 1024 columns put the stripes' λ outside 1e-5
// of a float64 loop at 8192^2), so each kDotBlock columns start fresh
// chains, and the blocks are added in order in f32, as the triangle's
// 128-column tiles are.
// In a block, 16-column region r goes to chain r % kDotAcc (independent
// chains keep the unit busy while one product waits for the last), and the
// chains are added as (0 + 1) + (2 + 3).
template <class T>
__device__ __forceinline__ void dot_segment(const DotRow<T>& lo, const DotRow<T>& hi,
                                            const float* ev_s, int c0, int c1, int lane,
                                            float (&s)[2]) {
  using E = evt::Elem<T>;
  using Chunk = typename E::Chunk;
  constexpr bool kExact = sizeof(T) < sizeof(float);  // a 2-byte A is exact in TF32
  constexpr int kRegions = kDotBlock / 16;
  // 16-column regions whose loads are issued together: two f32 ones (16
  // registers a lane) or four 2-byte ones; a whole block is unrolled, so the
  // compiler may issue the next regions' loads before this one's products
  constexpr int kB = sizeof(Chunk) == sizeof(float4) ? 2 : 4;
  // f32: the next batch's loads go out before this batch's products
  // (measured at 8192^2 it took the stream phase 97 -> 92 us a round at 28
  // bytes of spill; the 2-byte instances lost 6% by it)
  constexpr bool kPipe = !kExact;
  const int t = lane & 3;
  const float4* e4 = reinterpret_cast<const float4*>(ev_s);
  s[0] = s[1] = 0.0f;
  Chunk x[kB], y[kB];  // the batch in hand: the first one of the segment
  if (kPipe && c0 + kDotBlock <= c1) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      x[u] = lo((c0 >> 2) + 4 * u + t);
      y[u] = hi((c0 >> 2) + 4 * u + t);
    }
  }
  for (int b0 = c0; b0 < c1; b0 += kDotBlock) {
    // the next block's rows from device memory into L2 while this one runs:
    // a warp holds too few loads in flight to cover the latency of device
    // memory (PERF.md §6)
    if (b0 + kDotBlock < c1 && t == 0) {  // lane (g, 0) for rows g and g + 8
      lo.prefetch((b0 + kDotBlock) >> 2);
      hi.prefetch((b0 + kDotBlock) >> 2);
    }
    float d[kDotAcc][4];
#pragma unroll
    for (int a = 0; a < kDotAcc; ++a) d[a][0] = d[a][1] = d[a][2] = d[a][3] = 0.0f;
    if (b0 + kDotBlock <= c1) {
#pragma unroll
      for (int u0 = 0; u0 < kRegions; u0 += kB) {
        // kPipe: the next batch (the first of the next full block after the
        // last of this one) into nx, ny; else this batch into x, y
        const int nb = !kPipe || u0 + kB < kRegions ? b0 : b0 + kDotBlock;
        const int nu = !kPipe ? u0 : u0 + kB < kRegions ? u0 + kB : 0;
        Chunk nx[kB], ny[kB];
        if (nb + kDotBlock <= c1) {
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            const int q = (nb >> 2) + 4 * (nu + u) + t;
            (kPipe ? nx : x)[u] = lo(q);
            (kPipe ? ny : y)[u] = hi(q);
          }
        }
#pragma unroll
        for (int u = 0; u < kB; ++u)
          evt::mma_rows16<kExact>(d[(u0 + u) % kDotAcc], evt::tf32_split4<kExact>(E::up(x[u])),
                                  evt::tf32_split4<kExact>(E::up(y[u])),
                                  evt::tf32_split4(e4[(b0 >> 2) + 4 * (u0 + u) + t]));
#pragma unroll
        for (int u = 0; u < kB && kPipe; ++u) {
          x[u] = nx[u];
          y[u] = ny[u];
        }
      }
    } else {  // a segment shorter than a block (n < 1024)
#pragma unroll
      for (int u = 0; u < kRegions; ++u) {
        if (b0 + 16 * u < c1) {
          const int q = (b0 >> 2) + 4 * u + t;
          evt::mma_rows16<kExact>(d[u % kDotAcc], evt::tf32_split4<kExact>(E::up(lo(q))),
                                  evt::tf32_split4<kExact>(E::up(hi(q))),
                                  evt::tf32_split4(e4[q]));
        }
      }
    }
    s[0] += (d[0][0] + d[1][0]) + (d[2][0] + d[3][0]);
    s[1] += (d[0][2] + d[1][2]) + (d[2][2] + d[3][2]);
  }
}

// Dynamic shared memory: ev (n floats) | resident rows (resident * n
// elements of T) | ring stages (kWarps * ring, kSegChunks chunks each) |
// their mbarriers (kWarps * ring).  device.multiround_smem_bytes mirrors this.
template <class T>
size_t stage_bytes() {
  return kSegChunks * sizeof(typename evt::Elem<T>::Chunk);
}

template <class T>
size_t smem_bytes(int n, int resident, int ring) {
  return static_cast<size_t>(n) * (sizeof(float) + static_cast<size_t>(resident) * sizeof(T)) +
         static_cast<size_t>(ring) * kWarps * (stage_bytes<T>() + 8);
}

// A warp's ring over its streamed rows q = 0 .. nq - 1 (work item warp +
// q * kWarps, segments j = 0 .. nseg - 1 each), cyclic over the rounds.
template <class T>
struct StripeRing {
  using Chunk = typename evt::Elem<T>::Chunk;
  Chunk* stages;  // ring stages of kSegChunks chunks
  unsigned long long* bars;
  int ring, nq, nseg;
  const T* A;
  int n, b, G, nres, warp, l2_rows;  // streamed row q is b + (nres + warp + q * kWarps) * G
  unsigned long long keep, pass;     // the L2 policies
  unsigned used, issued;  // copies read, copies issued
  int q, j;               // the next copy: segment j of streamed row q

  // Lane 0 issues the next copy of the sequence into stage issued % ring.
  __device__ __forceinline__ void issue(int lane) {
    if (lane == 0) {
      const int m = warp + q * kWarps;
      const int base = j * kSegChunks;
      const int n4 = n >> 2;
      const unsigned bytes =
          static_cast<unsigned>(min(kSegChunks, n4 - base) * sizeof(Chunk));
      const int s = static_cast<int>(issued % ring);
      const Chunk* src =
          reinterpret_cast<const Chunk*>(A + static_cast<size_t>(b + (nres + m) * G) * n) + base;
      evt::fence_proxy_async();
      evt::mbar_expect(bars + s, bytes);
      evt::bulk_copy(stages + s * kSegChunks, src, bytes, bars + s, m < l2_rows ? keep : pass);
    }
    ++issued;
    if (++j == nseg) {
      j = 0;
      if (++q == nq) q = 0;
    }
  }

  // Waits for the next copy and returns its stage.
  __device__ __forceinline__ const Chunk* take() {
    const unsigned s = used % ring;
    evt::mbar_wait(bars + s, (used / ring) & 1u);
    return stages + s * kSegChunks;
  }

  // Waits for every copy still in flight.
  __device__ __forceinline__ void drain() {
    for (; used < issued; ++used) evt::mbar_wait(bars + used % ring, (used / ring) & 1u);
  }
};

// kRing: the instance with the ring (a launch whose plan has `ring` > 0);
// the other is the register path alone, so the ring's code costs it no
// register.  kDot: the dot formulation (register path, no ring, kDotThreads
// threads).
template <class T, bool kRing, bool kDot = false>
__global__ void __launch_bounds__(kDot ? kDotThreads : kThreads) multiround_kernel(
    const T* __restrict__ A, const float* __restrict__ ev_in,
    const float* __restrict__ v_in, const float* __restrict__ lam_in,
    int budget, float* __restrict__ ev_out, float* __restrict__ v_out,
    int* __restrict__ adv_out, float* __restrict__ lam_out, int* __restrict__ rounds_out,
    bool* __restrict__ converged_out, int rounds0,
    float* __restrict__ raw, int n, int chunk, float eps, int init, int rel,
    int resident, int l2_rows, int ring, float* __restrict__ part, int* __restrict__ work,
    unsigned long long* stamps) {
  static_assert(!(kRing && kDot), "the dot formulation has no ring");
  constexpr int kT = kDot ? kDotThreads : kThreads, kW = kT / 32;
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

  // this warp's ring, after the resident rows (16-byte aligned: the plan
  // gives a ring only where n * sizeof(T) is a multiple of 16)
  T* ring_s = rows_s + static_cast<size_t>(resident) * n;
  StripeRing<T> rg;
  Chunk* ring_c = reinterpret_cast<Chunk*>(ring_s);
  rg.stages = ring_c + static_cast<size_t>(warp) * ring * kSegChunks;
  rg.bars = reinterpret_cast<unsigned long long*>(ring_c + static_cast<size_t>(kWarps) * ring *
                                                               kSegChunks) +
            warp * ring;
  rg.ring = ring;
  rg.nq = kRing && ring && warp < nstream ? (nstream - 1 - warp) / kWarps + 1 : 0;
  rg.nseg = (n / 4 + kSegChunks - 1) / kSegChunks;
  rg.A = A;
  rg.n = n;
  rg.b = b;
  rg.G = G;
  rg.nres = nres;
  rg.warp = warp;
  rg.l2_rows = l2_rows;
  rg.keep = keep.policy;
  rg.pass = pass.policy;
  rg.used = rg.issued = 0;
  rg.q = rg.j = 0;
  if (rg.nq && lane == 0) {
    for (int s = 0; s < ring; ++s) evt::mbar_init(rg.bars + s);
    evt::mbar_init_fence();
  }

  for (int j = tid; j < n; j += kT) ev_s[j] = ev_in[j];
  // fill the resident rows, once per launch
  if ((n & 3) == 0) {
    const int n4 = n >> 2;
    Chunk* dst = reinterpret_cast<Chunk*>(rows_s);
#pragma unroll 4
    for (int e = tid; e < nres * n4; e += kT) {
      const int k = e / n4;
      dst[e] = pass(reinterpret_cast<const Chunk*>(
                        A + static_cast<size_t>(b + k * G) * n) + (e - k * n4));
    }
  } else {
    Bits* dst = reinterpret_cast<Bits*>(rows_s);
    for (int e = tid; e < nres * n; e += kT) {
      const int k = e / n;
      dst[e] = pass(reinterpret_cast<const Bits*>(A + static_cast<size_t>(b + k * G) * n) +
                    (e - k * n));
    }
  }
  __syncthreads();
  for (int s = 0; s < (rg.nq ? ring : 0); ++s) rg.issue(lane);

  int adv = 0;
  float lam = *lam_in;
  int last = -1;  // raw buffer of the latest matvec, -1 before the first
  for (int r = 0; r < chunk; ++r) {
    evt::stamp(stamps, r, 0, false);
    // this round's v: the input at r == 0, else the previous matvec / ev
    const float* prev = raw + static_cast<size_t>((r + 1) & 1) * n;
    if (!init || r != 0) {
      // half the threads take twice the chunks of v in the dot instance
      if (evt::round_prologue<kT, kBatch * kThreads / kT>(v_in, prev, r == 0, ev_s, n, eps,
                                                          rel, budget, adv, lam, red, stats))
        break;  // same decision in every block
    }
    evt::stamp(stamps, r, 1, false);
    float* out = raw + static_cast<size_t>(r & 1) * n;
    if constexpr (kDot) {
      // A work item: row group grp (rows k = 16 grp .. 16 grp + 15) of block
      // bb times column segment s.  Where a block has a row group's worth
      // of rows from device memory, the groups that hold resident rows (the
      // first `pinned`) are the block's own and every later group of every
      // block is in one pool, items claimed in turn from the round's
      // counter; else every group is the block's own (at 4096^2 the pool's
      // barrier and claims cost 12%)
      const int seg = n / kDotSegments, g8 = lane >> 2;
      const int most = (n - 1) / G + 1;  // block 0's rows, the most
      const int groups = (most + kDotRows - 1) / kDotRows;
      const bool pooled = most - resident - l2_rows >= kDotRows;
      const int pinned = pooled ? (resident + kDotRows - 1) / kDotRows : groups;
      const int pool = max(0, groups - pinned) * G * kDotSegments;
      const int own = min(pinned, (nrows + kDotRows - 1) / kDotRows) * kDotSegments;
      for (int e = warp;;) {
        int bb = b, grp, s;
        if (e < own) {
          grp = e / kDotSegments;
          s = e - grp * kDotSegments;
          e += kW;
        } else {
          int i = 0;
          if (lane == 0) i = atomicAdd(work + (r & 1), 1);
          i = __shfl_sync(0xffffffffu, i, 0);
          if (i >= pool) break;
          grp = pinned + i / (G * kDotSegments);
          i -= (grp - pinned) * G * kDotSegments;
          bb = i / kDotSegments;
          s = i - bb * kDotSegments;
        }
        const int brows = bb < n ? (n - 1 - bb) / G + 1 : 0;  // block bb's rows
        const int bres = min(resident, brows);  // its resident ones (bb == b only)
        if (grp * kDotRows >= brows) continue;
        DotRow<T> rows2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = grp * kDotRows + g8 + 8 * h;
          DotRow<T>& w = rows2[h];
          w.where = k >= brows ? 0 : k < bres ? 1 : 2;
          w.p = reinterpret_cast<const Chunk*>(
              k < bres ? rows_s + static_cast<size_t>(k) * n
                       : A + static_cast<size_t>(bb + (k < brows ? k : 0) * G) * n);
          w.policy = k - bres < l2_rows ? keep.policy : pass.policy;
        }
        float sums[2];
        dot_segment<T>(rows2[0], rows2[1], ev_s, s * seg, (s + 1) * seg, lane, sums);
        if ((lane & 3) == 0) {
          float* dst = part + static_cast<size_t>(s) * n + bb;
          const int k = grp * kDotRows + g8;
          if (k < brows) __stcg(dst + static_cast<size_t>(k) * G, sums[0]);
          if (k + 8 < brows) __stcg(dst + static_cast<size_t>(k + 8) * G, sums[1]);
        }
      }
      // every item of the round is written (read back through L2)
      if (pooled) {
        grid.sync();
        if (b == 0 && tid == 0) work[(r + 1) & 1] = 0;  // the next round's counter
      } else {
        __syncthreads();
      }
      for (int k = tid; k < nrows; k += kT) {
        const int row = b + k * G;
        float acc = __ldcg(part + row);
#pragma unroll
        for (int s = 1; s < kDotSegments; ++s) acc += __ldcg(part + static_cast<size_t>(s) * n + row);
        __stcg(out + row, acc);
      }
    } else {
      for (int m = warp; m < nrows; m += kW) {
        float s;
        int row;
        if (m < nstream && rg.nq) {
          row = b + (nres + m) * G;
          const float4* x4 = reinterpret_cast<const float4*>(ev_s);
          float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
          for (int j = 0; j < rg.nseg; ++j) {
            const int base = j * kSegChunks;
            evt::seg_dot<T>(rg.take(), x4 + base, min(kSegChunks, n / 4 - base), lane, s0, s1,
                            s2, s3);
            ++rg.used;
            __syncwarp();  // every lane has read the stage before it is refilled
            rg.issue(lane);
          }
          s = evt::row_finish(s0, s1, s2, s3);
        } else if (m < nstream) {
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
    }
    last = r & 1;
    evt::stamp(stamps, r, 2, true);
    grid.sync();
    evt::stamp(stamps, r, 3, false);
  }
  rg.drain();  // the copies issued ahead for a round that did not run

  // A frozen solve keeps the v it stopped on (the previous matvec / ev, or
  // the input if it stopped at r == 0); a running one leaves the division
  // of its last matvec to this epilogue.
  const float* fin = last < 0 ? nullptr : raw + static_cast<size_t>(last) * n;
  for (int j = blockIdx.x * kT + tid; j < n; j += gridDim.x * kT) {
    ev_out[j] = ev_s[j];
    v_out[j] = fin ? __ldcg(fin + j) / ev_s[j] : v_in[j];
  }
  if (blockIdx.x == 0 && tid == 0) {
    *adv_out = adv;
    *lam_out = lam;
  }
  if (rounds_out != nullptr)
    evt::write_finish<kT>(ev_s, v_out, ev_out, lam_out, rounds_out, converged_out, n, adv,
                          budget, chunk - init, rounds0, stats[0]);
}

// The instance a launch runs: dot, ring or register path.
template <class T>
auto instance(int ring, int dot) {
  return dot ? multiround_kernel<T, false, true>
             : ring ? multiround_kernel<T, true> : multiround_kernel<T, false>;
}

template <class T>
int blocks(int n, int resident, int ring, int dot) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr;
  const size_t smem = smem_bytes<T>(n, resident, ring);
  const auto kernel = instance<T>(ring, dot);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const size_t limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  if (smem > limit) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(limit));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      dot ? kDotThreads : kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

// The dot formulation's split of x[0 .. n - 1] as the kernels make it (the
// integer rounding), or by cvt.rna.tf32.f32 (`cvt`): a test of both against
// kernels.tf32_split, their plain version.
__global__ void tf32_split_kernel(const float* __restrict__ x, unsigned* __restrict__ big,
                                  unsigned* __restrict__ small, int n, int cvt) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (cvt) {
      const unsigned b = evt::tf32_cvt_rna(x[i]);
      big[i] = b;
      small[i] = evt::tf32_cvt_rna(x[i] - __uint_as_float(b));
    } else {
      const evt::Tf32Pair p = evt::tf32_split(x[i]);
      big[i] = p.big;
      small[i] = p.small;
    }
  }
}

}  // namespace

// x (n,) float32; big, small (n,) 32-bit words: the TF32 parts of x as the
// dot kernels split it (`cvt` = 0: the integer rounding) or as cvt.rna
// splits it (`cvt` = 1).  Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int evt_tf32_split(const float* x, unsigned* big, unsigned* small, int n, int cvt,
                              void* stream) {
  if (n <= 0) return 0;
  const int nb = n < 1024 * 256 ? (n + 255) / 256 : 1024;
  tf32_split_kernel<<<nb, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, big, small, n, cvt);
  return static_cast<int>(cudaGetLastError());
}

// Co-resident blocks of the kernel at dimension n with `resident` rows of
// element type `elem` (0 float32, 1 bfloat16, 2 float16) and `ring` ring
// stages a warp per block on the current device (`dot`: the dot
// formulation's instance, ring 0), 0 if one block does not fit, or a negated
// cudaError_t.  Also raises the kernel's dynamic shared-memory limit to the
// most the card allows.
extern "C" int evt_multiround_blocks(int n, int resident, int ring, int elem, int dot) {
  if (elem < 0 || elem > 2 || (dot && ring)) return -static_cast<int>(cudaErrorInvalidValue);
  return evt::with_elem(elem, [&](auto tag) {
    return blocks<typename decltype(tag)::type>(n, resident, ring, dot);
  });
}

// A (n, n) row-major in the element type `elem` names (0 float32, 1
// bfloat16, 2 float16); ev_in, v_in, ev_out, v_out (n,); lam_in, lam_out (1,);
// adv_out (1,) int32; raw (2n,) scratch; all on the current device.
// rounds_out (1,) int32 and converged_out (1,) bool ask for the solve's
// result, `rounds0` its rounds before this launch (evt::write_finish); both
// null: the carry alone.  `grid`
// blocks with `resident` rows each must be co-resident
// (evt_multiround_blocks); the first `l2_rows` streamed rows of a block are
// kept in L2.  `ring` > 0 streams the other rows through that many
// bulk-copy stages a warp (A 16-byte aligned, n * sizeof(T) % 16 == 0);
// 0 reads them into registers.  `dot` = 1 runs the dot formulation (ring 0,
// n % 128 == 0) with `part` (kDotSegments * n floats) and `work` (2 int32,
// zero at the launch: the rounds' work counters) as scratch; both are null
// otherwise.  `stamps` is null, or kStampRounds * kStampPhases *
// grid words for the phase stamps.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t (0 on success; a card
// without cooperative launch fails here).
extern "C" int evt_multiround(const void* A, const float* ev_in,
                              const float* v_in, const float* lam_in,
                              int budget, float* ev_out, float* v_out,
                              int* adv_out, float* lam_out, int* rounds_out,
                              bool* converged_out, int rounds0, float* raw, int n,
                              int chunk, float eps, int init, int rel,
                              int resident, int l2_rows, int ring, int dot, float* part,
                              int* work, void* stamps, int elem, int grid, void* stream) {
  if ((dot && (ring || n % 128 || !part || !work)) || !rounds_out != !converged_out)
    return static_cast<int>(cudaErrorInvalidValue);
  return evt::with_elem(elem, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const size_t smem = smem_bytes<T>(n, resident, ring);
    void* args[] = {&A, &ev_in, &v_in, &lam_in, &budget, &ev_out, &v_out, &adv_out,
                    &lam_out, &rounds_out, &converged_out, &rounds0, &raw, &n, &chunk,
                    &eps, &init, &rel, &resident, &l2_rows, &ring, &part, &work, &stamps};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)instance<T>(ring, dot),
        dim3(grid),
        dim3(dot ? kDotThreads : kThreads), args, smem, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}
