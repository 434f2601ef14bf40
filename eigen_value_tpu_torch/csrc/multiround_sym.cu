// Up to `chunk` rounds of the matvec-form solve in one launch, reading A
// as square bt x bt tiles: for a symmetric A only the g(g+1)/2 tiles on or
// above the block diagonal (g = n / bt), or, in dense tiled mode, all g^2
// tiles.  Some tiles can stay resident in shared memory across the rounds
// of a launch (the tile cache).
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, `multiround_sym` /
// `_multiround_sym_kernel` (the "vpu", "dot" and "mixed" formulations, the
// prologue and pipelined fills, sym and dense modes), with `_round_prologue`.
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
//     of once per round.  A block's shared memory holds ev, tiles and the
//     ring below, if any (the column sums of a tile stay in registers), so
//     three 64 KiB f32 tiles fit a block at n = 8192: 396 tiles, 26 MB.  The
//     budget comes from the card (device.sym_auto_cache_tiles);
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
// and stay resident in 2 bytes, so a block holds more of them beside ev
// (four 32 KiB tiles beside a 64 KiB ring at n = 8192: 528), a lane reads
// its four columns of a row as one 8-byte load, and each chunk is
// converted to f32 exactly before the f32 row and transpose terms.  The
// work items, slots and sums are
// those of the f32 kernel (the split depends on n, bt and the card only),
// so a launch on A_q gives the bits of a launch on A_q.float(), for every
// cache size.  All O(n) state stays f32.
// Measured and not here: asking the L2 for the next round's first rows
// before the barriers (no gain); loading a warp's first eight row segments
// of the next round into registers before the barriers (32 more live
// registers spill: +9% at 8192^2); cutting tiles into groups at 8192^2
// (more slots to sum than warps gained: +15%).
//
// The row terms of a trip's eight rows, for a 2-byte A: a reduce-scatter
// over the rows (rows8_sum) instead of eight butterflies.  At lane offsets
// 16, 8 and 4 a lane sends the half of its row partials that its partner
// keeps and adds the half it keeps (4 + 2 + 1 shuffles), then one row is
// left on every lane and two xor stages (offsets 2, 1) finish it; one more
// shuffle brings row u's sum to lane r8 + u.  10 shuffles where eight
// butterflies took 40.
// At every stage a lane adds its partner's value to its own, as the
// butterfly of each row did: the 32 lane partials of a row are added in the
// same tree (lane bit 4 first, then bits 3, 2, 1, 0) and the bits do not
// change.  The f32 instance keeps the eight butterflies: there the
// reduce-scatter, which waits for all eight rows before its first shuffle,
// was measured 24% slower at 8192^2 with the auto cache (it took 5% off the
// bf16 launch); both give the same bits, so a 2-byte launch still equals
// the f32 launch on A_q.float().
//
// The bulk-copy ring (`ring` > 0 stages a warp; the plan's choice,
// device.sym_ring, from A's element size and the card): the streamed tiles
// do not pass through registers.  A stage is one trip, the kAhead rows of a
// 128-column chunk of a tile (2 KB of bf16, 4 KB of f32), brought by one
// 2-D tensor copy of the Tensor Memory Accelerator (a box of A's tensor
// map, built on the host for each launch) that completes on the stage's
// mbarrier, with the L2 policy of the load it replaces.  (Eight 1-D
// cp.async.bulk copies a trip, one a row, were measured first: the ring
// lost 11% at 8192^2 in bf16.)  Each warp owns its `ring` stages (after the
// resident tiles, 128-byte aligned) and its lane 0 copies the warp's
// streamed work items' trips in the order the warp reads them, `ring`
// trips ahead; the trip is read from shared memory in the lane order of
// the load it replaces (lane l the chunk of columns 4l..4l+3 of each row),
// so the row and transpose terms keep their bits.  The copy sequence is
// cyclic over the rounds (A does not change), so the trips ahead of a
// warp's last trip of round r are its first of round r + 1: they land
// during the barriers, the sum and the prologue, held by no register.
// Measured at 8192^2 (PERF.md): two stages a warp take the bf16
// triangle from 16.2 to 12.2 us of tile phase a round though 264 fewer
// tiles stay resident (its trips were latency-bound); every depth cost the
// f32 launch (6% at one stage), so the plan gives an f32 A none.
// Constraints:
//   * shared memory: a warp's stage costs resident tiles (16 warps x 2 KB
//     is one 32 KiB bf16 slot, 132 tiles at n = 8192); the plan counts it;
//   * threads and registers: sixteen warps of 128 registers fill the
//     register file, so lane 0 of each consumer warp issues its copies; no
//     producer warp, no setmaxnreg;
//   * no empty barriers, no wait across warps: a warp's stages are its
//     own, and trip t waits on stage t % ring with parity (t / ring) & 1 only
//     after trip t - ring was read, so no wait can be a phase ahead;
//   * no copy in flight at exit: a block that leaves the round loop waits
//     for every copy it issued;
//   * A must be 16-byte aligned (the wrapper checks; n % 128 == 0 makes
//     its row pitch a multiple of 16 bytes, as a tensor map needs).
//
// The "dot" formulation (kDot; `form` = 1, the plan gives it no ring): each
// tile's row term and transpose term on the tensor cores in 3xTF32
// (mma_tf32.cuh), as the TPU kernel's formulation="dot" contracts each tile
// on its matrix unit (kernels.py:890-915, :948-965).  The work items, the
// tiles' places (streamed with their L2 policy, or resident, read from
// shared memory by the same helper), the slots and slot_sum are the vpu
// formulation's; only tile_terms changes, to tile_terms_dot.  A warp takes
// its rows 16 at a time (the unit's m16) and a 128-column chunk 16 columns
// at a time: lane (g, t) reads columns 4t .. 4t + 3 of rows g and g + 8 (the
// vpu path's loads, two of them), the row term chains over the columns and
// the transpose term over the rows, one accumulator per 16 columns of the
// chunk (32 registers).  Each loaded value is split once for the row term;
// the transpose term's fragments are the row fragments transposed by
// shuffles (transpose8) and split, and its vector is split once per 16 rows
// (mma_tf32.cuh says why; a 2-byte A is not split).  A streamed tile's loads
// ask the L2 for the 256-byte unit around them (FromGlobalAhead): the warp
// waits on memory more than it issues, and an L2 prefetch of the next 16
// rows cost registers (spills) and time.  Each slot holds what the
// vpu formulation's holds, the sum of its own products in a fixed order, so
// a dot launch is bit-identical for every cache size, every chunking, the
// lower block triangle's contents and A_q against A_q.float(); it agrees
// with a vpu launch in rounds and within rounding.
//
// The "mixed" formulation (kMixed; `form` = 2): the last m resident tiles of
// the split's order (indices mxu_from = C - m .. C - 1) take tile_terms_dot,
// every other tile (streamed through registers, or resident) takes
// tile_terms, as the TPU kernel's formulation="mixed"
// puts an `mxu_tiles` share of its VMEM-resident tiles on the matrix unit
// (kernels.py:981-1016, :1237-1283).  Both write the same slots, so
// slot_sum's order does not change; the TPU kernel's own accumulator for
// that share only broke a memory dependency there.  Which tiles take the
// dot form depends on (n, bt, C, sym, m) and on nothing else, so a mixed
// launch keeps every invariance of the other two (chunking, the block and
// slot a tile lies in, the lower block triangle, A_q against A_q.float()),
// and at m = 0 it gives the bits of a vpu launch.  It has no ring, as the dot
// instance has none: with the ring the 2-byte mixed instances spilled 68-84
// bytes (ptxas) and the bf16 launch was slower than without, with the same
// bits (8192^2, PERF.md §6).
//
// The pipelined fill (kFill; `fill` > 0 at the C entry), an instance of its
// own beside each of the others: the resident tiles are brought by 2-D
// tensor copies of the Tensor Memory Accelerator, one a work item (a whole
// tile, or one of its `split` row spans where different warps take them),
// each from a second tensor map of A whose box is one item (bt / split rows
// x bt columns; `fmap`, the kernel's last parameter, a placeholder in the
// other instances), with the evict_first policy of the plain fill (the
// map's L2 promotion instead was slower: PERF.md §6), into the item's place
// in its tile.  The tiles start 128-byte aligned, as a copy's destination
// must: the dynamic shared memory's base is declared so and n % 128 == 0
// (checked before the first copy).  Each copy completes on an mbarrier of
// its own, placed after the tiles.  Before ev is loaded (and before round
// 0's prologue on a launch that is not a solve's first), the lanes of warp
// 0 read the block's tile indices at once and thread 0 initialises the
// barriers and issues every copy, in the order warps first reach the items
// (a thread reading the indices one by one took 4 us a launch).  In round 0
// a warp waits on its item's barrier (parity 0) before the item's first
// read; the resident items come after the streamed ones in a warp's order,
// so the copies land while the streamed tiles are read; no barrier is
// re-armed.  The TPU kernel issued a step's tiles one step ahead only
// because its DMA queue is 8 deep (kernels.py:779-800, :943-946); the copy
// engine here takes them all at once.  A launch whose rounds stop before
// round 0's tile phase still waits for every copy before the block exits.
// The bytes that land are the prologue fill's, so the bits are the
// prologue fill's.  Measured at 8192^2 with the auto caches (NVIDIA H100
// 80GB HBM3, 700 W; kernel_phases.py against the prologue twins in one
// process, PERF.md §6): the prologue fill takes 10.5 us (f32) and 8.9 us
// (bf16) from the launch's start, ev's load in it, the issue 0.8-1.3 us;
// the copies slow round 0's streamed tiles by about 1 us (the fill's bytes
// share the memory with them), and the launches came to -0.9..+0.4% of
// their prologue twins' in f32, -0.8..+1.6% in 2 bytes (the 2-byte mixed
// twins lose in their rounds).  (The first design, one 1-D bulk copy a row
// issued by all 512 threads, 384 copies a block in f32 at 8192^2, saved
// nothing over the prologue fill and spilled 88-276 bytes in the dot and
// mixed twins.  A launch argument read by every instance, before that,
// moved the f32 dot instance's spills from 40 to 64 bytes of stores and
// cost the dense tiled dot launch 9.5% at 8192^2; as a template parameter
// the fill leaves the other instances as they were.)
// With stamps, every instance also stamps its fill (fill_stamp): the
// prologue fill from the launch's start (ev's load is in it) to after its
// loads and block barrier, the pipelined fill around thread 0's issue.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_runtime.h>

#include <type_traits>

#include "bulk.cuh"
#include "mma_tf32.cuh"
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

// A ring stage: kAhead rows of kChunk columns.
template <class S>
constexpr size_t stage_bytes() {
  return static_cast<size_t>(kAhead) * kChunk * sizeof(S);
}

// Dynamic shared memory (its base 128-byte aligned): ev (n floats) |
// resident tiles (slots * bt^2 elements of S, A's storage type) | with the
// pipelined fill, one mbarrier a copy (`fill` a slot) | up to 128 bytes to
// align the ring (a tensor copy's destination) | ring stages (kWarps *
// ring) | their mbarriers (kWarps * ring).  device.sym_smem_bytes mirrors
// this.
template <class S>
size_t smem_bytes(int n, int bt, int slots, int ring, int fill) {
  return static_cast<size_t>(n) * sizeof(float) +
         static_cast<size_t>(slots) * bt * bt * sizeof(S) + static_cast<size_t>(8) * slots * fill +
         (ring ? 128 + static_cast<size_t>(ring) * kWarps * (stage_bytes<S>() + 8) : 0);
}

// With stamps, thread 0 of every block writes the card's nanosecond timer
// before (p = 0) and after (p = 1) the resident tiles' fill, in the two
// words a block that follow the rounds' stamps (prologue.cuh stamp).  A
// call, not inlined: inlined, the two stamps moved the 2-byte register
// instances from 114 to 115 registers and the f32 ring instance from 0 to
// 16 bytes of spill stores, and after ev's load the first one slowed the
// f32 instance's sum phase by 0.3 us a round (ptxas, kernel_phases.py);
// as calls, at the launch's start and after the fill, they leave every
// prologue-fill instance's registers, spills and time as they were.
__device__ __noinline__ void fill_stamp(unsigned long long* stamps, int p) {
  if (stamps == nullptr || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[(static_cast<size_t>(evt::kStampRounds) * evt::kStampPhases + p) * gridDim.x +
         blockIdx.x] = t;
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// The sums of kAhead = 8 rows whose partials on this lane are d[0..7]: lane
// l gets the sum of row l >> 2 over the 32 lanes, each pair of lanes added
// in the order of a per-row xor butterfly at offsets 16, 8, 4, 2, 1 (own
// value + partner's), so the sum has that butterfly's bits.
__device__ __forceinline__ float rows8_sum(const float (&d)[kAhead], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float e[4], f[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // rows 0-3 stay on lanes 0-15, rows 4-7 on 16-31
    e[i] = (h4 ? d[i + 4] : d[i]) + __shfl_xor_sync(0xffffffffu, h4 ? d[i] : d[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    f[i] = (h3 ? e[i + 2] : e[i]) + __shfl_xor_sync(0xffffffffu, h3 ? e[i] : e[i + 2], 8);
  float g = (h2 ? f[1] : f[0]) + __shfl_xor_sync(0xffffffffu, h2 ? f[0] : f[1], 4);
  g += __shfl_xor_sync(0xffffffffu, g, 2);
  g += __shfl_xor_sync(0xffffffffu, g, 1);
  return g;
}

// No ring: tile_terms reads its rows through a load policy.
struct NoRing {};

// A warp's ring over the trips of its streamed work items k = 0 .. nk - 1
// (item warp + k * kWarps; for each 128-column chunk q, the rows lo, lo +
// 8, ... of its span), cyclic over the rounds.
template <class S>
struct SymRing {
  using Chunk = typename evt::Elem<S>::Chunk;
  Chunk* stages;  // kAhead * 32 chunks each
  unsigned long long* bars;
  int ring, nk;
  const void* tmap;  // A's tensor map
  const int2* tiles;
  int bt, warp, split, l2_tiles;
  unsigned long long keep, pass;  // the L2 policies
  unsigned used, issued;  // trips read, trips issued
  int k, q, r;            // the next trip: rows r.. of column chunk q of item k
  int row0, col0;         // item k's first row and column in A
  unsigned long long policy;

  // Points row0 / col0 / policy at item k.
  __device__ __forceinline__ void locate() {
    const int e = warp + k * kWarps;
    const int m = e / split, span = bt / split;
    const int t = blockIdx.x + m * gridDim.x;
    const int2 ij = tiles[t];
    row0 = ij.x * bt + (e - m * split) * span;
    col0 = ij.y * bt;
    policy = t < l2_tiles ? keep : pass;
  }

  // Lane 0 issues the next trip into stage issued % ring: the box of kAhead
  // rows x kChunk columns at (row0 + r, col0 + q), one tensor copy.
  __device__ __forceinline__ void issue(int lane) {
    if (lane == 0) {
      const int s = static_cast<int>(issued % ring);
      evt::fence_proxy_async();
      evt::mbar_expect(bars + s, static_cast<unsigned>(kAhead * kChunk * sizeof(S)));
      evt::tensor_copy_2d(stages + s * kAhead * 32, tmap, col0 + q, row0 + r, bars + s, policy);
    }
    ++issued;
    r += kAhead;
    if (r == bt / split) {
      r = 0;
      q += kChunk;
      if (q == bt) {
        q = 0;
        if (++k == nk) k = 0;
        locate();
      }
    }
  }

  // Waits for the next trip and returns its stage (row u at u * 32 chunks).
  __device__ __forceinline__ const Chunk* take() {
    const unsigned s = used % ring;
    evt::mbar_wait(bars + s, (used / ring) & 1u);
    return stages + s * kAhead * 32;
  }

  __device__ __forceinline__ void drain() {
    for (; used < issued; ++used) evt::mbar_wait(bars + used % ring, (used / ring) & 1u);
  }
};

// One warp's pass over rows [r_lo, r_hi) (whole groups) of tile (i, j), row
// r at src + r * stride (A in device memory, or a resident copy in shared
// memory; element type S), read through `load`.  Writes the row term
// T . ev[j_blk] of these rows to `row_out` (the tile's slot) and, when
// `trans`, the transpose term T^T . ev[i_blk] of these rows to `col_out`
// (bt floats).
// With a SymRing `ring` (streamed tiles of a launch with ring stages) the
// rows come from its stages, trip by trip, and src / stride / load are not
// read.
template <class S, class Load, class Ring = NoRing>
__device__ __forceinline__ void tile_terms(const S* src, size_t stride, int bt,
                                           int r_lo, int r_hi, bool trans,
                                           const float* evi, const float* evj,
                                           float* row_out, float* col_out, int lane,
                                           Load load, Ring* ring = nullptr) {
  using E = evt::Elem<S>;
  using Chunk = typename E::Chunk;
  constexpr bool kRing = !std::is_same<Ring, NoRing>::value;
  // a 2-byte A: the rows' reduce-scatter; f32: a butterfly per row
  constexpr bool kScatter = sizeof(Chunk) < sizeof(float4);
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
        if constexpr (kRing) {
          const Chunk* st = ring->take();
#pragma unroll
          for (int u = 0; u < kAhead; ++u) c[u] = st[u * 32 + lane];
          ++ring->used;
          __syncwarp();  // every lane has read the stage before it is refilled
          ring->issue(lane);
        } else {
#pragma unroll
          for (int u = 0; u < kAhead; ++u) c[u] = load(p + u * stride4);
          p += kAhead * stride4;
        }
        [[maybe_unused]] float d[kAhead];  // this lane's partial of each row's term (2-byte A)
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const float4 a = E::up(c[u]);
          if constexpr (kScatter) {
            d[u] = evt::dot4(a, x);
          } else {
            const float t = warp_sum(evt::dot4(a, x));
            if (lane == r8 + u) mine = t;
          }
          if (trans) {
            const float e = evi[g0 + r8 + u];
            col.x = fmaf(a.x, e, col.x);
            col.y = fmaf(a.y, e, col.y);
            col.z = fmaf(a.z, e, col.z);
            col.w = fmaf(a.w, e, col.w);
          }
        }
        if constexpr (kScatter) {
          // row r8 + u's sum lies on lanes 4u..4u+3; lane r8 + u keeps it
          const float got =
              __shfl_sync(0xffffffffu, rows8_sum(d, lane), ((lane - r8) & 7) << 2);
          if (static_cast<unsigned>(lane - r8) < kAhead) mine = got;
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

// tile_terms in the dot formulation: the same pass, rows and outputs, on the
// tensor cores.  Rows r_lo .. r_hi - 1 (a multiple of 16 of them) go 16 at a
// time; row r's term is two chains of the unit's products over each
// 128-column chunk (the even and the odd 16-column regions, in order), added,
// the chunks added in order in f32 (as tile_terms adds them), and column c's
// transpose term one chain over the rows in order.  (The unit's accumulator
// truncates: chains of 128 columns or rows keep λ within 1e-6 of a float64
// loop at 8192^2, where one over 1024 columns did not keep it within 1e-5.)
// The row term splits each loaded value once, the transpose term each
// shuffled one (mma_cols16); its vector (16 rows of evi) is split once per
// 16 rows.
template <class S, class Load>
__device__ __forceinline__ void tile_terms_dot(const S* src, size_t stride, int bt, int r_lo,
                                               int r_hi, bool trans, const float* evi,
                                               const float* evj, float* row_out,
                                               float* col_out, int lane, Load load) {
  using E = evt::Elem<S>;
  using Chunk = typename E::Chunk;
  constexpr bool kExact = sizeof(S) < sizeof(float);  // a 2-byte A is exact in TF32
  // 16-column steps whose loads go together: two f32 ones, four 2-byte ones
  constexpr int kB = sizeof(Chunk) == sizeof(float4) ? 2 : 4;
  constexpr int kSteps = kChunk / 16;
  const int g = lane >> 2, t = lane & 3;
  const size_t stride4 = stride >> 2;
  for (int q = 0; q < bt; q += kChunk) {
    float tacc[kSteps][4];  // the transpose term of columns q + 16u ..
#pragma unroll
    for (int u = 0; u < kSteps; ++u) tacc[u][0] = tacc[u][1] = tacc[u][2] = tacc[u][3] = 0.0f;
    const float4* e4 = reinterpret_cast<const float4*>(evj + q);
    for (int r0 = r_lo; r0 < r_hi; r0 += 16) {
      // the row term in two chains, the even and the odd 16-column regions
      float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      evt::Tf32x4 F;
      if (trans)
        F = evt::tf32_split4(make_float4(evi[r0 + 2 * t], evi[r0 + 2 * t + 1],
                                         evi[r0 + 8 + 2 * t], evi[r0 + 9 + 2 * t]));
      const Chunk* p = reinterpret_cast<const Chunk*>(src + q) + (r0 + g) * stride4 + t;
#pragma unroll
      for (int u0 = 0; u0 < kSteps; u0 += kB) {
        Chunk x[kB], y[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          x[u] = load(p + 4 * (u0 + u));
          y[u] = load(p + 8 * stride4 + 4 * (u0 + u));
        }
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const float4 xu = E::up(x[u]), yu = E::up(y[u]);
          evt::mma_rows16<kExact>(d[(u0 + u) & 1], evt::tf32_split4<kExact>(xu),
                                  evt::tf32_split4<kExact>(yu),
                                  evt::tf32_split4(e4[4 * (u0 + u) + t]));
          if (trans) evt::mma_cols16<kExact>(tacc[u0 + u], xu, yu, F, lane);
        }
      }
      if (t == 0) {  // chunks in order; the same lane wrote the earlier ones
        float* out = row_out + r0 + g;
        const float lo = d[0][0] + d[1][0], hi = d[0][2] + d[1][2];
        __stcg(out, q == 0 ? lo : __ldcg(out) + lo);
        __stcg(out + 8, q == 0 ? hi : __ldcg(out + 8) + hi);
      }
    }
    if (trans && t == 0) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        float* out = col_out + q + 16 * u + 4 * (g >> 1) + (g & 1);
        __stcg(out, tacc[u][0]);
        __stcg(out + 2, tacc[u][2]);
      }
    }
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
// kRing: the instance with the ring (a launch whose plan has `ring` > 0);
// the other is the register path alone.  kDot: the dot formulation
// (register path, no ring).  kMixed: the mixed formulation, resident tiles
// from index mxu_from on in the dot form (register path, no ring).
// kFill: the pipelined fill of the resident tiles, one tensor copy of `fmap`
// (box: bt / split rows x bt columns) a resident item (the other instances
// fill them before round 0 and take a placeholder for fmap, the last
// parameter, so that their other parameters and code stay as they were).
struct NoFillMap {
  int unused;
};
template <bool kFill>
using FillMap = typename std::conditional<kFill, CUtensorMap, NoFillMap>::type;

// The pipelined fill's mbarrier of resident item k (slot k / split, row span
// k % split): after the block's `slots` resident tiles.
template <class S>
__device__ __forceinline__ unsigned long long* fill_bar(S* cache, int slots, size_t tile_elems,
                                                         int k) {
  return reinterpret_cast<unsigned long long*>(cache + static_cast<size_t>(slots) * tile_elems) +
         k;
}

template <class S, bool kRing, bool kDot = false, bool kMixed = false, bool kFill = false>
__global__ void __launch_bounds__(kThreads) multiround_sym_kernel(
    const S* __restrict__ A, const int2* __restrict__ tiles, int T, int C,
    int slots, const float* __restrict__ ev_in, const float* __restrict__ v_in,
    const float* __restrict__ lam_in, int budget, float* __restrict__ ev_out,
    float* __restrict__ v_out, int* __restrict__ adv_out,
    float* __restrict__ lam_out, float* raw, float* part, float* part_t, int n,
    int bt, int chunk, float eps, int init, int rel, int sym, int split,
    int l2_tiles, int ring, int mxu_from, const __grid_constant__ CUtensorMap tmap,
    unsigned long long* stamps, const __grid_constant__ FillMap<kFill> fmap) {
  static_assert(!(kRing && kDot), "the dot formulation has no ring");
  static_assert(!(kDot && kMixed), "one formulation an instance");
  static_assert(!(kRing && kMixed), "the mixed formulation has no ring");
  cg::grid_group grid = cg::this_grid();
  if constexpr (!kFill) fill_stamp(stamps, 0);
  extern __shared__ __align__(128) float4 smem4[];
  float* ev_s = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  using Chunk = typename evt::Elem<S>::Chunk;
  // the resident tiles, after ev: 128-byte aligned (a tensor copy's
  // destination), as the base is and n % 128 == 0
  S* cache = reinterpret_cast<S*>(ev_s + n);
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

  // the pipelined fill's barriers, one a resident item, after the resident
  // tiles; then this warp's ring
  unsigned long long* fill_bars = fill_bar(cache, slots, tile_elems, 0);
  using Ring = SymRing<S>;
  char* after = reinterpret_cast<char*>(fill_bars + (kFill ? slots * split : 0));
  Chunk* ring_s =
      reinterpret_cast<Chunk*>(after + ((128u - (evt::smem_addr(after) & 127u)) & 127u));
  Ring rg;
  rg.stages = ring_s + static_cast<size_t>(warp) * ring * kAhead * 32;
  rg.bars = reinterpret_cast<unsigned long long*>(
                ring_s + static_cast<size_t>(kWarps) * ring * kAhead * 32) +
            warp * ring;
  rg.ring = ring;
  rg.nk = kRing && ring && warp < nstream * split ? (nstream * split - 1 - warp) / kWarps + 1
                                                   : 0;
  rg.tmap = &tmap;
  rg.tiles = tiles;
  rg.bt = bt;
  rg.warp = warp;
  rg.split = split;
  rg.l2_tiles = l2_tiles;
  rg.keep = keep.policy;
  rg.pass = pass.policy;
  rg.used = rg.issued = 0;
  rg.k = rg.q = rg.r = 0;
  if (rg.nk) {
    rg.locate();
    if (lane == 0) {
      for (int s = 0; s < ring; ++s) evt::mbar_init(rg.bars + s);
      evt::mbar_init_fence();
    }
  }

  if (kFill && warp == 0) {  // thread 0 issues every copy, in the work items' order
    // a lane reads each slot's tile (ncached <= 32), so the reads overlap
    const int2 mine = lane < ncached ? tiles[T + b + lane * nb] : make_int2(0, 0);
    const int items = ncached * split;
    if (lane == 0) {
      fill_stamp(stamps, 0);
      if (evt::smem_addr(cache) & 127u) __trap();  // no tensor copy to a misaligned tile
      for (int k = 0; k < items; ++k) evt::mbar_init(fill_bars + k);
      evt::mbar_init_fence();
      evt::fence_proxy_async();  // the barriers, initialised, to the copy engine
    }
    const unsigned bytes = static_cast<unsigned>(span * bt * sizeof(S));
    for (int k = 0; k < items; ++k) {
      const int m = k / split;
      const int col = __shfl_sync(0xffffffffu, mine.y, m) * bt;
      const int row = __shfl_sync(0xffffffffu, mine.x, m) * bt + (k - m * split) * span;
      if (lane == 0) {
        evt::mbar_expect(fill_bars + k, bytes);
        evt::tensor_copy_2d(cache + static_cast<size_t>(k) * span * bt, &fmap, col, row,
                            fill_bars + k, pass.policy);
      }
    }
    if (lane == 0) fill_stamp(stamps, 1);
  }
  for (int j = tid; j < n; j += kThreads) ev_s[j] = ev_in[j];
  // fill this block's resident tiles, once per launch (the prologue fill)
  for (int k = 0; k < (kFill ? 0 : ncached); ++k) {
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
  if constexpr (!kFill) fill_stamp(stamps, 1);
  for (int s = 0; s < (rg.nk ? ring : 0); ++s) rg.issue(lane);

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
      // a resident item's first read of a pipelined launch waits for its copy
      if (kFill && !streamed && r == 0)
        evt::mbar_wait(fill_bar(cache, slots, tile_elems, e - nstream * split), 0u);
      if constexpr (kDot) {
        if (streamed) {
          tile_terms_dot(A + static_cast<size_t>(ij.x) * bt * n + static_cast<size_t>(ij.y) * bt,
                         n, bt, lo, lo + span, trans, evi, evj, row_out, col_out, lane,
                         evt::FromGlobalAhead<256>{t < l2_tiles ? keep.policy : pass.policy});
        } else {
          tile_terms_dot(cache + (m - nstream) * tile_elems, bt, bt, lo, lo + span, trans, evi,
                         evj, row_out, col_out, lane, evt::FromShared());
        }
      } else if (streamed && rg.nk) {
        tile_terms(A, n, bt, lo, lo + span, trans, evi, evj, row_out, col_out, lane,
                   evt::FromShared(), &rg);
      } else if (streamed) {
        const S* src = A + static_cast<size_t>(ij.x) * bt * n +
                       static_cast<size_t>(ij.y) * bt;
        tile_terms(src, n, bt, lo, lo + span, trans, evi, evj, row_out, col_out,
                   lane, t < l2_tiles ? keep : pass);
      } else {
        const S* src = cache + (m - nstream) * tile_elems;
        if constexpr (kMixed) {
          if (b + (m - nstream) * nb >= mxu_from) {  // resident tile index s >= C - m
            tile_terms_dot(src, bt, bt, lo, lo + span, trans, evi, evj, row_out, col_out, lane,
                           evt::FromShared());
            continue;
          }
        }
        tile_terms(src, bt, bt, lo, lo + span, trans, evi, evj, row_out, col_out, lane,
                   evt::FromShared());
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
  rg.drain();  // the trips issued ahead for a round that did not run
  if (kFill && tid == 0)  // copies of a launch that stopped before its tile phase
    for (int k = 0; k < ncached * split; ++k)
      evt::mbar_wait(fill_bar(cache, slots, tile_elems, k), 0u);

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

// The instance a launch runs: by fill, by formulation (0 vpu, 1 dot, 2
// mixed), then ring or register path.
template <class S, bool kFill>
auto instance_of(int ring, int form) {
  return form == 1   ? multiround_sym_kernel<S, false, true, false, kFill>
         : form == 2 ? multiround_sym_kernel<S, false, false, true, kFill>
         : ring      ? multiround_sym_kernel<S, true, false, false, kFill>
                     : multiround_sym_kernel<S, false, false, false, kFill>;
}

// (The two fills' instances differ in their last parameter.)
template <class S>
const void* instance(int ring, int form, int fill) {
  return fill ? reinterpret_cast<const void*>(instance_of<S, true>(ring, form))
              : reinterpret_cast<const void*>(instance_of<S, false>(ring, form));
}

template <class S>
int grid_of(int n, int bt, int slots, int ring, int form, int fill) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaFuncAttributes attr;
  const size_t smem = smem_bytes<S>(n, bt, slots, ring, fill);
  const auto kernel = instance<S>(ring, form, fill);
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

// cuTensorMapEncodeTiled, looked up at run time by its entry point (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The fill map's L2 promotion; its copies carry the prologue fill's
// evict_first policy.
constexpr CUtensorMapL2promotion kFillPromotion = CU_TENSOR_MAP_L2_PROMOTION_NONE;

template <class S>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<S, float>::value           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<S, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// The tensor map of A (n x n, row-major) whose box is `rows` rows of `cols`
// elements (each at most 256, cols * sizeof(S) a multiple of 16), with the
// L2 promotion `promo`.  0 or a cudaError_t.
template <class S>
int tile_map(CUtensorMap* map, const void* A, int n, int cols, int rows,
             CUtensorMapL2promotion promo) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * sizeof(S)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, map_type<S>(), 2, const_cast<void*>(A), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, promo,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Co-resident blocks of the kernel at (n, bt, slots resident tiles per
// block, ring stages a warp, element type `elem`: 0 float32, 1 bfloat16, 2
// float16; `form`: the formulation's instance, 0 vpu, 1 dot, 2 mixed (ring
// 0 for both); `fill`: the pipelined fill's copies a resident tile, its
// `split`, 0 for the prologue fill) on the current device,
// 0 if one block does not fit, or a negated cudaError_t.  Also raises the
// kernel's dynamic shared-memory limit to the most the card allows.
extern "C" int evt_multiround_sym_grid(int n, int bt, int slots, int ring, int elem, int form,
                                       int fill) {
  if (elem < 0 || elem > 2 || form < 0 || form > 2 || (form && ring) || fill < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  return evt::with_elem(elem, [&](auto tag) {
    return grid_of<typename decltype(tag)::type>(n, bt, slots, ring, form, fill);
  });
}

// A (n, n) row-major in the element type `elem` names (0 float32, 1
// bfloat16, 2 float16); tiles (T + C) int32 pairs; ev_in, v_in, ev_out, v_out
// (n,); lam_in, lam_out (1,); adv_out (1,) int32; raw (n,), part (g * n,)
// and part_t (g * n * split,; one float when not sym) scratch; all on the
// current device.  `grid` blocks must be co-resident with `slots` resident
// tiles each (evt_multiround_sym_grid) and grid * slots >= C.  `split` is 1
// or bt / 32; the first `l2_tiles` streamed tiles are kept in L2.  `ring`
// > 0 streams tiles through that many bulk-copy stages a warp (A 16-byte
// aligned), 0 through registers.  `form`: 0 vpu, 1 dot, 2 mixed (ring 0 for
// both), whose resident tiles from index `mxu_from` on take the dot form
// (C: none).
// `fill` = `split` fills the resident tiles by one 2-D tensor copy a work
// item (a tile, or a row span of one), each waited for at the item's first
// read (A 16-byte aligned, bt <= 256), 0 before round 0; an encoding of the
// fill's tensor map that fails is returned, never replaced by another fill.
// `stamps` is null, or (kStampRounds * kStampPhases + 2) * grid words for
// the phase stamps and the fill's two.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t (0 on success).
extern "C" int evt_multiround_sym(const void* A, const int* tiles, int T,
                                  int C, int slots, const float* ev_in,
                                  const float* v_in, const float* lam_in,
                                  int budget, float* ev_out, float* v_out,
                                  int* adv_out, float* lam_out, float* raw,
                                  float* part, float* part_t, int n, int bt,
                                  int chunk, float eps, int init, int rel,
                                  int sym, int split, int l2_tiles, int ring, int form,
                                  int mxu_from, int fill, void* stamps, int elem, int grid,
                                  void* stream) {
  if (form < 0 || form > 2 || (form && ring) ||
      (fill && (fill != split || bt > 256 || slots > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int2* tiles2 = reinterpret_cast<const int2*>(tiles);
  CUtensorMap tmap = {};  // read only by a launch with a ring
  CUtensorMap fmap = {};  // read only by a launch with the pipelined fill
  void* args[] = {&A,        &tiles2,   &T,        &C,      &slots,  &ev_in,
                  &v_in,     &lam_in,   &budget,   &ev_out, &v_out,  &adv_out,
                  &lam_out,  &raw,      &part,     &part_t, &n,      &bt,
                  &chunk,    &eps,      &init,     &rel,    &sym,    &split,
                  &l2_tiles, &ring,     &mxu_from, &tmap,   &stamps, &fmap};
  return evt::with_elem(elem, [&](auto tag) {
    using E = typename decltype(tag)::type;
    if (ring) {
      const int rc = tile_map<E>(&tmap, A, n, kChunk, kAhead, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
      if (rc != 0) return rc;
    }
    if (fill) {  // the box: one work item, bt / split rows of a tile
      const int rc = tile_map<E>(&fmap, A, n, bt, bt / split, kFillPromotion);
      if (rc != 0) return rc;
    }
    const cudaError_t e = cudaLaunchCooperativeKernel(
        instance<E>(ring, form, fill), dim3(grid), dim3(kThreads), args,
        smem_bytes<E>(n, bt, slots, ring, fill), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}
