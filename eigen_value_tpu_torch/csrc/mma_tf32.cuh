// Matrix-vector products on the tensor cores in 3xTF32: the "dot"
// formulation of the persistent kernels (multiround.cu, multiround_sym.cu).
//
// Replaces: eigen_value_tpu/ops/pallas/kernels.py, the `dot_general` at
// Precision.HIGHEST of `_multiround_kernel` (:546-554) and of
// `_multiround_sym_kernel` (:890-915, :948-965): the TPU contracts a row
// stripe or a tile with ev on its matrix unit in full f32.
//
// Hopper's tensor cores have no f32 mode: TF32 keeps 10 fraction bits.  One
// TF32 product would put the row sums' noise above the absolute 1e-3 stop
// once λ ≳ 1, so every product here is three: each f32 value x is split
// into big = rna(x) and small = rna(x - big) (to nearest, ties away from
// zero; x - big is exact), and a piece of A times ev is
// a_big·e_small + a_small·e_big, then + a_big·e_big, into the f32
// accumulator; a_small·e_small (2^-22 relative) is dropped.  Nothing relies
// on the unit's own truncation of the low 13 bits.
//
// Bound on the H100: bytes, as the "vpu" formulation (2 flops a 4-byte
// element); the unit's work, 24 multiply-adds an element (7 wasted columns,
// 3 passes), is ~0.2 ms over 18 passes at 8192^2, hidden only where loads
// and products overlap.  The first design spent its issue slots on
// the splits: cvt.rna for every split, ev split again for every product,
// each A value of the triangle split twice, ~250 instructions for the 12
// mma.sync of a 16 x 16 piece.  So (PERF.md §6):
//   * the rounding is two integer instructions, (bits + 0x1000) & ~0x1fff,
//     where cvt.rna.tf32.f32 is four on sm_90a; for every finite value and
//     for +-inf it gives cvt.rna's bits (kernels.tf32_rna is the same
//     formula; tests/test_torch_cuda.py holds the two against each other).
//     The kernels assume A and ev finite, as a solve of a positive matrix
//     keeps them: a NaN whose carry reaches the exponent (the card's own
//     0x7fffffff) rounds to a signed zero, where cvt.rna keeps a NaN;
//   * the callers split A once for the row term and pass the TF32 words
//     (Tf32x4); the transpose term's vector is split once per 16 rows, not
//     once per product; only column 0 of the B operand is read back, so the
//     other lanes carry copies of the same words (they reach only columns
//     1-7 of the result) and no select zeroes them;
//   * a bf16 or f16 value is exact in TF32 (its small part is 0), so a
//     2-byte A (kExact) is not split and skips the a_small product: adding
//     a product of exact zeros leaves the accumulator's bits as they were,
//     so a launch on A_q still gives the bits of a launch on A_q.float()
//     (the card tests hold this).
// After these the f32 kernels wait on memory more than they issue: fewer
// instructions (an unmasked small word, shuffling split words) bought
// nothing at 8192^2, and what spills costs.
//
// The unit: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  A matvec
// has one column, so a 16 x 8 piece of the matrix goes in the A operand and
// the 8 matching entries of the vector in column 0 of the B operand.  Lane
// (g, t) = (lane / 4, lane % 4) holds A at rows g, g + 8 and columns t,
// t + 4, B at rows t, t + 4 of column g, and the result at rows g, g + 8 and
// columns 2t, 2t + 1: the sums of column 0 land on lanes 4g.
//
// The design reads A as the vpu paths do (a lane takes four consecutive
// columns of a row: one 16-byte f32 load, or 8 bytes of bf16 / f16), and
// the order of the k index inside an 8-column step is chosen to fit those
// loads: a product is a sum over k, so any order that A and B share gives
// the same sum, and a fixed one gives the same bits.
#pragma once

#include <cuda_runtime.h>

namespace evt {

// x rounded to TF32 (10 fraction bits), to nearest, ties away from zero:
// half of the last kept bit added to the magnitude, the 13 low bits
// cleared.  cvt.rna's bits for every finite x and +-inf.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
}

// cvt.rna.tf32.f32 itself: what tf32_rna is held against on the card.
__device__ __forceinline__ unsigned tf32_cvt_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct Tf32Pair {
  unsigned big, small;
};

__device__ __forceinline__ Tf32Pair tf32_split(float x) {
  const unsigned big = tf32_rna(x);
  return {big, tf32_rna(x - __uint_as_float(big))};
}

// Four values as TF32 words: big parts and, unless kExact (a 2-byte A,
// exact in TF32), small parts.
struct Tf32x4 {
  unsigned big[4], small[4];
};

template <bool kExact = false>
__device__ __forceinline__ Tf32x4 tf32_split4(float4 v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  Tf32x4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kExact) {
      r.big[i] = __float_as_uint(x[i]);
      r.small[i] = 0u;
    } else {
      const Tf32Pair p = tf32_split(x[i]);
      r.big[i] = p.big;
      r.small[i] = p.small;
    }
  }
  return r;
}

// d += A B on one m16n8k8 TF32 tile.
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                            unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k step of 8 in 3xTF32 on split words: a the lane's A words (rows g,
// g + 8 at k = t; rows g, g + 8 at k = t + 4; big `ab`, small `as`), b its B
// words (k = t, t + 4; big `bb`, small `bs`).  kExact: A's small words are
// 0 and their product is skipped.
template <bool kExact>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ab)[4],
                                           const unsigned (&as)[4], unsigned bb0, unsigned bb1,
                                           unsigned bs0, unsigned bs1) {
  mma_m16n8k8(d, ab[0], ab[1], ab[2], ab[3], bs0, bs1);
  if constexpr (!kExact) mma_m16n8k8(d, as[0], as[1], as[2], as[3], bb0, bb1);
  mma_m16n8k8(d, ab[0], ab[1], ab[2], ab[3], bb0, bb1);
}

// A 16 x 16 piece P of a matrix, as the loads leave it: lane (g, t) holds
// x = P[g][4t .. 4t + 3] and y = P[g + 8][4t .. 4t + 3], split as X and Y.

// The row term: d += P . e, where lane (g, t) holds E = the vector at the
// piece's columns 4t .. 4t + 3, split.  k = t, t + 4 are columns 4t, 4t + 1
// in the first step and 4t + 2, 4t + 3 in the second.  Rows g and g + 8
// land in d[0] and d[2] of lane 4g.
template <bool kExact>
__device__ __forceinline__ void mma_rows16(float (&d)[4], const Tf32x4& X, const Tf32x4& Y,
                                           const Tf32x4& E) {
  mma_3xtf32<kExact>(d, {X.big[0], Y.big[0], X.big[1], Y.big[1]},
                     {X.small[0], Y.small[0], X.small[1], Y.small[1]}, E.big[0], E.big[1],
                     E.small[0], E.small[1]);
  mma_3xtf32<kExact>(d, {X.big[2], Y.big[2], X.big[3], Y.big[3]},
                     {X.small[2], Y.small[2], X.small[3], Y.small[3]}, E.big[2], E.big[3],
                     E.small[2], E.small[3]);
}

// An 8 x 8 block X whose lane (r, s) holds v0 = X[r][2s], v1 = X[r][2s + 1],
// transposed: lane (g, t) gets w0 = X[2t][g], w1 = X[2t + 1][g].  Two
// shuffles: in the first, a lane of even g reads X[2t][g] from lane (2t,
// g / 2) and one of odd g reads X[2t + 1][g] from lane (2t + 1, g / 2); a
// source lane sends v0 when its row is even and v1 when odd, so it serves
// exactly what its readers want.  The second shuffle brings the other row.
__device__ __forceinline__ void transpose8(unsigned v0, unsigned v1, int lane, unsigned& w0,
                                           unsigned& w1) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = g & 1;
  const unsigned r1 =
      __shfl_sync(0xffffffffu, odd ? v1 : v0, ((2 * t + (g & 1)) << 2) + (g >> 1));
  const unsigned r2 =
      __shfl_sync(0xffffffffu, odd ? v0 : v1, ((2 * t + 1 - (g & 1)) << 2) + (g >> 1));
  w0 = odd ? r2 : r1;
  w1 = odd ? r1 : r2;
}

// The transpose term: d += P^T . f, where lane (g, t) holds F = the vector
// at the piece's rows 2t, 2t + 1, 8 + 2t, 9 + 2t, split.  There is no
// transposed ldmatrix for 32-bit values, so P^T's fragments come from the
// row fragments by transpose8: the block of columns 4s, 4s + 1 (x.x, x.y)
// and that of 4s + 2, 4s + 3 (x.z, x.w), for rows 0-7 (x) and 8-15 (y); the
// transposed values are split again (f32), which costs fewer registers
// than shuffling both split words (that spilled 148 bytes of the f32
// triangle's dot instance and was 4% slower at 8192^2, PERF.md §6).
// m = g is column P(g) = 4 (g / 2) + g % 2 of the piece, m = g + 8 column
// P(g) + 2; k = t, t + 4 are rows 2t, 2t + 1 (+ 8 in the second step).
// Column P(g) lands in d[0] of lane 4g, column P(g) + 2 in d[2].
template <bool kExact>
__device__ __forceinline__ void mma_cols16(float (&d)[4], float4 x, float4 y, const Tf32x4& F,
                                           int lane) {
  unsigned w[4];
  transpose8(__float_as_uint(x.x), __float_as_uint(x.y), lane, w[0], w[2]);
  transpose8(__float_as_uint(x.z), __float_as_uint(x.w), lane, w[1], w[3]);
  Tf32x4 P = tf32_split4<kExact>(make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                                             __uint_as_float(w[2]), __uint_as_float(w[3])));
  mma_3xtf32<kExact>(d, P.big, P.small, F.big[0], F.big[1], F.small[0], F.small[1]);
  transpose8(__float_as_uint(y.x), __float_as_uint(y.y), lane, w[0], w[2]);
  transpose8(__float_as_uint(y.z), __float_as_uint(y.w), lane, w[1], w[3]);
  P = tf32_split4<kExact>(make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                                      __uint_as_float(w[2]), __uint_as_float(w[3])));
  mma_3xtf32<kExact>(d, P.big, P.small, F.big[2], F.big[3], F.small[2], F.small[3]);
}

}  // namespace evt
