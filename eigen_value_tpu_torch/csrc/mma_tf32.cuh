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
// into big = rna(x) and small = rna(x - big) (cvt.rna.tf32.f32, to nearest,
// ties away from zero; x - big is exact), and a piece of A times ev is
// a_big·e_small + a_small·e_big, then + a_big·e_big, into the f32
// accumulator; a_small·e_small (2^-22 relative) is dropped.  Nothing relies
// on the unit's own truncation of the low 13 bits.  A bf16 or f16 value is
// exact in TF32 (its small part is 0), and a 2-byte A is converted to f32
// before the split: the same instructions on the same values, so a launch
// on A_q gives the bits of a launch on A_q.float().
//
// The unit: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  A matvec
// has one column, so a 16 x 8 piece of the matrix goes in the A operand and
// the 8 matching entries of the vector in column 0 of the B operand; the
// other 7 columns are zero.  Lane (g, t) = (lane / 4, lane % 4) holds A at
// rows g, g + 8 and columns t, t + 4, B at rows t, t + 4 of column g, and
// the result at rows g, g + 8 and columns 2t, 2t + 1: the sums of column 0
// land on lanes 4g.
//
// Bound on the H100: bytes, as the "vpu" formulation (2 flops a 4-byte
// element); the unit's work, 24 multiply-adds an element (7 wasted columns,
// 3 passes), is ~0.2 ms over 18 passes at 8192^2, hidden only where loads
// and products overlap.  The design reads A as the vpu paths do (a lane
// takes four consecutive columns of a row: one 16-byte f32 load, or 8 bytes
// of bf16 / f16), and the order of the k index inside an 8-column step is
// chosen to fit those loads: a product is a sum over k, so any order that A
// and B share gives the same sum, and a fixed one gives the same bits.
#pragma once

#include <cuda_runtime.h>

namespace evt {

// x rounded to TF32 (10 fraction bits), to nearest, ties away from zero.
__device__ __forceinline__ unsigned tf32_rna(float x) {
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

// d += A B on one m16n8k8 TF32 tile.
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                            unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k step of 8 in 3xTF32: a0..a3 the lane's A values (rows g, g + 8 at
// k = t; rows g, g + 8 at k = t + 4), b0, b1 its B values (k = t, t + 4;
// zero off column 0).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float a0, float a1, float a2, float a3,
                                           float b0, float b1) {
  const Tf32Pair p0 = tf32_split(a0), p1 = tf32_split(a1), p2 = tf32_split(a2),
                 p3 = tf32_split(a3), q0 = tf32_split(b0), q1 = tf32_split(b1);
  mma_m16n8k8(d, p0.big, p1.big, p2.big, p3.big, q0.small, q1.small);
  mma_m16n8k8(d, p0.small, p1.small, p2.small, p3.small, q0.big, q1.big);
  mma_m16n8k8(d, p0.big, p1.big, p2.big, p3.big, q0.big, q1.big);
}

// A 16 x 16 piece P of a matrix, as the loads leave it: lane (g, t) holds
// x = P[g][4t .. 4t + 3] and y = P[g + 8][4t .. 4t + 3].

// The row term: d += P . e, where lane (g, t) holds e = the vector at the
// piece's columns 4t .. 4t + 3 (read on lanes 0-3 only).  k = t, t + 4 are
// columns 4t, 4t + 1 in the first step and 4t + 2, 4t + 3 in the second.
// Rows g and g + 8 land in d[0] and d[2] of lane 4g.
__device__ __forceinline__ void mma_rows16(float (&d)[4], float4 x, float4 y, float4 e, int lane) {
  const bool col0 = lane < 4;
  mma_3xtf32(d, x.x, y.x, x.y, y.y, col0 ? e.x : 0.0f, col0 ? e.y : 0.0f);
  mma_3xtf32(d, x.z, y.z, x.w, y.w, col0 ? e.z : 0.0f, col0 ? e.w : 0.0f);
}

// An 8 x 8 block X whose lane (r, s) holds v0 = X[r][2s], v1 = X[r][2s + 1],
// transposed: lane (g, t) gets w0 = X[2t][g], w1 = X[2t + 1][g].  Two
// shuffles: in the first, a lane of even g reads X[2t][g] from lane (2t,
// g / 2) and one of odd g reads X[2t + 1][g] from lane (2t + 1, g / 2); a
// source lane sends v0 when its row is even and v1 when odd, so it serves
// exactly what its readers want.  The second shuffle brings the other row.
__device__ __forceinline__ void transpose8(float v0, float v1, int lane, float& w0, float& w1) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = g & 1;
  const float r1 =
      __shfl_sync(0xffffffffu, odd ? v1 : v0, ((2 * t + (g & 1)) << 2) + (g >> 1));
  const float r2 =
      __shfl_sync(0xffffffffu, odd ? v0 : v1, ((2 * t + 1 - (g & 1)) << 2) + (g >> 1));
  w0 = odd ? r2 : r1;
  w1 = odd ? r1 : r2;
}

// The transpose term: d += P^T . f, where lane (g, t) holds f = the vector
// at the piece's rows 2t, 2t + 1, 8 + 2t, 9 + 2t (read on lanes 0-3 only).
// There is no transposed ldmatrix for 32-bit values, so P^T's fragments come
// from the row fragments by transpose8: the block of columns 4s, 4s + 1
// (x.x, x.y) and that of 4s + 2, 4s + 3 (x.z, x.w), for rows 0-7 (x) and
// 8-15 (y).  m = g is column P(g) = 4 (g / 2) + g % 2 of the piece, m = g + 8
// column P(g) + 2; k = t, t + 4 are rows 2t, 2t + 1 (+ 8 in the second
// step).  Column P(g) lands in d[0] of lane 4g, column P(g) + 2 in d[2].
__device__ __forceinline__ void mma_cols16(float (&d)[4], float4 x, float4 y, float4 f, int lane) {
  const bool col0 = lane < 4;
  float p0, p1, q0, q1;
  transpose8(x.x, x.y, lane, p0, p1);
  transpose8(x.z, x.w, lane, q0, q1);
  mma_3xtf32(d, p0, q0, p1, q1, col0 ? f.x : 0.0f, col0 ? f.y : 0.0f);
  transpose8(y.x, y.y, lane, p0, p1);
  transpose8(y.z, y.w, lane, q0, q1);
  mma_3xtf32(d, p0, q0, p1, q1, col0 ? f.z : 0.0f, col0 ? f.w : 0.0f);
}

}  // namespace evt
