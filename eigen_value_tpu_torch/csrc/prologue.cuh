// The once-per-round O(n) prologue of the persistent multiround kernels,
// shared by multiround.cu and multiround_sym.cu so the two cannot drift.
//
// Reproduces eigen_value_tpu/ops/pallas/kernels.py `_round_prologue`
// expression for expression: v = raw / ev; tol = eps or eps * max|v|;
// fired = all |v - roll(v,-1)| < tol (taken as max|...| < tol, which is the
// same test, NaN included); halt = fired | (adv >= budget); lambda = v[0];
// m = max(v); ev = ev * (v / m).  Max is exact in any order, so every block
// of a grid computes bit-identical ev, m and halt from the same raw sums.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace evt {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// max that propagates NaN, like jnp.max / torch.max
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = nanmax(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// Block-wide max of three values; every thread gets the results.
__device__ __forceinline__ void block_max3(float& a, float& b, float& c,
                                           float (*red)[kWarps], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_max(a);
  b = warp_max(b);
  c = warp_max(c);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
    red[2][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? red[0][lane] : -INFINITY;
    b = lane < kWarps ? red[1][lane] : -INFINITY;
    c = lane < kWarps ? red[2][lane] : -INFINITY;
    a = warp_max(a);
    b = warp_max(b);
    c = warp_max(c);
    if (lane == 0) {
      out[0] = a;
      out[1] = b;
      out[2] = c;
    }
  }
  __syncthreads();
  a = out[0];
  b = out[1];
  c = out[2];
}

// One round's prologue on the block's shared-memory copy `ev_s` (n floats).
// This round's v is `v_in` when `first`, else raw / ev_s, with `raw` the
// previous round's row sums in global memory (written by other blocks, so
// read through L2).  Returns true when the solve halts here (the caller
// leaves its round loop; every block decides the same).  Otherwise takes
// the lambda snapshot, updates ev_s and counts the round in `adv`.
__device__ __forceinline__ bool round_prologue(
    const float* __restrict__ v_in, const float* raw, bool first, float* ev_s,
    int n, float eps, int rel, int budget, int& adv, float& lam,
    float (*red)[kWarps], float* stats) {
  const int tid = threadIdx.x;
  float mx = -INFINITY, mabs = -INFINITY, md = -INFINITY;
  for (int j = tid; j < n; j += kThreads) {
    const int jn = j + 1 == n ? 0 : j + 1;
    const float vj = first ? v_in[j] : __ldcg(raw + j) / ev_s[j];
    const float vn = first ? v_in[jn] : __ldcg(raw + jn) / ev_s[jn];
    mx = nanmax(mx, vj);
    mabs = nanmax(mabs, fabsf(vj));
    md = nanmax(md, fabsf(vj - vn));
  }
  block_max3(mx, mabs, md, red, stats);
  const float tol = rel ? eps * mabs : eps;
  if (md < tol || adv >= budget) return true;
  // thread 0 owns j == 0, so it reads v[0] before its own ev update
  if (tid == 0) lam = first ? v_in[0] : __ldcg(raw) / ev_s[0];
  for (int j = tid; j < n; j += kThreads) {
    const float vj = first ? v_in[j] : __ldcg(raw + j) / ev_s[j];
    ev_s[j] = ev_s[j] * (vj / mx);
  }
  __syncthreads();
  ++adv;
  return false;
}

}  // namespace evt
