// The once-per-round O(n) prologue of the persistent multiround kernels,
// and the solve's result they write where it ends, shared by multiround.cu
// and multiround_sym.cu so the two cannot drift.
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

// The stop's statistics, max v, max |v| and max |v[k] - v[k+1]|, taken on
// from a chunk of four values w and the value after it (stats4) or from
// one value and the next (stats1); every kernel that checks the stop on a
// thread's values takes them through these (round_prologue, round_glue.cu).
__device__ __forceinline__ void stats4(float4 w, float next, float& mx, float& mabs,
                                       float& md) {
  mx = nanmax(nanmax(nanmax(mx, w.x), nanmax(w.y, w.z)), w.w);
  mabs = nanmax(nanmax(nanmax(mabs, fabsf(w.x)), nanmax(fabsf(w.y), fabsf(w.z))), fabsf(w.w));
  md = nanmax(nanmax(nanmax(md, fabsf(w.x - w.y)), nanmax(fabsf(w.y - w.z), fabsf(w.z - w.w))),
              fabsf(w.w - next));
}

__device__ __forceinline__ void stats1(float v, float next, float& mx, float& mabs, float& md) {
  mx = nanmax(mx, v);
  mabs = nanmax(mabs, fabsf(v));
  md = nanmax(md, fabsf(v - next));
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = nanmax(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// Block-wide max of three values in a block of kT threads; every thread
// gets the results.
template <int kT = kThreads>
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
    a = lane < kT / 32 ? red[0][lane] : -INFINITY;
    b = lane < kT / 32 ? red[1][lane] : -INFINITY;
    c = lane < kT / 32 ? red[2][lane] : -INFINITY;
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

// One round's prologue on the block's shared-memory copy `ev_s` (n floats),
// run by a block of kT threads.
// This round's v is `v_in` when `first`, else raw / ev_s, with `raw` the
// previous round's row sums in global memory (written by other blocks, so
// read through L2).  Returns true when the solve halts
// here (the caller leaves its round loop; every block decides the same).
// Otherwise takes the lambda snapshot, updates ev_s and counts the round in
// `adv`.
//
// Nothing of A is in flight meanwhile, so what a round pays here is L2
// round trips.  With n % 4 == 0 a thread therefore takes float4 chunks and
// asks for all the values of up to kBatch chunks before it divides the
// first; the neighbour beyond a chunk comes from the next lane's registers
// (the last lane of a warp loads it); and up to n = 4 * kT * kBatch the
// thread keeps its v in registers for the ev update.  A round then costs
// one L2 round trip where a loop of dependent scalar loads paid sixteen at
// n = 8192.  The expressions, and so the bits, are the scalar path's.  The
// batch is the kernel's choice: its registers must hold it without
// spilling (a block that fills its shared memory with A has next to no L1
// left, so a spill there goes to L2).

__device__ __forceinline__ float4 div4(float4 a, float4 e) {
  return make_float4(a.x / e.x, a.y / e.y, a.z / e.z, a.w / e.w);
}

template <int kT, int kBatch>
__device__ __forceinline__ bool round_prologue(
    const float* __restrict__ v_in, const float* raw, bool first, float* ev_s,
    int n, float eps, int rel, int budget, int& adv, float& lam,
    float (*red)[kWarps], float* stats) {
  const int tid = threadIdx.x, lane = tid & 31;
  const float* src = first ? v_in : raw;  // v_in is read-only; raw through L2
  float mx = -INFINITY, mabs = -INFINITY, md = -INFINITY;
  const bool vec = (n & 3) == 0;
  const int n4 = n >> 2;
  const bool kept = n4 <= kT * kBatch;  // one batch: v stays in registers
  float4 v[kBatch];
  if (vec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const float4* ev4 = reinterpret_cast<const float4*>(ev_s);
    for (int c0 = tid; c0 - lane < n4; c0 += kT * kBatch) {
      float edge[kBatch];  // v beyond the chunk, where no lane holds it
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kT;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        edge[u] = 0.0f;
        if (c < n4) {
          v[u] = __ldcg(src4 + c);
          if (lane == 31 || c + 1 == n4) edge[u] = __ldcg(src + (c + 1 == n4 ? 0 : 4 * c + 4));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kT;
        const bool valid = c < n4;
        if (valid && !first) v[u] = div4(v[u], ev4[c]);
        float vn = __shfl_down_sync(0xffffffffu, v[u].x, 1);  // every lane of the warp
        if (valid) {
          if (lane == 31 || c + 1 == n4) {
            const int jn = c + 1 == n4 ? 0 : 4 * c + 4;
            vn = first ? edge[u] : edge[u] / ev_s[jn];
          }
          stats4(v[u], vn, mx, mabs, md);
        }
      }
    }
  } else {
    for (int j = tid; j < n; j += kT) {
      const int jn = j + 1 == n ? 0 : j + 1;
      const float vj = first ? v_in[j] : __ldcg(raw + j) / ev_s[j];
      const float vn = first ? v_in[jn] : __ldcg(raw + jn) / ev_s[jn];
      stats1(vj, vn, mx, mabs, md);
    }
  }
  block_max3<kT>(mx, mabs, md, red, stats);
  const float tol = rel ? eps * mabs : eps;
  if (md < tol || adv >= budget) return true;
  // thread 0 owns j == 0, so it reads v[0] before its own ev update
  if (tid == 0) lam = vec && kept ? v[0].x : first ? v_in[0] : __ldcg(raw) / ev_s[0];
  if (vec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* ev4 = reinterpret_cast<float4*>(ev_s);
    for (int c0 = tid; c0 < n4; c0 += kT * kBatch) {
      if (!kept) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (c0 + u * kT < n4) v[u] = __ldcg(src4 + c0 + u * kT);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kT;
        if (c < n4) {
          const float4 e = ev4[c];
          const float4 w = (kept || first) ? v[u] : div4(v[u], e);
          ev4[c] = make_float4(e.x * (w.x / mx), e.y * (w.y / mx), e.z * (w.z / mx),
                               e.w * (w.w / mx));
        }
      }
    }
  } else {
    for (int j = tid; j < n; j += kT) {
      const float vj = first ? v_in[j] : __ldcg(raw + j) / ev_s[j];
      ev_s[j] = ev_s[j] * (vj / mx);
    }
  }
  __syncthreads();
  ++adv;
  return false;
}

// The solve's result, where the caller asks for it (`rounds_out` not null),
// written after the launch's carry by the grid (kT threads a block, each
// over the indices whose carry it wrote: ev_s to ev_out, v to v_out, lambda
// to lam_out).  The solve's rounds are `rounds0` before this launch plus
// `adv`, and it converged where the launch halted (advanced fewer than the
// `runs` rounds its chunk holds) with budget left, solver._finish's rule
// rounds < max_itr.  A converged launch writes the solve's ev and lambda
// over the carry's: the update that round_prologue skipped where it halted,
// ev_s * (v / m) with m = max(v), which it left in `stats[0]`, and v[0],
// _finish's expressions in its f32 order, so its bits.  Any other launch
// leaves the carry, which a next launch resumes from.  A call, not inlined:
// inlined, the finish moved the registers or spills of 20 of the 33
// instances of the two kernels (ptxas); called after the carry's writes, it
// leaves every instance's as they were.
template <int kT>
__device__ __noinline__ void write_finish(const float* ev_s, const float* v_out, float* ev_out,
                                          float* lam_out, int* rounds_out, bool* converged_out,
                                          int n, int adv, int budget, int runs, int rounds0,
                                          float m) {
  const bool converged = adv < runs && adv < budget;
  if (converged)
    for (int j = blockIdx.x * kT + threadIdx.x; j < n; j += gridDim.x * kT)
      ev_out[j] = ev_s[j] * (v_out[j] / m);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (converged) *lam_out = v_out[0];
    *rounds_out = rounds0 + adv;
    *converged_out = converged;
  }
}

// Phase stamps for kernel_phases.py: with `stamps` set, thread 0 of every
// block writes the card's nanosecond timer at phase boundary p of round r
// (the first kStampRounds rounds; `sync` first waits for the block, so the
// stamp is the block's and not warp 0's).  Layout: [round][phase][block].
// A launch without stamps (nullptr: every solve) pays one uniform branch.
constexpr int kStampRounds = 32;
constexpr int kStampPhases = 6;

__device__ __forceinline__ void stamp(unsigned long long* stamps, int r, int p, bool sync) {
  if (stamps == nullptr) return;
  if (sync) __syncthreads();
  if (threadIdx.x == 0 && r < kStampRounds) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[(static_cast<size_t>(r) * kStampPhases + p) * gridDim.x + blockIdx.x] = t;
  }
}

}  // namespace evt
