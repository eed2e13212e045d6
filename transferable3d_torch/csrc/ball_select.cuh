// Ball-query selection shared by kernels K2 (sa_infer.cu), K3 and K4
// (ball_extract.cu), so the three cannot disagree on a group's members.
//
// For one centroid c and the N points of its batch row (one block):
//   d2     = ((0 + dx*dx) + dy*dy) + dz*dz, dx = c - p (direct form, each
//            product and sum its own rounded op, never an FMA), as the
//            JAX `_masked_rank` (transferable3d_tpu/ops/grouping.py) and
//            `_rank_rows` (ops/fused_sa.py) compute it;
//   in     = d2 <= r2, with r2 = float32(radius^2);
//   sel    = the first min(count, K) in-radius point indices, in index
//            order (a ballot/popc block scan gives each in-radius point
//            its rank);
//   empty  = count == 0: sel[0] = the nearest point, lowest index on ties
//            (block argmin).
// The caller's slot k then takes sel[k mod eff], eff = clip(count, 1, K).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace t3d {

constexpr unsigned kFullMask = 0xffffffffu;

// Returns the true in-radius count (the same value in every thread) and
// leaves sel[] complete and visible to the whole block. Shared scratch:
// sel[K], wcnt[kThreads / 32], red_d[kThreads / 32], red_i[kThreads / 32].
// Every thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ int ball_select(const float* __restrict__ pts,
                                           int N, float cx, float cy,
                                           float cz, float r2, int K,
                                           int* sel, int* wcnt, float* red_d,
                                           int* red_i) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int total = 0;              // in-radius points so far (all threads)
  float near_d = INFINITY;    // this thread's nearest point
  int near_i = N;
  for (int base = 0; base < N; base += kThreads) {
    const int p = base + tid;
    bool in = false;
    if (p < N) {
      const float dx = __fsub_rn(cx, pts[3 * p + 0]);
      const float dy = __fsub_rn(cy, pts[3 * p + 1]);
      const float dz = __fsub_rn(cz, pts[3 * p + 2]);
      float d = __fmul_rn(dx, dx);
      d = __fadd_rn(d, __fmul_rn(dy, dy));
      d = __fadd_rn(d, __fmul_rn(dz, dz));
      in = d <= r2;
      if (d < near_d) {  // p rises within a thread: lowest index stays
        near_d = d;
        near_i = p;
      }
    }
    const unsigned m = __ballot_sync(kFullMask, in);
    if (lane == 0) wcnt[warp] = __popc(m);
    __syncthreads();
    int off = total, tile = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += wcnt[w];
      tile += wcnt[w];
    }
    if (in) {
      const int r = off + __popc(m & ((1u << lane) - 1u));
      if (r < K) sel[r] = p;
    }
    total += tile;
    __syncthreads();
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_down_sync(kFullMask, near_d, o);
    const int oi = __shfl_down_sync(kFullMask, near_i, o);
    if (od < near_d || (od == near_d && oi < near_i)) {
      near_d = od;
      near_i = oi;
    }
  }
  if (lane == 0) {
    red_d[warp] = near_d;
    red_i[warp] = near_i;
  }
  __syncthreads();
  if (tid == 0 && total == 0) {
    float bd = red_d[0];
    int bi = red_i[0];
    for (int w = 1; w < kWarps; ++w) {
      if (red_d[w] < bd || (red_d[w] == bd && red_i[w] < bi)) {
        bd = red_d[w];
        bi = red_i[w];
      }
    }
    sel[0] = bi;
  }
  __syncthreads();
  return total;
}

}  // namespace t3d
