// Ball-query selection shared by kernels K2 (sa_infer.cu), K3 and K4
// (ball_extract.cu), K5 (sa_train_fwd.cu) and K9 (sa_train_bwd.cu), so
// that they cannot disagree on a group's members: a block's selection
// (`ball_select`, K2's f32 body), the warps of a block sharing one
// centroid (`ball_count_part` / `ball_place_part`, K9) and one warp a
// centroid (`ball_warp_step` / `ball_warp_nearest`, K2 and K5;
// `ball_warp_scan` with `ball_warp_nearest_of` for an empty ball, K3 and
// K4, which also counts past K and gives the members as bit words).
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

// The same selection by the warps of a block without block barriers of
// its own, for a block that holds several centroids at once (K9): the
// `nparts` warps of one centroid each take a contiguous share [lo, hi) of
// the points; `ball_count_part` leaves the share's in-radius count and
// nearest point, and after one barrier of the caller's `ball_place_part`
// gives the members their ranks across the shares, in index order.

__device__ __forceinline__ float ball_d2(const float* __restrict__ pts, int p,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(cx, pts[3 * p + 0]);
  const float dy = __fsub_rn(cy, pts[3 * p + 1]);
  const float dz = __fsub_rn(cz, pts[3 * p + 2]);
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

// The selection by one warp, 32 W points a step, for a warp that holds a
// centroid of its own (K2: W = 1; K5: W = 4). `ball_warp_step` takes
// points base .. base + 32 W - 1, lane l points base + 32 u + l: their d2
// (`ball_d2`, the W words' loads in flight together), then word by word a
// ballot and a popcount give the in-radius ones the ranks count, count +
// 1, ... in index order, and each rank below K writes its point to
// list[rank & mask] (a ring where mask + 1 is its power-of-two length,
// else mask = -1; K2's ring takes 32 new members a step, so W = 1 there);
// the lane's running nearest point (near_d, near_i) is updated. It returns
// the new count, at most K, the same in every lane. A caller stops at
// count == K or after the last point; if count is then 0,
// `ball_warp_nearest` gives the nearest point of the warp's running ones,
// the lowest index on ties, in every lane. Every lane of the warp calls
// both.
template <int W = 1>
__device__ __forceinline__ int ball_warp_step(const float* __restrict__ pts,
                                              int base, int N, float cx,
                                              float cy, float cz, float r2,
                                              int K, int count, int* list,
                                              int mask, float& near_d,
                                              int& near_i) {
  const int lane = threadIdx.x & 31;
  float d[W];
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int p = base + 32 * u + lane;
    d[u] = p < N ? ball_d2(pts, p, cx, cy, cz) : INFINITY;
  }
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int p = base + 32 * u + lane;
    if (d[u] < near_d) {  // p rises within a lane: the lowest index stays
      near_d = d[u];
      near_i = p;
    }
    const bool in = d[u] <= r2;
    const unsigned m = __ballot_sync(kFullMask, in);
    if (in) {
      const int r = count + __popc(m & ((1u << lane) - 1u));
      if (r < K) list[r & mask] = p;
    }
    count = min(count + __popc(m), K);
  }
  return count;
}

// The same step for the warps of K3 and K4's membership pass, which need
// more than the first K members: it returns the true in-radius count so
// far (not capped at K), writes each member of rank below K to list[rank]
// when `list` is given, and when `words` is given sets words[u] to the
// ballot of those members among points base + 32 u .. base + 32 u + 31.
// It keeps no nearest point: only an empty ball needs one, and
// `ball_warp_nearest_of` finds it then.
template <int W>
__device__ __forceinline__ int ball_warp_scan(const float* __restrict__ pts,
                                              int base, int N, float cx,
                                              float cy, float cz, float r2,
                                              int K, int count, int* list,
                                              unsigned* words) {
  const int lane = threadIdx.x & 31;
  float d[W];
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int p = base + 32 * u + lane;
    d[u] = p < N ? ball_d2(pts, p, cx, cy, cz) : INFINITY;
  }
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const bool in = d[u] <= r2;
    const unsigned m = __ballot_sync(kFullMask, in);
    if (count + __popc(m) <= K) {  // every one of them has a rank below K
      if (list != nullptr && in)
        list[count + __popc(m & ((1u << lane) - 1u))] = base + 32 * u + lane;
      if (words != nullptr) words[u] = m;
    } else {
      const int r = count + __popc(m & ((1u << lane) - 1u));
      const bool keep = in && r < K;
      if (list != nullptr && keep) list[r] = base + 32 * u + lane;
      if (words != nullptr) words[u] = __ballot_sync(kFullMask, keep);
    }
    count += __popc(m);
  }
  return count;
}

__device__ __forceinline__ int ball_warp_nearest(float near_d, int near_i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, near_d, o);
    const int oi = __shfl_xor_sync(kFullMask, near_i, o);
    if (od < near_d || (od == near_d && oi < near_i)) {
      near_d = od;
      near_i = oi;
    }
  }
  return near_i;
}

// The nearest of the N points, the lowest index on ties, in every lane of
// the warp (for the empty balls of `ball_warp_scan`).
__device__ __forceinline__ int ball_warp_nearest_of(
    const float* __restrict__ pts, int N, float cx, float cy, float cz) {
  const int lane = threadIdx.x & 31;
  float near_d = INFINITY;
  int near_i = N;
  for (int p = lane; p < N; p += 32) {  // p rises: the lowest index stays
    const float d = ball_d2(pts, p, cx, cy, cz);
    if (d < near_d) {
      near_d = d;
      near_i = p;
    }
  }
  return ball_warp_nearest(near_d, near_i);
}

// Every lane of the warp calls it; lane 0 writes *cnt, *nd and *ni.
__device__ __forceinline__ void ball_count_part(const float* __restrict__ pts,
                                                int lo, int hi, int N,
                                                float cx, float cy, float cz,
                                                float r2, int* cnt, float* nd,
                                                int* ni) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  float near_d = INFINITY;
  int near_i = N;
  // Four words of 32 points a round, so that their loads fly together.
  for (int base = lo; base < hi; base += 4 * 32) {
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = base + 32 * u + lane;
      d[u] = p < hi ? ball_d2(pts, p, cx, cy, cz) : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (d[u] < near_d) {  // p rises within a lane: lowest index stays
        near_d = d[u];
        near_i = base + 32 * u + lane;
      }
      count += __popc(__ballot_sync(kFullMask, d[u] <= r2));
    }
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
    *cnt = count;
    *nd = near_d;
    *ni = near_i;
  }
}

// cnts, nds, nis: the centroid's `nparts` results of ball_count_part.
// Writes sel[0 .. min(count, K)) (or the nearest point into sel[0]) and
// *eff = clip(count, 1, K). Every lane of the warp of share `part` calls
// it.
__device__ __forceinline__ void ball_place_part(
    const float* __restrict__ pts, int lo, int hi, float cx, float cy,
    float cz, float r2, int K, const int* cnts, const float* nds,
    const int* nis, int part, int nparts, int* sel, int* eff) {
  const int lane = threadIdx.x & 31;
  int off = 0, total = 0;
  for (int q = 0; q < nparts; ++q) {
    if (q < part) off += cnts[q];
    total += cnts[q];
  }
  if (total > 0) {
    for (int base = lo; base < hi && off < K; base += 4 * 32) {
      bool in[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = base + 32 * u + lane;
        in[u] = p < hi && ball_d2(pts, p, cx, cy, cz) <= r2;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned m = __ballot_sync(kFullMask, in[u]);
        if (in[u]) {
          const int r = off + __popc(m & ((1u << lane) - 1u));
          if (r < K) sel[r] = base + 32 * u + lane;
        }
        off += __popc(m);
      }
    }
  }
  if (part == 0 && lane == 0) {
    *eff = total == 0 ? 1 : min(total, K);
    if (total == 0) {
      float bd = nds[0];
      int bi = nis[0];
      for (int q = 1; q < nparts; ++q) {
        if (nds[q] < bd || (nds[q] == bd && nis[q] < bi)) {
          bd = nds[q];
          bi = nis[q];
        }
      }
      sel[0] = bi;
    }
  }
}

}  // namespace t3d
