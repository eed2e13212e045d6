// Fused set-abstraction inference for Hopper (sm_90a), kernel K2 of the
// port: ball query -> L x (BN + ReLU [+ Dense]) -> max over the group.
//
// Replaces the Pallas TPU kernels `_infer_kernel` and its planar twin
// `_infer_kernel_p` of transferable3d_tpu/ops/fused_sa.py (wrapper
// `_call_infer`). One kernel covers both: they compute the same values.
//
// What it computes, for centroid s of batch row b:
//   d2     = ((0 + dx*dx) + dy*dy) + dz*dz, dx = c - p (direct form,
//            no FMA), in radius when d2 <= r2 = float32(radius^2);
//   select = the in-radius points in index order (ranks 1..count); slot
//            k takes rank (k mod eff) + 1 with eff = clip(count, 1, K);
//            an empty ball takes the nearest point (lowest index on
//            ties); the d2 and selection code is ball_select.cuh, shared
//            with K3, K4, K5 and K9;
//   z1     = bf16(f32(pf[sel]) - f32(qc[s]));
//   h_d    = max(bf16(z_d * a_d + c_d), 0);
//   z_d+1  = bf16(sum_j h_d[j] * bf16(W_d)[j, o] + b_d[o])   (f32 sums);
//   pooled = max over the K slots of h_{L-1}.
// Rounding is round-to-nearest-even at exactly these sites, as in the
// JAX `_chain_all` / `_bf16_round`. Slots past eff repeat rows
// k mod eff, so the max over K equals the max over the first eff rows:
// the chain runs on those eff distinct rows only, which changes no bit.
//
// What bounds it: the products of the chain (989 TFLOP/s on the tensor
// cores at bf16) and the elementwise work around them; device memory
// traffic is small (xyz, the gathered pf rows, and `pooled`).
//
// The design (`sa_infer_mma_kernel`): a persistent grid of one block of
// 16 warps an SM, bf16(W) of every layer and the per-channel parameters in
// shared memory for the block's life, rounded and laid out there by the
// block itself from the chain's own f32 tensors (the launcher builds
// nothing). A warp takes whole centroids:
//   * its ball query runs 32 points a step (ball_select.cuh's
//     `ball_warp_step`, which K5 shares: a ballot and a popcount give the
//     members their ranks) and stops at the K-th member; the members wait
//     in a ring of 64 slots;
//   * every 16 members (and the last, fewer, padded by repeating a
//     member, which cannot change a max) go through the chain as one
//     16-row tile: z1 and h_0 are formed from the gathered pf rows in the
//     registers of the A fragment of `mma.sync.m16n8k16`; the accumulator
//     of layer d, after the bias, the bf16 rounding, BN and ReLU, is packed
//     to bf16 pairs that are the A fragment of layer d+1 (no shared-memory
//     round trip, no block barrier);
//   * the last layer, which feeds only the max, runs in chunks of 64
//     columns; its z = bf16(acc + b) is max- and min-reduced over the 16
//     rows by shuffles and into the warp's running extrema in shared
//     memory. h = relu(bf16(z a + c)) is monotone in z (rising for a > 0,
//     else falling), so the pooled row is h of the max or the min of z,
//     formed once when the centroid is done, as the training path's pool
//     epilogue forms it from K7's extrema.
// Its inner layers (F_0 .. F_{L-2}, widths padded to multiples of 16 with
// zero weights and a = c = 0, which keep h = 0 there) are at most 128
// wide. Chains with wider inner layers, or whose weights
// do not fit in shared memory, take the general kernel
// (`sa_infer_general_kernel`, the f32 pipes, one block a centroid); the
// launcher's plan (`sa_infer_plan` in ops/fused_sa.py) picks one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ball_select.cuh"
#include "tile_ops.cuh"

// Phase clocks, for `scripts/torch_time_sa_fwd.py --phases` only. Built
// with -DT3D_KERNEL_CLOCKS, lane 0 of warp 0 of block 0 adds to
// t3d_inf_clk[i] the cycles it spent between mark i - 1 and mark i (0:
// the ball query, 1: z1 and h_0, 2: the inner layers, 3: the last layer
// and the max, 4: the pooled row) and counts its centroids in
// t3d_inf_clk[7]. Otherwise the marks are empty.
#ifdef T3D_KERNEL_CLOCKS
__device__ unsigned long long t3d_inf_clk[8];
#define T3D_CLK_START long long clk_prev = clock64();
#define T3D_CLK(i)                                              \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                    \
    const long long clk_now = clock64();                        \
    t3d_inf_clk[i] += (unsigned long long)(clk_now - clk_prev); \
    t3d_inf_clk[7] += (i) == 4;                                 \
    clk_prev = clk_now;                                         \
  }
#else
#define T3D_CLK_START
#define T3D_CLK(i)
#endif

namespace {

typedef __nv_bfloat16 bf16;
using t3d::bf16_round2;
using t3d::bn_relu_pack;
using t3d::lds2;
using t3d::ldsm4t;
using t3d::mma16816;
using t3d::unpack2;

constexpr int kPad = 8;  // bf16 elements of padding per row of W
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 6;
constexpr int kRowTile = 4;

struct ChainDims {
  int depth;
  int f[kMaxDepth];
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float relu_bf16(float z, float a, float c) {
  const float y = bf16_round(__fadd_rn(__fmul_rn(z, a), c));
  return y > 0.0f ? y : 0.0f;
}

__host__ __device__ inline int head_bytes(int k) {
  const int h = (k + 3 * kWarps) * 4;
  return (h + 15) / 16 * 16;
}

// The general kernel, on the f32 pipes: one block of 256 threads a centroid,
// the whole [K, F] activation in two bf16 ping-pong tiles of shared
// memory (opted in above 48 KB), each thread four rows of one output
// channel, so a weight read from L2 feeds four multiply-adds on the f32
// pipes.
__global__ void __launch_bounds__(kThreads)
sa_infer_general_kernel(const float* __restrict__ cent,
                        const float* __restrict__ xyz,
                        const __nv_bfloat16* __restrict__ pf,
                        const __nv_bfloat16* __restrict__ qc,
                        const float* __restrict__ params,
                        __nv_bfloat16* __restrict__ pooled, int S, int N,
                        int K, ChainDims dims, float r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sel = reinterpret_cast<int*>(smem);          // [K] point indices
  int* wcnt = sel + K;                              // [kWarps]
  float* red_d = reinterpret_cast<float*>(wcnt + kWarps);
  int* red_i = reinterpret_cast<int*>(red_d + kWarps);
  int fmax = 0;
  for (int d = 0; d < dims.depth; ++d) fmax = max(fmax, dims.f[d]);
  __nv_bfloat16* cur =
      reinterpret_cast<__nv_bfloat16*>(smem + head_bytes(K));
  __nv_bfloat16* nxt = cur + K * fmax;

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t cs = (size_t)b * S + s;
  const float cx = cent[cs * 3 + 0];
  const float cy = cent[cs * 3 + 1];
  const float cz = cent[cs * 3 + 2];
  const float* pts = xyz + (size_t)b * N * 3;

  // --- ball query (ball_select.cuh): sel[] holds the eff members ---
  const int total = t3d::ball_select<kThreads>(pts, N, cx, cy, cz, r2, K,
                                              sel, wcnt, red_d, red_i);
  const int rows = total == 0 ? 1 : min(total, K);

  // --- z1 and layer 0: h0 = relu(bf16(bf16(pf - qc) * a0 + c0)) --------
  const float* prm = params;
  int fi = dims.f[0];
  {
    const float* a = prm;
    const float* c = prm + fi;
    prm += 2 * fi;
    const __nv_bfloat16* q = qc + cs * fi;
    for (int e = tid; e < rows * fi; e += kThreads) {
      const int r = e / fi, f = e - r * fi;
      const float g = __bfloat162float(pf[((size_t)b * N + sel[r]) * fi + f]);
      const float z = bf16_round(__fsub_rn(g, __bfloat162float(q[f])));
      cur[r * fi + f] = __float2bfloat16_rn(relu_bf16(z, a[f], c[f]));
    }
  }
  __syncthreads();

  // --- layers 1..L-1: z = bf16(h @ W + b), h = relu(bf16(z * a + c)) ---
  const int groups = (rows + kRowTile - 1) / kRowTile;
  for (int d = 0; d + 1 < dims.depth; ++d) {
    const int fo = dims.f[d + 1];
    const float* W = prm;
    const float* bias = W + (size_t)fi * fo;
    const float* a = bias + fo;
    const float* c = a + fo;
    prm = c + fo;
    for (int e = tid; e < groups * fo; e += kThreads) {
      const int g = e / fo, o = e - g * fo;
      int rr[kRowTile];
      for (int t = 0; t < kRowTile; ++t)
        rr[t] = min(g * kRowTile + t, rows - 1) * fi;
      float acc[kRowTile];
      for (int t = 0; t < kRowTile; ++t) acc[t] = 0.0f;
      for (int j = 0; j < fi; ++j) {
        const float w = W[(size_t)j * fo + o];
        // bf16 x bf16 products are exact in f32, so an FMA here rounds
        // exactly as a multiply then an add would.
        for (int t = 0; t < kRowTile; ++t)
          acc[t] = fmaf(__bfloat162float(cur[rr[t] + j]), w, acc[t]);
      }
      for (int t = 0; t < kRowTile; ++t) {
        const int r = g * kRowTile + t;
        if (r < rows) {
          const float z = bf16_round(__fadd_rn(acc[t], bias[o]));
          nxt[r * fo + o] = __float2bfloat16_rn(relu_bf16(z, a[o], c[o]));
        }
      }
    }
    __syncthreads();
    __nv_bfloat16* t = cur;
    cur = nxt;
    nxt = t;
    fi = fo;
  }

  // --- max over the group -------------------------------------------
  for (int o = tid; o < fi; o += kThreads) {
    float m = __bfloat162float(cur[o]);
    for (int r = 1; r < rows; ++r) m = fmaxf(m, __bfloat162float(cur[r * fi + o]));
    pooled[cs * fi + o] = __float2bfloat16_rn(m);
  }
}


// ------------------------------------------------ tensor-core kernel -----

constexpr int kInfThreads = 512;
constexpr int kInfWarps = kInfThreads / 32;
constexpr int kRing = 64;     // member slots a warp (15 pending + 32 new)
constexpr int kMaxKt = 8;     // 16-wide k steps of an inner layer (<= 128)
constexpr int kLastChunk = 8; // 8-column tiles of the last layer at once

struct InferArgs {
  const float* cent;   // [C, 3]
  const float* xyz;    // [B, N, 3]
  const bf16* pf;      // [B, N, F0]
  const bf16* qc;      // [C, F0]
  const float* w[kMaxDepth - 1];     // W_d [fr_d, fr_d+1], row-major
  const float* pack[kMaxDepth];      // layer d's pack [6, fr_d]: a, c, ...
  const float* bias[kMaxDepth - 1];  // b_d+1 [fr_d+1]
  bf16* pooled;        // [C, F_{L-1}]
  int ncent, S, N, K, depth;
  int f[kMaxDepth];    // the kernel's widths: fr padded to multiples of 16
  int fr[kMaxDepth];   // the chain's widths
  float r2;
  int wbytes, pbytes;  // shared memory of the weights and of a | c | b
};

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__global__ void __launch_bounds__(kInfThreads, 1)
sa_infer_mma_kernel(InferArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bf16* wsm = reinterpret_cast<const bf16*>(smem);
  const float* prm = reinterpret_cast<const float*>(smem + p.wbytes);
  const int FL = p.f[p.depth - 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lrow = lane >> 2, lcol = (lane & 3) * 2;
  unsigned char* mine =
      smem + p.wbytes + p.pbytes + (size_t)warp * (kRing + 2 * FL) * 4;
  int* ring = reinterpret_cast<int*>(mine);               // [kRing]
  // the last layer's z over the centroid's rows: max | -min, [2][FL]
  float* zext = reinterpret_cast<float*>(mine) + kRing;

  // bf16(W_d) as [F_d][F_d+1 + 8] rows, every layer's a | c | b: zero on
  // the padded channels (a = c = 0 keeps h = 0 there)
  {
    bf16* ws = reinterpret_cast<bf16*>(smem);
    for (int d = 0; d + 1 < p.depth; ++d) {
      const int ld = p.f[d + 1] + kPad, rr = p.fr[d], rc = p.fr[d + 1];
      const float* W = p.w[d];
      for (int i = threadIdx.x; i < p.f[d] * ld; i += kInfThreads) {
        const int r = i / ld, col = i - r * ld;
        ws[i] = __float2bfloat16_rn(r < rr && col < rc
                                        ? W[(size_t)r * rc + col] : 0.0f);
      }
      ws += (size_t)p.f[d] * ld;
    }
    float* pp = reinterpret_cast<float*>(smem + p.wbytes);
    for (int d = 0; d < p.depth; ++d) {
      const int fp = p.f[d], fr = p.fr[d];
      for (int i = threadIdx.x; i < fp; i += kInfThreads) {
        const bool real = i < fr;
        pp[i] = real ? p.pack[d][i] : 0.0f;
        pp[fp + i] = real ? p.pack[d][fr + i] : 0.0f;
        pp[2 * fp + i] = real && d ? p.bias[d - 1][i] : 0.0f;
      }
      pp += 3 * fp;
    }
  }
  __syncthreads();

  const int F0 = p.f[0], nk0 = F0 / 16;
  const float* plast = prm;  // a | c of the last layer
  for (int d = 0; d + 1 < p.depth; ++d) plast += 3 * p.f[d];
  T3D_CLK_START
  for (int c = blockIdx.x * kInfWarps + warp; c < p.ncent;
       c += gridDim.x * kInfWarps) {
    const int b = c / p.S;
    const float* pts = p.xyz + (size_t)b * p.N * 3;
    const float cx = p.cent[(size_t)c * 3 + 0];
    const float cy = p.cent[(size_t)c * 3 + 1];
    const float cz = p.cent[(size_t)c * 3 + 2];
    const bf16* pfb = p.pf + (size_t)b * p.N * F0 + lcol;
    const bf16* qcs = p.qc + (size_t)c * F0 + lcol;
    for (int f = lane; f < 2 * FL; f += 32) zext[f] = -INFINITY;

    // The chain on members start .. start + nvalid - 1 (ring slots), as
    // one 16-row tile; rows past nvalid repeat the last member.
    auto chain = [&](int start, int nvalid) {
      const int m_lo = ring[(start + min(lrow, nvalid - 1)) & (kRing - 1)];
      const int m_hi =
          ring[(start + min(lrow + 8, nvalid - 1)) & (kRing - 1)];
      const bf16* g_lo = pfb + (size_t)m_lo * F0;
      const bf16* g_hi = pfb + (size_t)m_hi * F0;
      // z1 = bf16(pf - qc) and h_0 in the A fragment of the first product
      uint32_t a[kMaxKt][4];
#pragma unroll
      for (int kk = 0; kk < kMaxKt; ++kk) {
        if (kk < nk0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = kk * 16 + h * 8;
            const float2 q = unpack2(ldg32(qcs + k));
            const float2 x = unpack2(ldg32(g_lo + k));
            const float2 y = unpack2(ldg32(g_hi + k));
            const float2 av = lds2(prm + k + lcol);
            const float2 cv = lds2(prm + F0 + k + lcol);
            a[kk][2 * h] = bn_relu_pack(
                bf16_round2(__fsub_rn(x.x, q.x), __fsub_rn(x.y, q.y)), av, cv);
            a[kk][2 * h + 1] = bn_relu_pack(
                bf16_round2(__fsub_rn(y.x, q.x), __fsub_rn(y.y, q.y)), av, cv);
          }
        }
      }
      T3D_CLK(1)
      const bf16* wd = wsm;
      const float* lp = prm + 3 * F0;  // layer d + 1: a | c | b
      int fi = F0;
      for (int d = 0; d + 1 < p.depth; ++d) {
        const int fo = p.f[d + 1], ldw = fo + kPad, nki = fi / 16;
        const float *av = lp, *cv = lp + fo, *bv = lp + 2 * fo;
        // B fragments of k step kk, 16 columns from n: matrices (k 0-7,
        // n..n+7), (k 8-15, n..), (k 0-7, n+8..), (k 8-15, n+8..)
        const bf16* wl = wd + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * ldw +
                         (lane >> 4) * 8;
        if (d + 2 < p.depth) {
          uint32_t an[kMaxKt][4];
#pragma unroll
          for (int j = 0; j < kMaxKt; ++j) {
            if (j < fo / 16) {
              float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f},
                                 {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
              for (int kk = 0; kk < kMaxKt; ++kk) {
                if (kk < nki) {
                  uint32_t bf[4];
                  ldsm4t(bf, wl + (size_t)kk * 16 * ldw + j * 16);
                  mma16816(acc[0], a[kk], bf[0], bf[1]);
                  mma16816(acc[1], a[kk], bf[2], bf[3]);
                }
              }
              // bias, bf16 round, BN, ReLU: the A fragment of layer d + 2
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = j * 16 + h * 8 + lcol;
                const float2 bb = lds2(bv + col), aa = lds2(av + col),
                             cc = lds2(cv + col);
                an[j][2 * h] = bn_relu_pack(
                    bf16_round2(__fadd_rn(acc[h][0], bb.x),
                                __fadd_rn(acc[h][1], bb.y)), aa, cc);
                an[j][2 * h + 1] = bn_relu_pack(
                    bf16_round2(__fadd_rn(acc[h][2], bb.x),
                                __fadd_rn(acc[h][3], bb.y)), aa, cc);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kMaxKt; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[j][e] = an[j][e];
          T3D_CLK(2)
        } else {
          // the last layer, 64 columns at a time: z and its max and min
          // over the 16 rows (h's max follows from them at the end)
          for (int n0 = 0; n0 < fo; n0 += 8 * kLastChunk) {
            const int nt = min(kLastChunk, (fo - n0) / 8);  // even
            float acc[kLastChunk][4];
#pragma unroll
            for (int t = 0; t < kLastChunk; ++t)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < kMaxKt; ++kk) {
              if (kk < nki) {
#pragma unroll
                for (int t = 0; t < kLastChunk; t += 2) {
                  if (t < nt) {
                    uint32_t bf[4];
                    ldsm4t(bf, wl + (size_t)kk * 16 * ldw + n0 + t * 8);
                    mma16816(acc[t], a[kk], bf[0], bf[1]);
                    mma16816(acc[t + 1], a[kk], bf[2], bf[3]);
                  }
                }
              }
            }
#pragma unroll
            for (int t = 0; t < kLastChunk; ++t) {
              if (t < nt) {
                const int col = n0 + t * 8 + lcol;
                const float2 bb = lds2(bv + col);
                const float2 lo = bf16_round2(__fadd_rn(acc[t][0], bb.x),
                                              __fadd_rn(acc[t][1], bb.y));
                const float2 hi = bf16_round2(__fadd_rn(acc[t][2], bb.x),
                                              __fadd_rn(acc[t][3], bb.y));
                // the min as the max of the negated values: exact
                const float e[4] = {fmaxf(lo.x, hi.x), fmaxf(lo.y, hi.y),
                                    -fminf(lo.x, hi.x), -fminf(lo.y, hi.y)};
                const float m = t3d::col_reduce4<true>(e);
                if (!(lane & 4)) {
                  float* at = zext + ((lane >> 4) & 1) * FL + col +
                              ((lane >> 3) & 1);
                  *at = fmaxf(*at, m);
                }
              }
            }
          }
          T3D_CLK(3)
        }
        wd += (size_t)fi * ldw;
        lp += 3 * fo;
        fi = fo;
      }
    };

    // Ball query, 32 points a step (ball_select.cuh), until K members.
    int count = 0, done = 0, near_i = p.N;
    float near_d = INFINITY;
    for (int base = 0; base < p.N && count < p.K; base += 32) {
      count = t3d::ball_warp_step(pts, base, p.N, cx, cy, cz, p.r2, p.K,
                                  count, ring, kRing - 1, near_d, near_i);
      __syncwarp();
      T3D_CLK(0)
      for (; count - done >= 16; done += 16) chain(done, 16);
    }
    if (count == 0) {  // an empty ball: the nearest point, lowest index
      const int nearest = t3d::ball_warp_nearest(near_d, near_i);
      if (lane == 0) ring[0] = nearest;
      __syncwarp();
      count = 1;
    }
    if (count > done) chain(done, count - done);
    __syncwarp();
    // pooled = max_k relu(bf16(z_k a + c)): the map is monotone in z, so
    // it is that of the max of z where a > 0 and of the min elsewhere
    bf16* out = p.pooled + (size_t)c * FL;
    for (int f = 2 * lane; f < FL; f += 64) {
      const float2 aa = lds2(plast + f), cc = lds2(plast + FL + f);
      const float2 z = make_float2(aa.x > 0.0f ? zext[f] : -zext[FL + f],
                                   aa.y > 0.0f ? zext[f + 1] : -zext[FL + f + 1]);
      *reinterpret_cast<uint32_t*>(out + f) = bn_relu_pack(z, aa, cc);
    }
    __syncwarp();
    T3D_CLK(4)
  }
}

}  // namespace

extern "C" int t3d_sa_infer(const float* cent, const float* xyz,
                            const void* pf, const void* qc,
                            const float* params, void* pooled, int b, int s,
                            int n, int k, int depth, const int* dims_host,
                            float r2, void* stream) {
  if (depth < 2 || depth > kMaxDepth || b < 1 || s < 1 || n < 1 || k < 1 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  ChainDims dims;
  dims.depth = depth;
  int fmax = 0;
  for (int d = 0; d < kMaxDepth; ++d) {
    dims.f[d] = d < depth ? dims_host[d] : 0;
    if (d < depth) fmax = dims.f[d] > fmax ? dims.f[d] : fmax;
  }
  const size_t smem = (size_t)head_bytes(k) + 2 * (size_t)k * fmax * 2;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sa_infer_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(s, b);
  sa_infer_general_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cent, xyz, static_cast<const __nv_bfloat16*>(pf),
      static_cast<const __nv_bfloat16*>(qc), params,
      static_cast<__nv_bfloat16*>(pooled), s, n, k, dims, r2);
  return (int)cudaGetLastError();
}

#ifdef T3D_KERNEL_CLOCKS
// Copies K2's phase clocks to `out` (8 values) and sets them to zero.
extern "C" int t3d_sa_infer_clocks(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, t3d_inf_clk, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(t3d_inf_clk, zero, sizeof(zero));
  return (int)e;
}
#endif

// The tensor-core kernel. w, packs and biases are host arrays of the
// chain's f32 device tensors (depth - 1, depth and depth - 1 of them);
// `real` holds the chain's widths and `dims` the kernel's, padded to
// multiples of 16 (the inner ones at most 128); pf [B, N, dims[0]] and qc
// [B, S, dims[0]] bf16, zero on their padded channels, 4-byte aligned;
// pooled [B, S, dims[depth - 1]] bf16.
extern "C" int t3d_sa_infer_mma(const float* cent, const float* xyz,
                                const void* pf, const void* qc,
                                const float* const* w,
                                const float* const* packs,
                                const float* const* biases, void* pooled,
                                int b, int s, int n, int k, int depth,
                                const int* dims, const int* real, int grid,
                                float r2, void* stream) {
  if (depth < 2 || depth > kMaxDepth || b < 1 || s < 1 || n < 1 || k < 1 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  InferArgs a;
  size_t wbytes = 0, pbytes = 0;
  for (int d = 0; d < kMaxDepth; ++d) {
    a.f[d] = d < depth ? dims[d] : 0;
    a.fr[d] = d < depth ? real[d] : 0;
    if (d < depth && (a.f[d] < 16 || a.f[d] % 16 || a.fr[d] < 1 ||
                      a.fr[d] > a.f[d] ||
                      (d + 1 < depth && a.f[d] > 16 * kMaxKt)))
      return (int)cudaErrorInvalidValue;
    if (d < depth) {
      a.pack[d] = packs[d];
      pbytes += (size_t)3 * a.f[d] * 4;
    }
    if (d + 1 < depth) {
      a.w[d] = w[d];
      a.bias[d] = biases[d];
      wbytes += (size_t)a.f[d] * (dims[d + 1] + kPad) * 2;
    }
  }
  const size_t smem = wbytes + pbytes +
                      (size_t)kInfWarps * (kRing + 2 * a.f[depth - 1]) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sa_infer_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  a.cent = cent;
  a.xyz = xyz;
  a.pf = static_cast<const bf16*>(pf);
  a.qc = static_cast<const bf16*>(qc);
  a.pooled = static_cast<bf16*>(pooled);
  a.ncent = b * s;
  a.S = s;
  a.N = n;
  a.K = k;
  a.depth = depth;
  a.r2 = r2;
  a.wbytes = (int)wbytes;
  a.pbytes = (int)pbytes;
  sa_infer_mma_kernel<<<grid, kInfThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
