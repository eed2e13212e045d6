// Fused set-abstraction training, forward passes, for Hopper (sm_90a):
// kernels K5, K6 and K7 of the port.
//
// Replace the Pallas TPU kernels of transferable3d_tpu/ops/fused_sa.py:
//   K5 `_extract_kernel`  (and its planar twin `_extract_kernel_p`),
//   K6 `_fwd_step_kernel` (and `_fwd_step_kernel_cp`),
//   K7 `_fwd_last_kernel` (and, with the pool epilogue of the wrapper,
//      `_fwd_pool_ymax_kernel_cp`).
// The planar twins compute the same values in a layout that only a TPU's
// 128-lane padding asks for, so one kernel answers both.
//
// What they compute, for the K rows of centroid s of batch row b:
//   K5: members by ball_select.cuh (direct-form d2, first K in radius by
//       index, the nearest point for an empty ball); slot k takes member
//       k mod eff, eff = clip(count, 1, K);
//       z1[k] = bf16(f32(pf[sel]) - f32(qc[s])), written as bf16
//       [B, S, K, F0]; sum z1 and sum z1^2 per channel over all B*S*K
//       rows, repeats counted.
//   K6: h = max(bf16(z * a + c), 0); z' = bf16(sum_j h[j] * bf16(W)[j, o]
//       + b[o]) with f32 sums; z' written; sum z' and sum z'^2.
//   K7: K6, and max_k z' and min_k z' per centroid, f32 [B, S, F_out].
//
// What bounds them: K5 writes [B, S, K, F0] bf16 and reads 12 KB of xyz
// per centroid from L2: device-memory bytes. K6/K7 read [rows, F_in] and
// write [rows, F_out] bf16 around F_in * F_out multiply-adds a row: at
// F = 32..256 that is 11..85 operations a byte, below the card's 295, so
// bytes bound them too, provided the product runs on the tensor cores and
// the elementwise work around it stays a few instructions an element.
//
// K5's design: one warp a centroid, so no block barrier a centroid, up to
// 16 warps a block and two blocks an SM, a persistent grid
// (`sa_extract_plan` in ops/fused_sa.py, mirrored by `extract_layout`).
//   * The ball query is ball_select.cuh's warp step, which K2 shares: 128
//     points a step (their loads in flight together), ranks by ballot and
//     popcount, a stop at the K-th member, the nearest point by shuffles
//     for an empty ball.
//   * A lane takes 8 channels of a row as one 16-byte access (F0 / 8
//     lanes a row, 256 / F0 rows a warp step; a single bf16 where F0 is
//     not a multiple of 8), with qc's 8 values in registers; a centroid's
//     K rows are contiguous, so the stores coalesce. They are marked
//     evict-first (`st.global.cs`): z1 streams past the L2, which keeps
//     the rows it gathers from and the points of the query (8-30% less
//     time a launch on a train step's balls at seg SA1 and box SA1).
//   * Each distinct member's z1 is computed once and stored to every slot
//     that takes it; a centroid's sums add mult * z and mult * z^2, mult
//     its slot count (both exact for K <= 256), in f32 registers.
//   * Across the walk the sums are f64: each lane adds its centroid's f32
//     sums into f64 slots of shared memory that it alone owns; the row
//     groups of a warp, the warps of a block and the blocks are added in
//     fixed orders in f64, and the result is rounded to f32 once. So the
//     only f32 roundings are those of one centroid's few terms.
//
// K6/K7's design (the tools of sa_train_bwd.cu):
//   * A tile is `ct` whole centroids, ct * K <= 128 rows (4 centroids at
//     K = 32, 2 at K = 64); the last tile of a launch may hold fewer. A
//     persistent grid of one 512-thread block an SM walks the tiles.
//   * z_prev tiles come in as 16-byte `cp.async` copies into padded
//     shared-memory rows, through a ring of up to three stages: a tile's
//     loads are issued as soon as the products have read its stage.
//   * bf16(W) stays in shared memory for the block's walk where it fits
//     (the widest corner, 256 -> 256 at 128 rows, reads W^T through L2).
//   * Products are `mma.sync.m16n8k16` from `ldmatrix` operands: warp
//     (wm, wn) of the 8 x 2 grid takes 16 rows and half of the columns, so
//     every warp has work at every width. BN and ReLU are applied to the A
//     fragment in registers on its way into the product: once for every
//     warp and 64-column chunk that reads it (four times an element at
//     128 -> 256), yet an in-place pass over the tile instead, once an
//     element, was slower (K6 1.77-1.87 ms a step against 1.57-1.62): the
//     pass is a phase of its own, bound by its latency, while on the
//     fragment the same work hides behind the products'.
//   * The epilogue stays in registers: bias, the bf16 rounding, the
//     columns' sum and sum of squares over the warp's 16 rows by four
//     shuffles (t3d::col_reduce4), added per owner lane across the walk;
//     K7's max and min of each 16-row block the same way, combined per
//     centroid (its K rows lie in one tile) after the tile's barrier.
//   * z' is staged in shared memory and leaves as 16-byte stores while
//     the next tile's loads fly.
// Shared memory (`fwd_layout`, mirrored by `sa_fwd_layout_bytes` in
// ops/fused_sa.py, which plans ct, the stages and W's place).
//
// Whole-grid sums (sa_train.cuh): every partial has one owner (a lane's
// register or f64 slot across the walk, then the row blocks in order, then
// the blocks in order by a second launch): the same bits run after run for
// one grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_select.cuh"
#include "sa_train.cuh"
#include "tile_ops.cuh"

// Phase clocks, for `scripts/torch_time_sa_fwd.py --phases` only. Built
// with -DT3D_KERNEL_CLOCKS, thread 0 of block 0 adds to t3d_fwd_clk[i] the
// cycles it spent between mark i - 1 and mark i of every tile of K6/K7 (0:
// the ring's wait, 1: the products with their epilogue, 2: the way out)
// and counts its tiles in t3d_fwd_clk[7]; K5's marks below. Otherwise the
// marks are empty.
#ifdef T3D_KERNEL_CLOCKS
__device__ unsigned long long t3d_fwd_clk[8];
#define T3D_CLK_START long long clk_prev = clock64();
#define T3D_CLK(i)                                              \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                    \
    const long long clk_now = clock64();                        \
    t3d_fwd_clk[i] += (unsigned long long)(clk_now - clk_prev); \
    t3d_fwd_clk[7] += (i) == 2;                                 \
    clk_prev = clk_now;                                         \
  }
// K5's, in t3d_ext_clk by lane 0 of warp 0 of block 0 (0: the ball
// query, 1: the rows with the centroid's sums added into the f64 slots,
// per centroid; 2: the block's sums at the end; 7: its centroids).
__device__ unsigned long long t3d_ext_clk[8];
#define T3D_XCLK_START long long xclk_prev = clock64();
#define T3D_XCLK(i)                                               \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                      \
    const long long clk_now = clock64();                          \
    t3d_ext_clk[i] += (unsigned long long)(clk_now - xclk_prev);  \
    t3d_ext_clk[7] += (i) == 1;                                   \
    xclk_prev = clk_now;                                          \
  }
#else
#define T3D_CLK_START
#define T3D_CLK(i)
#define T3D_XCLK_START
#define T3D_XCLK(i)
#endif

namespace {

using t3d::bf16;
using t3d::bn_relu_pack;
using t3d::copy_rows;
using t3d::cp_commit;
using t3d::cp_wait;
using t3d::kPad;
using t3d::lds2;
using t3d::ldsm4;
using t3d::ldsm4t;
using t3d::mma16816;
using t3d::pack2;
using t3d::tof;
using t3d::unpack2;

// ---------------------------------------------------------------- K5 -----

constexpr int kMaxExtractK = 4096;
constexpr int kExtMaxWarps = 16;
constexpr int kExtMaxCh = 8;  // channels a lane owns (F0 <= 256)
// f64 sums a warp owns: (row group, channel) pairs, rows a warp step times
// F0, at most 256 for F0 <= 256, each a sum and a sum of squares.
constexpr int kExtAccPairs = 256;

// Shared memory of a K5 block of `warps` warps (mirrored by
// `sa_extract_layout_bytes` in ops/fused_sa.py): each warp's f64 sums,
// [2][kExtAccPairs] doubles, then each warp's member list, K ints rounded
// up to 4.
__host__ __device__ inline size_t extract_list_ints(int K) {
  return (size_t)(K + 3) / 4 * 4;
}

__host__ __device__ inline size_t extract_layout(int K, int F, int warps) {
  (void)F;
  return (size_t)warps * (2 * kExtAccPairs * 8 + extract_list_ints(K) * 4);
}

struct ExtArgs {
  const float* cent;  // [C, 3]
  const float* xyz;   // [B, N, 3]
  const bf16* pf;     // [B, N, F]
  const bf16* qc;     // [C, F]
  bf16* z1;           // [C, K, F]
  double* partials;   // [grid, 2, F]
  int ncent, S, N, K, F;
  float r2;
};

// z = bf16(pf - qc) of the V channels at src (V = 8: one 16-byte access;
// V = 1: one bf16), stored to `nslot` slot rows `step` elements apart from
// dst; with `mult` > 0 adds mult * z and mult * z^2 to the channels' sums
// s and q (z has 8 significant bits: both products are exact for mult
// <= 256).
__device__ __forceinline__ void add_stats(float& s, float& q, float mult,
                                          float z) {
  s = __fadd_rn(s, __fmul_rn(mult, z));
  q = __fadd_rn(q, __fmul_rn(mult, __fmul_rn(z, z)));
}

template <int V>
__device__ __forceinline__ void extract_chunk(const bf16* __restrict__ src,
                                              const float* qv, bf16* dst,
                                              size_t step, int nslot,
                                              float mult, float* s,
                                              float* q) {
  if constexpr (V == 8) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
    uint32_t zw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2(xw[i]);
      zw[i] = pack2(__fsub_rn(f.x, qv[2 * i]), __fsub_rn(f.y, qv[2 * i + 1]));
    }
    const uint4 z = make_uint4(zw[0], zw[1], zw[2], zw[3]);
    for (int t = 0; t < nslot; ++t)
      __stcs(reinterpret_cast<uint4*>(dst + (size_t)t * step), z);
    if (mult > 0.0f) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack2(zw[i]);
        add_stats(s[2 * i], q[2 * i], mult, f.x);
        add_stats(s[2 * i + 1], q[2 * i + 1], mult, f.y);
      }
    }
  } else {
    const bf16 zb = __float2bfloat16_rn(__fsub_rn(tof(src[0]), qv[0]));
    for (int t = 0; t < nslot; ++t) dst[(size_t)t * step] = zb;
    if (mult > 0.0f) add_stats(s[0], q[0], mult, tof(zb));
  }
}

// One warp a centroid. A row of F channels is cpr = F / V chunks of V
// channels; L lanes (cpr rounded up to a power of two, at most 32) take a
// row, lane j0 of them chunks j0, j0 + L, ... (J = ceil(cpr / L) of
// them), so 32 / L rows move in a warp step. A lane owns its chunks'
// channels in its row group rg for the whole walk: their qc values and a
// centroid's sums stay in its registers, the walk's sums in its f64 slots
// rg * F + channel of the warp's shared memory.
template <int V>
__global__ void __launch_bounds__(kExtMaxWarps * 32, 2)
sa_extract_kernel(ExtArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kJ = kExtMaxCh / V;  // chunks a lane may own
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = p.K, F = p.F, cpr = F / V;
  int L = 1;
  while (L < cpr && L < 32) L <<= 1;
  const int rpw = 32 / L, j0 = lane & (L - 1), rg = lane / L;
  double* acc = reinterpret_cast<double*>(smem) +
                (size_t)warp * 2 * kExtAccPairs;  // [2][rpw * F]
  int* list = reinterpret_cast<int*>(reinterpret_cast<double*>(smem) +
                                     (size_t)warps * 2 * kExtAccPairs) +
              warp * extract_list_ints(K);
  for (int i = lane; i < 2 * kExtAccPairs; i += 32) acc[i] = 0.0;
  __syncwarp();

  T3D_XCLK_START
  for (int c = blockIdx.x * warps + warp; c < p.ncent;
       c += gridDim.x * warps) {
    const int b = c / p.S;
    const float* pts = p.xyz + (size_t)b * p.N * 3;
    const float cx = p.cent[(size_t)c * 3 + 0];
    const float cy = p.cent[(size_t)c * 3 + 1];
    const float cz = p.cent[(size_t)c * 3 + 2];
    // the members (ball_select.cuh, shared with K2): the first K in radius
    // by index, or the nearest point for an empty ball
    int eff = 0, near_i = p.N;
    float near_d = INFINITY;
    for (int base = 0; base < p.N && eff < K; base += 4 * 32)
      eff = t3d::ball_warp_step<4>(pts, base, p.N, cx, cy, cz, p.r2, K, eff,
                                   list, -1, near_d, near_i);
    if (eff == 0) {
      const int nearest = t3d::ball_warp_nearest(near_d, near_i);
      if (lane == 0) list[0] = nearest;
      eff = 1;
    }
    __syncwarp();
    T3D_XCLK(0)

    // Slot k takes member k mod eff. Rows 0 .. P - 1 with P = eff (eff >=
    // 32 / L) or the least multiple of eff that fills a warp step: row i
    // holds member i mod eff and goes to the K / P + (i < K mod P) slots
    // i, i + P, ... < K, and the sums count member m < eff once, with its
    // slot count K / eff + (m < K mod eff).
    const int P = eff >= rpw ? eff : eff * ((rpw + eff - 1) / eff);
    const int rows = min(P, K);
    const int qp = K / P, rp = K - qp * P, qe = K / eff, re = K - qe * eff;
    float qv[kExtMaxCh], s[kExtMaxCh], q[kExtMaxCh];
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      const int g = j0 + t * L;
      const bf16* qs = p.qc + (size_t)c * F + g * V;
      if constexpr (V == 8) {
        const uint4 u = g < cpr ? __ldg(reinterpret_cast<const uint4*>(qs))
                                : make_uint4(0, 0, 0, 0);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack2(w[i]);
          qv[t * V + 2 * i] = f.x;
          qv[t * V + 2 * i + 1] = f.y;
        }
      } else {
        qv[t * V] = g < cpr ? tof(qs[0]) : 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < kExtMaxCh; ++e) s[e] = q[e] = 0.0f;
    const bf16* src = p.pf + (size_t)b * p.N * F;
    bf16* dst = p.z1 + (size_t)c * K * F;
    const size_t step = (size_t)P * F;
    for (int i = rg; i < rows; i += rpw) {
      const int m = i < eff ? i : i % eff;
      const bf16* row = src + (size_t)list[m] * F;
      const int nslot = qp + (i < rp);
      const float mult = i < eff ? (float)(qe + (i < re)) : 0.0f;
#pragma unroll
      for (int t = 0; t < kJ; ++t) {
        const int g = j0 + t * L;
        if (g < cpr)
          extract_chunk<V>(row + g * V, qv + t * V, dst + (size_t)i * F + g * V,
                           step, nslot, mult, s + t * V, q + t * V);
      }
    }
    // the centroid's sums into the lane's own f64 slots
#pragma unroll
    for (int t = 0; t < kJ; ++t) {
      const int g = j0 + t * L;
      if (g < cpr) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int i = rg * F + g * V + v;
          acc[i] = __dadd_rn(acc[i], (double)s[t * V + v]);
          acc[kExtAccPairs + i] =
              __dadd_rn(acc[kExtAccPairs + i], (double)q[t * V + v]);
        }
      }
    }
    __syncwarp();  // the list is rewritten by the next centroid
    T3D_XCLK(1)
  }

  // The block's sums in f64: each warp's row groups in order, then the
  // warps in order; then the blocks in order (reduce_partials), rounded to
  // f32 once: the same bits run after run.
  __syncthreads();
  const double* all = reinterpret_cast<const double*>(smem);
  for (int i = threadIdx.x; i < 2 * F; i += blockDim.x) {
    const int half = i / F, ch = i - half * F;
    double sum = 0.0;
    for (int w = 0; w < warps; ++w)
      for (int r = 0; r < rpw; ++r)
        sum = __dadd_rn(sum, all[((size_t)w * 2 + half) * kExtAccPairs +
                                 r * F + ch]);
    p.partials[(size_t)blockIdx.x * 2 * F + i] = sum;
  }
  T3D_XCLK(2)
}

// ----------------------------------------------------------- K6, K7 ------

constexpr int kFwdThreads = 512;
constexpr int kFwdWm = 8;      // 16-row blocks of a 128-row tile
static_assert(kFwdThreads / 32 == 2 * kFwdWm, "an 8 x 2 grid of warps");
constexpr int kFwdMaxStages = 3;
constexpr int kChunk = 8;      // 8-column accumulator tiles a warp holds
constexpr int kMaxNt = 16;     // 8-column tiles a warp owns (F_out <= 256)
constexpr size_t kSmemLimit = 232448;

struct FwdArgs {
  const bf16* z_prev;  // [C, K, Fin]
  const float* pack;   // [6, Fin]: rows a, c
  const float* w;      // W [Fin, Fout] f32, when W stays in shared memory
  const bf16* wt;      // else bf16(W)^T [Fout, Fin], read through L2
  const float* bias;   // [Fout]
  bf16* z_next;        // [C, K, Fout]
  float* partials;     // [grid, 2, Fout]
  float* zmax;         // K7: [C, Fout]
  float* zmin;         // K7: [C, Fout]
  int ncent, K, Fin, Fout;
  int ct, stages, wsmem;  // the launcher's plan
};

// Byte offsets of the shared-memory buffers (R = ct * K rows, pad = 8
// bf16 a row): `stages` z_prev tiles of R (Fin + 8) 2 bytes, bf16(W) Fin
// (Fout + 8) 2 if it stays, z' R (Fout + 8) 2, a | c | b (2 Fin + Fout) 4
// and, in K7, the 16-row blocks' extrema 2 x 8 x Fout 4.
struct FwdLayout {
  size_t tz, w, out, pk, ext, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int K, int Fin, int Fout,
                                                int ct, int stages, int wsmem,
                                                int last) {
  FwdLayout L;
  const size_t R = (size_t)ct * K;
  L.tz = R * (Fin + kPad) * 2;
  L.w = L.tz * stages;
  L.out = L.w + (wsmem ? (size_t)Fin * (Fout + kPad) * 2 : 0);
  L.pk = L.out + R * (Fout + kPad) * 2;
  L.ext = L.pk + (size_t)(2 * Fin + Fout) * 4;
  L.total = L.ext + (last ? (size_t)2 * kFwdWm * Fout * 4 : 0);
  return L;
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A tile is `ct` whole centroids (R = ct * K <= 128 rows). Warp (wm, wn)
// computes rows 16 wm .. 16 wm + 15 and the columns of half wn of z', in
// chunks of 8 accumulator tiles; the A operand is BN + ReLU of z_prev,
// applied to the `ldmatrix` fragment in registers.
template <bool kLast>
__global__ void __launch_bounds__(kFwdThreads, 1)
sa_fwd_step_kernel(FwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.K, Fin = p.Fin, Fout = p.Fout, ct = p.ct;
  const int stages = p.stages, ldi = Fin + kPad, ldo = Fout + kPad;
  const bool wsmem = p.wsmem != 0;
  const FwdLayout L = fwd_layout(K, Fin, Fout, ct, stages, p.wsmem, kLast);
  bf16* wsm = reinterpret_cast<bf16*>(smem + L.w);     // [Fin][ldo]
  bf16* outs = reinterpret_cast<bf16*>(smem + L.out);  // [R][ldo]
  float* pa = reinterpret_cast<float*>(smem + L.pk);   // a [Fin]
  float* pc = pa + Fin;                                // c [Fin]
  float* pb = pc + Fin;                                // bias [Fout]
  float* ext = reinterpret_cast<float*>(smem + L.ext);  // [2][kFwdWm][Fout]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kFwdWm, wn = warp / kFwdWm;
  const int lrow = lane >> 2, lcol = (lane & 3) * 2;
  const int ntn = Fout / 16, nbase = wn * (Fout / 2), nkk = Fin / 16;
  const int ntiles = (p.ncent + ct - 1) / ct;

  for (int i = tid; i < Fin; i += kFwdThreads) {
    pa[i] = p.pack[i];
    pc[i] = p.pack[Fin + i];
  }
  for (int i = tid; i < Fout; i += kFwdThreads) pb[i] = p.bias[i];
  auto load = [&](int T, int s) {
    if (T >= ntiles) return;
    const int c0 = T * ct, rows = min(ct, p.ncent - c0) * K;
    copy_rows<kFwdThreads>(reinterpret_cast<bf16*>(smem + L.tz * s), ldi,
                           p.z_prev + (size_t)c0 * K * Fin, rows, Fin);
  };
  for (int s = 0; s < stages; ++s) {
    load(blockIdx.x + s * gridDim.x, s);
    cp_commit();
  }
  // bf16(W) into shared memory while the first tiles fly
  if (wsmem) {
    for (int i = tid; i < Fin * Fout; i += kFwdThreads) {
      const int r = i / Fout;
      wsm[(size_t)r * ldo + i - r * Fout] = __float2bfloat16_rn(p.w[i]);
    }
  }

  // Lane l's share of the column sums, one value per 8-column tile t of
  // its warp: after col_reduce4 it holds sum z' (bit 4 of l clear) or sum
  // z'^2 (set) of column 8 t + lcol + bit 3 of l over this warp's rows,
  // added tile after tile in the walk's order.
  float sacc[kMaxNt];
#pragma unroll
  for (int t = 0; t < kMaxNt; ++t) sacc[t] = 0.0f;

  int it = 0;
  T3D_CLK_START
  for (int T = blockIdx.x; T < ntiles; T += gridDim.x, ++it) {
    const int s = it % stages;
    const int c0 = T * ct, nval = min(ct, p.ncent - c0), rows = nval * K;
    const bf16* zt = reinterpret_cast<const bf16*>(smem + L.tz * s);
    // One group a tile is committed; all but the later tiles' have landed.
    if (stages == 1) cp_wait<0>();
    else if (stages == 2) cp_wait<1>();
    else cp_wait<2>();
    __syncthreads();
    T3D_CLK(0)

    // --- z' = bf16(relu(bf16(z a + c)) @ bf16(W) + b) -------------------
    if (wm * 16 < rows) {
      const bf16* arow = zt + (size_t)(wm * 16 + (lane & 15)) * ldi +
                         (lane >> 4) * 8;
      const int r0 = wm * 16 + lrow;
#pragma unroll
      for (int ch = 0; ch < kMaxNt / kChunk; ++ch) {
        const int t0 = ch * kChunk;
        if (t0 < ntn) {
          float acc[kChunk][4];
#pragma unroll
          for (int t = 0; t < kChunk; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
          for (int kk = 0; kk < nkk; ++kk) {
            uint32_t a[4];
            ldsm4(a, arow + kk * 16);
            const int k0 = kk * 16 + lcol;
            const float2 alo = lds2(pa + k0), ahi = lds2(pa + k0 + 8);
            const float2 clo = lds2(pc + k0), chi = lds2(pc + k0 + 8);
            a[0] = bn_relu_pack(unpack2(a[0]), alo, clo);
            a[1] = bn_relu_pack(unpack2(a[1]), alo, clo);
            a[2] = bn_relu_pack(unpack2(a[2]), ahi, chi);
            a[3] = bn_relu_pack(unpack2(a[3]), ahi, chi);
#pragma unroll
            for (int t = 0; t < kChunk; t += 2) {
              const int tt = t0 + t;
              if (tt < ntn) {
                const bool two = tt + 1 < ntn;
                uint32_t b[4];
                if (wsmem) {
                  // matrices: (k 0-7, tile tt), (k 8-15, tt), and the
                  // same of tile tt + 1 (tt again at the last odd tile)
                  const int mt = tt + ((lane >> 4) & (two ? 1 : 0));
                  ldsm4t(b, wsm + (size_t)(kk * 16 + (lane & 7) +
                                           ((lane >> 3) & 1) * 8) * ldo +
                                nbase + mt * 8);
                } else {
                  const bf16* w0 =
                      p.wt + (size_t)(nbase + tt * 8 + lrow) * Fin + k0;
                  b[0] = ldg32(w0);
                  b[1] = ldg32(w0 + 8);
                  if (two) {
                    b[2] = ldg32(w0 + (size_t)8 * Fin);
                    b[3] = ldg32(w0 + (size_t)8 * Fin + 8);
                  }
                }
                mma16816(acc[t], a, b[0], b[1]);
                if (two) mma16816(acc[t + 1], a, b[2], b[3]);
              }
            }
          }
          // Epilogue in registers: bias and bf16 rounding, z' into the
          // staging tile, the column sums (and K7's extrema) of the
          // warp's 16 rows by shuffles.
#pragma unroll
          for (int t = 0; t < kChunk; ++t) {
            if (t0 + t < ntn) {
              const int col = nbase + (t0 + t) * 8 + lcol;
              const float2 bv = lds2(pb + col);
              const uint32_t plo = pack2(__fadd_rn(acc[t][0], bv.x),
                                         __fadd_rn(acc[t][1], bv.y));
              const uint32_t phi = pack2(__fadd_rn(acc[t][2], bv.x),
                                         __fadd_rn(acc[t][3], bv.y));
              *reinterpret_cast<uint32_t*>(outs + r0 * ldo + col) = plo;
              *reinterpret_cast<uint32_t*>(outs + (r0 + 8) * ldo + col) = phi;
              const float2 lo = unpack2(plo), hi = unpack2(phi);
              const float v[4] = {
                  __fadd_rn(lo.x, hi.x), __fadd_rn(lo.y, hi.y),
                  __fadd_rn(__fmul_rn(lo.x, lo.x), __fmul_rn(hi.x, hi.x)),
                  __fadd_rn(__fmul_rn(lo.y, lo.y), __fmul_rn(hi.y, hi.y))};
              sacc[t0 + t] = __fadd_rn(sacc[t0 + t], t3d::col_reduce4(v));
              if (kLast) {
                // the min as the max of the negated values: exact
                const float e[4] = {fmaxf(lo.x, hi.x), fmaxf(lo.y, hi.y),
                                    -fminf(lo.x, hi.x), -fminf(lo.y, hi.y)};
                const float m = t3d::col_reduce4<true>(e);
                if (!(lane & 4))
                  ext[(((lane >> 4) & 1) * kFwdWm + wm) * Fout + col +
                      ((lane >> 3) & 1)] = m;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is read, z' and the extrema are complete
    T3D_CLK(1)

    // --- the tile of T + stages * grid flies from here; z' leaves as
    // 16-byte stores; K7's extrema of each centroid from its row blocks -
    load(T + stages * gridDim.x, s);
    cp_commit();
    {
      const int cpr = Fout >> 3, total = rows * cpr;
      bf16* out = p.z_next + (size_t)c0 * K * Fout;
      int r = tid / cpr, g = tid - r * cpr;
      const int dr = kFwdThreads / cpr, dg = kFwdThreads - dr * cpr;
      for (int i = tid; i < total; i += kFwdThreads) {
        *reinterpret_cast<uint4*>(out + (size_t)i * 8) =
            *reinterpret_cast<const uint4*>(outs + (size_t)r * ldo + g * 8);
        r += dr;
        g += dg;
        if (g >= cpr) {
          g -= cpr;
          ++r;
        }
      }
    }
    if (kLast) {
      const int bpc = K / 16;  // row blocks a centroid
      for (int i = tid; i < nval * Fout; i += kFwdThreads) {
        const int ci = i / Fout, col = i - ci * Fout;
        float mx = -INFINITY, nmn = -INFINITY;
        for (int w = ci * bpc; w < (ci + 1) * bpc; ++w) {
          mx = fmaxf(mx, ext[w * Fout + col]);
          nmn = fmaxf(nmn, ext[(kFwdWm + w) * Fout + col]);
        }
        p.zmax[(size_t)(c0 + ci) * Fout + col] = mx;
        p.zmin[(size_t)(c0 + ci) * Fout + col] = -nmn;
      }
    }
    T3D_CLK(2)
  }
  cp_wait<0>();
  __syncthreads();

  // --- this block's partial sums: the warps' shares in row-block order --
  float* slot = reinterpret_cast<float*>(outs);  // [2][kFwdWm][Fout]
  if (!(lane & 4)) {
#pragma unroll
    for (int t = 0; t < kMaxNt; ++t)
      if (t < ntn)
        slot[(((lane >> 4) & 1) * kFwdWm + wm) * Fout + nbase + t * 8 + lcol +
             ((lane >> 3) & 1)] = sacc[t];
  }
  __syncthreads();
  if (tid < 2 * Fout) {
    const int stat = tid / Fout, col = tid - stat * Fout;
    const float* at = slot + stat * kFwdWm * Fout + col;
    float sum = at[0];
    for (int w = 1; w < kFwdWm; ++w) sum = __fadd_rn(sum, at[w * Fout]);
    p.partials[(size_t)blockIdx.x * 2 * Fout + tid] = sum;
  }
}

bool bad_tile(int k, int f) {
  return k < 16 || k > t3d::kMaxK || k % 16 || f < 16 || f > t3d::kMaxF ||
         f % 16;
}

}  // namespace

// z1 [B, S, K, F] bf16; partials f64 [grid, 2, F] scratch; sums f32 [2, F]
// receives sum z1 and sum z1^2. `warps` a block and `vec` (8: F a multiple
// of 8 and pf 16-byte aligned; else 1) are the launcher's plan
// (`sa_extract_plan`).
extern "C" int t3d_sa_extract(const float* cent, const float* xyz,
                              const void* pf, const void* qc, void* z1,
                              double* partials, float* sums, int b, int s,
                              int n, int k, int f, float r2, int warps,
                              int vec, int grid, void* stream) {
  if (b < 1 || s < 1 || n < 1 || k < 1 || k > kMaxExtractK || f < 1 ||
      f > t3d::kMaxF || grid < 1 || warps < 1 || warps > kExtMaxWarps ||
      (vec != 1 && vec != 8) || f % vec)
    return (int)cudaErrorInvalidValue;
  const size_t smem = extract_layout(k, f, warps);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto kern = vec == 8 ? sa_extract_kernel<8> : sa_extract_kernel<1>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ExtArgs a;
  a.cent = cent;
  a.xyz = xyz;
  a.pf = static_cast<const bf16*>(pf);
  a.qc = static_cast<const bf16*>(qc);
  a.z1 = static_cast<bf16*>(z1);
  a.partials = partials;
  a.ncent = b * s;
  a.S = s;
  a.N = n;
  a.K = k;
  a.F = f;
  a.r2 = r2;
  kern<<<grid, warps * 32, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)t3d::reduce_partials(partials, sums, grid, 2 * f, st);
}

#ifdef T3D_KERNEL_CLOCKS
// Copies K6/K7's phase clocks to `out` (8 values) and sets them to zero.
extern "C" int t3d_sa_fwd_clocks(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, t3d_fwd_clk, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(t3d_fwd_clk, zero, sizeof(zero));
  return (int)e;
}

// The same for K5's.
extern "C" int t3d_sa_extract_clocks(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, t3d_ext_clk, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(t3d_ext_clk, zero, sizeof(zero));
  return (int)e;
}
#endif

// z_next [C, K, F_out] bf16 from z_prev [C, K, F_in] (16-byte aligned);
// w is W [F_in, F_out] f32 row-major when `wsmem` (the kernel rounds it
// into shared memory), else bf16(W)^T [F_out, F_in]; partials f32 [grid,
// 2, F_out] scratch; sums f32 [2, F_out];
// zmax, zmin f32 [C, F_out] when `last`. `ct` centroids a tile, `stages`
// ring stages and `wsmem` are the launcher's plan (`sa_fwd_plan`).
extern "C" int t3d_sa_fwd_step(const void* z_prev, const float* pack,
                               const void* w, const float* bias,
                               void* z_next, float* partials, float* sums,
                               float* zmax, float* zmin, int ncent, int k,
                               int fin, int fout, int last, int ct,
                               int stages, int wsmem, int grid,
                               void* stream) {
  if (ncent < 1 || grid < 1 || bad_tile(k, fin) || bad_tile(k, fout) ||
      (last && (!zmax || !zmin)))
    return (int)cudaErrorInvalidValue;
  if (ct < 1 || ct * k > t3d::kMaxK || stages < 1 || stages > kFwdMaxStages)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_layout(k, fin, fout, ct, stages, wsmem, last).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto kern = last ? sa_fwd_step_kernel<true> : sa_fwd_step_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  FwdArgs a;
  a.z_prev = static_cast<const bf16*>(z_prev);
  a.pack = pack;
  a.w = wsmem ? static_cast<const float*>(w) : nullptr;
  a.wt = wsmem ? nullptr : static_cast<const bf16*>(w);
  a.bias = bias;
  a.z_next = static_cast<bf16*>(z_next);
  a.partials = partials;
  a.zmax = zmax;
  a.zmin = zmin;
  a.ncent = ncent;
  a.K = k;
  a.Fin = fin;
  a.Fout = fout;
  a.ct = ct;
  a.stages = stages;
  a.wsmem = wsmem;
  kern<<<grid, kFwdThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)t3d::reduce_partials(partials, sums, grid, 2 * fout, st);
}
