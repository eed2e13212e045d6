// Fused set-abstraction training, backward passes, for Hopper (sm_90a):
// kernels K8 and K9 of the port.
//
// Replace the Pallas TPU kernels of transferable3d_tpu/ops/fused_sa.py:
//   K8 `_bwd_step_kernel`  (and its planar twin `_bwd_step_kernel_cp`),
//   K9 `_bwd_step0_kernel` (and `_bwd_step0_kernel_cp`),
// with their helpers `_step_dz_rows`, `_top_dy_rows`, `_mult_from_rank`.
// One kernel body, instantiated without (K8) and with (K9) the scatter.
//
// What they compute, for the K rows of centroid s of batch row b, with
// pack rows a, c, mu, r, mdy, mdyx of layers j and j+1:
//   dy_{j+1}: read from device memory, or at the top layer redone from
//       z_{j+1}: h1 = max(bf16(z * a1 + c1), 0), eq = (h1 == pooled[s]),
//       ties = sum_k eq, dy = (h1 > 0) ? bf16(dpooled[s] * eq /
//       max(ties, 1)) : 0, the pool gradient split equally among ties;
//   dz = bf16((dy - mdy1 - xhat1 * mdyx1) * a1), xhat1 = (z_{j+1} - mu1)
//       * r1, in that order (train), or bf16(dy * a1) (eval);
//   h_j = max(bf16(z_j * a + c), 0);
//   dh = bf16(sum_o dz[o] * bf16(W_j)[f, o]); dy_j = (h_j > 0) ? dh : 0;
//   sums over all rows: dW_j = h_j^T dz, db_j = sum dz, sum dy_j,
//       sum dy_j * xhat_j;
//   K8 writes dy_j [B, S, K, F_j] bf16;
//   K9 (j = 0) does not: with the members of ball_select.cuh, per member
//       n with 1-based rank r <= eff, m = the f32 sum of dy_0 over its
//       slots (r-1, r-1+eff, ...) in ascending order and mult = (K - r) /
//       eff + 1 (integers); H[b, n] = the sum of m, cnt[b, n] that of
//       mult and Mq[b, n] that of mult * qc[s], each over the centroids
//       that took n in ascending s, in f32 from +0; and per centroid Sdy
//       = sum_k dy_0 and Sz = sum_k z_j.
//
// What bounds them on this card: bytes. Two or three [rows, F] bf16
// streams come in and one goes out around two products of F_j * F_{j+1}
// multiply-adds a row each; at the training widths the streams need 3.4
// times as long at 3.35 TB/s as the products at the tensor cores' bf16
// peak. So the design keeps loads in flight and touches device memory
// once. What it then spends its time on is the elementwise work around
// the products: some 25 machine operations an element of dz at the top
// and 20 an element of dy_j in the epilogue, half of them on the
// half-rate integer, compare and convert pipe. So the passes are written
// to need few of them: 8-byte shared-memory accesses, a shift and a mask
// to unpack a pair, `train` a compile-time flag of the dz pass.
//
//   * A tile is `ct` whole centroids, ct * K <= 128 rows (4 centroids at
//     K = 32, 2 at K = 64), a contiguous run of device memory per tensor.
//     All 16 warps have product work at every width, and the block
//     barriers per row fall with ct. The last tile of a launch may hold
//     fewer centroids; its missing rows are neither loaded nor used.
//   * Each tile's z_j, z_{j+1} and dy_{j+1} (or pooled and dpooled) come
//     in once, as 16-byte `cp.async` copies into padded shared-memory
//     rows, through a ring of `stages` stages. The loads of tile t +
//     stages start while tile t is still at work: the z_{j+1} side
//     as soon as both products have read dz, the z_j side once dy_j has
//     left. Ties, dz, h_j, xhat_j and K9's Sz all read the shared copy.
//   * dz is written in place over z_{j+1} (top) or dy_{j+1}; dy_j in
//     place over z_j, by the thread that just read z_j for xhat_j; it
//     leaves as 16-byte stores (K8) or feeds the scatter (K9).
//   * Four block barriers a tile. The first pass computes h_j and, below
//     a stored dy, dz. At the top the pool's gradient is split among the
//     rows that hold the pooled maximum, and a ball with few members
//     repeats them, so that ties are the rule: the first pass counts them
//     for every column and dz follows in a second pass over z_{j+1}. (A
//     first pass that wrote dz of the rows off the maximum and left the
//     others to a scalar pass was faster on random tensors and slower on
//     a training step's.)
//   * bf16(W_j) stays in shared memory for the block's whole walk where it
//     fits; else the dy product reads its B fragments through L1/L2.
//   * The products are `mma.sync.m16n8k16` bf16 with f32 accumulators and
//     `ldmatrix` operands. The accumulator layout is known, so dy_j is
//     masked, rounded, summed and stored from registers. dW_j (up to
//     128 x 256 f32) lives in up to 64 registers a thread for the whole
//     walk; a tile's contribution is summed from zero and added with one
//     rounded f32 add.
//   * K9's ball query is redone by all warps in two sweeps over the
//     points (count, then place), without a block barrier of its own.
//   * K9's sums onto the points are the same bits on every run: no
//     floating-point atomics, each output element one owner. The main
//     launch writes each member's slot sum m (f32) to row (c, r - 1) of a
//     member buffer [C, K, F0], its rank r to byte s of the point's row of
//     a zeroed rank table [B, N, S rounded up to 4] and eff to [C]; a
//     second launch (`sa_bwd_gather_kernel`) gives each point one warp,
//     which reads the point's row of the table 128 centroids a step and
//     adds, in ascending s, each member's m, mult * qc[s] and mult, the
//     lanes owning the channels. The member rows add 8 Fj bytes a member
//     (written once, read once) and the table 2 S bytes a point to what
//     K9 moves; the zeroed f32 workspace of H, Mq and cnt and its
//     read-modify-write atomics are gone.
//
// Shared memory (bytes; R = ct * K rows, pad = 8 bf16 a row):
//   stage  = R (Fj + 8) 2  [z_j, then dy_j]
//          + R (Fj1 + 8) 2 [z_j1, at the top then dz]
//          + top ? 4 ct Fj1 [pooled | dpooled] : R (Fj1 + 8) 2 [dy_j1, dz]
//   fixed  = R (Fj + 8) 2 [h_j] + (W ? Fj (Fj1 + 8) 2 : 0) + 16 Fj
//          [a, c, mu, r of layer j] + 24 Fj1 [layer j+1's pack] + 64 Fj
//          [the whole-grid column sums] + 4 ct Fj1 [ties] + 2048 [the
//          per-centroid column sums' shares] + 4 R [members] + 256
// The launcher (ops/fused_sa.py, `sa_bwd_plan`) picks the most centroids
// a tile can hold with two stages and W resident, a third stage if it
// fits; a shape too wide for that runs one stage (the next tile's loads
// then overlap the epilogue only), and leaves W in L2 if it must:
//   K8 top   K  32  32<- 64  ct 4  3 stages  W       111,872
//            K  64  64<-128  ct 2  3 stages  W       210,688
//            K 128  96<-128  ct 1  2 stages  W       190,720
//            K  64 128<-256  ct 1  2 stages  W       209,408
//            K 128 128<-256  ct 1  1 stage   W       226,048
//   K9       K  32  32<- 32  ct 4  3 stages  W       111,616
//            K  64  64<- 64  ct 2  3 stages  W       203,520
//            K 128  64<- 96  ct 1  2 stages  W       185,728
//            K  64 128<-128  ct 1  3 stages  W       225,280
//            K 128 128<-128  ct 1  1 stage   W       190,720
//   corners  K  16  16<- 16  ct 8  3 stages  W        67,200
//            K 128 128<-256  ct 1  1 stage   W in L2  225,024
//            K 128 256<-128  ct 1  1 stage   W in L2  231,680
// of the 232,448 a block may have (the corners below a stored dy, their
// larger form). One block of 512 threads runs per SM, at 128 registers a
// thread. Registers decide the speed of the passes: beside this much
// shared memory the L1 is too small to hold spilled values, so the packs
// wait in shared memory between the passes, and the kernel is compiled
// for 1, 2, 4 and 8 accumulator blocks of dW a warp, so that only a dW of
// more than 16,384 entries (128 x 256) fills the register file.
//
// Every whole-grid sum is deterministic (see sa_train.cuh): the grid is
// fixed, a block walks its tiles in order, each accumulator has one owner
// (a thread's registers, or one thread's slot of shared memory), row
// groups and warps are added in index order and the blocks' partials in
// block order. Tie counts are integer atomics in shared memory. No
// floating-point atomics anywhere: K9's sums onto the points have one
// owner each (above). TMA, wgmma and two blocks per SM are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ball_select.cuh"
#include "sa_train.cuh"
#include "tile_ops.cuh"

// Phase clocks, for `scripts/torch_time_sa_bwd.py --phases` only. Built
// with -DT3D_KERNEL_CLOCKS, thread 0 of block 0 adds to t3d_bwd_clk[i] the
// cycles it spent between mark i - 1 and mark i of every tile (0: the
// ring's wait, 1: the first pass, 2: the second, 3: the products, 4: the
// way out) and counts its tiles in t3d_bwd_clk[7]. Otherwise the marks are
// empty.
#ifdef T3D_KERNEL_CLOCKS
__device__ unsigned long long t3d_bwd_clk[8];
#define T3D_CLK_START long long clk_prev = clock64();
#define T3D_CLK(i)                                              \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                    \
    const long long clk_now = clock64();                        \
    t3d_bwd_clk[i] += (unsigned long long)(clk_now - clk_prev); \
    t3d_bwd_clk[7] += (i) == 4;                                 \
    clk_prev = clk_now;                                         \
  }
#else
#define T3D_CLK_START
#define T3D_CLK(i)
#endif

namespace {

using t3d::bf16;
using t3d::kPad;
using t3d::tof;
using t3d::bf16_round2;
using t3d::bf162;
using t3d::copy_rows;
using t3d::cp16;
using t3d::cp_commit;
using t3d::cp_wait;
using t3d::ld2;
using t3d::lds2;
using t3d::ldsm4;
using t3d::ldsm4t;
using t3d::mma16816;
using t3d::pack2;
using t3d::st2;
using t3d::unpack2;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDwFrags = 8;   // most 16x16 accumulator blocks of dW a warp
constexpr int kDyChunk = 2;   // 16-column blocks of dy_j a warp holds at once
constexpr int kMaxStages = 3;
constexpr int kMaxWm = 8;     // 16-row blocks of the largest tile
constexpr size_t kSmemLimit = 232448;

struct BwdArgs {
  const bf16* z_j;      // [C, K, Fj]
  const bf16* z_j1;     // [C, K, Fj1]
  const bf16* dy_j1;    // [C, K, Fj1], not at the top
  const bf16* pooled;   // [C, Fj1], at the top
  const bf16* dpooled;  // [C, Fj1], at the top
  const float* pack_j;  // [6, Fj]
  const float* pack_j1; // [6, Fj1]
  const bf16* wb;       // bf16(W_j) [Fj, Fj1]
  const float* cent;    // step 0: [C, 3]
  const float* xyz;     // step 0: [B, N, 3]
  bf16* dy_j;           // [C, K, Fj], not at step 0
  float* partials;      // [grid, Fj*Fj1 + 2 Fj + Fj1]: dW | sdy | sdyx | db
  float* msum;          // step 0: [C, K, Fj], row (c, r - 1) for r <= eff
  int* eff;             // step 0: [C]
  unsigned char* rank;  // step 0: zeroed [B, N, Sp], the rank r at (n, s)
  float* per_cent;      // step 0: [2, C, Fj]: Sdy | Sz
  int ncent, S, Sp, N, K, Fj, Fj1;
  float r2;
  int train, top;
  int ct, stages, wsmem;  // the launcher's plan
};

// Byte offsets of the shared-memory buffers (the table in the header).
struct Layout {
  size_t tz, t1;               // one [R, Fj] and one [R, Fj1] padded tile
  size_t a1, x, stage;  // within a stage: z_j at 0, z_j1, dy_j1 | pl
  size_t h, w, pk, pk1, cs, ties, colred, sel, misc, total;
};

__host__ __device__ inline Layout bwd_layout(int K, int Fj, int Fj1, int ct,
                                             int stages, int wsmem, int top) {
  Layout L;
  const size_t R = (size_t)ct * K;
  L.tz = R * (Fj + kPad) * 2;
  L.t1 = R * (Fj1 + kPad) * 2;
  L.a1 = L.tz;
  L.x = L.tz + L.t1;
  L.stage = L.x + (top ? (size_t)4 * ct * Fj1 : L.t1);
  L.h = L.stage * stages;
  L.w = L.h + L.tz;
  L.pk = L.w + (wsmem ? (size_t)Fj * (Fj1 + kPad) * 2 : 0);
  L.pk1 = L.pk + (size_t)4 * Fj * 4;
  L.cs = L.pk1 + (size_t)6 * Fj1 * 4;
  L.ties = L.cs + (size_t)2 * kMaxWm * Fj * 4;
  L.colred = L.ties + (size_t)4 * ct * Fj1;
  L.sel = L.colred + kThreads * 4;
  L.misc = L.sel + R * 4;
  L.total = L.misc + 256;
  return L;
}

__device__ __forceinline__ void copy_flat(bf16* dst, const bf16* src,
                                          int elems) {
  for (int i = threadIdx.x * 8; i < elems; i += kThreads * 8)
    cp16(dst + i, src + i);
}

// Four channels of a row (8-byte aligned) as two packed pairs.
__device__ __forceinline__ uint2 lds8(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// t3d::bn_relu of a pair of channels.
__device__ __forceinline__ float2 bn_relu2(float2 z, float2 a, float2 c) {
  const float2 y = bf16_round2(__fadd_rn(__fmul_rn(z.x, a.x), c.x),
                               __fadd_rn(__fmul_rn(z.y, a.y), c.y));
  return make_float2(fmaxf(y.x, 0.0f), fmaxf(y.y, 0.0f));
}

// Rows 0, 2, 3, 4, 5 of a pack for a pair of channels.
struct Pack2 {
  float2 a, mu, r, mdy, mdyx;
};

// dz of a pair of channels, given dy_{j+1} and z_{j+1}.
template <bool kTrain>
__device__ __forceinline__ float2 dz_of(float2 dy, float2 z, const Pack2& k) {
  if (!kTrain)
    return bf16_round2(__fmul_rn(dy.x, k.a.x), __fmul_rn(dy.y, k.a.y));
  const float xx = __fmul_rn(__fsub_rn(z.x, k.mu.x), k.r.x);
  const float xy = __fmul_rn(__fsub_rn(z.y, k.mu.y), k.r.y);
  return bf16_round2(
      __fmul_rn(__fsub_rn(__fsub_rn(dy.x, k.mdy.x), __fmul_rn(xx, k.mdyx.x)),
                k.a.x),
      __fmul_rn(__fsub_rn(__fsub_rn(dy.y, k.mdy.y), __fmul_rn(xy, k.mdyx.y)),
                k.a.y));
}

// Per-centroid column sums of a tile of ncol = centroids * F columns, in
// two steps around a barrier of the caller's: `nseg` threads a column sum
// a share of its K rows each, then one adds the shares in order.
__device__ __forceinline__ int col_segments(int ncol, int K) {
  return 2 * ncol <= kThreads ? min(kThreads / ncol, K / 8) : 1;
}

__device__ __forceinline__ void col_sums_part(const bf16* buf, int ld, int K,
                                              int F, int ncol, float* colred,
                                              float* out) {
  const int nseg = col_segments(ncol, K);
  for (int i = threadIdx.x; i < ncol * nseg; i += kThreads) {
    const int seg = i / ncol, col = i - seg * ncol;
    const int ci = col / F, f = col - ci * F;
    const bf16* at = buf + (size_t)ci * K * ld + f;
    float sum = 0.0f;
    for (int k = seg * K / nseg; k < (seg + 1) * K / nseg; ++k)
      sum = __fadd_rn(sum, tof(at[k * ld]));
    if (nseg == 1) out[col] = sum;
    else colred[i] = sum;
  }
}

__device__ __forceinline__ void col_sums_join(int K, int ncol,
                                              const float* colred,
                                              float* out) {
  const int nseg = col_segments(ncol, K);
  if (nseg == 1) return;
  for (int col = threadIdx.x; col < ncol; col += kThreads) {
    float sum = colred[col];
    for (int g = 1; g < nseg; ++g) sum = __fadd_rn(sum, colred[g * ncol + col]);
    out[col] = sum;
  }
}

// kNF: the 16x16 blocks of dW a warp keeps (1, 2, 4 or 8). The registers a
// narrow dW does not need stay free for the passes; with all 8 a few
// values live in local memory.
template <bool kStep0, int kNF>
__global__ void __launch_bounds__(kThreads, 1) sa_bwd_step_kernel(BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.K, Fj = p.Fj, Fj1 = p.Fj1, ct = p.ct, stages = p.stages;
  const int R = ct * K;
  const int ldj = Fj + kPad, ld1 = Fj1 + kPad;
  const bool train = p.train != 0, top = p.top != 0, wsmem = p.wsmem != 0;
  const bool need_z1 = top || train;
  const Layout L = bwd_layout(K, Fj, Fj1, ct, stages, p.wsmem, p.top);
  bf16* hbuf = reinterpret_cast<bf16*>(smem + L.h);          // [R][ldj]
  bf16* wsm = reinterpret_cast<bf16*>(smem + L.w);           // [Fj][ld1]
  float* pk = reinterpret_cast<float*>(smem + L.pk);    // a | c | mu | r
  float* pk1 = reinterpret_cast<float*>(smem + L.pk1);  // pack_j1's 6 rows
  float* cs = reinterpret_cast<float*>(smem + L.cs);  // [2][kMaxWm][Fj]
  int* ties = reinterpret_cast<int*>(smem + L.ties);         // [ct][Fj1]
  float* colred = reinterpret_cast<float*>(smem + L.colred);  // [kThreads]
  int* sel = reinterpret_cast<int*>(smem + L.sel);           // [ct][K]
  int* selcnt = reinterpret_cast<int*>(smem + L.misc);       // [kWarps]
  float* neard = reinterpret_cast<float*>(selcnt + kWarps);  // [kWarps]
  int* neari = reinterpret_cast<int*>(neard + kWarps);       // [kWarps]
  int* effs = neari + kWarps;                                // [ct]
  int* brow = effs + t3d::kMaxK / 16;  // [ct], the centroids' batch rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nfj = Fj / 16, nfo = Fj1 / 16, nfrag = nfj * nfo;
  const int ntiles = (p.ncent + ct - 1) / ct;

  // Elementwise passes: a thread owns four channels of layer j+1 (and
  // four of layer j), as two pairs, for the rows rg, rg + nrg, ... of
  // every tile.
  const int nq1 = Fj1 / 4, nrg1 = min(kThreads / nq1, R);
  const int rg1 = tid / nq1, o1 = 4 * (tid % nq1);
  const bool act1 = tid < nrg1 * nq1;
  const int nqj = Fj / 4, nrgj = min(kThreads / nqj, R);
  const int rgj = tid / nqj, oj = 4 * (tid % nqj);
  const bool actj = tid < nrgj * nqj;
  // The packs wait in shared memory: a pass reads its rows when it
  // starts, so that they hold no registers during the products.
  for (int i = tid; i < 4 * Fj; i += kThreads) pk[i] = p.pack_j[i];
  for (int i = tid; i < 6 * Fj1; i += kThreads) pk1[i] = p.pack_j1[i];
  for (int i = tid; i < 2 * kMaxWm * Fj; i += kThreads) cs[i] = 0.0f;
  for (int i = tid; i < ct * Fj1; i += kThreads) ties[i] = 0;

  // Products: warp (wm, wn) of the dy product owns the 16-row block wm and
  // the 16-column blocks wn, wn + WN, ...; dW's 16x16 blocks go round the
  // warps.
  const int nmt_full = R / 16;
  const int WM = nmt_full > 4 ? 8 : nmt_full > 2 ? 4 : nmt_full > 1 ? 2 : 1;
  const int WN = kWarps / WM, wm = warp % WM, wn = warp / WM;
  const int lrow = lane >> 2, lcol = (lane & 3) * 2;

  float dw[kNF][2][4];
#pragma unroll
  for (int i = 0; i < kNF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[i][h][e] = 0.0f;
  float2 s_db[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  auto stage_ptr = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L.stage * s);
  };
  // The z_{j+1} side of tile T into stage s.
  auto load1 = [&](int T, int s) {
    if (T >= ntiles) return;
    const int c0 = T * ct, nval = min(ct, p.ncent - c0), rows = nval * K;
    unsigned char* st = smem + L.stage * s;
    if (need_z1)
      copy_rows<kThreads>(reinterpret_cast<bf16*>(st + L.a1), ld1,
                p.z_j1 + (size_t)c0 * K * Fj1, rows, Fj1);
    bf16* x = reinterpret_cast<bf16*>(st + L.x);
    if (top) {
      copy_flat(x, p.pooled + (size_t)c0 * Fj1, nval * Fj1);
      copy_flat(x + ct * Fj1, p.dpooled + (size_t)c0 * Fj1, nval * Fj1);
    } else {
      copy_rows<kThreads>(x, ld1, p.dy_j1 + (size_t)c0 * K * Fj1, rows, Fj1);
    }
  };
  auto load_z = [&](int T, int s) {
    if (T >= ntiles) return;
    const int c0 = T * ct, rows = min(ct, p.ncent - c0) * K;
    copy_rows<kThreads>(stage_ptr(s), ldj, p.z_j + (size_t)c0 * K * Fj, rows, Fj);
  };

  if (wsmem) copy_rows<kThreads>(wsm, ld1, p.wb, Fj, Fj1);
  for (int s = 0; s < stages; ++s) {
    const int T = blockIdx.x + s * gridDim.x;
    load1(T, s);
    cp_commit();
    load_z(T, s);
    cp_commit();
  }

  int it = 0;
  T3D_CLK_START
  for (int T = blockIdx.x; T < ntiles; T += gridDim.x, ++it) {
    const int s = it % stages;
    const int c0 = T * ct, nval = min(ct, p.ncent - c0), rows = nval * K;
    unsigned char* st = smem + L.stage * s;
    bf16* zj = reinterpret_cast<bf16*>(st);              // [R][ldj]
    bf16* z1 = reinterpret_cast<bf16*>(st + L.a1);       // [R][ld1]
    bf16* xb = reinterpret_cast<bf16*>(st + L.x);        // dy_j1 | pooled
    bf16* dzs = top ? z1 : xb;
    const bf16* pls = xb;                                // [ct][Fj1]
    const bf16* dps = xb + ct * Fj1;                     // [ct][Fj1]

    // K9: the warps of centroid sci share its ball query; the centroid is
    // loaded ahead of the wait.
    const int wpc = kWarps / ct, sci = warp / wpc, spart = warp % wpc;
    const int schunk = ((p.N + wpc - 1) / wpc + 31) & ~31;
    const int slo = spart * schunk, shi = min(p.N, slo + schunk);
    const float* spts = nullptr;
    float scx = 0, scy = 0, scz = 0;
    if (kStep0 && sci < nval) {
      const int c = c0 + sci, b = c / p.S;
      if (spart == 0 && lane == 0) brow[sci] = b;
      spts = p.xyz + (size_t)b * p.N * 3;
      scx = p.cent[(size_t)c * 3 + 0];
      scy = p.cent[(size_t)c * 3 + 1];
      scz = p.cent[(size_t)c * 3 + 2];
    }
    // Two groups a tile are committed; all but those of the later tiles
    // have landed.
    if (stages == 1) cp_wait<0>();
    else if (stages == 2) cp_wait<2>();
    else cp_wait<4>();
    __syncthreads();
    T3D_CLK(0)

    // --- h_j; ties or dz_{j+1}; Sz; the ball query's count ---------------
    // A thread's rows rg, rg + nrg, ...: `next` steps (k, ci), the row
    // within its centroid and the centroid, without a division.
    auto next = [&](int& k, int& ci, int step) {
      for (k += step; k >= K; k -= K) ++ci;
    };
    // dz_{j+1} in place of dy_{j+1}, or at the top in place of z_{j+1}.
    auto dz_pass = [&](auto train_c) {
      constexpr bool kTrain = decltype(train_c)::value;
      Pack2 k1[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* q = pk1 + o1 + 2 * u;
        k1[u].a = lds2(q);
        if (kTrain) {
          k1[u].mu = lds2(q + 2 * Fj1);
          k1[u].r = lds2(q + 3 * Fj1);
          k1[u].mdy = lds2(q + 4 * Fj1);
          k1[u].mdyx = lds2(q + 5 * Fj1);
        }
      }
      if (top) {
        float2 c1[2], pl[2], share[2];
        c1[0] = lds2(pk1 + Fj1 + o1);
        c1[1] = lds2(pk1 + Fj1 + o1 + 2);
        int k = -1, ci = 0, last = -1;
        next(k, ci, rg1 + 1);
        for (int row = rg1; row < rows; row += nrg1) {
          const uint2 raw = lds8(z1 + row * ld1 + o1);
          uint32_t out[2];
          if (ci != last) {
            last = ci;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              pl[u] = ld2(pls + ci * Fj1 + o1 + 2 * u);
              const float2 dp = ld2(dps + ci * Fj1 + o1 + 2 * u);
              const int* tp = ties + ci * Fj1 + o1 + 2 * u;
              share[u] = bf16_round2(__fdiv_rn(dp.x, (float)max(tp[0], 1)),
                                     __fdiv_rn(dp.y, (float)max(tp[1], 1)));
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 z = unpack2(u ? raw.y : raw.x);
            const float2 h1 = bn_relu2(z, k1[u].a, c1[u]);
            // dpooled * eq / ties with eq in {0, 1}; masked where h1 == 0
            const float2 dy = {
                (h1.x == pl[u].x && h1.x > 0.0f) ? share[u].x : 0.0f,
                (h1.y == pl[u].y && h1.y > 0.0f) ? share[u].y : 0.0f};
            const float2 dz = dz_of<kTrain>(dy, z, k1[u]);
            out[u] = pack2(dz.x, dz.y);
            s_db[u].x = __fadd_rn(s_db[u].x, dz.x);
            s_db[u].y = __fadd_rn(s_db[u].y, dz.y);
          }
          *reinterpret_cast<uint2*>(z1 + row * ld1 + o1) =
              make_uint2(out[0], out[1]);
          next(k, ci, nrg1);
        }
      } else {
        for (int row = rg1; row < rows; row += nrg1) {
          const uint2 raw = lds8(xb + row * ld1 + o1);
          uint2 zraw = make_uint2(0, 0);
          if (kTrain) zraw = lds8(z1 + row * ld1 + o1);
          uint32_t out[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 dz = dz_of<kTrain>(unpack2(u ? raw.y : raw.x),
                                            unpack2(u ? zraw.y : zraw.x), k1[u]);
            out[u] = pack2(dz.x, dz.y);
            s_db[u].x = __fadd_rn(s_db[u].x, dz.x);
            s_db[u].y = __fadd_rn(s_db[u].y, dz.y);
          }
          *reinterpret_cast<uint2*>(xb + row * ld1 + o1) =
              make_uint2(out[0], out[1]);
        }
      }
    };
    // In K9 half of each scheduler's warps run the ball query's count (a
    // wait for its points) before their share of the pass, the others
    // after it.
    const bool query_first = kStep0 && ((warp >> 2) & 1) != 0;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if ((half == 0) == query_first) {
        if (kStep0) {
          col_sums_part(zj, ldj, K, Fj, nval * Fj, colred,
                        p.per_cent + ((size_t)p.ncent + c0) * Fj);
          if (sci < nval)
            t3d::ball_count_part(spts, slo, shi, p.N, scx, scy, scz, p.r2,
                                 selcnt + warp, neard + warp, neari + warp);
        }
        continue;
      }
      if (actj) {
        float2 aj[2], cj[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          aj[u] = lds2(pk + oj + 2 * u);
          cj[u] = lds2(pk + Fj + oj + 2 * u);
        }
        const bf162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
        for (int row = rgj; row < rows; row += nrgj) {
          const uint2 raw = lds8(zj + row * ldj + oj);
          uint32_t out[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 z = unpack2(u ? raw.y : raw.x);
            const bf162 y = __hmax2(
                __floats2bfloat162_rn(__fadd_rn(__fmul_rn(z.x, aj[u].x), cj[u].x),
                                      __fadd_rn(__fmul_rn(z.y, aj[u].y), cj[u].y)),
                zero);
            out[u] = *reinterpret_cast<const uint32_t*>(&y);
          }
          *reinterpret_cast<uint2*>(hbuf + row * ldj + oj) =
              make_uint2(out[0], out[1]);
        }
      }
      // dz_{j+1}: below a stored dy here; at the top the pool's gradient
      // is split among the rows that hold the pooled maximum, so this pass
      // counts them and dz follows after the barrier.
      if (act1 && top) {
        float2 a1[2], c1[2], pl[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          a1[u] = lds2(pk1 + o1 + 2 * u);
          c1[u] = lds2(pk1 + Fj1 + o1 + 2 * u);
        }
        // a thread's count of a centroid's ties joins the others' when its
        // rows leave the centroid
        int found[4] = {0, 0, 0, 0};
        auto join = [&](int c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (found[e]) atomicAdd(ties + c * Fj1 + o1 + e, found[e]);
            found[e] = 0;
          }
        };
        int k = -1, ci = 0, last = -1;
        next(k, ci, rg1 + 1);
        for (int row = rg1; row < rows; row += nrg1) {
          const uint2 raw = lds8(z1 + row * ld1 + o1);
          if (ci != last) {
            if (last >= 0) join(last);
            last = ci;
            pl[0] = ld2(pls + ci * Fj1 + o1);
            pl[1] = ld2(pls + ci * Fj1 + o1 + 2);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float2 h1 = bn_relu2(unpack2(u ? raw.y : raw.x), a1[u], c1[u]);
            // a channel pooled at 0 gets no gradient: its ties are not used
            found[2 * u] += pl[u].x > 0.0f && h1.x == pl[u].x;
            found[2 * u + 1] += pl[u].y > 0.0f && h1.y == pl[u].y;
          }
          next(k, ci, nrg1);
        }
        if (last >= 0) join(last);
      } else if (act1) {
        if (train) dz_pass(std::true_type());
        else dz_pass(std::false_type());
      }
    }
    __syncthreads();
    T3D_CLK(1)

    // --- at the top dz_{j+1}; the ball query's members -------------------
    if (act1 && top) {
      if (train) dz_pass(std::true_type());
      else dz_pass(std::false_type());
    }
    if (kStep0) {
      col_sums_join(K, nval * Fj, colred,
                    p.per_cent + ((size_t)p.ncent + c0) * Fj);
      if (sci < nval)
        t3d::ball_place_part(spts, slo, shi, scx, scy, scz, p.r2, K,
                             selcnt + sci * wpc, neard + sci * wpc,
                             neari + sci * wpc, spart, wpc, sel + sci * K,
                             effs + sci);
    }
    __syncthreads();
    T3D_CLK(2)

    // --- dy_j = relu'(h_j) * bf16(dz @ bf16(W_j)^T), in place over z_j ---
    const int nmt = rows / 16;
    if (wm < nmt) {
      const bf16* arow = dzs + (size_t)(wm * 16 + (lane & 15)) * ld1 +
                         (lane >> 4) * 8;
      const int r0 = wm * 16 + lrow;
      for (int n0 = wn; n0 < nfj; n0 += WN * kDyChunk) {
        float acc[kDyChunk][2][4];
#pragma unroll
        for (int q = 0; q < kDyChunk; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][h][e] = 0.0f;
        for (int kk = 0; kk < nfo; ++kk) {
          uint32_t fa[4];
          ldsm4(fa, arow + kk * 16);
#pragma unroll
          for (int q = 0; q < kDyChunk; ++q) {
            const int nt = n0 + q * WN;
            if (nt < nfj) {
              // B(k = o, n = f) = W[f][o]: W's rows are B's columns
              uint32_t fb[4];
              if (wsmem) {
                ldsm4(fb, wsm + (size_t)(nt * 16 + (lane & 7) +
                                         (lane >> 4) * 8) * ld1 +
                              kk * 16 + ((lane >> 3) & 1) * 8);
              } else {
                const bf16* wp = p.wb + (size_t)(nt * 16 + lrow) * Fj1 +
                                 kk * 16 + lcol;
                fb[0] = __ldg(reinterpret_cast<const uint32_t*>(wp));
                fb[1] = __ldg(reinterpret_cast<const uint32_t*>(wp + 8));
                fb[2] = __ldg(reinterpret_cast<const uint32_t*>(
                    wp + (size_t)8 * Fj1));
                fb[3] = __ldg(reinterpret_cast<const uint32_t*>(
                    wp + (size_t)8 * Fj1 + 8));
              }
              mma16816(acc[q][0], fa, fb[0], fb[1]);
              mma16816(acc[q][1], fa, fb[2], fb[3]);
            }
          }
        }
        // The accumulator of a thread: rows r0 and r0 + 8, columns col and
        // col + 1 of each 8-column block.
#pragma unroll
        for (int q = 0; q < kDyChunk; ++q) {
          const int nt = n0 + q * WN;
          if (nt < nfj) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = nt * 16 + h * 8 + lcol;
              const float2 mu = lds2(pk + 2 * Fj + col);
              const float2 rr = lds2(pk + 3 * Fj + col);
              float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // sdy | sdyx
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int row = r0 + e * 8;
                const float2 hv = ld2(hbuf + row * ldj + col);
                const float2 zv = ld2(zj + row * ldj + col);
                const float2 dh =
                    bf16_round2(acc[q][h][2 * e], acc[q][h][2 * e + 1]);
                const float dx = hv.x > 0.0f ? dh.x : 0.0f;
                const float dy = hv.y > 0.0f ? dh.y : 0.0f;
                st2(zj + row * ldj + col, dx, dy);
                const float xx = __fmul_rn(__fsub_rn(zv.x, mu.x), rr.x);
                const float xy = __fmul_rn(__fsub_rn(zv.y, mu.y), rr.y);
                v[0] = __fadd_rn(v[0], dx);
                v[1] = __fadd_rn(v[1], dy);
                v[2] = __fadd_rn(v[2], __fmul_rn(dx, xx));
                v[3] = __fadd_rn(v[3], __fmul_rn(dy, xy));
              }
              const float sum = t3d::col_reduce4(v);
              if (!(lane & 4)) {  // the one owner of its slot of cs
                float* at = cs + (((lane >> 4) & 1) * kMaxWm + wm) * Fj + col +
                            ((lane >> 3) & 1);
                *at = __fadd_rn(*at, sum);
              }
            }
          }
        }
      }
    }

    // --- dW_j += h_j^T dz ------------------------------------------------
#pragma unroll
    for (int i = 0; i < kNF; ++i) {
      const int fr = warp + kWarps * i;
      if (fr < nfrag) {
        const int fi = fr / nfo, fo = fr - fi * nfo;
        // A(m = f, k = row) = h[row][f] and B(k = row, n = o) = dz[row][o]:
        // both are read transposed.
        const bf16* ap = hbuf + (size_t)((lane & 7) + (lane >> 4) * 8) * ldj +
                         fi * 16 + ((lane >> 3) & 1) * 8;
        const bf16* bp = dzs + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) *
                                   ld1 +
                         fo * 16 + (lane >> 4) * 8;
        // The tensor cores do not round their running sum to nearest: a
        // tile's contribution is summed from zero and joins the walk's sum
        // by one rounded add, or the error grows with the walk.
        float tile[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        for (int kk = 0; kk < nmt; ++kk) {
          uint32_t fa[4], fb[4];
          ldsm4t(fa, ap + (size_t)kk * 16 * ldj);
          ldsm4t(fb, bp + (size_t)kk * 16 * ld1);
          mma16816(tile[0], fa, fb[0], fb[1]);
          mma16816(tile[1], fa, fb[2], fb[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dw[i][h][e] = __fadd_rn(dw[i][h][e], tile[h][e]);
      }
    }
    __syncthreads();  // dz is read, dy_j is complete
    T3D_CLK(3)

    // --- the next tile's z_{j+1} side flies from here --------------------
    const int Tn = T + stages * gridDim.x;
    load1(Tn, s);
    cp_commit();
    if (top)
      for (int i = tid; i < ct * Fj1; i += kThreads) ties[i] = 0;

    // --- dy_j's way out --------------------------------------------------
    if (!kStep0) {
      const int cpr = Fj >> 3, total = rows * cpr;
      bf16* out = p.dy_j + (size_t)c0 * K * Fj;
      int r = tid / cpr, g = tid - r * cpr;
      const int dr = kThreads / cpr, dg = kThreads - dr * cpr;
      for (int i = tid; i < total; i += kThreads) {
        *reinterpret_cast<uint4*>(out + (size_t)i * 8) =
            *reinterpret_cast<const uint4*>(zj + (size_t)r * ldj + g * 8);
        r += dr;
        g += dg;
        if (g >= cpr) {
          g -= cpr;
          ++r;
        }
      }
    } else {
      // members: the member of rank j + 1 fills slots j, j + eff, ...; its
      // slot sum goes to row (c, j) of the member buffer and j + 1 to its
      // point's row of the rank table. A lane takes four channels of one
      // member, Fj / 4 lanes a member.
      const int lpm = Fj / 4, mpw = lpm < 32 ? 32 / lpm : 1;
      const int sub = lpm < 32 ? lane / lpm : 0, f0 = (lane - sub * lpm) * 4;
      if (sub < mpw) {
        // member m = ci * K + j, stepped without a division
        const int step = kWarps * mpw;
        int ci = 0, j = warp * mpw + sub;
        for (; j >= K; j -= K) ++ci;
        for (int m = warp * mpw + sub; m < rows; m += step) {
          const int eff = effs[ci];
          if (j < eff) {
            const int c = c0 + ci;
            float* mrow = p.msum + ((size_t)c * K + j) * Fj;
            for (int f = f0; f < Fj; f += 128) {
              const bf16* col = zj + (size_t)ci * K * ldj + f;
              float4 sum = {0.0f, 0.0f, 0.0f, 0.0f};
              for (int k = j; k < K; k += eff) {
                const uint2 raw = lds8(col + k * ldj);
                const float2 u = unpack2(raw.x), v = unpack2(raw.y);
                sum.x = __fadd_rn(sum.x, u.x);
                sum.y = __fadd_rn(sum.y, u.y);
                sum.z = __fadd_rn(sum.z, v.x);
                sum.w = __fadd_rn(sum.w, v.y);
              }
              *reinterpret_cast<float4*>(mrow + f) = sum;
            }
            if (f0 == 0)
              p.rank[((size_t)brow[ci] * p.N + sel[ci * K + j]) * p.Sp +
                     (c - brow[ci] * p.S)] = (unsigned char)(j + 1);
          }
          for (j += step; j >= K; j -= K) ++ci;
        }
      }
      if (tid < nval) p.eff[c0 + tid] = effs[tid];
      col_sums_part(zj, ldj, K, Fj, nval * Fj, colred,
                    p.per_cent + (size_t)c0 * Fj);
    }
    __syncthreads();  // the z_j buffer, sel and effs are free
    T3D_CLK(4)

    if (kStep0)
      col_sums_join(K, nval * Fj, colred, p.per_cent + (size_t)c0 * Fj);
    load_z(Tn, s);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();

  // --- this block's partial sums ---------------------------------------
  float* part = p.partials + (size_t)blockIdx.x * (Fj * Fj1 + 2 * Fj + Fj1);
#pragma unroll
  for (int i = 0; i < kNF; ++i) {
    const int fr = warp + kWarps * i;
    if (fr < nfrag) {
      const int fi = fr / nfo, fo = fr - fi * nfo;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* at = part + (size_t)(fi * 16 + lrow) * Fj1 + fo * 16 + h * 8 +
                    lcol;
        *reinterpret_cast<float2*>(at) = make_float2(dw[i][h][0], dw[i][h][1]);
        *reinterpret_cast<float2*>(at + (size_t)8 * Fj1) =
            make_float2(dw[i][h][2], dw[i][h][3]);
      }
    }
  }
  float* tail = part + (size_t)Fj * Fj1;
  for (int col = tid; col < 2 * Fj; col += kThreads) {
    // col < Fj: sum dy_j; else sum dy_j * xhat_j; row blocks in order
    const float* a = cs + (col < Fj ? col : kMaxWm * Fj + col - Fj);
    float sum = a[0];
    for (int m = 1; m < kMaxWm; ++m) sum = __fadd_rn(sum, a[m * Fj]);
    tail[col] = sum;
  }
  float* red = reinterpret_cast<float*>(smem);  // [nrg1][Fj1], stage 0
  if (act1) {
    *reinterpret_cast<float4*>(red + rg1 * Fj1 + o1) =
        make_float4(s_db[0].x, s_db[0].y, s_db[1].x, s_db[1].y);
  }
  __syncthreads();
  for (int col = tid; col < Fj1; col += kThreads) {
    float sum = red[col];
    for (int g = 1; g < nrg1; ++g) sum = __fadd_rn(sum, red[g * Fj1 + col]);
    tail[2 * Fj + col] = sum;
  }
}

// K9's second launch: one warp a point (b, n) owns H[b, n, :], Mq[b, n,
// :] and cnt[b, n]. Lane l reads bytes 4 l .. 4 l + 3 of a 128-centroid
// step of the point's row of the rank table; the lanes that hold a rank
// are walked in ascending order (a ballot), and each of their centroids
// s, in ascending s, adds its member row's m, mult * qc[s] (exact: an
// integer of at most 8 bits times a bf16) and mult into f32 registers,
// lane l owning channels l, l + 32, ...
constexpr int kGatherWarps = 8;
constexpr int kGatherF = t3d::kMaxF / 32;

__global__ void __launch_bounds__(kGatherWarps * 32)
    sa_bwd_gather_kernel(const float* __restrict__ msum,
                         const int* __restrict__ effs,
                         const unsigned char* __restrict__ rank,
                         const bf16* __restrict__ qc, float* __restrict__ out,
                         int B, int S, int Sp, int N, int K, int Fj) {
  const int lane = threadIdx.x & 31;
  const int pt = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (pt >= B * N) return;
  const int b = pt / N;
  const unsigned char* row = rank + (size_t)pt * Sp;
  float h[kGatherF], q[kGatherF];
#pragma unroll
  for (int i = 0; i < kGatherF; ++i) h[i] = q[i] = 0.0f;
  float cnt = 0.0f;
  for (int s0 = 0; s0 < Sp; s0 += 128) {
    const int s4 = s0 + 4 * lane;
    const uint32_t w =
        s4 < Sp ? *reinterpret_cast<const uint32_t*>(row + s4) : 0u;
    for (unsigned held = __ballot_sync(t3d::kFullMask, w != 0u); held;
         held &= held - 1) {
      const int L = __ffs(held) - 1;
      const uint32_t wl = __shfl_sync(t3d::kFullMask, w, L);
      for (int e = 0; e < 4; ++e) {
        const int r = (wl >> (8 * e)) & 0xff;
        if (r == 0) continue;
        const int c = b * S + s0 + 4 * L + e;
        const float mult = (float)((K - r) / effs[c] + 1);
        const float* m = msum + ((size_t)c * K + r - 1) * Fj;
        const bf16* qr = qc + (size_t)c * Fj;
#pragma unroll
        for (int i = 0; i < kGatherF; ++i) {
          const int f = lane + 32 * i;
          if (f < Fj) {
            h[i] = __fadd_rn(h[i], m[f]);
            q[i] = __fadd_rn(q[i], __fmul_rn(mult, tof(qr[f])));
          }
        }
        cnt = __fadd_rn(cnt, mult);
      }
    }
  }
  const size_t plane = (size_t)B * N * Fj;
#pragma unroll
  for (int i = 0; i < kGatherF; ++i) {
    const int f = lane + 32 * i;
    if (f < Fj) {
      out[(size_t)pt * Fj + f] = h[i];
      out[plane + (size_t)pt * Fj + f] = q[i];
    }
  }
  if (lane == 0) out[2 * plane + pt] = cnt;
}

bool bad_tile(int k, int f) {
  return k < 16 || k > t3d::kMaxK || k % 16 || f < 16 || f > t3d::kMaxF ||
         f % 16;
}

}  // namespace

#ifdef T3D_KERNEL_CLOCKS
// Copies the phase clocks to `out` (8 values) and sets them to zero.
extern "C" int t3d_sa_bwd_clocks(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, t3d_bwd_clk, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(t3d_bwd_clk, zero, sizeof(zero));
  return (int)e;
}
#endif

// One backward step of the chain (K8, or K9 with `step0`). `partials` is
// f32 [grid, Fj*Fj1 + 2 Fj + Fj1] scratch and `sums` receives dW_j
// [Fj, Fj1] | sum dy_j | sum dy_j * xhat_j | db_j. `ct` centroids a tile,
// `stages` ring stages and `wsmem` (W_j in shared memory) are the
// launcher's plan. Every tensor is 16-byte aligned. K9 also takes the
// scratch `msum` (f32 [B S, K, Fj]), `eff` (int [B S]) and `rank` (bytes
// [B, N, sp], sp = s rounded up to 4, zeroed), and writes H, Mq [B, N,
// Fj] | cnt [B, N] to `scat` (f32) in a second launch. See BwdArgs for
// the other buffers; those a form does not use may be null.
extern "C" int t3d_sa_bwd_step(
    const void* z_j, const void* z_j1, const void* dy_j1, const void* pooled,
    const void* dpooled, const float* pack_j, const float* pack_j1,
    const void* wb, const float* cent, const float* xyz, const void* qc,
    void* dy_j, float* partials, float* sums, float* msum, int* eff,
    unsigned char* rank, float* scat, float* per_cent, int b, int s, int n,
    int k, int fj, int fj1, float r2, int train, int top, int step0, int ct,
    int stages, int wsmem, int grid, void* stream) {
  if (b < 1 || s < 1 || grid < 1 || bad_tile(k, fj) || bad_tile(k, fj1) ||
      (fj / 16) * (fj1 / 16) > kDwFrags * kWarps)
    return (int)cudaErrorInvalidValue;
  if (ct < 1 || ct * k > t3d::kMaxK || kWarps % ct || stages < 1 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (top ? (!pooled || !dpooled) : !dy_j1) return (int)cudaErrorInvalidValue;
  if (step0 ? (!cent || !xyz || !qc || !msum || !eff || !rank || !scat ||
               !per_cent || n < 1)
            : !dy_j)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_layout(k, fj, fj1, ct, stages, wsmem, top).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.z_j = static_cast<const bf16*>(z_j);
  a.z_j1 = static_cast<const bf16*>(z_j1);
  a.dy_j1 = static_cast<const bf16*>(dy_j1);
  a.pooled = static_cast<const bf16*>(pooled);
  a.dpooled = static_cast<const bf16*>(dpooled);
  a.pack_j = pack_j;
  a.pack_j1 = pack_j1;
  a.wb = static_cast<const bf16*>(wb);
  a.cent = cent;
  a.xyz = xyz;
  a.dy_j = static_cast<bf16*>(dy_j);
  a.partials = partials;
  a.msum = msum;
  a.eff = eff;
  a.rank = rank;
  a.per_cent = per_cent;
  a.ncent = b * s;
  a.S = s;
  a.Sp = (s + 3) & ~3;
  a.N = n;
  a.K = k;
  a.Fj = fj;
  a.Fj1 = fj1;
  a.r2 = r2;
  a.train = train;
  a.top = top;
  a.ct = ct;
  a.stages = stages;
  a.wsmem = wsmem;
  cudaStream_t st = (cudaStream_t)stream;
  const int nf = ((fj / 16) * (fj1 / 16) + kWarps - 1) / kWarps;
  void (*kern)(BwdArgs);
  if (nf <= 1)
    kern = step0 ? sa_bwd_step_kernel<true, 1> : sa_bwd_step_kernel<false, 1>;
  else if (nf <= 2)
    kern = step0 ? sa_bwd_step_kernel<true, 2> : sa_bwd_step_kernel<false, 2>;
  else if (nf <= 4)
    kern = step0 ? sa_bwd_step_kernel<true, 4> : sa_bwd_step_kernel<false, 4>;
  else
    kern = step0 ? sa_bwd_step_kernel<true, 8> : sa_bwd_step_kernel<false, 8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (step0) {
    const int pts = b * n;
    sa_bwd_gather_kernel<<<(pts + kGatherWarps - 1) / kGatherWarps,
                           kGatherWarps * 32, 0, st>>>(
        msum, eff, rank, static_cast<const bf16*>(qc), scat, b, s, a.Sp, n,
        k, fj);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)t3d::reduce_partials(partials, sums, grid,
                                   fj * fj1 + 2 * fj + fj1, st);
}
