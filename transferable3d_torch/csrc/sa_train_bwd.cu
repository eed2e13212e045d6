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
//   K9 (j = 0) does not: with the members of ball_select.cuh it adds, per
//       member n with 1-based rank r <= eff, the f32 sum of dy_0 over its
//       slots (r-1, r-1+eff, ...) to H[b, n], mult = (K - r) / eff + 1
//       (integers) to cnt[b, n] and mult * qc[s] to Mq[b, n], and writes
//       per centroid Sdy = sum_k dy_0 and Sz = sum_k z_j.
//
// What bounds them: three or four [rows, F] bf16 streams around two
// products of F_j * F_{j+1} multiply-adds a row each, so bytes, provided
// the products run on the tensor cores. The design: `wmma` 16x16x16 bf16
// fragments with f32 accumulators; a block of 16 warps holds one
// centroid's dz, h_j and dy_j tiles in shared memory (159 KB at K = 128,
// 128 -> 256); dW_j (up to 128 x 256 f32) lives in 8 accumulator
// fragments per warp for the block's whole walk, each centroid's
// contribution summed in a fresh fragment and added with one rounded f32
// add; every whole-grid sum is deterministic (see sa_train.cuh). Only
// K9's scatter uses atomicAdd into a zeroed f32 workspace, as K4 does:
// cnt is exact (small integers), H and Mq are exact on integer-valued
// inputs and otherwise within one ulp of the sum of the terms'
// magnitudes. TMA, wgmma and a pipeline over centroids are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "ball_select.cuh"
#include "sa_train.cuh"

namespace {

using namespace nvcuda;
using t3d::bf16;
using t3d::kPad;
using t3d::tof;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDwFrags = 8;  // accumulator fragments of dW per warp

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
  const bf16* qc;       // step 0: [C, Fj]
  bf16* dy_j;           // [C, K, Fj], not at step 0
  float* partials;      // [grid, Fj*Fj1 + 2 Fj + Fj1]: dW | sdy | sdyx | db
  float* scat;          // step 0: zeroed [B, N, 2 Fj + 1]: H | Mq | cnt
  float* per_cent;      // step 0: [2, C, Fj]: Sdy | Sz
  int ncent, S, N, K, Fj, Fj1;
  float r2;
  int train, top;
};

inline size_t bwd_smem_bytes(int k, int fj, int fj1) {
  return (size_t)k * (fj1 + kPad) * 2 + 2 * (size_t)k * (fj + kPad) * 2 +
         kWarps * 256 * 4 + kThreads * 4 + (size_t)fj1 * 4 +
         (size_t)(k + 3 * kWarps) * 4;
}

template <bool kStep0>
__global__ void __launch_bounds__(kThreads, 1) sa_bwd_step_kernel(BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.K, Fj = p.Fj, Fj1 = p.Fj1;
  const int lddz = Fj1 + kPad, ldh = Fj + kPad;
  bf16* dzs = reinterpret_cast<bf16*>(smem);            // [K][lddz]
  bf16* h = dzs + (size_t)K * lddz;                     // [K][ldh]
  bf16* dyj = h + (size_t)K * ldh;                      // [K][ldh]
  float* patch = reinterpret_cast<float*>(dyj + (size_t)K * ldh);
  float* red = patch + kWarps * 256;                    // [kThreads]
  int* ties = reinterpret_cast<int*>(red + kThreads);   // [Fj1]
  int* sel = ties + Fj1;                                // [K]
  int* wcnt = sel + K;                                  // [kWarps]
  float* red_d = reinterpret_cast<float*>(wcnt + kWarps);
  int* red_i = reinterpret_cast<int*>(red_d + kWarps);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nmi = K / 16, nfj = Fj / 16, nfo = Fj1 / 16;
  const int nfrag = nfj * nfo;
  const bool train = p.train != 0, top = p.top != 0;

  // This thread's channel of layer j+1 (o1) and of layer j (o).
  const t3d::Own o1 = t3d::own(Fj1);
  const t3d::Own o = t3d::own(Fj);
  float a1 = 0, c1 = 0, mu1 = 0, r1 = 0, mdy1 = 0, mdyx1 = 0;
  if (o1.active) {
    a1 = p.pack_j1[o1.f];
    c1 = p.pack_j1[Fj1 + o1.f];
    mu1 = p.pack_j1[2 * Fj1 + o1.f];
    r1 = p.pack_j1[3 * Fj1 + o1.f];
    mdy1 = p.pack_j1[4 * Fj1 + o1.f];
    mdyx1 = p.pack_j1[5 * Fj1 + o1.f];
  }
  float a = 0, cc = 0, mu = 0, r = 0;
  if (o.active) {
    a = p.pack_j[o.f];
    cc = p.pack_j[Fj + o.f];
    mu = p.pack_j[2 * Fj + o.f];
    r = p.pack_j[3 * Fj + o.f];
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dwacc[kDwFrags];
#pragma unroll
  for (int i = 0; i < kDwFrags; ++i) wmma::fill_fragment(dwacc[i], 0.0f);
  float s_dy = 0.0f, s_dyx = 0.0f, s_db = 0.0f;

  for (int c = blockIdx.x; c < p.ncent; c += gridDim.x) {
    const int b = c / p.S;
    int eff = 1;
    if (kStep0) {
      const int total = t3d::ball_select<kThreads>(
          p.xyz + (size_t)b * p.N * 3, p.N, p.cent[(size_t)c * 3 + 0],
          p.cent[(size_t)c * 3 + 1], p.cent[(size_t)c * 3 + 2], p.r2, K, sel,
          wcnt, red_d, red_i);
      eff = total == 0 ? 1 : min(total, K);
    }

    // --- dz_{j+1} tile -------------------------------------------------
    const bf16* z1p = p.z_j1 + (size_t)c * K * Fj1 + o1.f;
    if (top) {
      float pl = 0.0f, dp = 0.0f;
      int cnt = 0;
      if (o1.active) {
        pl = tof(p.pooled[(size_t)c * Fj1 + o1.f]);
        dp = tof(p.dpooled[(size_t)c * Fj1 + o1.f]);
        for (int k = o1.rg; k < K; k += o1.nrg)
          cnt += t3d::bn_relu(tof(z1p[(size_t)k * Fj1]), a1, c1) == pl;
      }
      // ties per channel: integer sum over the row groups
      __syncthreads();
      if (o1.active) reinterpret_cast<int*>(red)[o1.rg * Fj1 + o1.f] = cnt;
      __syncthreads();
      if (tid < Fj1) {
        int t = 0;
        for (int g = 0; g < o1.nrg; ++g)
          t += reinterpret_cast<int*>(red)[g * Fj1 + tid];
        ties[tid] = t;
      }
      __syncthreads();
      if (o1.active) {
        const float tie = (float)max(ties[o1.f], 1);
        const float share = t3d::bf16_round(__fdiv_rn(dp, tie));
        for (int k = o1.rg; k < K; k += o1.nrg) {
          const float z = tof(z1p[(size_t)k * Fj1]);
          const float h1 = t3d::bn_relu(z, a1, c1);
          // dpooled * eq / ties with eq in {0, 1}; masked where h1 == 0
          const float dy = (h1 == pl && h1 > 0.0f) ? share : 0.0f;
          float dz;
          if (train) {
            const float xhat = __fmul_rn(__fsub_rn(z, mu1), r1);
            dz = t3d::bf16_round(__fmul_rn(
                __fsub_rn(__fsub_rn(dy, mdy1), __fmul_rn(xhat, mdyx1)), a1));
          } else {
            dz = t3d::bf16_round(__fmul_rn(dy, a1));
          }
          dzs[k * lddz + o1.f] = __float2bfloat16_rn(dz);
          s_db = __fadd_rn(s_db, dz);
        }
      }
    } else if (o1.active) {
      const bf16* dyp = p.dy_j1 + (size_t)c * K * Fj1 + o1.f;
      for (int k = o1.rg; k < K; k += o1.nrg) {
        const float dy = tof(dyp[(size_t)k * Fj1]);
        float dz;
        if (train) {
          const float z = tof(z1p[(size_t)k * Fj1]);
          const float xhat = __fmul_rn(__fsub_rn(z, mu1), r1);
          dz = t3d::bf16_round(__fmul_rn(
              __fsub_rn(__fsub_rn(dy, mdy1), __fmul_rn(xhat, mdyx1)), a1));
        } else {
          dz = t3d::bf16_round(__fmul_rn(dy, a1));
        }
        dzs[k * lddz + o1.f] = __float2bfloat16_rn(dz);
        s_db = __fadd_rn(s_db, dz);
      }
    }

    // --- h_j tile ------------------------------------------------------
    const bf16* zjp = p.z_j + (size_t)c * K * Fj + o.f;
    if (o.active)
      for (int k = o.rg; k < K; k += o.nrg)
        h[k * ldh + o.f] = __float2bfloat16_rn(
            t3d::bn_relu(tof(zjp[(size_t)k * Fj]), a, cc));
    __syncthreads();

    // --- dy_j = relu'(h_j) * bf16(dz @ bf16(W_j)^T) -> shared ----------
    const int nchunk = (nmi + 3) / 4;
    for (int it = warp; it < nfj * nchunk; it += kWarps) {
      const int ni = it % nfj, m0 = (it / nfj) * 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[m], 0.0f);
      for (int kk = 0; kk < nfo; ++kk) {
        // B(k = o, n = f) = W[f][o]: column-major over wb's rows
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, p.wb + (size_t)ni * 16 * Fj1 + kk * 16,
                               Fj1);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m0 + m < nmi) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                fa;
            wmma::load_matrix_sync(fa, dzs + (m0 + m) * 16 * lddz + kk * 16,
                                   lddz);
            wmma::mma_sync(acc[m], fa, fb, acc[m]);
          }
        }
      }
      float* pw = patch + warp * 256;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m0 + m < nmi) {
          wmma::store_matrix_sync(pw, acc[m], 16, wmma::mem_row_major);
          __syncwarp();
          for (int i = lane; i < 256; i += 32) {
            const int at = ((m0 + m) * 16 + (i >> 4)) * ldh + ni * 16 +
                           (i & 15);
            dyj[at] = tof(h[at]) > 0.0f ? __float2bfloat16_rn(pw[i])
                                        : __float2bfloat16_rn(0.0f);
          }
          __syncwarp();
        }
      }
    }

    // --- dW_j += h_j^T dz ----------------------------------------------
#pragma unroll
    for (int i = 0; i < kDwFrags; ++i) {
      const int fr = warp + kWarps * i;
      if (fr < nfrag) {
        const int fi = fr / nfo, fo = fr - fi * nfo;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> tmp;
        wmma::fill_fragment(tmp, 0.0f);
        for (int kk = 0; kk < nmi; ++kk) {
          // A(i = f, k = row) = h[row][f]: column-major over h's rows
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
              fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fa, h + kk * 16 * ldh + fi * 16, ldh);
          wmma::load_matrix_sync(fb, dzs + kk * 16 * lddz + fo * 16, lddz);
          wmma::mma_sync(tmp, fa, fb, tmp);
        }
#pragma unroll
        for (int e = 0; e < tmp.num_elements; ++e)
          dwacc[i].x[e] = __fadd_rn(dwacc[i].x[e], tmp.x[e]);
      }
    }
    __syncthreads();  // dyj is complete

    // --- sums of dy_j, and its way out ---------------------------------
    float c_dy = 0.0f, c_z = 0.0f;
    if (o.active) {
      bf16* out = kStep0 ? nullptr : p.dy_j + (size_t)c * K * Fj + o.f;
      for (int k = o.rg; k < K; k += o.nrg) {
        const bf16 db16 = dyj[k * ldh + o.f];
        const float dy = tof(db16);
        const float z = tof(zjp[(size_t)k * Fj]);
        const float xhat = __fmul_rn(__fsub_rn(z, mu), r);
        s_dy = __fadd_rn(s_dy, dy);
        s_dyx = __fadd_rn(s_dyx, __fmul_rn(dy, xhat));
        if (kStep0) {
          c_dy = __fadd_rn(c_dy, dy);
          c_z = __fadd_rn(c_z, z);
        } else {
          out[(size_t)k * Fj] = db16;
        }
      }
    }
    if (kStep0) {
      c_dy = t3d::reduce_rg<t3d::kSum>(c_dy, o, Fj, red);
      c_z = t3d::reduce_rg<t3d::kSum>(c_z, o, Fj, red);
      if (tid < Fj) {
        p.per_cent[(size_t)c * Fj + tid] = c_dy;
        p.per_cent[((size_t)p.ncent + c) * Fj + tid] = c_z;
      }
      // scatter: member j's slots are j, j + eff, ...
      const int w = 2 * Fj + 1;
      for (int e = tid; e < eff * Fj; e += kThreads) {
        const int j = e / Fj, f = e - j * Fj;
        float sum = 0.0f;
        for (int k = j; k < K; k += eff)
          sum = __fadd_rn(sum, tof(dyj[k * ldh + f]));
        const int mult = (K - (j + 1)) / eff + 1;
        float* row = p.scat + ((size_t)b * p.N + sel[j]) * w;
        atomicAdd(row + f, sum);
        atomicAdd(row + Fj + f,
                  __fmul_rn((float)mult, tof(p.qc[(size_t)c * Fj + f])));
        if (f == 0) atomicAdd(row + 2 * Fj, (float)mult);
      }
    }
    __syncthreads();  // the tiles and sel are rewritten by the next centroid
  }

  // --- this block's partial sums ---------------------------------------
  float* part = p.partials + (size_t)blockIdx.x * (nfrag * 256 + 2 * Fj + Fj1);
#pragma unroll
  for (int i = 0; i < kDwFrags; ++i) {
    const int fr = warp + kWarps * i;
    if (fr < nfrag) {
      const int fi = fr / nfo, fo = fr - fi * nfo;
      wmma::store_matrix_sync(part + (size_t)fi * 16 * Fj1 + fo * 16,
                              dwacc[i], Fj1, wmma::mem_row_major);
    }
  }
  float* tail = part + (size_t)Fj * Fj1;
  s_dy = t3d::reduce_rg<t3d::kSum>(s_dy, o, Fj, red);
  s_dyx = t3d::reduce_rg<t3d::kSum>(s_dyx, o, Fj, red);
  s_db = t3d::reduce_rg<t3d::kSum>(s_db, o1, Fj1, red);
  if (tid < Fj) {
    tail[tid] = s_dy;
    tail[Fj + tid] = s_dyx;
  }
  if (tid < Fj1) tail[2 * Fj + tid] = s_db;
}

bool bad_tile(int k, int f) {
  return k < 16 || k > t3d::kMaxK || k % 16 || f < 16 || f > t3d::kMaxF ||
         f % 16;
}

}  // namespace

// One backward step of the chain (K8, or K9 with `step0`). `partials` is
// f32 [grid, Fj*Fj1 + 2 Fj + Fj1] scratch and `sums` receives dW_j
// [Fj, Fj1] | sum dy_j | sum dy_j * xhat_j | db_j. See BwdArgs for the
// other buffers; those a form does not use may be null.
extern "C" int t3d_sa_bwd_step(
    const void* z_j, const void* z_j1, const void* dy_j1, const void* pooled,
    const void* dpooled, const float* pack_j, const float* pack_j1,
    const void* wb, const float* cent, const float* xyz, const void* qc,
    void* dy_j, float* partials, float* sums, float* scat, float* per_cent,
    int b, int s, int n, int k, int fj, int fj1, float r2, int train, int top,
    int step0, int grid, void* stream) {
  if (b < 1 || s < 1 || grid < 1 || bad_tile(k, fj) || bad_tile(k, fj1) ||
      (fj / 16) * (fj1 / 16) > kDwFrags * kWarps)
    return (int)cudaErrorInvalidValue;
  if (top ? (!pooled || !dpooled) : !dy_j1) return (int)cudaErrorInvalidValue;
  if (step0 ? (!cent || !xyz || !qc || !scat || !per_cent || n < 1) : !dy_j)
    return (int)cudaErrorInvalidValue;
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
  a.qc = static_cast<const bf16*>(qc);
  a.dy_j = static_cast<bf16*>(dy_j);
  a.partials = partials;
  a.scat = scat;
  a.per_cent = per_cent;
  a.ncent = b * s;
  a.S = s;
  a.N = n;
  a.K = k;
  a.Fj = fj;
  a.Fj1 = fj1;
  a.r2 = r2;
  a.train = train;
  a.top = top;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = bwd_smem_bytes(k, fj, fj1);
  auto kern = step0 ? sa_bwd_step_kernel<true> : sa_bwd_step_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)t3d::reduce_partials(partials, sums, grid,
                                   fj * fj1 + 2 * fj + fj1, st);
}
