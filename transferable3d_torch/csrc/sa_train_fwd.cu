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
// F = 64..256 that is 21..85 operations a byte, below the card's 295, so
// bytes bound them too, provided the product runs on the tensor cores.
// The design: the product is `wmma` 16x16x16 bf16 fragments with f32
// accumulators (the operands are bf16 by definition, so every product is
// exact and only the f32 sum's order differs from the plain twin's); a
// block holds one centroid's h and z' tiles in shared memory, a warp owns
// 16 output channels and keeps the weight fragment across the row
// fragments; all sums are deterministic (see sa_train.cuh). TMA, wgmma
// and a pipeline over centroids are later work.

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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExtractK = 4096;

// ---------------------------------------------------------------- K5 -----

__global__ void __launch_bounds__(kThreads)
sa_extract_kernel(const float* __restrict__ cent,
                  const float* __restrict__ xyz, const bf16* __restrict__ pf,
                  const bf16* __restrict__ qc, bf16* __restrict__ z1,
                  float* __restrict__ partials, int ncent, int S, int N,
                  int K, int F, float r2) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* sel = reinterpret_cast<int*>(smem);             // [K]
  int* wcnt = sel + K;                                 // [kWarps]
  float* red_d = reinterpret_cast<float*>(wcnt + kWarps);
  int* red_i = reinterpret_cast<int*>(red_d + kWarps);
  float* red = reinterpret_cast<float*>(red_i + kWarps);  // [kThreads]

  const t3d::Own o = t3d::own(F);
  float s = 0.0f, q = 0.0f;
  for (int c = blockIdx.x; c < ncent; c += gridDim.x) {
    const int b = c / S;
    const int total = t3d::ball_select<kThreads>(
        xyz + (size_t)b * N * 3, N, cent[(size_t)c * 3 + 0],
        cent[(size_t)c * 3 + 1], cent[(size_t)c * 3 + 2], r2, K, sel, wcnt,
        red_d, red_i);
    const int eff = total == 0 ? 1 : min(total, K);
    if (o.active) {
      const float qv = tof(qc[(size_t)c * F + o.f]);
      const bf16* src = pf + (size_t)b * N * F + o.f;
      bf16* dst = z1 + (size_t)c * K * F + o.f;
      for (int k = o.rg; k < K; k += o.nrg) {
        const bf16 zb = __float2bfloat16_rn(
            __fsub_rn(tof(src[(size_t)sel[k % eff] * F]), qv));
        dst[(size_t)k * F] = zb;
        const float z = tof(zb);
        s = __fadd_rn(s, z);
        q = __fadd_rn(q, __fmul_rn(z, z));
      }
    }
    __syncthreads();  // sel is rewritten by the next centroid
  }
  s = t3d::reduce_rg<t3d::kSum>(s, o, F, red);
  q = t3d::reduce_rg<t3d::kSum>(q, o, F, red);
  if (threadIdx.x < F) {
    float* p = partials + (size_t)blockIdx.x * 2 * F;
    p[threadIdx.x] = s;
    p[F + threadIdx.x] = q;
  }
}

// ----------------------------------------------------------- K6, K7 ------

inline size_t fwd_smem_bytes(int k, int fin, int fout) {
  return (size_t)k * (fin + kPad) * 2 + (size_t)k * (fout + kPad) * 2 +
         kWarps * 256 * 4 + kThreads * 4;
}

template <bool kLast>
__global__ void __launch_bounds__(kThreads)
sa_fwd_step_kernel(const bf16* __restrict__ z_prev,
                   const float* __restrict__ pack,
                   const bf16* __restrict__ wb,
                   const float* __restrict__ bias, bf16* __restrict__ z_next,
                   float* __restrict__ partials, float* __restrict__ zmax,
                   float* __restrict__ zmin, int ncent, int K, int Fin,
                   int Fout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = Fin + kPad, ldz = Fout + kPad;
  bf16* h = reinterpret_cast<bf16*>(smem);                 // [K][ldh]
  bf16* zn = h + (size_t)K * ldh;                          // [K][ldz]
  float* patch = reinterpret_cast<float*>(zn + (size_t)K * ldz);
  float* red = patch + kWarps * 256;                       // [kThreads]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pa = pack;
  const float* pc = pack + Fin;
  const int nmi = K / 16, nni = Fout / 16, nkk = Fin / 16;
  const t3d::Own o = t3d::own(Fout);
  float s = 0.0f, q = 0.0f;

  for (int c = blockIdx.x; c < ncent; c += gridDim.x) {
    // h = relu(BN(z_prev)) for the K rows of this centroid
    const bf16* zp = z_prev + (size_t)c * K * Fin;
    for (int e = tid; e < K * Fin; e += kThreads) {
      const int k = e / Fin, f = e - k * Fin;
      h[k * ldh + f] =
          __float2bfloat16_rn(t3d::bn_relu(tof(zp[e]), pa[f], pc[f]));
    }
    __syncthreads();

    // z' = bf16(h @ bf16(W) + b): a warp owns 16 output channels
    for (int ni = warp; ni < nni; ni += kWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) wmma::fill_fragment(acc[m], 0.0f);
      for (int kk = 0; kk < nkk; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, wb + (size_t)kk * 16 * Fout + ni * 16,
                               Fout);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          if (m < nmi) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                fa;
            wmma::load_matrix_sync(fa, h + m * 16 * ldh + kk * 16, ldh);
            wmma::mma_sync(acc[m], fa, fb, acc[m]);
          }
        }
      }
      float* pw = patch + warp * 256;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (m < nmi) {
          wmma::store_matrix_sync(pw, acc[m], 16, wmma::mem_row_major);
          __syncwarp();
          for (int i = lane; i < 256; i += 32) {
            const int r = i >> 4, ch = ni * 16 + (i & 15);
            zn[(m * 16 + r) * ldz + ch] =
                __float2bfloat16_rn(__fadd_rn(pw[i], bias[ch]));
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();

    // write z', and its sums (and extrema) in a fixed order
    float mx = -INFINITY, mn = INFINITY;
    if (o.active) {
      bf16* zo = z_next + (size_t)c * K * Fout + o.f;
      for (int k = o.rg; k < K; k += o.nrg) {
        const bf16 zb = zn[k * ldz + o.f];
        zo[(size_t)k * Fout] = zb;
        const float z = tof(zb);
        s = __fadd_rn(s, z);
        q = __fadd_rn(q, __fmul_rn(z, z));
        mx = fmaxf(mx, z);
        mn = fminf(mn, z);
      }
    }
    if (kLast) {
      mx = t3d::reduce_rg<t3d::kMax>(mx, o, Fout, red);
      mn = t3d::reduce_rg<t3d::kMin>(mn, o, Fout, red);
      if (tid < Fout) {
        zmax[(size_t)c * Fout + tid] = mx;
        zmin[(size_t)c * Fout + tid] = mn;
      }
    }
    __syncthreads();  // h and zn are rewritten by the next centroid
  }
  s = t3d::reduce_rg<t3d::kSum>(s, o, Fout, red);
  q = t3d::reduce_rg<t3d::kSum>(q, o, Fout, red);
  if (tid < Fout) {
    float* p = partials + (size_t)blockIdx.x * 2 * Fout;
    p[tid] = s;
    p[Fout + tid] = q;
  }
}

bool bad_tile(int k, int f) {
  return k < 16 || k > t3d::kMaxK || k % 16 || f < 16 || f > t3d::kMaxF ||
         f % 16;
}

}  // namespace

// z1 [B, S, K, F] bf16; partials f32 [grid, 2, F] scratch; sums f32 [2, F]
// receives sum z1 and sum z1^2.
extern "C" int t3d_sa_extract(const float* cent, const float* xyz,
                              const void* pf, const void* qc, void* z1,
                              float* partials, float* sums, int b, int s,
                              int n, int k, int f, float r2, int grid,
                              void* stream) {
  if (b < 1 || s < 1 || n < 1 || k < 1 || k > kMaxExtractK || f < 1 ||
      f > t3d::kMaxF || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(k + 3 * kWarps + kThreads) * 4;
  sa_extract_kernel<<<grid, kThreads, smem, st>>>(
      cent, xyz, static_cast<const bf16*>(pf), static_cast<const bf16*>(qc),
      static_cast<bf16*>(z1), partials, b * s, s, n, k, f, r2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)t3d::reduce_partials(partials, sums, grid, 2 * f, st);
}

// z_next [C, K, F_out] bf16 from z_prev [C, K, F_in]; wb is bf16(W)
// [F_in, F_out] row-major; partials f32 [grid, 2, F_out] scratch; sums f32
// [2, F_out]; zmax, zmin f32 [C, F_out] when `last`.
extern "C" int t3d_sa_fwd_step(const void* z_prev, const float* pack,
                               const void* wb, const float* bias,
                               void* z_next, float* partials, float* sums,
                               float* zmax, float* zmin, int ncent, int k,
                               int fin, int fout, int last, int grid,
                               void* stream) {
  if (ncent < 1 || grid < 1 || bad_tile(k, fin) || bad_tile(k, fout) ||
      (last && (!zmax || !zmin)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = fwd_smem_bytes(k, fin, fout);
  auto kern = last ? sa_fwd_step_kernel<true> : sa_fwd_step_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(z_prev), pack, static_cast<const bf16*>(wb),
      bias, static_cast<bf16*>(z_next), partials, zmax, zmin, ncent, k, fin,
      fout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)t3d::reduce_partials(partials, sums, grid, 2 * fout, st);
}
