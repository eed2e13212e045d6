// Ball-query extraction and its backward for Hopper (sm_90a): kernels K3
// and K4 of the port.
//
// Replaces the Pallas TPU kernels `_extract_fwd_kernel` (K3) and
// `_extract_bwd_kernel` (K4) of transferable3d_tpu/ops/grouping.py, the
// forward and backward of its custom-VJP `ball_query_extract`, which the
// unfused set-abstraction path (T3D_FUSED_SA=0) runs at every grouped
// SA scale.
//
// What they compute, for centroid s of batch row b (one block each), with
// the members of ball_select.cuh (direct-form d2, first K in radius by
// index, the nearest point for an empty ball) and eff = clip(count, 1, K):
//   K3: out[b, s, k, :] = payload[b, sel[k mod eff], :], copied bit for
//       bit, and count[b, s] = the true in-radius count (0 when empty);
//   K4: dpay[b, n, :] = bf16(sum over every (s, k) whose slot took n of
//       f32(dg[b, s, k, :])), summed in f32 and rounded to bf16 once.
// The TPU kernels' one-hot MXU contraction, lane prefix sums and `+0.25`
// reciprocal bias are TPU workarounds and are not carried over.
//
// What bounds them: K3 writes [B, S, K, C] bf16 (268 MB at seg-SA1 scale
// 3, S=128 K=128 C=64 B=128) and K4 reads the same amount, so both are
// bound by device-memory bandwidth; the selection reads one 12 KB row of
// xyz per block, from L2. K3 copies rows as 16-byte vectors (C is a
// multiple of 8 on every path), consecutive threads on consecutive
// addresses of the output. K4 sums, in f32 and slot order, the cyclic
// repeats of each of the eff members in the block (slots j, j+eff, ...),
// then adds the eff member sums into an f32 [B, N, C] workspace with
// atomicAdd; a second kernel rounds the workspace to bf16. The atomics
// make the order of the cross-centroid sums vary from run to run: the
// result differs from the plain twin's by at most 1 bf16 ulp of the sum
// of the terms' magnitudes (more ulps of the result where terms cancel),
// and not at all when the cotangents are small integers (every partial
// sum is then exact).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ball_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Largest K: its selection takes (K + 3 * kWarps) * 4 = 16.5 KB of shared
// memory, within the 48 KB a launch gets without opting in.
constexpr int kMaxK = 4096;

inline size_t select_smem_bytes(int k) {
  return (size_t)(k + 3 * kWarps) * 4;
}

struct Select {
  int* sel;
  int total;
  int eff;
};

// The members of centroid (b, s); every thread of the block calls it.
__device__ __forceinline__ Select select_members(
    const float* __restrict__ cent, const float* __restrict__ xyz,
    size_t cs, int b, int N, int K, float r2) {
  extern __shared__ __align__(16) int smem_i[];
  int* sel = smem_i;                                  // [K]
  int* wcnt = sel + K;                                // [kWarps]
  float* red_d = reinterpret_cast<float*>(wcnt + kWarps);
  int* red_i = reinterpret_cast<int*>(red_d + kWarps);
  const int total = t3d::ball_select<kThreads>(
      xyz + (size_t)b * N * 3, N, cent[cs * 3 + 0], cent[cs * 3 + 1],
      cent[cs * 3 + 2], r2, K, sel, wcnt, red_d, red_i);
  return {sel, total, total == 0 ? 1 : min(total, K)};
}

__global__ void __launch_bounds__(kThreads)
extract_fwd_kernel(const float* __restrict__ cent,
                   const float* __restrict__ xyz,
                   const __nv_bfloat16* __restrict__ pay,
                   __nv_bfloat16* __restrict__ out, int* __restrict__ count,
                   int S, int N, int K, int C, float r2, int vec) {
  const int b = blockIdx.y;
  const size_t cs = (size_t)b * S + blockIdx.x;
  const Select m = select_members(cent, xyz, cs, b, N, K, r2);
  if (threadIdx.x == 0) count[cs] = m.total;
  const __nv_bfloat16* src = pay + (size_t)b * N * C;
  __nv_bfloat16* dst = out + cs * K * C;
  if (vec) {
    const int cv = C / 8;  // 16-byte vectors per row
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int e = threadIdx.x; e < K * cv; e += kThreads) {
      const int k = e / cv, v = e - k * cv;
      d4[e] = s4[(size_t)m.sel[k % m.eff] * cv + v];
    }
  } else {
    for (int e = threadIdx.x; e < K * C; e += kThreads) {
      const int k = e / C, c = e - k * C;
      dst[e] = src[(size_t)m.sel[k % m.eff] * C + c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
extract_bwd_kernel(const float* __restrict__ cent,
                   const float* __restrict__ xyz,
                   const __nv_bfloat16* __restrict__ dg,
                   float* __restrict__ acc, int S, int N, int K, int C,
                   float r2) {
  const int b = blockIdx.y;
  const size_t cs = (size_t)b * S + blockIdx.x;
  const Select m = select_members(cent, xyz, cs, b, N, K, r2);
  const __nv_bfloat16* g = dg + cs * K * C;
  float* a = acc + (size_t)b * N * C;
  for (int e = threadIdx.x; e < m.eff * C; e += kThreads) {
    const int j = e / C, c = e - j * C;
    float sum = 0.0f;
    for (int k = j; k < K; k += m.eff)
      sum = __fadd_rn(sum, __bfloat162float(g[(size_t)k * C + c]));
    atomicAdd(a + (size_t)m.sel[j] * C + c, sum);
  }
}

__global__ void round_bf16_kernel(const float* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ out,
                                  size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(acc[i]);
}

bool bad_shape(int b, int s, int n, int k, int c) {
  return b < 1 || s < 1 || n < 1 || k < 1 || c < 1 || b > 65535 ||
         k > kMaxK;
}

}  // namespace

extern "C" int t3d_extract_fwd(const float* cent, const float* xyz,
                               const void* pay, void* out, int* count, int b,
                               int s, int n, int k, int c, float r2,
                               void* stream) {
  if (bad_shape(b, s, n, k, c)) return (int)cudaErrorInvalidValue;
  const size_t smem = select_smem_bytes(k);
  const int vec = c % 8 == 0 && (uintptr_t)pay % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  extract_fwd_kernel<<<dim3(s, b), kThreads, smem, (cudaStream_t)stream>>>(
      cent, xyz, static_cast<const __nv_bfloat16*>(pay),
      static_cast<__nv_bfloat16*>(out), count, s, n, k, c, r2, vec);
  return (int)cudaGetLastError();
}

// acc must be a zeroed f32 [B, N, C] workspace; dpay receives bf16(acc).
extern "C" int t3d_extract_bwd(const float* cent, const float* xyz,
                               const void* dg, float* acc, void* dpay, int b,
                               int s, int n, int k, int c, float r2,
                               void* stream) {
  if (bad_shape(b, s, n, k, c)) return (int)cudaErrorInvalidValue;
  const size_t smem = select_smem_bytes(k);
  cudaStream_t st = (cudaStream_t)stream;
  extract_bwd_kernel<<<dim3(s, b), kThreads, smem, st>>>(
      cent, xyz, static_cast<const __nv_bfloat16*>(dg), acc, s, n, k, c, r2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)b * n * c;
  const int blocks = (int)((total + 1023) / 1024 < 65535 * 4
                               ? (total + 1023) / 1024
                               : 65535 * 4);
  round_bf16_kernel<<<blocks, 1024, 0, st>>>(
      acc, static_cast<__nv_bfloat16*>(dpay), total);
  return (int)cudaGetLastError();
}
