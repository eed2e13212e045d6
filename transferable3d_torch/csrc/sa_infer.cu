// Fused set-abstraction inference for Hopper (sm_90a), kernel K2 of the
// port: ball query -> L x (BN + ReLU [+ Dense]) -> max over the group.
//
// Replaces the Pallas TPU kernels `_infer_kernel` and its planar twin
// `_infer_kernel_p` of transferable3d_tpu/ops/fused_sa.py (wrapper
// `_call_infer`). One kernel covers both: they compute the same values.
//
// What it computes, for centroid s of batch row b (one block each):
//   d2     = ((0 + dx*dx) + dy*dy) + dz*dz, dx = c - p (direct form,
//            no FMA), in radius when d2 <= r2 = float32(radius^2);
//   select = the in-radius points in index order (ranks 1..count); slot
//            k takes rank (k mod eff) + 1 with eff = clip(count, 1, K);
//            an empty ball takes the nearest point (lowest index on
//            ties); the d2 and selection code is ball_select.cuh, shared
//            with K3 and K4;
//   z1     = bf16(f32(pf[sel]) - f32(qc[s]));
//   h_d    = max(bf16(z_d * a_d + c_d), 0);
//   z_d+1  = bf16(sum_j h_d[j] * bf16(W_d)[j, o] + b_d[o])   (f32 sums);
//   pooled = max over the K slots of h_{L-1}.
// Rounding is round-to-nearest-even at exactly these sites, as in the
// JAX `_chain_all` / `_bf16_round`. Slots past eff repeat rows
// k mod eff, so the max over K equals the max over the first eff rows:
// the chain runs on those eff distinct rows only, which changes no bit.
//
// What bounds it: the chain's multiply-adds (up to 128 rows x 96 x 128
// per centroid at seg-SA1) run on the f32 pipes from shared memory, not
// on the tensor cores; device memory traffic is small (xyz, the
// gathered pf rows, the weights from L2, and only `pooled` written). The
// design keeps every [K, F] activation in shared memory (two bf16
// ping-pong buffers of K x F_max, up to 128 KB at seg-SA2 K=128 F=256,
// opted in above 48 KB), never writes a [B, S, K, F] tensor, and gives
// each thread four rows of one output channel so a weight read from L2
// feeds four multiply-adds. Tensor-core (mma/wgmma) tiling is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ball_select.cuh"

namespace {

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

__global__ void __launch_bounds__(kThreads)
sa_infer_kernel(const float* __restrict__ cent, const float* __restrict__ xyz,
                const __nv_bfloat16* __restrict__ pf,
                const __nv_bfloat16* __restrict__ qc,
                const float* __restrict__ params,
                __nv_bfloat16* __restrict__ pooled, int S, int N, int K,
                ChainDims dims, float r2) {
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
        sa_infer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(s, b);
  sa_infer_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cent, xyz, static_cast<const __nv_bfloat16*>(pf),
      static_cast<const __nv_bfloat16*>(qc), params,
      static_cast<__nv_bfloat16*>(pooled), s, n, k, dims, r2);
  return (int)cudaGetLastError();
}
