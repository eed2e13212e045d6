// Shared pieces of the fused set-abstraction training kernels K5-K9
// (sa_train_fwd.cu, sa_train_bwd.cu).
//
// Rounding: bf16 round-to-nearest-even at exactly the sites the JAX
// kernels mark with `_bf16(...)`; every other value is f32, and the f32
// multiply-adds outside the tensor cores are separate rounded ops
// (`__fmul_rn`, `__fadd_rn`), never an FMA, as the plain PyTorch twins
// compute them.
//
// Whole-grid sums. On the TPU the grid runs in order and a kernel adds
// into one accumulator. Here a fixed grid of blocks each walks the
// centroids c = blockIdx.x, blockIdx.x + gridDim.x, ... in order; thread
// (rg, f) of a block owns channel f for the rows rg, rg + nrg, ... of
// every centroid and keeps its partial sum in a register; the row groups
// are added in shared memory in rg order; each block writes one partial
// and `reduce_partials_kernel` adds the partials in block order. The
// result is the same bits run after run (for one grid size).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace t3d {

typedef __nv_bfloat16 bf16;

// bf16 elements of padding per row of a shared-memory tile, so that the
// rows of a 16x16 fragment fall into different banks.
constexpr int kPad = 8;
// Largest tile: K <= 128 rows (8 fragments of 16), widths <= 256.
constexpr int kMaxK = 128;
constexpr int kMaxF = 256;

__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// h = max(bf16(z * a + c), 0)
__device__ __forceinline__ float bn_relu(float z, float a, float c) {
  const float y = bf16_round(__fadd_rn(__fmul_rn(z, a), c));
  return y > 0.0f ? y : 0.0f;
}

// Which channel and rows of a [K, F] tile a thread owns (F <= blockDim.x).
struct Own {
  int f, rg, nrg;
  bool active;
};

__device__ __forceinline__ Own own(int F) {
  Own o;
  o.nrg = blockDim.x / F;
  o.active = threadIdx.x < o.nrg * F;
  o.f = threadIdx.x % F;
  o.rg = threadIdx.x / F;
  return o;
}

enum { kSum = 0, kMax = 1, kMin = 2 };

// Combines v over the row groups of each channel in rg order. Every
// thread of the block calls it; threads 0..F-1 get channel threadIdx.x's
// result. `red` holds blockDim.x floats.
template <int kOp>
__device__ __forceinline__ float reduce_rg(float v, const Own& o, int F,
                                           float* red) {
  __syncthreads();
  if (o.active) red[o.rg * F + o.f] = v;
  __syncthreads();
  float r = 0.0f;
  if (threadIdx.x < F) {
    r = red[threadIdx.x];
    for (int g = 1; g < o.nrg; ++g) {
      const float x = red[g * F + threadIdx.x];
      r = kOp == kSum ? __fadd_rn(r, x) : kOp == kMax ? fmaxf(r, x)
                                                      : fminf(r, x);
    }
  }
  return r;
}

// out[i] = sum over blocks g = 0, 1, ... of part[g][i], in that order.
static __global__ void reduce_partials_kernel(const float* __restrict__ part,
                                              float* __restrict__ out, int G,
                                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s = __fadd_rn(s, part[(size_t)g * n + i]);
  out[i] = s;
}

static inline cudaError_t reduce_partials(const float* part, float* out, int G,
                                          int n, cudaStream_t st) {
  reduce_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, G, n);
  return cudaGetLastError();
}

}  // namespace t3d
