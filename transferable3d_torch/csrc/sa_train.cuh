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
// into one accumulator. Here a fixed grid of blocks each walks its
// centroids or tiles in a fixed order; every partial sum has one owner (a
// lane's register, or K5's f64 slot in shared memory, across the walk),
// the owners of a block are added in a fixed order; each block writes one
// partial and `reduce_partials_kernel` adds the partials in block order.
// The result is the same bits run after run (for one grid size).

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

// out[i] = sum over blocks g = 0, 1, ... of part[g][i], in that order,
// in the partials' type T (f32, or f64 rounded to f32 once at the end).
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
static __global__ void reduce_partials_kernel(const T* __restrict__ part,
                                       float* __restrict__ out, int G, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = 0;
  for (int g = 0; g < G; ++g) s = add_rn(s, part[(size_t)g * n + i]);
  out[i] = (float)s;
}

template <typename T>
static inline cudaError_t reduce_partials(const T* part, float* out, int G,
                                          int n, cudaStream_t st) {
  reduce_partials_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(part, out, G, n);
  return cudaGetLastError();
}

}  // namespace t3d
