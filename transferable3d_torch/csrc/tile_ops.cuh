// Warp-level building blocks of the tensor-core kernels K2 (sa_infer.cu),
// K6/K7 (sa_train_fwd.cu) and K8/K9 (sa_train_bwd.cu): 16-byte
// asynchronous copies into shared memory, `ldmatrix` operand loads, the
// `mma.sync.m16n8k16` bf16 product with f32 accumulators, and the packed
// bf16 pair arithmetic of their epilogues.
//
// Fragment layout of m16n8k16 (lane l, lrow = l / 4, lcol = 2 (l % 4)):
//   A (16 x 16, row-major) a[0] = rows lrow, cols lcol..+1; a[1] = rows
//   lrow + 8, same cols; a[2], a[3] = the same rows, cols + 8;
//   B (16 x 8) b[0] = rows (k) lcol..+1 of col (n) lrow; b[1] = k + 8;
//   C (16 x 8) c[0..1] = row lrow, cols lcol..+1; c[2..3] = row lrow + 8.
// So the accumulators of two neighbouring 8-column tiles are, packed to
// bf16 pairs, the A fragment of the next product's 16-wide k step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t3d {

typedef __nv_bfloat162 bf162;

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// `rows` rows of F bf16 (F a multiple of 8) from a dense global run into
// shared-memory rows `ld` apart, as 16-byte copies by a block of kThreads.
template <int kThreads>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int rows,
                                          int F) {
  const int cpr = F >> 3, total = rows * cpr;
  // chunk i = r * cpr + g, stepped by kThreads without a division
  int r = threadIdx.x / cpr, g = threadIdx.x - r * cpr;
  const int dr = kThreads / cpr, dg = kThreads - dr * cpr;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    cp16(dst + (size_t)r * ld + g * 8, src + (size_t)i * 8);
    r += dr;
    g += dg;
    if (g >= cpr) {
      g -= cpr;
      ++r;
    }
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool lane_id_bit(int bit) {
  return (threadIdx.x >> bit) & 1;
}

// A pair of bf16 as two f32: a shift and a mask.
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return unpack2(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const bf162 b = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Both values rounded to bf16 by one conversion.
__device__ __forceinline__ float2 bf16_round2(float x, float y) {
  return unpack2(pack2(x, y));
}

// max(bf16(z * a + c), 0) of a pair of channels (t3d::bn_relu), as a
// packed bf16 pair.
__device__ __forceinline__ uint32_t bn_relu_pack(float2 z, float2 a,
                                                 float2 c) {
  const bf162 y = __hmax2(
      __floats2bfloat162_rn(__fadd_rn(__fmul_rn(z.x, a.x), c.x),
                            __fadd_rn(__fmul_rn(z.y, a.y), c.y)),
      __floats2bfloat162_rn(0.0f, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// Four values a lane, each reduced over the 8 lanes l, l + 4, ..., l + 28
// that hold one column pair of an accumulator block, in a fixed order and
// four shuffles: lanes trade halves, so that lane l + 8 i of the lanes
// below 16 + 4 ends with v[i] reduced. Returns v[((lane >> 4) & 1) * 2 +
// ((lane >> 3) & 1)] reduced, complete in every lane. kMax: the maximum,
// else the rounded f32 sum.
template <bool kMax = false>
__device__ __forceinline__ float col_reduce4(const float (&v)[4]) {
  const unsigned full = 0xffffffffu;
  auto op = [](float x, float y) { return kMax ? fmaxf(x, y) : __fadd_rn(x, y); };
  const bool hi = lane_id_bit(4), mid = lane_id_bit(3);
  float a = hi ? v[2] : v[0], b = hi ? v[3] : v[1];
  a = op(a, __shfl_xor_sync(full, hi ? v[0] : v[2], 16));
  b = op(b, __shfl_xor_sync(full, hi ? v[1] : v[3], 16));
  float keep = mid ? b : a;
  keep = op(keep, __shfl_xor_sync(full, mid ? a : b, 8));
  return op(keep, __shfl_xor_sync(full, keep, 4));
}

}  // namespace t3d
