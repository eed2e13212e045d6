// Farthest-point sampling for Hopper (sm_90a), kernel K1 of the port.
//
// Replaces the Pallas TPU kernel `_fps_kernel` of
// transferable3d_tpu/ops/sampling.py (wrapper `_fps_pallas`).
//
// What it computes: seed index 0; dist starts at 1e10; for k-1 steps,
// dist = min(dist, (dx*dx + dy*dy) + dz*dz) to the last pick, and the
// next pick is the argmax of dist with the first index winning ties.
// Every product and sum is a separately rounded f32 op (__fmul_rn /
// __fadd_rn are never contracted into an FMA), so the indices equal the
// plain twin's (ops/sampling.fps_plain) and the JAX `_fps_ref`'s bit for
// bit.
//
// What bounds it: the k-1 steps are sequential and each ends in a
// block-wide argmax, so a step costs the latency of its dependent chain
// (the distances, the argmax across the block, the next pick's
// coordinates) and almost no bandwidth: the arithmetic is 8 flops per
// point per step. One batch row a block; B rows run as B independent
// blocks.
//
// The design shortens that chain:
//   * The points and their running distances live in registers, P = 4 or
//     8 a thread (strided: point j T + t in thread t), in blocks of T
//     threads chosen by n (the launcher's plan, `fps_plan` in
//     ops/sampling.py: one warp for 128 points, 8 for 1,024). A thread's
//     slots past n repeat point 0 and come after its real ones, so their
//     distance (0 once point 0 is picked) never beats a real one and
//     never wins a tie. Above 4,096 points the points stay in shared
//     memory (x, y, z and the distance, 16 bytes a point) and 1,024
//     threads walk them: a second path of the one kernel (P = 0).
//   * The distances are >= 0, so their f32 bits order as unsigned
//     integers: a warp's argmax is two `redux.sync` instructions
//     (`__reduce_max_sync` of the bits, then `__reduce_min_sync` of the
//     indices of the lanes that hold them).
//   * One block barrier a step: lane 0 of each warp writes its (bits,
//     index) into a double-buffered slot; after the barrier every warp
//     reduces the slots itself, so no second barrier and no broadcast.
//   * The pick's coordinates come from a shared-memory copy of the
//     points (one broadcast 16-byte load).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float dist2(float4 p, float lx, float ly,
                                       float lz) {
  const float dx = __fsub_rn(p.x, lx);
  const float dy = __fsub_rn(p.y, ly);
  const float dz = __fsub_rn(p.z, lz);
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

// The block's argmax of (bits, index) pairs, the lowest index on ties:
// each warp by two redux.sync, then, with more than one warp, the warps'
// pairs through slot buffer `buf` and one barrier. Every thread returns
// the winning index.
__device__ __forceinline__ unsigned block_argmax(unsigned bits,
                                                 unsigned idx, uint2* slots,
                                                 int buf, int nwarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned m = __reduce_max_sync(kFull, bits);
  unsigned wi = __reduce_min_sync(kFull, bits == m ? idx : 0xffffffffu);
  if (nwarps == 1) return wi;
  if (lane == 0) slots[buf * kMaxWarps + warp] = make_uint2(m, wi);
  __syncthreads();
  const uint2 c = lane < nwarps ? slots[buf * kMaxWarps + lane]
                                : make_uint2(0u, 0xffffffffu);
  m = __reduce_max_sync(kFull, c.x);
  return __reduce_min_sync(kFull, c.x == m ? c.y : 0xffffffffu);
}

// P points a thread in registers (P > 0), or all of them in shared memory
// (P == 0). Shared memory: the points as float4 (x, y, z, and in the
// shared path the running distance).
template <int P>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
           int k) {
  extern __shared__ float4 pts[];  // [n]
  __shared__ uint2 slots[2 * kMaxWarps];
  const int tid = threadIdx.x, T = blockDim.x, nwarps = T >> 5;
  const float* src = xyz + (size_t)blockIdx.x * n * 3;
  int* o = out + (size_t)blockIdx.x * k;

  for (int i = tid; i < n; i += T)
    pts[i] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2], 1e10f);
  float4 mine[P > 0 ? P : 1];
  float d[P > 0 ? P : 1];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = j * T + tid;
    const int at = i < n ? i : 0;  // past n: point 0 again
    mine[j] = make_float4(src[3 * at], src[3 * at + 1], src[3 * at + 2], 0.f);
    d[j] = 1e10f;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();
  float4 last = pts[0];

  for (int step = 1; step < k; ++step) {
    float bv = -1.0f;  // every distance is >= 0
    unsigned bi = 0xffffffffu;
    if constexpr (P > 0) {
      // i rises with j: a strict > keeps the first index of a tie
#pragma unroll
      for (int j = 0; j < P; ++j) {
        d[j] = fminf(d[j], dist2(mine[j], last.x, last.y, last.z));
        if (d[j] > bv) {
          bv = d[j];
          bi = j * T + tid;
        }
      }
    } else {
      for (int i = tid; i < n; i += T) {
        float4 p = pts[i];
        p.w = fminf(p.w, dist2(p, last.x, last.y, last.z));
        pts[i].w = p.w;
        if (p.w > bv) {
          bv = p.w;
          bi = i;
        }
      }
    }
    // a thread without a point reports (0, ~0), which loses every tie
    const unsigned bits = bi < (unsigned)n ? __float_as_uint(bv) : 0u;
    const unsigned pick = block_argmax(bits, bi, slots, step & 1, nwarps);
    if (tid == 0) o[step] = (int)pick;
    last = pts[pick];
  }
}

}  // namespace

// `threads` and `per_thread` (4 or 8 points a thread in registers, 0 for
// the shared-memory path) are the launcher's plan (`fps_plan`).
extern "C" int t3d_fps(const float* xyz, int* out, int b, int n, int k,
                       int threads, int per_thread, void* stream) {
  const size_t smem = (size_t)n * sizeof(float4);
  if (b < 1 || n < 1 || k < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || (per_thread != 0 && per_thread != 4 &&
                       per_thread != 8) ||
      (per_thread && (size_t)threads * per_thread < (size_t)n) ||
      smem > kSmemLimit - sizeof(uint2) * 2 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  auto kern = per_thread == 4 ? fps_kernel<4>
              : per_thread == 8 ? fps_kernel<8> : fps_kernel<0>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<b, threads, smem, (cudaStream_t)stream>>>(xyz, out, n, k);
  return (int)cudaGetLastError();
}
