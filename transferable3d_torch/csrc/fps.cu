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
// block-wide argmax, so a step costs a few microseconds of latency
// (two barriers, a warp-shuffle reduction) and almost no bandwidth: the
// arithmetic is 8 flops per point per step. The design keeps one batch
// row per block with x, y, z and the running distance in shared memory
// (16 bytes a point), so no step touches device memory except the one
// index it writes; B rows run as B independent blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void argmax_pair(float& v, int& i, float ov,
                                            int oi) {
  // Larger value wins; on equal values the lower index wins.
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           int* __restrict__ out, int n, int k) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* sd = sz + n;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * k;

  for (int i = tid; i < n; i += blockDim.x) {
    sx[i] = p[3 * i + 0];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
    sd[i] = 1e10f;
  }
  if (tid == 0) {
    o[0] = 0;
    s_last = 0;
  }
  __syncthreads();

  for (int step = 1; step < k; ++step) {
    const int last = s_last;
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = -1.0f;  // every distance is >= 0
    int bi = n;
    for (int i = tid; i < n; i += blockDim.x) {
      const float dx = __fsub_rn(sx[i], lx);
      const float dy = __fsub_rn(sy[i], ly);
      const float dz = __fsub_rn(sz[i], lz);
      float d = __fmul_rn(dx, dx);
      d = __fadd_rn(d, __fmul_rn(dy, dy));
      d = __fadd_rn(d, __fmul_rn(dz, dz));
      const float nd = fminf(sd[i], d);
      sd[i] = nd;
      if (nd > bv) {  // i rises within a thread: the first index stays
        bv = nd;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, off);
      const int oi = __shfl_down_sync(kFull, bi, off);
      argmax_pair(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -1.0f;
      bi = lane < nwarps ? red_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(kFull, bv, off);
        const int oi = __shfl_down_sync(kFull, bi, off);
        argmax_pair(bv, bi, ov, oi);
      }
      if (lane == 0) {
        s_last = bi;
        o[step] = bi;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int t3d_fps(const float* xyz, int* out, int b, int n, int k,
                       void* stream) {
  if (b < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  int threads = ((n + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  const size_t smem = (size_t)n * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(xyz, out, n, k);
  return (int)cudaGetLastError();
}
