// Systematic rank-select fetch for Hopper (sm_90a), kernel K15 of the port.
//
// Replaces the Pallas TPU kernel `_fetch_select_kernel` of
// transferable3d_tpu/data/frustum_jit.py (wrapper `_fetch_select_pallas`),
// together with the rank bookkeeping of `_select_prelude` that fed it.
//
// What it computes, per frustum (one 2D box on one frame's point grid):
// count = the number of in-box points; for each of the npoints output
// slots s the 1-based rank
//   slot = perm[s] + floor(u * np), wrapped into [0, np)
//   want = min(1 + floor((slot + u) * count / np), max(count, 1))
// and the C coordinates of the in-box point whose rank in index order is
// `want`, plus that point's index. An empty frustum gives zero rows and
// index -1. The rank arithmetic is f32 with every product, sum and
// quotient rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn are never
// contracted), in the order the plain twin (data/frustum_jit.want_ranks)
// and the JAX code take it, so the ranks are the same integers.
//
// On the TPU the search was two one-hot matrix products over 128-point
// tiles with the coordinates split into bf16 hi + lo parts, because a
// row-by-row gather is slow there. Here it is what it is: a rank search
// and a gather of the exact f32 point.
//
// What bounds it: bytes, and few of them (the mask once, npoints rows
// out), so at the training shape (128 frustums of 12,288 points) the
// launch latency sets the time. The design: one block per frustum. Each
// warp turns 32 mask bytes into one ballot word; the words and the
// exclusive prefix of their popcounts live in shared memory (8 bytes per
// 32 points: 77 KB for a 480x640 depth map); each slot then binary-
// searches the prefix for its word, takes the (want - start)-th set bit
// of it, and copies C floats. No rank tensor and no one-hot tensor is
// ever written to device memory.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;

__global__ void fetch_select_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ inside,
    const float* __restrict__ u, const float* __restrict__ perm,
    float* __restrict__ sampled, int* __restrict__ idx,
    int* __restrict__ count, int mb, int n, int c, int np, int nwords) {
  extern __shared__ unsigned smem[];
  unsigned* bits = smem;                               // [nwords]
  int* start = reinterpret_cast<int*>(smem + nwords);  // [nwords]
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int s_count;

  const int b = blockIdx.x;  // frustum = frame * mb + box
  const int f = b / mb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // 1. The mask as one ballot word per 32 points.
  const unsigned char* m = inside + (size_t)b * n;
  for (int w = warp; w < nwords; w += nwarps) {
    const int i = w * 32 + lane;
    const bool in = i < n && m[i] != 0;
    const unsigned word = __ballot_sync(kFull, in);
    if (lane == 0) bits[w] = word;
  }
  __syncthreads();

  // 2. start[w] = number of in-box points before word w: each thread
  // sums a contiguous run of words, the runs are scanned over the block.
  const int chunk = (nwords + blockDim.x - 1) / blockDim.x;
  const int w0 = min(tid * chunk, nwords);
  const int w1 = min(w0 + chunk, nwords);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
  int incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < nwarps ? warp_tot[lane] : 0;
    int ti = t;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, ti, off);
      if (lane >= off) ti += o;
    }
    if (lane < nwarps) warp_tot[lane] = ti - t;  // exclusive
    if (lane == 31) s_count = ti;
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - mine;
  for (int w = w0; w < w1; ++w) {
    start[w] = run;
    run += __popc(bits[w]);
  }
  __syncthreads();
  const int cnt = s_count;
  if (tid == 0) count[b] = cnt;

  // 3. Per slot: the wanted rank, its word, its bit, its row.
  const float uf = u[b];
  const float npf = (float)np;
  const float cf = (float)cnt;
  const float shift = floorf(__fmul_rn(uf, npf));
  const float cap = fmaxf(cf, 1.0f);
  const float* p = pts + (size_t)f * n * c;
  float* o = sampled + (size_t)b * np * c;
  int* oi = idx + (size_t)b * np;
  for (int s = tid; s < np; s += blockDim.x) {
    if (cnt == 0) {
      oi[s] = -1;
      for (int ci = 0; ci < c; ++ci) o[(size_t)s * c + ci] = 0.0f;
      continue;
    }
    float slot = __fadd_rn(perm[s], shift);
    if (slot >= npf) slot = __fsub_rn(slot, npf);
    float want = __fadd_rn(
        1.0f,
        floorf(__fdiv_rn(__fmul_rn(__fadd_rn(slot, uf), cf), npf)));
    want = fminf(want, cap);
    const int r = (int)want;  // 1 <= r <= cnt
    // The last word with start < r holds rank r (start[0] = 0 < r).
    int lo = 0, hi = nwords - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] < r) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    unsigned word = bits[lo];
    for (int k = r - start[lo]; k > 1; --k) word &= word - 1;
    const int pix = lo * 32 + __ffs(word) - 1;
    oi[s] = pix;
    for (int ci = 0; ci < c; ++ci)
      o[(size_t)s * c + ci] = p[(size_t)pix * c + ci];
  }
}

}  // namespace

// pts [F, N, C] f32; inside [F, MB, N] bytes (nonzero = in the box);
// u [F, MB] f32 phases in [0, 1); perm [np] f32 slot order; outputs
// sampled [F, MB, np, C] f32, idx [F, MB, np] i32, count [F, MB] i32.
extern "C" int t3d_fetch_select(const float* pts, const unsigned char* inside,
                                const float* u, const float* perm,
                                float* sampled, int* idx, int* count, int f,
                                int mb, int n, int c, int np, void* stream) {
  if (f < 1 || mb < 1 || n < 1 || c < 1 || np < 1)
    return (int)cudaErrorInvalidValue;
  const int nwords = (n + 31) / 32;
  const size_t smem = (size_t)nwords * 2 * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fetch_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fetch_select_kernel<<<f * mb, kThreads, smem, (cudaStream_t)stream>>>(
      pts, inside, u, perm, sampled, idx, count, mb, n, c, np, nwords);
  return (int)cudaGetLastError();
}
