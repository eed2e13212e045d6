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
// What bounds it on the H100: bytes, almost all of them the mask. At a
// 480x640 depth map a frustum's mask is 307,200 bytes, at the e2e batch
// of 128 frustums 39 MB a call (12 us at 3.35 TB/s); the rows it gathers
// and the outputs are 5% of that. At 96x128 (12,288 bytes a frustum) the
// launch and the chain of dependent steps inside a block set the time.
//
// The design (the launch shape comes from `frustum_jit.fetch_select_plan`,
// which the entry point checks):
//   * a group of G blocks a frustum (G = 1 at 96x128, up to 8 at 480x640
//     with few frustums), launched as a thread-block cluster of G, so that
//     some 2 x 132 blocks of 512 threads fill the card at any frustum
//     count. Block g owns the contiguous span of words [g * span,
//     (g + 1) * span) of its frustum (a word: 32 points, one bit each);
//   * the mask is read at the card's rate: a thread loads 16 bytes at a
//     time (4 or 1 where N or the pointer is not 16-byte aligned), four
//     loads in flight before it uses one, a warp on 512 contiguous bytes,
//     evict-first; the bits are formed in registers (4 bytes -> 4 bits by
//     one compare and one multiply) and the lanes of a word OR theirs
//     together with shuffles;
//   * the words and the block-local exclusive prefix of their popcounts
//     live in shared memory (8 bytes a word: 38 KB for a 480x640 map at
//     G = 2); the block's total goes to the group through distributed
//     shared memory after one cluster barrier: each block reads the G
//     totals, so it knows the frustum's count and the ranks it owns
//     (prefix, prefix + total]. Each total has one owner and is added in
//     rank order, so every run gives the same bits;
//   * slots go to the block that owns their rank: each block walks all
//     np slots, computes `want` (cheap) and takes the slots whose rank
//     falls in its span; for them it binary-searches its own word starts
//     in its own shared memory, finds the bit with `__fns` and gathers the
//     exact row. Only the G totals cross the cluster, never a search (a
//     search through another block's shared memory is some 11 dependent
//     distributed-shared-memory round trips). A block signals that it has
//     read the totals and waits for the group only before it exits, so a
//     block's shared memory outlives every read of it;
//   * outputs are stored per slot: they are 5% of the bytes, and with
//     G > 1 the slots a block owns lie scattered over s, so staging whole
//     lines in shared memory would not make them contiguous.
// No rank tensor and no one-hot tensor is ever written to device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Phase clocks, for `scripts/torch_time_fetch.py --phases` only. Built
// with -DT3D_KERNEL_CLOCKS, thread 0 of every block adds to
// t3d_fetch_clk[i] the cycles between mark i - 1 and mark i, each mark
// after a barrier of the block (0: the mask's loads into words, 1: the
// block's scan, 2: the group's totals, 3: the slots), and counts the
// blocks in t3d_fetch_clk[7]. Otherwise the marks are empty.
#ifdef T3D_KERNEL_CLOCKS
__device__ unsigned long long t3d_fetch_clk[8];
#define T3D_FCLK_START long long fclk_prev = clock64();
#define T3D_FCLK(i)                                                  \
  __syncthreads();                                                   \
  if (threadIdx.x == 0) {                                            \
    const long long clk_now = clock64();                             \
    atomicAdd(&t3d_fetch_clk[i],                                     \
              (unsigned long long)(clk_now - fclk_prev));            \
    fclk_prev = clk_now;                                             \
  }
#define T3D_FCLK_END \
  if (threadIdx.x == 0) atomicAdd(&t3d_fetch_clk[7], 1ull);
#else
#define T3D_FCLK_START
#define T3D_FCLK(i)
#define T3D_FCLK_END
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // mask loads in flight a thread
constexpr int kMaxGroup = 8;   // the portable cluster size
// Words a block may own: 8 bytes of shared memory each (229,376 bytes);
// mirrored by frustum_jit._FETCH_MAX_SPAN.
constexpr int kMaxSpan = 28672;

// Four mask bytes -> four bits, byte 0 in bit 0 (nonzero = in the box):
// each 0/1 byte lands on its own bit of the top nibble, with no carries.
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

template <int V>
struct Chunk;

template <>
struct Chunk<16> {
  using T = uint4;
  static __device__ __forceinline__ unsigned bits(T q) {
    return nibble(q.x) | nibble(q.y) << 4 | nibble(q.z) << 8 |
           nibble(q.w) << 12;
  }
};

template <>
struct Chunk<4> {
  using T = unsigned;
  static __device__ __forceinline__ unsigned bits(T q) { return nibble(q); }
};

template <>
struct Chunk<1> {
  using T = unsigned char;
  static __device__ __forceinline__ unsigned bits(T q) { return q != 0; }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
fetch_select_kernel(const float* __restrict__ pts,
                    const unsigned char* __restrict__ inside,
                    const float* __restrict__ u,
                    const float* __restrict__ perm,
                    float* __restrict__ sampled, int* __restrict__ idx,
                    int* __restrict__ count, int mb, int n, int c, int np,
                    int group, int span) {
  using T = typename Chunk<V>::T;
  constexpr int kPerWord = 32 / V;  // lanes whose chunks make one word
  extern __shared__ unsigned smem[];
  unsigned* bits = smem;                              // [span]
  int* start = reinterpret_cast<int*>(smem + span);   // [span]
  __shared__ int warp_tot[kWarps];
  __shared__ int s_total;
  __shared__ int s_totals[kMaxGroup];

  const int b = blockIdx.x / group;  // frustum = frame * mb + box
  const int g = blockIdx.x % group;  // the block's rank in its cluster
  const int f = b / mb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  T3D_FCLK_START

  // 1. The span's mask bytes as words in shared memory. Block g owns the
  // bytes [32 * g * span, min(32 * (g + 1) * span, n)); with V > 1, n is a
  // multiple of V, so the chunks are whole.
  const int byte0 = 32 * g * span;
  const int nbytes = min(byte0 + 32 * span, n) - byte0;
  const int nw = (nbytes + 31) / 32;
  const int nchunks = (nbytes + V - 1) / V;
  const T* src = reinterpret_cast<const T*>(inside + (size_t)b * n + byte0);
  for (int base = 0; base < nchunks; base += kThreads * kUnroll) {
    T q[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int ci = base + j * kThreads + tid;
      q[j] = ci < nchunks ? __ldcs(src + ci) : T{};
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int ci = base + j * kThreads + tid;
      unsigned word;
      if constexpr (V == 1) {
        word = __ballot_sync(kFull, Chunk<V>::bits(q[j]));
      } else {
        word = Chunk<V>::bits(q[j]) << ((lane % kPerWord) * V);
#pragma unroll
        for (int off = 1; off < kPerWord; off <<= 1)
          word |= __shfl_xor_sync(kFull, word, off);
      }
      // The word's first chunk is in range whenever any of it is.
      if (lane % kPerWord == 0 && ci < nchunks) bits[ci / kPerWord] = word;
    }
  }
  __syncthreads();
  T3D_FCLK(0)

  // 2. start[w] = in-box points of the span before word w: each thread
  // sums a contiguous run of words, the runs are scanned over the block.
  const int run_len = (nw + kThreads - 1) / kThreads;
  const int w0 = min(tid * run_len, nw);
  const int w1 = min(w0 + run_len, nw);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? warp_tot[lane] : 0;
    int ti = t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, ti, off);
      if (lane >= off) ti += o;
    }
    if (lane < kWarps) warp_tot[lane] = ti - t;  // exclusive
    if (lane == 31) s_total = ti;
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - mine;
  for (int w = w0; w < w1; ++w) {
    start[w] = run;
    run += __popc(bits[w]);
  }

  T3D_FCLK(1)

  // 3. The group's totals: the frustum's count and this block's ranks.
  int cnt, before = 0;
  if (group > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's s_total written and visible
    if (tid < group) s_totals[tid] = *cluster.map_shared_rank(&s_total, tid);
    // Done with the other blocks' shared memory; wait for them at exit.
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    __syncthreads();
    cnt = 0;
    for (int j = 0; j < group; ++j) {
      if (j == g) before = cnt;
      cnt += s_totals[j];
    }
  } else {
    __syncthreads();
    cnt = s_total;
  }
  const int mine_lo = before, mine_hi = before + s_total;  // ranks (lo, hi]
  if (g == 0 && tid == 0) count[b] = cnt;
  T3D_FCLK(2)

  // 4. Per slot: the wanted rank; the block that owns it finds its word,
  // its bit and its row. An empty frustum's slots are spread over the
  // group by s.
  const float uf = u[b];
  const float npf = (float)np;
  const float cf = (float)cnt;
  const float shift = floorf(__fmul_rn(uf, npf));
  const float cap = fmaxf(cf, 1.0f);
  const float* p = pts + (size_t)f * n * c;
  float* o = sampled + (size_t)b * np * c;
  int* oi = idx + (size_t)b * np;
  for (int s = tid; s < np; s += kThreads) {
    if (cnt == 0) {
      if (s % group == g) {
        oi[s] = -1;
        for (int ci = 0; ci < c; ++ci) o[(size_t)s * c + ci] = 0.0f;
      }
      continue;
    }
    float slot = __fadd_rn(perm[s], shift);
    if (slot >= npf) slot = __fsub_rn(slot, npf);
    float want = __fadd_rn(
        1.0f,
        floorf(__fdiv_rn(__fmul_rn(__fadd_rn(slot, uf), cf), npf)));
    want = fminf(want, cap);
    const int r = (int)want;  // 1 <= r <= cnt
    if (r <= mine_lo || r > mine_hi) continue;
    const int rl = r - mine_lo;  // 1 <= rl <= s_total
    // The last word with start < rl holds the rank (start[0] = 0 < rl).
    int lo = 0, hi = nw - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] < rl) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int pix = (g * span + lo) * 32 + (int)__fns(bits[lo], 0u,
                                                      rl - start[lo]);
    oi[s] = pix;
    for (int ci = 0; ci < c; ++ci)
      o[(size_t)s * c + ci] = p[(size_t)pix * c + ci];
  }
  T3D_FCLK(3)
  T3D_FCLK_END
  if (group > 1)
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <int V>
cudaError_t launch(const float* pts, const unsigned char* inside,
                   const float* u, const float* perm, float* sampled,
                   int* idx, int* count, int frustums, int mb, int n, int c,
                   int np, int group, int span, cudaStream_t stream) {
  const size_t smem = (size_t)span * 2 * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fetch_select_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(frustums * group);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = group;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = group > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fetch_select_kernel<V>, pts, inside, u,
                            perm, sampled, idx, count, mb, n, c, np, group,
                            span);
}

}  // namespace

// pts [F, N, C] f32; inside [F, MB, N] bytes (nonzero = in the box);
// u [F, MB] f32 phases in [0, 1); perm [np] f32 slot order; outputs
// sampled [F, MB, np, C] f32, idx [F, MB, np] i32, count [F, MB] i32.
// The plan (frustum_jit.fetch_select_plan): `group` blocks a frustum,
// each owning `span` 32-point words, the last one at least one; `vec`
// mask bytes a load (16, 4 or 1), which N and `inside` must be aligned
// to.
extern "C" int t3d_fetch_select(const float* pts, const unsigned char* inside,
                                const float* u, const float* perm,
                                float* sampled, int* idx, int* count, int f,
                                int mb, int n, int c, int np, int group,
                                int span, int vec, void* stream) {
  if (f < 1 || mb < 1 || n < 1 || c < 1 || np < 1)
    return (int)cudaErrorInvalidValue;
  const int nwords = (n + 31) / 32;
  if (group < 1 || group > kMaxGroup || span < 1 || span > kMaxSpan ||
      (long long)group * span < nwords || (group - 1) * span >= nwords)
    return (int)cudaErrorInvalidValue;
  if ((vec != 16 && vec != 4 && vec != 1) || n % vec != 0 ||
      reinterpret_cast<size_t>(inside) % vec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (vec == 16) {
    e = launch<16>(pts, inside, u, perm, sampled, idx, count, f * mb, mb, n,
                   c, np, group, span, st);
  } else if (vec == 4) {
    e = launch<4>(pts, inside, u, perm, sampled, idx, count, f * mb, mb, n,
                  c, np, group, span, st);
  } else {
    e = launch<1>(pts, inside, u, perm, sampled, idx, count, f * mb, mb, n,
                  c, np, group, span, st);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#ifdef T3D_KERNEL_CLOCKS
// Copies K15's phase clocks to `out` (8 values) and sets them to zero.
extern "C" int t3d_fetch_select_clocks(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, t3d_fetch_clk, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(t3d_fetch_clk, zero, sizeof(zero));
  return (int)e;
}
#endif
