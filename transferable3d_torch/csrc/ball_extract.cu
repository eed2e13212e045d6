// Ball-query extraction and its backward for Hopper (sm_90a): kernels K3
// and K4 of the port.
//
// Replaces the Pallas TPU kernels `_extract_fwd_kernel` (K3) and
// `_extract_bwd_kernel` (K4) of transferable3d_tpu/ops/grouping.py, the
// forward and backward of its custom-VJP `ball_query_extract`, which the
// unfused set-abstraction path (T3D_FUSED_SA=0, and every scale that
// `fused_sa.fused_route` sends there) runs at every grouped SA scale.
//
// What they compute, for centroid s of batch row b, with the members of
// ball_select.cuh (direct-form d2, first K in radius by index, the nearest
// point for an empty ball) and eff = clip(count, 1, K):
//   K3: out[b, s, k, :] = payload[b, sel[k mod eff], :], copied bit for
//       bit, and count[b, s] = the true in-radius count (0 when empty);
//   K4: dpay[b, n, :] = bf16(sum over every (s, k) whose slot took n of
//       f32(dg[b, s, k, :])), summed in f32 from +0.0 in ascending (s, k)
//       and rounded to bf16 once: the order in which the plain twin's
//       `index_add_` adds on the CPU, so the two agree bit for bit.
// The TPU kernels' one-hot MXU contraction, lane prefix sums and `+0.25`
// reciprocal bias are TPU workarounds and are not carried over.
//
// What bounds them: K3 writes [B, S, K, C] bf16 (268 MB at seg-SA1 scale
// 3, S=128 K=128 C=64 B=128) and K4 reads the same amount, so both are
// bound by device-memory bandwidth; the query reads 12 KB of xyz a
// centroid, from L2.
//
// K3: one warp a centroid (8 warps a block, each with its list of K
// members in shared memory). The query is ball_select.cuh's warp scan,
// 128 points a step over all N (the count is the true one). A lane moves
// 8 channels of a row as one 16-byte access (one bf16 where C is not a
// multiple of 8 or a row is not 16-byte aligned); each distinct member's
// row is loaded once and stored, evict-first (`st.global.cs`: the rows
// stream past the L2), to every slot that takes it, a centroid's K rows
// being contiguous. Row i of the P rows that fill whole warp steps holds
// member i mod eff, kept by adding the step's rows mod eff: no divide or
// modulo an access.
//
// K4: the owner of each element computes it, with no atomics and no
// workspace to clear, in two launches:
//   (a) membership, one warp a centroid: the same warp scan, stopped at
//       the K-th member, writes for every 32-point word of the batch row
//       its members' bits and the number of members in the words before
//       it (the rank of its first member), as `uint2` [B, N/32, S], and
//       eff [B, S]; an empty ball's word holds its nearest point;
//   (b) gather, a block for (b, one word of 32 points, up to 64 channels),
//       over passes of 128 centroids: the block loads its word of each
//       centroid and turns the 32 x 32 bit blocks around with ballots, so
//       that each point has the bits of the centroids that took it; a
//       point's rank r in a ball is a popcount, its slots r, r + eff, ...
//       < K. Each warp takes 4 points (8 at C = 32): its stream is their
//       slots, point after point and each point's in ascending (s, k).
//       The warp walks a point's memberships together, its lanes list the
//       slots' rows, and the listed rows come in as 16-byte cp.async
//       copies, 4 rows of 16 bytes a lane a batch through two buffers of
//       the warp's own, the next batch in flight while the lanes that own
//       (point n, 8 channels) add their point's rows of this one in order
//       into f32 registers; one bf16 store at the end.
//       A point's slots are a serial chain (the order is the result), and
//       short balls, whose one member takes all K slots, make long ones:
//       every lane of the warp loads the chain's rows, so a chain costs
//       adds from shared memory, not round trips to device memory; and no
//       block barrier follows the words, so the warps of the 4 blocks an
//       SM holds hide each other's latency.
// Every dg row is read once (each slot takes one point), the element's
// sum has one owner and one order, and the result is the same bits on
// every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ball_select.cuh"
#include "tile_ops.cuh"

// Phase clocks, for `scripts/torch_time_sa_fwd.py --phases` only. Built
// with -DT3D_KERNEL_CLOCKS, thread 0 of every block of K4's gather adds to
// t3d_gather_clk[i] the cycles it spent between mark i - 1 and mark i (0:
// a pass's words and their transposes, 1: warp 0's stream in the pass)
// and counts the blocks in t3d_gather_clk[7]. Otherwise the marks are
// empty.
#ifdef T3D_KERNEL_CLOCKS
__device__ unsigned long long t3d_gather_clk[8];
#define T3D_GCLK_START long long gclk_prev = clock64();
#define T3D_GCLK(i)                                                  \
  if (threadIdx.x == 0) {                                            \
    const long long clk_now = clock64();                             \
    atomicAdd(&t3d_gather_clk[i],                                    \
              (unsigned long long)(clk_now - gclk_prev));            \
    gclk_prev = clk_now;                                             \
  }
#define T3D_GCLK_END \
  if (threadIdx.x == 0) atomicAdd(&t3d_gather_clk[7], 1ull);
#else
#define T3D_GCLK_START
#define T3D_GCLK(i)
#define T3D_GCLK_END
#endif

namespace {

typedef __nv_bfloat16 bf16;

// Largest K: K3 keeps a warp's K members in shared memory, within the
// 48 KB a launch gets without opting in (3 warps a block at K = 4096).
constexpr int kMaxK = 4096;
constexpr int kFwdMaxWarps = 8;
constexpr int kListBytes = 48 * 1024;
constexpr int kMemWarps = 8;
// K4's gather: centroids a pass of the block (their words, ranks and eff
// in shared memory), chunks of 16 bytes a row slot (warps a block), a
// warp's list of slot rows, and its 16-byte loads in flight a lane.
constexpr int kSChunk = 128;
constexpr int kMaxChunks = 8;
constexpr int kList = 256;
constexpr int kRowLoads = 4;
constexpr int kBufs = 2;

int fwd_warps(int k) {
  const int w = kListBytes / (k * 4);
  return w < 1 ? 1 : (w > kFwdMaxWarps ? kFwdMaxWarps : w);
}

// ---------------------------------------------------------------- K3 -----

struct FwdArgs {
  const float* cent;  // [B * S, 3]
  const float* xyz;   // [B, N, 3]
  const bf16* pay;    // [B, N, C]
  bf16* out;          // [B * S, K, C]
  int* count;         // [B * S]
  int ncent, S, N, K, C;
  float r2;
};

// One access of V channels (V = 8: 16 bytes; V = 1: one bf16) stored to
// `nslot` slot rows `step` elements apart.
template <int V>
__device__ __forceinline__ void copy_chunk(const bf16* __restrict__ src,
                                           bf16* dst, size_t step,
                                           int nslot) {
  if constexpr (V == 8) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
    for (int t = 0; t < nslot; ++t)
      __stcs(reinterpret_cast<uint4*>(dst + (size_t)t * step), x);
  } else {
    const unsigned short x =
        __ldg(reinterpret_cast<const unsigned short*>(src));
    for (int t = 0; t < nslot; ++t)
      __stcs(reinterpret_cast<unsigned short*>(dst + (size_t)t * step), x);
  }
}

template <int V>
__global__ void __launch_bounds__(kFwdMaxWarps * 32)
extract_fwd_kernel(FwdArgs p) {
  extern __shared__ int lists[];  // [warps][K]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= p.ncent) return;  // a whole warp: no block barrier follows
  const int K = p.K, C = p.C, b = c / p.S;
  int* list = lists + (size_t)warp * K;
  const float* pts = p.xyz + (size_t)b * p.N * 3;
  const float cx = p.cent[(size_t)c * 3 + 0];
  const float cy = p.cent[(size_t)c * 3 + 1];
  const float cz = p.cent[(size_t)c * 3 + 2];
  int count = 0;
  for (int base = 0; base < p.N; base += 4 * 32)
    count = t3d::ball_warp_scan<4>(pts, base, p.N, cx, cy, cz, p.r2, K,
                                   count, list, nullptr);
  int eff = min(count, K);
  if (count == 0) {
    const int nearest = t3d::ball_warp_nearest_of(pts, p.N, cx, cy, cz);
    if (lane == 0) list[0] = min(nearest, p.N - 1);
    eff = 1;
  }
  if (lane == 0) p.count[c] = count;
  __syncwarp();

  // A row is C / V accesses; L lanes (C / V rounded up to a power of two,
  // at most 32) take a row, so rpw = 32 / L rows move in a warp step. Rows
  // 0 .. P - 1 with P = eff (eff >= rpw) or the least multiple of eff that
  // fills a warp step: row i holds member i mod eff and goes to the slots
  // i, i + P, ... < K.
  const int cpr = C / V;
  int lg = 0;
  while ((1 << lg) < cpr && lg < 5) ++lg;
  const int L = 1 << lg, rpw = 32 >> lg;
  const int j0 = lane & (L - 1), rg = lane >> lg;
  const int P = eff >= rpw ? eff : eff * ((rpw + eff - 1) / eff);
  const int rows = min(P, K), qp = K / P, rp = K - qp * P;
  const int dm = rpw % eff;
  int m = rg % eff;  // member of row i, i = rg, rg + rpw, ...
  const bf16* src = p.pay + (size_t)b * p.N * C;
  bf16* dst = p.out + (size_t)c * K * C;
  const size_t step = (size_t)P * C;
  for (int i = rg; i < rows; i += rpw) {
    const bf16* row = src + (size_t)list[m] * C;
    bf16* d = dst + (size_t)i * C;
    const int nslot = qp + (i < rp);
    for (int g = j0 * V; g < C; g += L * V)
      copy_chunk<V>(row + g, d + g, step, nslot);
    m += dm;
    if (m >= eff) m -= eff;
  }
}

// ---------------------------------------------------------------- K4 -----

struct MembersArgs {
  const float* cent;  // [B * S, 3]
  const float* xyz;   // [B, N, 3]
  uint2* words;       // [B, ceil(N / 32), S]: members' bits, rank of the first
  int* eff;           // [B * S]
  int ncent, S, N, K;
  float r2;
};

// (a) One warp a centroid.
__global__ void __launch_bounds__(kMemWarps * 32)
extract_members_kernel(MembersArgs p) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kMemWarps + (threadIdx.x >> 5);
  if (c >= p.ncent) return;
  const int K = p.K, b = c / p.S, s = c - b * p.S;
  const int nw = (p.N + 31) >> 5;
  uint2* out = p.words + (size_t)b * nw * p.S + s;  // word w at out[w * S]
  const float* pts = p.xyz + (size_t)b * p.N * 3;
  const float cx = p.cent[(size_t)c * 3 + 0];
  const float cy = p.cent[(size_t)c * 3 + 1];
  const float cz = p.cent[(size_t)c * 3 + 2];
  int count = 0, base = 0;
  for (; base < p.N && count < K; base += 4 * 32) {
    unsigned words[4];
    const int before = count;
    count = t3d::ball_warp_scan<4>(pts, base, p.N, cx, cy, cz, p.r2, K,
                                   count, nullptr, words);
    // lane u < 4 writes word u of the step with the members before it
    unsigned mine = 0u;
    int pre = before, mine_pre = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (lane == u) {
        mine = words[u];
        mine_pre = pre;
      }
      pre += __popc(words[u]);
    }
    const int w = (base >> 5) + lane;
    if (lane < 4 && w < nw)
      out[(size_t)w * p.S] = make_uint2(mine, (unsigned)mine_pre);
  }
  // past the K-th member: no member in the remaining words
  for (int w = (base >> 5) + lane; w < nw; w += 32)
    out[(size_t)w * p.S] = make_uint2(0u, (unsigned)K);
  if (count == 0) {
    const int nearest =
        min(t3d::ball_warp_nearest_of(pts, p.N, cx, cy, cz), p.N - 1);
    __syncwarp();  // after the zero word that another lane wrote there
    if (lane == 0)
      out[(size_t)(nearest >> 5) * p.S] =
          make_uint2(1u << (nearest & 31), 0u);
  }
  if (lane == 0) p.eff[c] = count == 0 ? 1 : min(count, K);
}

struct GatherArgs {
  const uint2* words;  // as written by extract_members_kernel
  const int* eff;
  const bf16* dg;      // [B, S, K, C]
  bf16* dpay;          // [B, N, C]
  int S, N, K, C;
  int cpb;             // chunks a row slot of a warp, and warps a block
};

// V channels of one dg row: one 16-byte load (V = 8) or one bf16.
template <int V>
struct Chunk;

template <>
struct Chunk<8> {
  typedef uint4 T;
  // dg's 16 bytes at p into shared memory, asynchronously (cp.async.cg:
  // through the L2 only)
  __device__ __forceinline__ static void stage(T* dst, const bf16* p) {
    t3d::cp16(dst, p);
  }
  __device__ __forceinline__ static void add(float* acc, T x) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = t3d::unpack2(w[i]);
      acc[2 * i] = __fadd_rn(acc[2 * i], f.x);
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], f.y);
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float* acc) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        t3d::pack2(acc[0], acc[1]), t3d::pack2(acc[2], acc[3]),
        t3d::pack2(acc[4], acc[5]), t3d::pack2(acc[6], acc[7]));
  }
};

template <>
struct Chunk<1> {
  typedef unsigned short T;
  __device__ __forceinline__ static void stage(T* dst, const bf16* p) {
    *dst = __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static void add(float* acc, T x) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float((unsigned)x << 16));
  }
  __device__ __forceinline__ static void store(bf16* p, const float* acc) {
    p[0] = __float2bfloat16_rn(acc[0]);
  }
};

// (b) Block (word w, batch row b, channel group z) of cpb warps. Lane l of
// warp v is (point v * R + l / cpb, chunk z * cpb + l % cpb), cpb chunks a
// row (a power of two, 8 for C >= 64), R = 32 / cpb points a warp, so that
// a warp instruction moves R rows. A warp's slots, its points one after
// the other and each point's in ascending (s, k), form its stream: the
// warp walks each point's memberships (the same for every lane) and lists
// the slots' rows, the lanes each taking slots of a membership, kList at a
// time; then it loads the listed rows kRowLoads * R at a time (kRowLoads
// 16-byte loads in flight a lane) through its own shared memory, and each
// lane adds its point's rows of the batch in stream order. Only the
// centroids' words need the whole block (a barrier a pass).
template <int V>
struct Stream {
  typedef typename Chunk<V>::T T;
  const int* list;
  T* stage;
  const bf16* dg0;
  int C, cpb, rows, lane, rg, gl;
  bool chunk;

  // The listed rows [0, fill), at stream places pos.. ; the lane adds those
  // in [a, b) (its point's, b = INT_MAX while the point is being listed).
  // Batches of kRowLoads * R rows go through a ring of kBufs buffers: the
  // copies of the next kBufs - 1 batches fly while the lanes add one.
  __device__ __forceinline__ void copy(int bi, int fill) const {
    T* buf = stage + (bi % kBufs) * kRowLoads * 32;
    const int t = bi * kRowLoads * rows;
#pragma unroll
    for (int q = 0; q < kRowLoads; ++q) {
      const int row = t + q * rows + rg;
      if (chunk && row < fill)
        Chunk<V>::stage(buf + q * 32 + lane, dg0 + (size_t)list[row] * C);
    }
  }

  __device__ __forceinline__ void drain(int fill, int pos, int a, int b,
                                        float (&acc)[V]) const {
    const int batch = kRowLoads * rows, nb = (fill + batch - 1) / batch;
    for (int bi = 0; bi < kBufs - 1; ++bi) {
      if (bi < nb) copy(bi, fill);
      t3d::cp_commit();
    }
    for (int bi = 0; bi < nb; ++bi) {
      if (bi + kBufs - 1 < nb) copy(bi + kBufs - 1, fill);
      t3d::cp_commit();
      t3d::cp_wait<kBufs - 1>();
      __syncwarp();
      const T* buf = stage + (bi % kBufs) * kRowLoads * 32;
      const int t = bi * batch;
      if (chunk) {
        const int lo = max(a - pos, t);
        const int hi = min(min(b - pos, fill), t + batch);
#pragma unroll 8
        for (int r = lo; r < hi; ++r)
          Chunk<V>::add(acc, buf[(r - t) * cpb + gl]);
      }
      __syncwarp();  // the buffer takes a later batch
    }
  }
};

template <int V>
__global__ void __launch_bounds__(kMaxChunks * 32, 4)
extract_gather_kernel(GatherArgs p) {
  typedef typename Chunk<V>::T T;
  __shared__ unsigned s_word[kSChunk];
  __shared__ int s_pre[kSChunk], s_eff[kSChunk], s_kq[kSChunk],
      s_km[kSChunk];
  __shared__ unsigned s_pts[32][kSChunk / 32 + 1];  // [point][s group]
  __shared__ int s_list[kMaxChunks][kList];
  extern __shared__ __align__(16) unsigned char g_stage[];  // per warp:
  T* stage = reinterpret_cast<T*>(g_stage);  // [kBufs][kRowLoads * 32]
  const int w = blockIdx.x, b = blockIdx.y, cpb = p.cpb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = 32 / cpb, rg = lane / cpb, gl = lane - rg * cpb;
  const int g = blockIdx.z * cpb + gl;
  const int K = p.K, C = p.C, nw = (p.N + 31) >> 5;
  const int pt0 = warp * rows;  // the warp's first point in the word
  const int n = w * 32 + pt0 + rg;
  Stream<V> st{s_list[warp], stage + warp * kBufs * kRowLoads * 32, nullptr,
               C, cpb, rows, lane, rg, gl, g * V < C};
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  const uint2* wsrc = p.words + ((size_t)b * nw + w) * p.S;
  T3D_GCLK_START
  for (int s0 = 0; s0 < p.S; s0 += kSChunk) {
    const int sc = min(kSChunk, p.S - s0), ng = (sc + 31) >> 5;
    __syncthreads();  // the previous pass has read the shared arrays
    for (int i = threadIdx.x; i < sc; i += blockDim.x) {
      const uint2 m = wsrc[s0 + i];
      const int e = p.eff[(size_t)b * p.S + s0 + i];
      s_word[i] = m.x;
      s_pre[i] = (int)m.y;
      s_eff[i] = e;
      s_kq[i] = K / e;  // rank r takes K / eff + (r < K mod eff) slots
      s_km[i] = K - (K / e) * e;
    }
    __syncthreads();
    // bit q of centroid (32 j + l)'s word -> bit l of point q's group j
    for (int j = warp; j < ng; j += blockDim.x >> 5) {
      const unsigned x = j * 32 + lane < sc ? s_word[j * 32 + lane] : 0u;
      unsigned mine = 0u;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const unsigned t = __ballot_sync(t3d::kFullMask, (x >> q) & 1u);
        if (lane == q) mine = t;
      }
      s_pts[lane][j] = mine;
    }
    __syncthreads();
    T3D_GCLK(0)
    st.dg0 = p.dg + ((size_t)b * p.S + s0) * K * C + g * V;
    int* list = s_list[warp];
    int fill = 0, pos = 0, a = INT_MAX, bnd = INT_MAX;
    for (int u = 0; u < rows && w * 32 + pt0 + u < p.N; ++u) {
      const int pt = pt0 + u;
      const unsigned below = (1u << pt) - 1u;
      if (u == rg) a = pos + fill;
      for (int j = 0; j < ng; ++j) {
        for (unsigned bits = s_pts[pt][j]; bits; bits &= bits - 1u) {
          const int i = j * 32 + __ffs(bits) - 1;
          const int r = s_pre[i] + __popc(s_word[i] & below);
          const int e = s_eff[i], cnt = s_kq[i] + (r < s_km[i]);
          const int row0 = i * K + r;
          for (int j0 = 0; j0 < cnt;) {
            const int take = min(cnt - j0, kList - fill);
            for (int q = lane; q < take; q += 32)
              list[fill + q] = row0 + (j0 + q) * e;
            fill += take;
            j0 += take;
            if (fill == kList) {
              __syncwarp();
              st.drain(fill, pos, a, bnd, acc);
              pos += fill;
              fill = 0;
            }
          }
        }
      }
      if (u == rg) bnd = pos + fill;
    }
    __syncwarp();
    st.drain(fill, pos, a, bnd, acc);
    T3D_GCLK(1)
  }
  T3D_GCLK_END
  if (n < p.N && st.chunk)
    Chunk<V>::store(p.dpay + ((size_t)b * p.N + n) * C + g * V, acc);
}

bool bad_shape(int b, int s, int n, int k, int c) {
  return b < 1 || s < 1 || n < 1 || k < 1 || c < 1 || b > 65535 ||
         k > kMaxK || (long long)b * s > INT_MAX ||
         (long long)b * s * k * c > LLONG_MAX / 2;
}

}  // namespace

extern "C" int t3d_extract_fwd(const float* cent, const float* xyz,
                               const void* pay, void* out, int* count, int b,
                               int s, int n, int k, int c, float r2,
                               void* stream) {
  if (bad_shape(b, s, n, k, c)) return (int)cudaErrorInvalidValue;
  const bool vec = c % 8 == 0 && (uintptr_t)pay % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int warps = fwd_warps(k);
  FwdArgs a;
  a.cent = cent;
  a.xyz = xyz;
  a.pay = static_cast<const bf16*>(pay);
  a.out = static_cast<bf16*>(out);
  a.count = count;
  a.ncent = b * s;
  a.S = s;
  a.N = n;
  a.K = k;
  a.C = c;
  a.r2 = r2;
  const int grid = (a.ncent + warps - 1) / warps;
  const size_t smem = (size_t)warps * k * 4;
  auto kern = vec ? extract_fwd_kernel<8> : extract_fwd_kernel<1>;
  kern<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// members: scratch of B * ceil(N / 32) * S * 8 + B * S * 4 bytes
// (`extract_members_bytes` in ops/grouping.py), written before it is read.
extern "C" int t3d_extract_bwd(const float* cent, const float* xyz,
                               const void* dg, void* members, void* dpay,
                               int b, int s, int n, int k, int c, float r2,
                               void* stream) {
  if (bad_shape(b, s, n, k, c)) return (int)cudaErrorInvalidValue;
  const int nw = (n + 31) / 32;
  const bool vec = c % 8 == 0 && (uintptr_t)dg % 16 == 0 &&
                   (uintptr_t)dpay % 16 == 0;
  const int cpr = vec ? c / 8 : c;
  int cpb = 1;  // chunks a row slot of a warp: a power of two, at most 8
  while (cpb < cpr && cpb < kMaxChunks) cpb *= 2;
  const int groups = (cpr + cpb - 1) / cpb;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MembersArgs m;
  m.cent = cent;
  m.xyz = xyz;
  m.words = static_cast<uint2*>(members);
  m.eff = reinterpret_cast<int*>(m.words + (size_t)b * nw * s);
  m.ncent = b * s;
  m.S = s;
  m.N = n;
  m.K = k;
  m.r2 = r2;
  extract_members_kernel<<<(m.ncent + kMemWarps - 1) / kMemWarps,
                           kMemWarps * 32, 0, st>>>(m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  GatherArgs a;
  a.words = m.words;
  a.eff = m.eff;
  a.dg = static_cast<const bf16*>(dg);
  a.dpay = static_cast<bf16*>(dpay);
  a.S = s;
  a.N = n;
  a.K = k;
  a.C = c;
  a.cpb = cpb;
  auto kern = vec ? extract_gather_kernel<8> : extract_gather_kernel<1>;
  const size_t stage = (size_t)cpb * kBufs * kRowLoads * 32 * (vec ? 16 : 2);
  if (stage > 32 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)stage);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(nw, b, groups), cpb * 32, stage, st>>>(a);
  return (int)cudaGetLastError();
}

#ifdef T3D_KERNEL_CLOCKS
// Copies K4's gather phase clocks to `out` (8 values) and sets them to zero.
extern "C" int t3d_extract_bwd_clocks(unsigned long long* out) {
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, t3d_gather_clk, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(t3d_gather_clk, zero, sizeof(zero));
  return (int)e;
}
#endif
