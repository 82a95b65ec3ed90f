// The MPPI control update, for Hopper (sm_90a): the softmax weights of the
// K rollout costs and the weighted noise sum, a cluster of C blocks a
// (chunk of kSteps steps, scenario b).
//
// Replaces the JAX package's XLA-fused update_useq
// (mppi_numba_tpu/ops/update.py:23-55; no Pallas kernel), some dozen
// torch launches in the port before.  Per scenario b:
//
//   beta   = min_k cost[b, k]                  (a NaN propagates, as in
//                                               torch.min)
//   w_k    = expf(-(cost[b, k] - beta) / lambda[b])
//   eta    = tree_k w_k ;  w_k <- w_k / eta     (weights[b, k])
//   du_c   = tree_k w_k * noise[b, k, t, c]
//   u'     = clamp(u[b, t, c] + du_c) to vrange[b] (c = 0) / wrange[b]
//            (c = 1), as torch.clamp does it (NaN first)
//
// "tree" is the halving tree of tree_sum.cuh, the order of the plain
// version (ops/kernels/update_useq.py), which this equals bit for bit: an
// IEEE division, full-precision expf (no __expf, no fast math), as torch's
// CUDA exp computes it, and -fmad=false.  beta's zero sign cannot change a
// weight (c - 0.0 and c - -0.0 round alike, and exp(+-0) = 1), so the
// minimum is taken on order keys, NaN first, one redux a warp.
//
// Bound: the bytes, the costs, the noise and u read once and u' and the
// weights written once (at K = 1024, T = 100: some 0.8 MB, 0.25 us at HBM
// rate).  What holds a launch back at one scenario is latency: a chain of
// reductions, each a few barriers, before the noise sum can start.  So:
//
// - A tree position's bits are [register index a | thread]: thread tid of
//   a block of W holds positions a * W + tid, a < A = L / W (L >=
//   next_pow2(K)), and the tree's levels run in its registers (pairwise,
//   in bit-reversed order of a); then, after one barrier, each warp that
//   needs the sum reads the block's W partial sums (W / 32 a lane), runs
//   the levels over them in registers and the last five through xor
//   shuffles.
// - The chunk's noise sum is spread over a cluster of C blocks
//   (ops/kernels/update_useq.py::launch_shape picks W and C): block q
//   multiplies only the rows a = i * C + q, i < R = A / C, so a's bits are
//   [i | q]; the levels over i run in its registers, those over q through
//   distributed shared memory (block q finishing the columns j with
//   j % C == q from every block's partial sums), then its block and warps.
// - The noise does not wait for the weights: the block copies its rows'
//   32 contiguous bytes (kSteps steps x 2; a warp's copy 8 whole rows)
//   into shared memory with cp.async at the start, so the loads overlap
//   beta and eta, which every block derives from all K costs (4-40 KB
//   from L2) itself: no cluster barrier before the noise sum.
// - Barriers: one for beta, one for eta, two for the staged noise (landed,
//   read), two of the cluster (the partial sums published, and the last
//   remote read done before a block exits).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tree_sum.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlock = 512;
constexpr int kSteps = 4;            // steps a block
constexpr int kCols = 2 * kSteps;    // its (t, c) columns

// Unsigned order of floats with every NaN first: key 0 is a NaN's.
__device__ __forceinline__ uint32_t min_key(float x) {
  if (isnan(x)) return 0u;
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float min_value(uint32_t k) {
  if (k == 0u) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// torch.clamp(v, lo, hi) on CUDA tensors (aten's clamp_kernel_cuda).
__device__ __forceinline__ float clamp_like_torch(float v, float lo,
                                                  float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// Leaves pushed in order i = 0 .. N - 1 (N a power of two, i a constant
// after unrolling) summed pairwise: i with i ^ 1, then pairs of pairs, ...;
// acc[log2 N] ends as the sum.  Held in bit-reversed order (leaf i the
// position bit_reverse(i)), that is the halving tree's order over them.
template <int N, int COLS>
struct Pairwise {
  static constexpr int kLog = tree::ilog2(N);
  float acc[kLog + 1][COLS];

  __device__ __forceinline__ void push(int i, float (&leaf)[COLS]) {
    bool carry = true;
#pragma unroll
    for (int l = 0; l < kLog; ++l) {
      if (carry && ((i >> l) & 1)) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) leaf[j] = acc[l][j] + leaf[j];
      } else if (carry) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[l][j] = leaf[j];
        carry = false;
      }
    }
    if (carry) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[kLog][j] = leaf[j];
    }
  }
};

template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// Every lane of a warp: the halving tree's sum of the W positions lane +
// 32 m (m < W / 32) that get(position) reads, padded with -0.0 to
// kMaxBlock: levels over m in registers, then xor shuffles (each lane
// adds the same pairs, in either order).
template <class Get>
__device__ __forceinline__ float warp_tree(Get get, int W, int lane) {
  constexpr int kM = kMaxBlock / 32;
  float y[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) y[m] = 32 * m < W ? get(lane + 32 * m) : -0.0f;
  tree::halve<kM>(y);
  float x = y[0];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    x = x + __shfl_xor_sync(tree::kFull, x, o);
  return x;
}

// A: positions a thread of all L = A * blockDim.x; C: the cluster's blocks.
template <int A, int C>
__global__ void __launch_bounds__(kMaxBlock)
update_useq_kernel(const float* __restrict__ costs,
                   const float* __restrict__ noise,
                   const float* __restrict__ u,
                   const float* __restrict__ lam,
                   const float* __restrict__ vrange,
                   const float* __restrict__ wrange,
                   float* __restrict__ u_out, float* __restrict__ weights,
                   int K, int T) {
  constexpr int R = A / C;           // the block's own rows a thread
  constexpr int kMine = kCols / C;   // the columns the block finishes
  constexpr bool kHeld = A <= 32;    // the costs stay in registers
  extern __shared__ __align__(16) float smem[];
  __shared__ float sh[kMaxBlock];
  __shared__ uint32_t warp_min[kMaxBlock / 32];
  const int W = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = static_cast<int>(blockIdx.x) % C;  // rank in the cluster
  const int t0 = static_cast<int>(blockIdx.x) / C * kSteps;
  const int b = blockIdx.y;
  const int cols = min(kCols, 2 * (T - t0));
  // R x W rows of kCols noise values, then (once every row is read) the
  // kCols x W partial sums: one region, so a block of a 4-row shape fits
  // six to an SM.
  float* stage = smem;
  float* part = smem;
  const float* cb = costs + static_cast<size_t>(b) * K;

  // The costs first (beta and eta wait on them), then the own rows'
  // noise, in flight while the weights are derived: row (i, t) of the
  // block (rollout (i * C + q) * W + t) is four 8-byte pieces; copy s of
  // thread tid takes piece tid % 4 of row (s / 4, (s % 4) W / 4 + tid /
  // 4), so a warp's copy covers 8 rows' 32 contiguous bytes.
  float c[kHeld ? A : 1];
  if constexpr (kHeld) {
#pragma unroll
    for (int a = 0; a < A; ++a)
      c[a] = a * W + tid < K ? cb[a * W + tid] : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < 4 * R; ++s) {
    const int i = s >> 2, t = (s & 3) * (W >> 2) + (tid >> 2);
    const int j = 2 * (tid & 3), k = (i * C + q) * W + t;
    if (k < K && j < cols)
      __pipeline_memcpy_async(
          stage + (i * W + t) * kCols + j,
          noise + (static_cast<size_t>(b) * K + k) * T * 2 + 2 * t0 + j, 8);
  }
  __pipeline_commit();

  // beta over all K: in registers, a redux a warp, then the warps.
  uint32_t mk = ~0u;  // no float's key
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int k = a * W + tid;
    if constexpr (kHeld) {
      if (k < K) mk = min(mk, min_key(c[a]));
    } else {
      if (k < K) mk = min(mk, min_key(cb[k]));
    }
  }
  mk = __reduce_min_sync(tree::kFull, mk);
  if (lane == 0) warp_min[warp] = mk;
  __syncthreads();
  mk = warp_min[0];
  for (int i = 1; i < (W >> 5); ++i) mk = min(mk, warp_min[i]);
  const float beta = min_value(mk);

  // eta over all K: the levels over a in registers, then every warp the
  // block's (one barrier).  The own rows' weights are kept.  Past 32
  // positions a thread the costs are read again (L1), not held.
  const float lam_b = lam[b];
  Pairwise<A, 1> eta_part;
  float own[R];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int a = tree::bit_reverse<A>(i), k = a * W + tid;
    float ca;
    if constexpr (kHeld) {
      ca = c[a];
    } else {
      ca = k < K ? __ldcg(cb + k) : 0.0f;
    }
    float leaf[1] = {k < K ? expf(-(ca - beta) / lam_b) : -0.0f};
    if (a % C == q) own[a / C] = leaf[0];
    eta_part.push(i, leaf);
  }
  sh[tid] = eta_part.acc[Pairwise<A, 1>::kLog][0];
  __syncthreads();
  const float eta = warp_tree([&](int p) { return sh[p]; }, W, lane);

  // The own rows' weights (the first chunk's blocks write them) times
  // their noise, each column's levels over i in registers.
  __pipeline_wait_prior(0);
  __syncthreads();  // every thread's copies have landed
  Pairwise<R, kCols> col;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int ri = tree::bit_reverse<R>(i);
    const int k = (ri * C + q) * W + tid;
    float w = -0.0f;
    if (k < K) {
      w = own[ri] / eta;
      if (t0 == 0) weights[static_cast<size_t>(b) * K + k] = w;
    }
    const float* row = stage + (ri * W + tid) * kCols;
    float leaf[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      leaf[j] = k < K && j < cols ? w * row[j] : -0.0f;
    col.push(i, leaf);
  }
  __syncthreads();  // every staged row is read
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    part[j * W + tid] = col.acc[Pairwise<R, kCols>::kLog][j];
  cluster_sync<C>();

  // Block q finishes columns q, q + C, ..., a warp a column: the levels
  // over the cluster's ranks from every block's partial sums (distributed
  // shared memory), then over the block's threads.
  const float* ranks[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    if constexpr (C == 1) {
      ranks[r] = part;
    } else {
      ranks[r] = cg::this_cluster().map_shared_rank(part, r);
    }
  }
  for (int jj = warp; jj < kMine; jj += W >> 5) {  // warp-uniform
    const int j = jj * C + q;
    const float x = warp_tree(
        [&](int p) {
          float z[C];
#pragma unroll
          for (int r = 0; r < C; ++r) z[r] = ranks[r][j * W + p];
          tree::halve<C>(z);
          return z[0];
        },
        W, lane);
    if (lane == 0 && j < cols) {
      const size_t o = (static_cast<size_t>(b) * T + t0) * 2 + j;
      const float* range = (j & 1) ? wrange : vrange;
      u_out[o] = clamp_like_torch(u[o] + x, range[2 * b], range[2 * b + 1]);
    }
  }
  // Before a block exits, every block has read its partial sums (their
  // values are used above, so the reads are done: a relaxed arrive).
  if constexpr (C > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

// The instantiations: (positions a thread, blocks a cluster), at most 8
// own rows a thread.
#define UPDATE_SHAPES(X_)                                            \
  X_(1, 1) X_(2, 1) X_(2, 2) X_(4, 1) X_(4, 2) X_(4, 4) X_(8, 1)     \
  X_(8, 2) X_(8, 4) X_(8, 8) X_(16, 2) X_(16, 4) X_(16, 8) X_(32, 4) \
  X_(32, 8) X_(64, 8)

size_t dynamic_bytes(int A, int C, int W) {
  return sizeof(float) * static_cast<size_t>(kCols) * W * (A / C);
}

}  // namespace

// Lets every instantiation take a block's whole opt-in shared memory on
// the current device.  Call once a card, before a launch and outside a
// capture.  Returns the first failing call's cudaError_t.
extern "C" int update_useq_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
#define UPDATE_PREPARE(A_, C_)                                          \
  if (err == cudaSuccess) {                                             \
    cudaFuncAttributes fa;                                              \
    err = cudaFuncGetAttributes(&fa, update_useq_kernel<A_, C_>);       \
    if (err == cudaSuccess)                                             \
      err = cudaFuncSetAttribute(                                       \
          update_useq_kernel<A_, C_>,                                   \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                  \
          optin - static_cast<int>(fa.sharedSizeBytes));                \
  }
  UPDATE_SHAPES(UPDATE_PREPARE)
#undef UPDATE_PREPARE
  return static_cast<int>(err);
}

// costs (B, K), noise (B, K, T, 2) (8-byte aligned), u (B, T, 2), lam
// (B,), vrange and wrange (B, 2): float32, contiguous, on the current
// device; u_out (B, T, 2) and weights (B, K) float32.  width: threads a
// block, a power of two from 32 to 512 with width * A >= K for an
// instantiation's A; cluster: its C.  B <= 65535.  Returns the launch's
// cudaError_t.
extern "C" int update_useq_launch(const float* costs, const float* noise,
                                  const float* u, const float* lam,
                                  const float* vrange, const float* wrange,
                                  float* u_out, float* weights, int B, int K,
                                  int T, int width, int cluster,
                                  void* stream) {
  int L = 32;
  while (L < K) L <<= 1;
  if (width < 32 || width > kMaxBlock || (width & (width - 1)) != 0 ||
      L % width != 0 || B < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int A = L / width;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((T + kSteps - 1) / kSteps) * cluster, B);
  cfg.blockDim = dim3(width);
  cfg.dynamicSmemBytes = dynamic_bytes(A, cluster, width);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaErrorInvalidValue;
#define UPDATE_LAUNCH(A_, C_)                                            \
  if (A == A_ && cluster == C_)                                          \
    err = cudaLaunchKernelEx(&cfg, update_useq_kernel<A_, C_>, costs,    \
                             noise, u, lam, vrange, wrange, u_out,       \
                             weights, K, T);
  UPDATE_SHAPES(UPDATE_LAUNCH)
#undef UPDATE_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
