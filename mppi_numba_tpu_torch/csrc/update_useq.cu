// The MPPI control update, for Hopper (sm_90a): the softmax weights of the
// K rollout costs and the weighted noise sum, one block a (chunk of
// kSteps steps, scenario b).
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
// CUDA exp computes it, and -fmad=false.
//
// Every block recomputes beta, the weights and eta from the scenario's K
// costs (4-40 KB from L2), so no block waits for another: one launch, no
// grid-wide barrier.  Thread tid owns positions r * blockDim.x + tid, r <
// R, of the tree padded to L = R * blockDim.x >= next_pow2(K) (blockDim.x
// = L / 4 between 32 and 512: R = 4 at K = 1024, 32 at model_bench's
// 10240), so the levels above the block's width are register adds; it
// holds them in bit-reversed order of r (tree::fold_bit_reversed), which
// makes those levels pair neighbouring registers, so every register index
// is a constant.  A block sums its 2 * kSteps (t, c) columns together: it
// stages the noise of blockDim.x rollouts at a time in shared memory (32
// contiguous bytes a rollout, so a warp's load touches 4 sectors, not
// 32; the next rollouts' loads in flight while these are summed), each
// thread multiplies its rollout's row by its weight and adds the
// products into a pairwise stack, one entry a level, in the order it
// holds its positions; one shared-memory tree then serves all the columns
// (its levels down to 32), and each warp finishes some of them with
// shuffles.  Block (0, b) writes the weights.  Bound: the bytes, the
// costs, the noise and u read once and u' and the weights written once
// (at K = 1024, T = 100: some 0.8 MB, 0.25 us at HBM rate).
#include <cstdint>
#include <cuda_runtime.h>

#include "tree_sum.cuh"

namespace {

constexpr int kMaxBlock = 512;
constexpr int kSteps = 4;            // steps a block
constexpr int kCols = 2 * kSteps;    // its (t, c) columns
constexpr int kStride = kCols + 1;   // a staged row: no bank conflict
constexpr int kShared = kMaxBlock * kStride;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// torch.clamp(v, lo, hi) on CUDA tensors (aten's clamp_kernel_cuda).
__device__ __forceinline__ float clamp_like_torch(float v, float lo,
                                                  float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

template <int R>
__global__ void __launch_bounds__(kMaxBlock)
update_useq_kernel(const float* __restrict__ costs,
                   const float* __restrict__ noise,
                   const float* __restrict__ u,
                   const float* __restrict__ lam,
                   const float* __restrict__ vrange,
                   const float* __restrict__ wrange,
                   float* __restrict__ u_out, float* __restrict__ weights,
                   int K, int T) {
  __shared__ float sh[kShared];
  __shared__ float total;
  const int t0 = blockIdx.x * kSteps, b = blockIdx.y;
  const int tid = threadIdx.x, width = blockDim.x;
  const float* cb = costs + static_cast<size_t>(b) * K;

  // w[i]: the rollout k[i] = bit_reverse(i) * width + tid.
  int k[R];
  float w[R];
  float mn = __int_as_float(0x7f800000);  // +inf
#pragma unroll
  for (int i = 0; i < R; ++i) {
    k[i] = tree::bit_reverse<R>(i) * width + tid;
    w[i] = k[i] < K ? cb[k[i]] : 0.0f;
    if (k[i] < K) mn = nan_min(mn, w[i]);
  }
  sh[tid] = mn;
  __syncthreads();
  for (int h = width >> 1; h >= 1; h >>= 1) {
    if (tid < h) sh[tid] = nan_min(sh[tid], sh[tid + h]);
    __syncthreads();
  }
  const float beta = sh[0];
  __syncthreads();  // every thread has read sh[0]

  const float lam_b = lam[b];
  float p[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    w[i] = k[i] < K ? expf(-(w[i] - beta) / lam_b) : -0.0f;
    p[i] = w[i];
  }
  tree::fold_bit_reversed<R>(p);
  const float eta = tree::block(p[0], sh, &total);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    w[i] = k[i] < K ? w[i] / eta : -0.0f;
    if (blockIdx.x == 0 && k[i] < K)
      weights[static_cast<size_t>(b) * K + k[i]] = w[i];
  }

  // Column j = 2 (t - t0) + c of this block's steps.  The levels above
  // the block's width: a pairwise stack a column, acc[l] the sum of 2^l
  // neighbouring held positions (fold_bit_reversed's pairing).
  constexpr int kLog = tree::ilog2(R);
  const int cols = min(kCols, 2 * (T - t0));
  const float* nb = noise + static_cast<size_t>(b) * K * T * 2 + 2 * t0;
  // Thread tid stages elements tid + q * width, q < kCols, of each round's
  // (width rollouts x kCols) noise; the next round's are loaded into
  // registers before this round's syncs, so their latency overlaps them.
  float staged[kCols];
  auto load_round = [&](int first) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int e = tid + q * width;
      const int row = e / kCols, j = e - row * kCols;
      staged[q] = first + row < K && j < cols
                      ? nb[static_cast<size_t>(first + row) * T * 2 + j]
                      : 0.0f;
    }
  };
  load_round(k[0] - tid);
  float acc[kLog + 1][kCols];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int e = tid + q * width;
      const int row = e / kCols;
      sh[row * kStride + e - row * kCols] = staged[q];
    }
    if (i + 1 < R) load_round(k[i + 1] - tid);
    __syncthreads();
    float leaf[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      leaf[j] = k[i] < K && j < cols ? w[i] * sh[tid * kStride + j] : -0.0f;
    __syncthreads();  // every thread has read the staged rows
    bool carry = true;
#pragma unroll
    for (int l = 0; l < kLog; ++l) {
      if (carry && ((i >> l) & 1)) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) leaf[j] = acc[l][j] + leaf[j];
      } else if (carry) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[l][j] = leaf[j];
        carry = false;
      }
    }
    if (carry) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[kLog][j] = leaf[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) sh[j * width + tid] = acc[kLog][j];
  __syncthreads();
  for (int h = width >> 1; h >= 32; h >>= 1) {
    if (tid < h) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sh[j * width + tid] = sh[j * width + tid] + sh[j * width + tid + h];
    }
    __syncthreads();
  }
  const int lane = tid & 31;
  for (int j = tid >> 5; j < cols; j += width >> 5) {  // warp-uniform
    float x = sh[j * width + lane];
#pragma unroll
    for (int l = 4; l >= 0; --l)
      x = x + __shfl_down_sync(tree::kFull, x, 1 << l);
    if (lane == 0) {
      const size_t o = (static_cast<size_t>(b) * T + t0) * 2 + j;
      const float* range = (j & 1) ? wrange : vrange;
      u_out[o] = clamp_like_torch(u[o] + x, range[2 * b], range[2 * b + 1]);
    }
  }
}

}  // namespace

// costs (B, K), noise (B, K, T, 2), u (B, T, 2), lam (B,), vrange and
// wrange (B, 2): float32, contiguous, on the current device; u_out (B, T,
// 2) and weights (B, K) float32.  K <= 32768, B <= 65535.  Returns the
// launch's cudaError_t.
extern "C" int update_useq_launch(const float* costs, const float* noise,
                                  const float* u, const float* lam,
                                  const float* vrange, const float* wrange,
                                  float* u_out, float* weights, int B, int K,
                                  int T, void* stream) {
  int L = 32;
  while (L < K) L <<= 1;
  // A quarter of the padded row a block, 32 to 512 threads: R = L / width.
  const int width = L / 4 < 32 ? 32 : L / 4 > kMaxBlock ? kMaxBlock : L / 4;
  const dim3 grid((T + kSteps - 1) / kSteps, B), block(width);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UPDATE_LAUNCH(R_)                                              \
  update_useq_kernel<R_><<<grid, block, 0, st>>>(                      \
      costs, noise, u, lam, vrange, wrange, u_out, weights, K, T)
  switch (L / width) {
    case 1: UPDATE_LAUNCH(1); break;
    case 2: UPDATE_LAUNCH(2); break;
    case 4: UPDATE_LAUNCH(4); break;
    case 8: UPDATE_LAUNCH(8); break;
    case 16: UPDATE_LAUNCH(16); break;
    case 32: UPDATE_LAUNCH(32); break;
    case 64: UPDATE_LAUNCH(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UPDATE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
