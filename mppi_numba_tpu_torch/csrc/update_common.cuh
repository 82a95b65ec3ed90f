// What the update's kernels share (csrc/update_useq.cu, the one-launch
// kernel, and csrc/update_wide.cu, the wide path): the block and chunk
// sizes, the order keys of beta (NaN first), torch.clamp's NaN rules, and
// the warp form of the halving tree (tree_sum.cuh).
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
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

using tree::Pairwise;

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

}  // namespace
