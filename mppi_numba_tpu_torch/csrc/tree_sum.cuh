// The halving tree, the summation order of the control coupling and the
// update (ops/tree.py::tree_sum): a row of n terms padded with -0.0 to a
// power of two L >= n, then while L > 1: L <- L / 2 and v[i] <- v[i] +
// v[i + L] for i < L; the sum is v[0].  x + (-0.0) == x for every float,
// so any padded length >= next_pow2(n) gives the same bits.  Each form
// below performs exactly those additions (a + b is commutative in IEEE
// arithmetic, so which operand a thread holds does not matter); the
// kernels are built with -fmad=false, so no product feeding a sum is
// contracted into an fma.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tree {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// One warp, a row of L (a power of two) floats in shared memory at s,
// written before the call by any lane of the warp; every lane returns the
// sum.  Level h: lanes add s[i + h] into s[i] for i < h.
__device__ __forceinline__ float warp_smem(float* s, int L, int lane) {
  __syncwarp();
  for (int h = L >> 1; h >= 1; h >>= 1) {
    for (int i = lane; i < h; i += 32) s[i] = s[i] + s[i + h];
    __syncwarp();
  }
  const float total = s[0];
  __syncwarp();  // every lane has read s[0] before s is written again
  return total;
}

// A block of blockDim.x threads (a power of two, 32 to 1024), one float
// each, position tid in x of thread tid: the tree's levels blockDim.x / 2
// .. 32 in shared memory (sh: blockDim.x floats), the last five levels
// shuffles in warp 0.  Every thread returns the sum (through *out, a
// shared float).  Call from every thread of the block.
__device__ __forceinline__ float block(float x, float* sh, float* out) {
  const int tid = threadIdx.x;
  sh[tid] = x;
  __syncthreads();
  for (int h = blockDim.x >> 1; h >= 32; h >>= 1) {
    if (tid < h) sh[tid] = sh[tid] + sh[tid + h];
    __syncthreads();
  }
  if (tid < 32) {
    float v = sh[tid];
#pragma unroll
    for (int l = 4; l >= 0; --l) v = v + __shfl_down_sync(kFull, v, 1 << l);
    if (tid == 0) *out = v;
  }
  __syncthreads();
  const float total = *out;
  __syncthreads();  // every thread has read *out before sh or *out is reused
  return total;
}

// A thread's R positions r * blockDim.x + tid held in bit-reversed order,
// x[i] the position of r = bit_reverse(i): the tree's levels above the
// block's width pair r with r + R / 2 first, which is i with i + 1, then
// i with i + 2, ...  Sums them into x[0]; x is overwritten.
template <int R>
__device__ __forceinline__ void fold_bit_reversed(float (&x)[R]) {
#pragma unroll
  for (int h = 1; h < R; h <<= 1) {
#pragma unroll
    for (int i = 0; i < R; i += 2 * h) x[i] = x[i] + x[i + h];
  }
}

// bit_reverse(i) over log2(R) bits: thread tid's i-th held position is
// bit_reverse(i) * blockDim.x + tid.
template <int R>
__device__ __forceinline__ int bit_reverse(int i) {
  return R == 1 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(i)) >>
                                       (32 - ilog2(R)));
}

}  // namespace tree
