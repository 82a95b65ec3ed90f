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

// The halving tree over y[0, N) in registers (N a power of two): y[m] +=
// y[m + N / 2] for m < N / 2, then N / 4, ...; y[0] ends as the sum.
// Compile-time bounds at every level, so y stays in registers.
template <int N>
__device__ __forceinline__ void halve(float* y) {
  if constexpr (N > 1) {
#pragma unroll
    for (int m = 0; m < N / 2; ++m) y[m] = y[m] + y[m + N / 2];
    halve<N / 2>(y);
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
