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

// log2 of a power of two known at run time.
__host__ __device__ __forceinline__ int ilog2_run(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
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

// bit_reverse over a run-time log2(R) bits (log_r 0: position 0).
__device__ __forceinline__ int bit_reverse_bits(int i, int log_r) {
  return log_r == 0 ? 0
                    : static_cast<int>(__brev(static_cast<unsigned>(i)) >>
                                       (32 - log_r));
}

// The halving tree over a run-time number R (a power of two) of leaves
// pushed in order i = 0 .. R - 1, leaf i at position bit_reverse(i):
// pushed pairwise (i with i ^ 1, then pairs of pairs, ...), which is the
// halving tree's order over the positions.  The partial sums wait in a
// stack of one word a level (local memory: its index is not a constant).
struct Streamed {
  float acc[32];

  __device__ __forceinline__ void push(int i, float leaf) {
    int l = 0;
    for (; (i >> l) & 1; ++l) leaf = acc[l] + leaf;
    acc[l] = leaf;
  }

  // The sum once all R leaves are pushed.
  __device__ __forceinline__ float sum(int log_r) const { return acc[log_r]; }
};

// Leaves pushed in order i = 0 .. N - 1 (N a power of two; i a constant
// after unrolling, or a run-time value) summed pairwise: i with i ^ 1,
// then pairs of pairs, ...; acc[log2 N] ends as the sum.  Held in
// bit-reversed order (leaf i the position bit_reverse(i)), that is the
// halving tree's order over them.  Every index into acc is a constant
// after unrolling, so the stack stays in registers.
template <int N, int COLS>
struct Pairwise {
  static constexpr int kLog = ilog2(N);
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

// Every lane of a warp: the halving tree's sum of n positions (a power of
// two), lane l holding positions l + 32 m, m < max(1, n / 32), that
// get(position) reads (-0.0 past n): the levels over m streamed, then xor
// shuffles.
template <class Get>
__device__ __forceinline__ float lane_tree(Get get, int n, int lane) {
  const int per = n > 32 ? n / 32 : 1;
  const int log_per = ilog2_run(per);
  Streamed st;
  for (int i = 0; i < per; ++i) {
    const int p = lane + 32 * bit_reverse_bits(i, log_per);
    st.push(i, p < n ? get(p) : -0.0f);
  }
  float x = st.sum(log_per);
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x = x + __shfl_xor_sync(kFull, x, o);
  return x;
}

}  // namespace tree
