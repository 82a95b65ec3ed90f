// Dependent gather chain, for Hopper (sm_90a): the gather-latency probe.
//
// Replaces: scripts/gather_probe.py::make_kernel(prim, S, R, L, mod).run
// (pl.pallas_call at :108), the probe of which table shapes the TPU's
// tpu.dynamic_gather serves.  For every (r, lane) of an int32 (R, L) index
// tile it runs `iters` steps of
//
//     x <- (gather(table, x) ^ x) % mod
//
// over an int32 (S, L) table, the gather being either
//   COLUMN  table[x % S, lane]          (the TPU's sublane gather, dims=[0])
//   FLAT    table.flat[x % (S * L)]     (the TPU's 2-D gather, dims=[0, 1])
// and writes the final x to out (R, L).  The semantics are the script's
// `reference(_cg_ref | _fg_ref, ...)`.
//
// Design.  One thread per (r, lane), r * L + lane on blockIdx.x /
// threadIdx.x.  The chain runs in a register: each step's load address is
// the last step's result, so each step waits out one load's latency from
// the level that holds the table (L1 for a few KB, L2 up to its 50 MB,
// HBM beyond).  That data dependence is what the probe measures, so the
// loop is not unrolled (`#pragma unroll 1`) and nothing is prefetched.
// R = 32 (the TPU's tile) measures latency; R = 1056 (132 SMs x 1024
// threads / 128 lanes) puts a full card of chains in flight.
//
// What bounds it: the chain's latency, iters dependent loads in a row, far
// above both the bytes bound (the table entries it touches, idx and out, at
// HBM rate) and the operations bound (3 integer operations per lane-step).
//
// Arithmetic is unsigned.  The wrapper checks that table and idx are
// nonnegative and 0 < mod < 2^31, so every x stays in [0, 2^31) and C's
// truncating % equals the JAX reference's flooring %.  The flat index
// x % n is taken in 32 bits (n = S * L < 2^31) before any widening.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

template <bool FLAT>
__global__ void __launch_bounds__(kBlock)
gather_chain_kernel(const uint32_t* __restrict__ table,
                    const uint32_t* __restrict__ idx,
                    uint32_t* __restrict__ out, int n_threads, int L,
                    uint32_t S, uint32_t n, uint32_t mod, int iters) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_threads) return;
  const uint32_t lane = static_cast<uint32_t>(i % L);
  uint32_t x = idx[i];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const uint32_t g = FLAT ? table[x % n]
                            : table[(size_t)(x % S) * L + lane];
    x = (g ^ x) % mod;
  }
  out[i] = x;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers:
// table int32 with S rows and n entries (S x L for the column gather),
// idx / out int32 (R, L).  flat: 0 column gather, 1 flat gather.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int gather_chain_launch(const void* table, const void* idx,
                                   void* out, int R, int L, int S, int n,
                                   int mod, int iters, int flat,
                                   void* stream) {
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const uint32_t* x = static_cast<const uint32_t*>(idx);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int n_threads = R * L;
  const dim3 grid((n_threads + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flat)
    gather_chain_kernel<true><<<grid, kBlock, 0, s>>>(
        t, x, o, n_threads, L, static_cast<uint32_t>(S),
        static_cast<uint32_t>(n), static_cast<uint32_t>(mod), iters);
  else
    gather_chain_kernel<false><<<grid, kBlock, 0, s>>>(
        t, x, o, n_threads, L, static_cast<uint32_t>(S),
        static_cast<uint32_t>(n), static_cast<uint32_t>(mod), iters);
  return static_cast<int>(cudaGetLastError());
}
