// The solve's per-rollout cost, for Hopper (sm_90a): CVaR over the M map
// samples plus the control-coupling term, one warp a (scenario, rollout)
// row.
//
// Replaces the JAX package's XLA-fused cvar_from_costs /
// cvar_from_costs_dynamic (mppi_numba_tpu/ops/cvar.py:17-33,79-91) and
// control_coupling (mppi_numba_tpu/ops/rollout.py:123-131), which have no
// Pallas kernel; in torch ops they were a top-k (or a sort) and some five
// elementwise and reduce launches.  For row (b, k):
//
//   n        = numel (static), or (int) ceilf((float) M * alpha[b])
//   cvar     = fold(the worst min(n, M) of costs[b, k, :], largest
//              first) / n
//   coupling = tree over i = 2t + c of noise[b, k, t, c] *
//                (u[b, t, c] / (u_std[b, c] * u_std[b, c]))
//   out      = cvar + lambda[b] * coupling
//
// "fold" sums left to right, "tree" is the halving tree of tree_sum.cuh:
// the orders of the plain versions (ops/tree.py,
// ops/kernels/cvar_costs.py), so the kernel equals them bit for bit:
// descending order as torch.topk / torch.sort give it, NaN largest (every
// float maps to an unsigned key in the same order; all NaNs to the
// largest key), positions past n -0.0, IEEE division, and -fmad=false.
// The run-time n is read on the card: no host read, so the launch
// captures into a CUDA graph.
//
// Bound: the bytes, 4 * (M + 2T) a row (at K = M = 1024, T = 100: 4.8 MB,
// some 1.5 us at HBM rate; the rollout has just written the costs, so
// they come from L2).  The work is a bitonic sort of M keys a row, log2(M)
// (log2(M) + 1) / 2 compare-exchange stages.  For M <= 1024 each lane
// holds E = next_pow2(M) / 32 keys in registers (position lane * E + r):
// stages with a stride below E exchange registers inside a lane, the rest
// pair lanes with __shfl_xor_sync; no shared memory and no __syncthreads.
// The fold then runs lane after lane over the lanes that hold the worst
// n, each adding its registers to the running sum and passing it on.  For
// 1024 < M <= 4096 the keys sort in the warp's shared memory (__syncwarp
// between stages) and lane 0 folds them.  The coupling's 2T terms are
// summed in the warp's shared memory.  One warp a row, four a block: 1024
// rows fill the card in one wave.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "tree_sum.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRegisterM = 1024;
constexpr int kSmemPerBlock = 48 * 1024;

// Unsigned order of floats: -inf .. -0, +0 .. +inf, then every NaN.
// Key 0 is no float's: it pads a row, and sorts last.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  if (isnan(x)) return 0xffffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Bitonic sort of 32 * E keys, descending, position lane * E + r in v[r].
template <int E>
__device__ __forceinline__ void sort_registers(uint32_t (&v)[E], int lane) {
  constexpr int kLog = tree::ilog2(32 * E);
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= E) {
        const int lanes = j / E;
        const bool upper = (lane & lanes) != 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const bool desc = ((lane * E + r) & k) == 0;
          const uint32_t o = __shfl_xor_sync(tree::kFull, v[r], lanes);
          const uint32_t hi = max(v[r], o), lo = min(v[r], o);
          v[r] = (desc != upper) ? hi : lo;
        }
      } else {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & j) == 0) {
            const bool desc = ((lane * E + r) & k) == 0;
            const uint32_t a = v[r], b = v[r | j];
            const uint32_t hi = max(a, b), lo = min(a, b);
            v[r] = desc ? hi : lo;
            v[r | j] = desc ? lo : hi;
          }
        }
      }
    }
  }
}

// Bitonic sort of L keys (a power of two) in the warp's shared memory,
// descending.
__device__ void sort_shared(uint32_t* s, int L, int lane) {
  __syncwarp();
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = lane; p < (L >> 1); p += 32) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const uint32_t a = s[i], b = s[i | j];
        const uint32_t hi = max(a, b), lo = min(a, b);
        const bool desc = (i & k) == 0;
        s[i] = desc ? hi : lo;
        s[i | j] = desc ? lo : hi;
      }
      __syncwarp();
    }
  }
}

// E > 0: the register sort of 32 * E keys; E == 0: the shared-memory sort
// of L keys.  buf: floats of shared memory a warp.
template <int E>
__global__ void __launch_bounds__(32 * kWarps)
cvar_costs_kernel(const float* __restrict__ costs,
                  const float* __restrict__ noise,
                  const float* __restrict__ u,
                  const float* __restrict__ u_std,
                  const float* __restrict__ lam,
                  const float* __restrict__ alpha, float* __restrict__ out,
                  int rows, int K, int M, int T, int numel, int L, int Lc,
                  int buf) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the whole warp
  float* s = smem + warp * buf;
  const int b = row / K;
  const float* c = costs + static_cast<size_t>(row) * M;
  const int n =
      alpha != nullptr ? static_cast<int>(ceilf(static_cast<float>(M) * alpha[b]))
                       : numel;
  const int take = min(max(n, 0), M);

  float sum;
  if constexpr (E > 0) {
    uint32_t v[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int i = lane + 32 * r;  // any start order: coalesced loads
      v[r] = i < M ? order_key(c[i]) : 0u;
    }
    if (M > 1) sort_registers<E>(v, lane);  // one cost: in place at 0
    // The fold: -0.0 + x == x, and the terms past take are -0.0.
    sum = -0.0f;
    for (int l = 0; l * E < take; ++l) {
      if (lane == l) {
#pragma unroll
        for (int r = 0; r < E; ++r)
          sum = sum + (l * E + r < take ? key_value(v[r]) : -0.0f);
      }
      sum = __shfl_sync(tree::kFull, sum, l);
    }
  } else {
    uint32_t* keys = reinterpret_cast<uint32_t*>(s);
    for (int i = lane; i < L; i += 32) keys[i] = i < M ? order_key(c[i]) : 0u;
    sort_shared(keys, L, lane);
    sum = -0.0f;
    if (lane == 0)
      for (int i = 0; i < take; ++i) sum = sum + key_value(keys[i]);
    sum = __shfl_sync(tree::kFull, sum, 0);
    __syncwarp();  // lane 0 has read the keys before s is written again
  }
  const float cvar = sum / static_cast<float>(n);

  const float* nz = noise + static_cast<size_t>(row) * T * 2;
  const float* ub = u + static_cast<size_t>(b) * T * 2;
  const float var0 = u_std[2 * b] * u_std[2 * b];
  const float var1 = u_std[2 * b + 1] * u_std[2 * b + 1];
  for (int i = lane; i < Lc; i += 32)
    s[i] = i < 2 * T ? nz[i] * (ub[i] / ((i & 1) ? var1 : var0)) : -0.0f;
  const float coupling = tree::warp_smem(s, Lc, lane);
  if (lane == 0) out[row] = cvar + lam[b] * coupling;
}

int pow2_at_least(int n, int floor) {
  int p = floor;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// costs (B, K, M), noise (B, K, T, 2), u (B, T, 2), u_std (B, 2), lam (B,)
// and alpha (B,) or null (then numel, already min(numel, M), is used):
// float32, contiguous, on the current device.  out: float32 (B, K).
// Returns the launch's cudaError_t.
extern "C" int cvar_costs_launch(const float* costs, const float* noise,
                                 const float* u, const float* u_std,
                                 const float* lam, const float* alpha,
                                 float* out, int B, int K, int M, int T,
                                 int numel, void* stream) {
  const int rows = B * K;
  const int L = pow2_at_least(M, 32);
  const int Lc = pow2_at_least(2 * T, 32);
  const bool registers = M <= kRegisterM;
  const int buf = registers ? Lc : std::max(L, Lc);
  const size_t warp_bytes = sizeof(float) * static_cast<size_t>(buf);
  if (warp_bytes > kSmemPerBlock || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps;
  while (warps > 1 && warps * warp_bytes > kSmemPerBlock) --warps;
  const dim3 grid((rows + warps - 1) / warps), block(32 * warps);
  const size_t shm = warps * warp_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CVAR_LAUNCH(E_)                                                  \
  cvar_costs_kernel<E_><<<grid, block, shm, st>>>(                       \
      costs, noise, u, u_std, lam, alpha, out, rows, K, M, T, numel, L, \
      Lc, buf)
  switch (registers ? L / 32 : 0) {
    case 1: CVAR_LAUNCH(1); break;
    case 2: CVAR_LAUNCH(2); break;
    case 4: CVAR_LAUNCH(4); break;
    case 8: CVAR_LAUNCH(8); break;
    case 16: CVAR_LAUNCH(16); break;
    case 32: CVAR_LAUNCH(32); break;
    default: CVAR_LAUNCH(0); break;
  }
#undef CVAR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel's launch: the floor of one graph node, timed beside the
// solve-tail kernels' bounds.
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
