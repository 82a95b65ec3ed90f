// The solve's per-rollout cost, for Hopper (sm_90a): CVaR over the M map
// samples plus the control-coupling term, a team of TPR threads a
// (scenario, rollout) row.
//
// Replaces the JAX package's XLA-fused cvar_from_costs /
// cvar_from_costs_dynamic (mppi_numba_tpu/ops/cvar.py:17-33,79-91) and
// control_coupling (mppi_numba_tpu/ops/rollout.py:123-131), which have no
// Pallas kernel; in torch ops they were a top-k (or a sort) and some five
// elementwise and reduce launches.  For row (b, k):
//
//   n        = numel (static), or (int) ceilf((float) M * alpha[b])
//   take     = min(max(n, 0), M)
//   cvar     = static, n < M: wsum(the worst n of costs[b, k, :], largest
//                first) * (1.0f / n)
//              static, n = M: wsum(costs[b, k, :] as stored) * (1.0f / M)
//              alpha: wsum(sorted row * (position < take), over M) / n
//   coupling = tree over i = 2t + c of noise[b, k, t, c] *
//                (u[b, t, c] / (u_std[b, c] * u_std[b, c]))
//   out      = cvar + lambda[b] * coupling
//
// "wsum" is XLA's CPU order of a row sum (windows of 32 terms, see
// window_sum_team in cvar_common.cuh), "tree" the halving tree of
// tree_sum.cuh: the orders of the plain versions (ops/tree.py,
// ops/cvar.py), which are the JAX package's on the CPU, so the kernel
// equals them bit for bit: descending order as torch.topk / torch.sort
// give it, NaN largest (every float maps to an unsigned key in the same
// order; all NaNs to the largest key), a masked infinite cost NaN (0 *
// inf), IEEE division, and -fmad=false.  Equal keys are the same float,
// so which of them a step takes cannot change a bit.  The run-time n is
// read on the card: no host read, so the launch captures into a CUDA
// graph.
//
// Bound: the bytes, 4 * (M + 2T) a row (at K = M = 1024, T = 100: 4.8 MB,
// some 1.5 us at HBM rate; the rollout has just written the costs, so
// they come from L2).  What a sort spends instead is operations and
// latency, and they are what this design cuts:
//
// - A team of threads a row, chosen by the launcher from the shapes
//   (ops/kernels/cvar_costs.py::threads_per_row): 128 threads a row where
//   the rows take at most half the card (world (a)), one warp a row (four
//   rows a block) where they fill it, a block of 512 (1,024 past M =
//   8192) past M = 1024.  Thread tid holds E keys at positions tid * E + r
//   of a bitonic network: stages of stride < E in registers, < 32 E
//   through shuffles, larger ones through shared memory (two barriers a
//   stage).
// - From M = 129 (a padded row of kSelectFrom = 256 keys; shorter rows
//   sort whole, cheaper than the select's passes), select before
//   sorting: an MSD radix select of the take-th largest key (8-bit digits, two 256-bin histograms in shared memory used in turns,
//   warp 0 scanning from the top), stopping at the first digit whose bin
//   fits the sort the take needs; the keys from that bin up (or above the
//   threshold, then its copies) are gathered (one shared atomic a warp)
//   and bitonic-sorted at next_pow2(their count): at numel 205 of M =
//   1024, 256 keys a row, not 1,024.
// - The sorted worst costs (or, for a static count of M, the row as
//   stored: no select and no sort) are written to shared memory as the
//   windowed sum's terms, one word of padding after every 32, so that
//   lane j folds window j from +0.0 (32 dependent adds) without a bank
//   conflict; the partial sums fold the same way a level up: at (a)'s
//   205 terms, 7 lanes of at most 32 adds and one fold of 7, not one
//   thread's chain of 205.
// - The coupling's noise is copied into shared memory (cp.async) while
//   the row sorts; its terms and the tree's levels above the team's width
//   run in each thread's own positions, then one barrier and warp 0
//   finishes the tree.
//
// Shared memory a team (team_words): L words and their padding (the
// gathered keys, the sort's exchanges, the windows' terms), Lc (the
// coupling), two histograms, the windows' level buffers.  Past 48 KB a
// block (M > 8192, or T > 512 with four warp teams) it needs the opt-in
// that cvar_costs_prepare sets once a card.
//
// Past T = kStagedT and M = kSortedM the launches go to csrc/cvar_wide.cu,
// a library of its own (the coupling kernel, the twins that read its sums,
// and the wide kernel).
#include <cstdint>
#include <cuda_runtime.h>

#include "cvar_common.cuh"

using namespace cvar;

// Lets every instantiation take a block's whole opt-in shared memory on
// the current device.  Call once a card, before a launch and outside a
// capture.  Returns the first failing call's cudaError_t.
extern "C" int cvar_costs_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
#define CVAR_PREPARE(TPR_, E_)                                           \
  if (err == cudaSuccess)                                                \
    err = cudaFuncSetAttribute(cvar_costs_kernel<TPR_, E_, false>,       \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               optin);
  CVAR_SHAPES(CVAR_PREPARE)
#undef CVAR_PREPARE
  return static_cast<int>(err);
}

// costs (B, K, M), noise (B, K, T, 2), u (B, T, 2), u_std (B, 2), lam (B,)
// and alpha (B,) or null (then numel, already min(numel, M), is used):
// float32, contiguous, on the current device.  out: float32 (B, K).  tpr:
// threads a row, 32 or 128 (M <= 1024), 512 (M <= 8192) or 1024 (M <=
// kSortedM); T <= kStagedT (past either, cvar_wide.cu).  Returns the
// launch's cudaError_t.
extern "C" int cvar_costs_launch(const float* costs, const float* noise,
                                 const float* u, const float* u_std,
                                 const float* lam, const float* alpha,
                                 float* out, int B, int K, int M, int T,
                                 int numel, int tpr, void* stream) {
  const int rows = B * K;
  const int L = pow2_at_least(M, tpr);
  const int Lc = pow2_at_least(2 * T, 32);
  if (rows <= 0 || M < 1 || T < 1 || M > kSortedM || T > kStagedT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int teams = tpr == 32 ? kWarpTeams : 1;
  const dim3 grid((rows + teams - 1) / teams), block(tpr * teams);
  const size_t shm =
      sizeof(uint32_t) * static_cast<size_t>(teams) * team_words(L, Lc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool launched = false;
#define CVAR_LAUNCH(TPR_, E_)                                           \
  if (!launched && tpr == TPR_ && L == TPR_ * E_) {                     \
    cvar_costs_kernel<TPR_, E_, false><<<grid, block, shm, st>>>(       \
        costs, noise, u, u_std, lam, alpha, out, rows, K, M, T, numel, \
        Lc);                                                            \
    launched = true;                                                    \
  }
  CVAR_SHAPES(CVAR_LAUNCH)
#undef CVAR_LAUNCH
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
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
