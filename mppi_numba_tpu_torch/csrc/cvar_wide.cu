// The CVaR plus coupling kernels for the rows a team cannot stage or
// sort in shared memory, for Hopper (sm_90a): the same function as
// csrc/cvar_costs.cu's (see there), bit for bit with the plain version,
// on shapes that kernel's launcher refuses, in a library of its own
// (the shapes below them launch there as before).  Two paths, each its
// own instantiation or kernel, picked by the launcher from the shapes:
//
// - T > kStagedT (Lc > 8192 words a team): the coupling streams (STREAM).
//   Thread j of a team owns positions j + r * TPR; the tree's levels over
//   r are a halving tree over r, which is the pairwise tree over r
//   bit-reversed.  So the thread reads its terms from global memory in
//   bit-reversed order of r (a team's reads of one r coalesced), 16 at a
//   time, sums each 16 (a whole subtree) in registers and pushes the sum
//   into a stack of log2(Lc / TPR) - 4 partial sums (tree::Streamed), and
//   writes one word; shared memory no longer grows with T.
// - M > kSortedM (16,384 keys: 1,024 threads x 16): cvar_wide_kernel, a
//   block of 1,024 threads a row, in rounds of at most kSortedM keys.  A
//   round selects the need-th largest key below the last round's
//   threshold (the same MSD radix select, its histogram passes reading
//   the row from global memory, where the rollout has just left it in
//   L2), gathers and sorts only those keys in shared memory, and thread 0
//   folds them on, largest first.  Between rounds the threshold's copies
//   not yet folded (keys >= it, counted, less those folded) are folded
//   first; equal keys are the same float.  So the fold adds the worst
//   take costs in descending order, as the plain version does, in any
//   number of rounds (a = 1 at M = 70,000: five).  The coupling streams.
#include <cstdint>
#include <cuda_runtime.h>

#include "cvar_common.cuh"

namespace {

// The coupling's last levels: warp 0 of a team reads the TPR partial sums
// cs[0, TPR) (-0.0 past Lc), halves over them, then over its lanes.
template <int TPR>
__device__ __forceinline__ float coupling_of_partials(const float* cs,
                                                      int Lc, int lane) {
  constexpr int kM = TPR / 32;
  float y[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m)
    y[m] = lane + 32 * m < Lc ? cs[lane + 32 * m] : -0.0f;
  tree::halve<kM>(y);
  float coupling = y[0];
#pragma unroll
  for (int l = 4; l >= 0; --l)
    coupling = coupling + __shfl_down_sync(tree::kFull, coupling, 1 << l);
  return coupling;
}

// cvar_wide_select: one round of the wide kernel.  The need-th largest
// key of the row's keys below hi (2^32: all), by the MSD radix select of
// select_then_sort with its histogram passes over the row in global
// memory; the keys from its bin up (or above it, then its copies)
// gathered into x, sorted, and written as values to x[0, need).
__device__ __forceinline__ void cvar_wide_select(const float* c, int M,
                                                 uint64_t hi, uint32_t* x,
                                                 int* hist, int* misc,
                                                 int take, int tid) {
  constexpr int TPR = kWideTPR;
  const int lane = tid & 31;
  uint32_t prefix = 0u;
  int need = take, shift = 24, buf = 0;
  bool whole = false;
  for (int i = tid; i < 2 * kBins; i += TPR) hist[i] = 0;
  if (tid == 0) misc[3] = 0;
  __syncthreads();
  for (;;) {
    int* h = hist + buf * kBins;
    const uint32_t high = shift == 24 ? 0u : ~0u << (shift + 8);
    for (int i = tid; i < M; i += TPR) {
      const uint32_t k = order_key(c[i]);
      if (k < hi && (k & high) == prefix)
        atomicAdd(&h[(k >> shift) & 0xffu], 1);
    }
    __syncthreads();
    if (tid < 32) pick_bin(h, need, misc, tid);
    int* other = hist + (buf ^ 1) * kBins;
    for (int i = tid; i < kBins; i += TPR) other[i] = 0;
    __syncthreads();
    need -= misc[1];
    prefix |= static_cast<uint32_t>(misc[0]) << shift;
    if (take - need + misc[2] <= pow2_at_least(take, 1)) {
      whole = true;
      break;
    }
    if (shift == 0) break;
    shift -= 8;
    buf ^= 1;
  }
  const uint32_t floor_key = whole ? prefix >> shift : prefix;
  for (int i0 = 0; i0 < M; i0 += TPR) {
    const int i = i0 + tid;
    const uint32_t k = i < M ? order_key(c[i]) : 0u;
    const bool pick = k != 0u && k < hi &&
                      (whole ? (k >> shift) >= floor_key : k > floor_key);
    const unsigned m = __ballot_sync(tree::kFull, pick);
    int base = 0;
    if (lane == 0 && m != 0u) base = atomicAdd(&misc[3], __popc(m));
    base = __shfl_sync(tree::kFull, base, 0);
    if (pick) x[base + __popc(m & ((1u << lane) - 1u))] = k;
  }
  __syncthreads();
  const int got = misc[3];
  const int e = max(1, pow2_at_least(got, 1) / TPR);
#define CVAR_WIDE_SORT(E_) \
  if (e == E_) sort_gathered<TPR, E_>(x, got, take, prefix, tid);
  CVAR_WIDE_SORT(1)
  CVAR_WIDE_SORT(2)
  CVAR_WIDE_SORT(4)
  CVAR_WIDE_SORT(8)
  CVAR_WIDE_SORT(16)
#undef CVAR_WIDE_SORT
}

// A row a block of kWideTPR threads, M > kSortedM: the worst take keys in
// rounds of at most kSortedM (see the top of the file), the coupling
// streamed.  Shared memory: kSortedM words (the gathered keys, the sort,
// the fold's values), kWideTPR (the coupling's partial sums), two
// histograms, kMisc + 1 (the round's count of keys >= the threshold).
__global__ void __launch_bounds__(kWideTPR, 1)
cvar_wide_kernel(const float* __restrict__ costs,
                 const float* __restrict__ noise,
                 const float* __restrict__ u,
                 const float* __restrict__ u_std,
                 const float* __restrict__ lam,
                 const float* __restrict__ alpha, float* __restrict__ out,
                 int K, int M, int T, int numel, int Lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* x = smem;
  float* cs = reinterpret_cast<float*>(smem + kSortedM);
  int* hist = reinterpret_cast<int*>(cs + kWideTPR);
  int* misc = hist + 2 * kBins;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x;
  const int b = row / K;
  const float* c = costs + static_cast<size_t>(row) * M;
  const int n =
      alpha != nullptr ? static_cast<int>(ceilf(static_cast<float>(M) * alpha[b]))
                       : numel;
  const int take = min(max(n, 0), M);
  const float* fb = reinterpret_cast<const float*>(x);
  float sum = -0.0f;
  uint64_t hi = uint64_t{1} << 32;   // the keys a round selects from
  int done = 0;                      // the keys folded
  while (done < take) {
    if (hi >> 32 == 0) {
      // The threshold's copies left: keys >= it less those folded.
      if (tid == 0) misc[kMisc] = 0;
      __syncthreads();
      int ge = 0;
      for (int i = tid; i < M; i += kWideTPR)
        ge += order_key(c[i]) >= static_cast<uint32_t>(hi);
      ge = __reduce_add_sync(tree::kFull, ge);
      if (lane == 0 && ge > 0) atomicAdd(&misc[kMisc], ge);
      __syncthreads();
      const int copies = min(misc[kMisc] - done, take - done);
      if (tid == 0) {
        const float tv = key_value(static_cast<uint32_t>(hi));
        for (int i = 0; i < copies; ++i) sum = sum + tv;
      }
      done += copies;
      if (done >= take) break;
    }
    const int need = min(kSortedM, take - done);
    cvar_wide_select(c, M, hi, x, hist, misc, need, tid);
    __syncthreads();
    if (tid == 0) {
      int i = 0;
      for (; i + 4 <= need; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(fb + i);
        sum = sum + q.x;
        sum = sum + q.y;
        sum = sum + q.z;
        sum = sum + q.w;
      }
      for (; i < need; ++i) sum = sum + fb[i];
    }
    hi = order_key(fb[need - 1]);
    done += need;
    __syncthreads();  // x is read before the next round writes it
  }
  const float* ub = u + static_cast<size_t>(b) * T * 2;
  const float var0 = u_std[2 * b] * u_std[2 * b];
  const float var1 = u_std[2 * b + 1] * u_std[2 * b + 1];
  cs[tid] = streamed_coupling<kWideTPR>(
      noise + static_cast<size_t>(row) * T * 2, ub, var0, var1, T, Lc, tid);
  __syncthreads();
  if (tid < 32) {
    const float coupling = coupling_of_partials<kWideTPR>(cs, kWideTPR, tid);
    if (tid == 0)
      out[row] = sum / static_cast<float>(n) + lam[b] * coupling;
  }
}

}  // namespace

// Lets the streamed twins and the wide kernel take a block's whole opt-in
// shared memory on the current device.  Call once a card, before a launch
// and outside a capture.  Returns the first failing call's cudaError_t.
extern "C" int cvar_wide_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
#define CVAR_PREPARE_ONE(F_)                                             \
  if (err == cudaSuccess)                                                \
    err = cudaFuncSetAttribute(F_,                                       \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               optin);
#define CVAR_PREPARE(TPR_, E_) CVAR_PREPARE_ONE((cvar_costs_kernel<TPR_, E_, true>))
  CVAR_SHAPES(CVAR_PREPARE)
  CVAR_PREPARE_ONE(cvar_wide_kernel)
#undef CVAR_PREPARE
#undef CVAR_PREPARE_ONE
  return static_cast<int>(err);
}

// Arguments as csrc/cvar_costs.cu's cvar_costs_launch, on the shapes it
// refuses: M > kSortedM (the wide kernel, tpr 1024), else T > kStagedT
// (the team tpr's streamed twin).  B * K < 2^31.  Returns the launch's
// cudaError_t.
extern "C" int cvar_wide_launch(const float* costs, const float* noise,
                                const float* u, const float* u_std,
                                const float* lam, const float* alpha,
                                float* out, int B, int K, int M, int T,
                                int numel, int tpr, void* stream) {
  const long long rows_ll = static_cast<long long>(B) * K;
  if (rows_ll <= 0 || rows_ll >= (1ll << 31) || M < 1 || T < 1 ||
      (M <= kSortedM && T <= kStagedT))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>(rows_ll);
  const int Lc = pow2_at_least(2 * T, 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > kSortedM) {
    if (tpr != kWideTPR) return static_cast<int>(cudaErrorInvalidValue);
    const size_t shm =
        sizeof(uint32_t) * (kSortedM + kWideTPR + 2 * kBins + kMisc + 1);
    cvar_wide_kernel<<<rows, kWideTPR, shm, st>>>(
        costs, noise, u, u_std, lam, alpha, out, K, M, T, numel, Lc);
    return static_cast<int>(cudaGetLastError());
  }
  const int L = pow2_at_least(M, tpr);
  const int teams = tpr == 32 ? kWarpTeams : 1;
  const dim3 grid((rows + teams - 1) / teams), block(tpr * teams);
  const size_t shm = sizeof(uint32_t) * static_cast<size_t>(teams) *
                     (L + tpr + 2 * kBins + kMisc);
  bool launched = false;
#define CVAR_LAUNCH(TPR_, E_)                                              \
  if (!launched && tpr == TPR_ && L == TPR_ * E_) {                        \
    cvar_costs_kernel<TPR_, E_, true><<<grid, block, shm, st>>>(           \
        costs, noise, u, u_std, lam, alpha, out, rows, K, M, T, numel, Lc); \
    launched = true;                                                       \
  }
  CVAR_SHAPES(CVAR_LAUNCH)
#undef CVAR_LAUNCH
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
