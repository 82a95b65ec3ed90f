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
//   block of 1,024 threads a row, in rounds of at most kSortedM terms.  A
//   round selects the need-th largest key below the last round's
//   threshold (the same MSD radix select, its histogram passes reading
//   the row from global memory, where the rollout has just left it in
//   L2), gathers and sorts only those keys in shared memory and writes
//   them as the next terms of the windowed sum (XLA's CPU order,
//   window_round below), which the block folds at once; a
//   window that straddles two rounds carries its partial sum into the
//   next, and every level above the windows the same.  Between rounds the
//   threshold's copies not yet summed (keys >= it, counted, less those
//   summed) come first, as rounds of terms at their positions; equal keys
//   are the same float.  So the sum adds the worst take costs in
//   descending order, in the windows the plain version has, in any number
//   of rounds (a = 1 at M = 70,000: five).  A static count of M sums the
//   row as stored, in rounds of kSortedM costs read in order.  The
//   coupling streams.
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

// The windowed sum's terms in rounds: a window that straddles two rounds
// carries its partial sum into the next, at every level.  The progress is
// the same in every thread: the terms of each level summed so far, and
// which of a level's two carry words holds its open window (the words
// are used in turns, so the thread that writes the next carry never
// races the thread that reads the last).
constexpr int kWinLevels = 8;    // levels of 32-term windows (2^31 terms)

struct WinState {
  int s[kWinLevels];
  int ph[kWinLevels];
};

// One round of the windowed sum over the n0 terms of a row: this round's
// c terms (the row's terms st.s[0] .. st.s[0] + c - 1) at
// x[win_slot(p + off0)], p < c, off0 = (st.s[0] + win_lo(n0)) & 31.  last:
// no term follows (any still missing are zeros, which change no sum).
// Every thread of the block calls it; wa, wb and carry are the block's
// level buffers.  Returns the sum in thread 0 after the last round (+0.0
// when no term came), 0.0 elsewhere.
__device__ float window_round(WinState& st, int n0, const float* x,
                              float* wa, float* wb, float* carry, int c,
                              bool last, int tid) {
  float result = 0.0f;
  const float* in = x;
  int n = n0;
  for (int k = 0; k < kWinLevels; ++k) {
    const int m = (n + 31) >> 5;
    const int lo = win_lo(n);
    const bool top = n <= 32;
    const int s = st.s[k];
    const int off = (s + lo) & 31;
    const int w0 = (s + lo) >> 5;        // the first window this round
    const bool carried = s > 0 && off != 0;
    int nwin, ncomp;
    if (c > 0) {
      nwin = ((s + c - 1 + lo) >> 5) - w0 + 1;
      ncomp = (last || s + c >= n) ? nwin : ((s + c + lo) >> 5) - w0;
    } else {
      nwin = carried && last ? 1 : 0;
      ncomp = nwin;
    }
    // The next level's terms: the windows completed, from w0 on (as many
    // windows were completed before this round).
    float* out = (k & 1) ? wb : wa;
    const int off1 = top ? 0 : (w0 + win_lo(m)) & 31;
    const int ph = st.ph[k];
    for (int t = tid; t < nwin; t += kWideTPR) {
      const float acc =
          win_fold(in, t, off - 32 * t, off + c - 32 * t,
                   t == 0 && carried ? carry[2 * k + ph] : 0.0f);
      if (t >= ncomp) {
        carry[2 * k + (ph ^ 1)] = acc;
      } else if (top) {
        result = acc;
      } else {
        out[win_slot(t + off1)] = acc;
      }
    }
    st.s[k] = s + c;
    if (ncomp < nwin) st.ph[k] = ph ^ 1;
    if (top) break;
    __syncthreads();
    if (ncomp == 0 && !last) break;
    c = ncomp;
    in = out;
    n = m;
  }
  return result;
}

// cvar_wide_select: one round of the wide kernel.  The need-th largest
// key of the row's keys below hi (2^32: all), by the MSD radix select of
// select_then_sort with its histogram passes over the row in global
// memory; the keys from its bin up (or above it, then its copies)
// gathered into x, sorted, and written as values to the terms p < need
// at x[win_slot(p + off)].
__device__ __forceinline__ void cvar_wide_select(const float* c, int M,
                                                 uint64_t hi, uint32_t* x,
                                                 int* hist, int* misc,
                                                 int take, int off,
                                                 int tid) {
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
  if (e == E_) sort_gathered<TPR, E_>(x, got, take, prefix, off, tid);
  CVAR_WIDE_SORT(1)
  CVAR_WIDE_SORT(2)
  CVAR_WIDE_SORT(4)
  CVAR_WIDE_SORT(8)
  CVAR_WIDE_SORT(16)
#undef CVAR_WIDE_SORT
}

// A row a block of kWideTPR threads, M > kSortedM: the worst take keys in
// rounds of at most kSortedM (see the top of the file), the coupling
// streamed.  Shared memory (wide_words): the terms of a round, padded
// (the gathered keys, the sort, the windows' terms), kWideTPR words (the
// coupling's partial sums), two histograms, kMisc counts, the windows'
// level buffers.
__host__ __device__ constexpr int wide_words() {
  return win_words(kSortedM) + kWideTPR + 2 * kBins + kMisc +
         win_words(win_count(kSortedM)) +
         win_words(win_count(win_count(kSortedM))) + 2 * kWinLevels;
}

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
  float* cs = reinterpret_cast<float*>(smem + win_words(kSortedM));
  int* hist = reinterpret_cast<int*>(cs + kWideTPR);
  int* misc = hist + 2 * kBins;
  float* wa = reinterpret_cast<float*>(misc + kMisc);
  float* wb = wa + win_words(win_count(kSortedM));
  float* carry = wb + win_words(win_count(win_count(kSortedM)));
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x;
  const int b = row / K;
  const float* c = costs + static_cast<size_t>(row) * M;
  const bool dyn = alpha != nullptr;
  const int n =
      dyn ? static_cast<int>(ceilf(static_cast<float>(M) * alpha[b])) : numel;
  const int take = min(max(n, 0), M);
  const bool unsorted = !dyn && take == M;
  const int Lw = dyn ? M : take;
  const int lo = win_lo(Lw);
  float* fb = reinterpret_cast<float*>(x);

  // A masked cost that is infinite or NaN makes the sum NaN (0 * inf).
  bool nan_sum = false;
  if (dyn && take < M) {
    if (tid == 0) misc[kMiscHigh] = misc[kMiscLow] = 0;
    __syncthreads();
    int hi_n = 0, lo_n = 0;
    for (int i = tid; i < M; i += kWideTPR) {
      const uint32_t k = order_key(c[i]);
      hi_n += k >= kKeyPosInf;
      lo_n += k == kKeyNegInf;
    }
    hi_n = __reduce_add_sync(tree::kFull, hi_n);
    lo_n = __reduce_add_sync(tree::kFull, lo_n);
    if (lane == 0) {
      atomicAdd(&misc[kMiscHigh], hi_n);
      atomicAdd(&misc[kMiscLow], lo_n);
    }
    __syncthreads();
    nan_sum = masked_nonfinite(misc[kMiscHigh], misc[kMiscLow], take, M);
  }

  // One round: the c terms at fb[win_slot(p + (done + lo) & 31)], summed
  // on; the sum when they are the last.
  WinState st = {};
  float sum = 0.0f;
  auto sum_round = [&](int done, int cnt) {
    const bool last = done + cnt >= take;
    const float r =
        Lw == 1 ? fb[win_slot(lo)]
                : window_round(st, Lw, fb, wa, wb, carry, cnt, last, tid);
    if (last) sum = r;
  };
  if (unsorted) {
    for (int done = 0; done < M; done += kSortedM) {
      const int cnt = min(kSortedM, M - done);
      const int off = (done + lo) & 31;
      for (int i = tid; i < cnt; i += kWideTPR)
        fb[win_slot(i + off)] = c[done + i];
      __syncthreads();
      sum_round(done, cnt);
      __syncthreads();  // the terms are read before the next round's
    }
  } else {
    uint64_t hi = uint64_t{1} << 32;   // the keys a round selects from
    int done = 0;                      // the terms summed
    while (done < take) {
      if (hi >> 32 == 0) {
        // The threshold's copies left: keys >= it less those summed.
        if (tid == 0) misc[kMiscGe] = 0;
        __syncthreads();
        int ge = 0;
        for (int i = tid; i < M; i += kWideTPR)
          ge += order_key(c[i]) >= static_cast<uint32_t>(hi);
        ge = __reduce_add_sync(tree::kFull, ge);
        if (lane == 0 && ge > 0) atomicAdd(&misc[kMiscGe], ge);
        __syncthreads();
        int copies = min(misc[kMiscGe] - done, take - done);
        const float tv = key_value(static_cast<uint32_t>(hi));
        while (copies > 0) {
          const int cnt = min(copies, kSortedM);
          const int off = (done + lo) & 31;
          for (int i = tid; i < cnt; i += kWideTPR) fb[win_slot(i + off)] = tv;
          __syncthreads();
          sum_round(done, cnt);
          __syncthreads();
          done += cnt;
          copies -= cnt;
        }
        if (done >= take) break;
      }
      const int need = min(kSortedM, take - done);
      const int off = (done + lo) & 31;
      cvar_wide_select(c, M, hi, x, hist, misc, need, off, tid);
      __syncthreads();
      sum_round(done, need);
      hi = order_key(fb[win_slot(need - 1 + off)]);
      done += need;
      __syncthreads();  // x is read before the next round writes it
    }
  }
  if (nan_sum) sum = __int_as_float(0x7fffffff);
  const float* ub = u + static_cast<size_t>(b) * T * 2;
  const float var0 = u_std[2 * b] * u_std[2 * b];
  const float var1 = u_std[2 * b + 1] * u_std[2 * b + 1];
  cs[tid] = streamed_coupling<kWideTPR>(
      noise + static_cast<size_t>(row) * T * 2, ub, var0, var1, T, Lc, tid);
  __syncthreads();
  if (tid < 32) {
    const float coupling = coupling_of_partials<kWideTPR>(cs, kWideTPR, tid);
    if (tid == 0)
      out[row] = (dyn ? sum / static_cast<float>(n)
                      : sum * (1.0f / static_cast<float>(n))) +
                 lam[b] * coupling;
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
    const size_t shm = sizeof(uint32_t) * wide_words();
    cvar_wide_kernel<<<rows, kWideTPR, shm, st>>>(
        costs, noise, u, u_std, lam, alpha, out, K, M, T, numel, Lc);
    return static_cast<int>(cudaGetLastError());
  }
  const int L = pow2_at_least(M, tpr);
  const int teams = tpr == 32 ? kWarpTeams : 1;
  const dim3 grid((rows + teams - 1) / teams), block(tpr * teams);
  const size_t shm =
      sizeof(uint32_t) * static_cast<size_t>(teams) * team_words(L, tpr);
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
