// The CVaR plus coupling kernels for the rows a team cannot stage or
// sort in shared memory, for Hopper (sm_90a): the same function as
// csrc/cvar_costs.cu's (see there), bit for bit with the plain version,
// on shapes that kernel's launcher refuses, in a library of its own
// (the shapes below them launch there as before).  Picked by the
// launcher from the shapes:
//
// - T > kStagedT (2T > 8192 coupling terms a row): cvar_coupling_kernel,
//   a launch of its own before the CVaR's, writes each row's coupling
//   (the halving tree of its 2T terms) to out; the CVaR kernel (the team
//   kernel's STREAM twin, or the wide kernel) reads it back and adds the
//   CVaR.  Bound: the noise's bytes, 8T a row.  A block of 256 threads
//   takes two rows of one scenario and spreads each over H = 512
//   position classes (a thread two: a step's two controls): class j sums
//   its positions j + H r over r in the halving tree's order, then the
//   block halves the H class sums (the identity coupling_of_partials
//   uses, for any power of two H).  A thread reads its positions in groups
//   of 4 r's (r = c + C s, s < 4: the first two levels, over s), each
//   group's 8-byte pieces copied into its own slots of a ring of three
//   stages in shared memory (cp.async) two groups ahead, so that no
//   register waits on a load; the groups' sums go, in bit-reversed order
//   of c, into a register stack of fixed depth (tree::Pairwise, 16
//   groups), and a stack in local memory takes the rare super-groups past
//   16 (T > 16,384).  u / sigma^2 is divided once for both rows.  At K =
//   1,024 the launch is 512 blocks, two an SM; the team kernel's twin had
//   a warp a row and few loads in flight.
// - M > kSortedM (16,384 keys: 1,024 threads x 16): cvar_wide_kernel, a
//   block of 1,024 threads a row, in rounds of at most kSortedM terms,
//   largest first.  The row's histogram of its keys' top 12 bits is built
//   once.  The block then walks the bins from the top: a round takes
//   whole bins while their keys fit in kSortedM, and refines by the next
//   8 bits (then 8, then the last 4: one more pass over the row, a
//   histogram of that bin alone) only the bin that does not fit even
//   alone; at the last level such a bin is one key's copies, summed as
//   such in rounds.  A round gathers its key range [lo, hi) from the row
//   in one pass (one shared atomic a warp a step) and sorts it in shared
//   memory: past 8,192 keys with a stable LSD radix sort, 4 bits a pass
//   over the digits its keys do not share (each thread counts its 16
//   keys' digits; a scan of the threads' counts places them), at 8,192
//   keys and fewer with the bitonic network the teams use, which measured
//   faster there.  It writes the first terms the take
//   still needs, largest first, to the windowed sum (XLA's CPU order,
//   window_round below), which the block folds at once; a window that
//   straddles two rounds carries its partial sum into the next, and every
//   level above the windows the same.  Equal keys are the same float, so
//   the sum adds the worst take costs in descending order, in the windows
//   the plain version has, in any number of rounds.  Every pass over the
//   row streams it through a ring of three steps in shared memory, each
//   thread copying its own costs two steps ahead (cp.async).  A static
//   count of M sums the row as stored, in rounds of kSortedM costs read
//   in order.  At T <= kStagedT the block sums the coupling itself (at
//   most 8 terms a thread, in registers).  One block an SM: at K = 256, M
//   = 70,000 the 132 rows in flight are 37 MB, which L2 keeps between a
//   row's passes.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cvar_common.cuh"

namespace cvar {

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

// -- the coupling past kStagedT ---------------------------------------------

constexpr int kCoupleThreads = 256;             // threads a block
constexpr int kCoupleH = 2 * kCoupleThreads;    // position classes a row
constexpr int kCoupleRows = 2;                  // rows a block
constexpr int kCoupleLeaves = 4;                // r's a group
constexpr int kCoupleStack = 16;                // groups a register stack
constexpr int kCoupleStages = 3;                // groups a thread in flight
constexpr int kCoupleBlocks = 2;                // blocks an SM

// log2 of the groups a thread sums at T steps: C = R / kCoupleLeaves
// groups of the R >= ceil(T / 256) step indices r (a power of two).
__host__ __device__ constexpr int coupling_log_groups(int T) {
  int c = 0;
  while ((kCoupleLeaves << c) * kCoupleThreads < T) ++c;
  return c;
}

// The ring of staged groups: [stage][s][u, then each row's noise][thread]
// float2.
__host__ __device__ constexpr int coupling_ring_bytes() {
  return kCoupleStages * kCoupleLeaves * (kCoupleRows + 1) *
         kCoupleThreads * 8;
}

// The (scenario, rollout) rows 2 q + {0, 1} of scenario b = blockIdx.x /
// kblocks, q = blockIdx.x % kblocks: out[b, k] = the halving tree of the
// 2T terms noise[b, k, t, c] * (u[b, t, c] / u_std[b, c]^2).  Thread j
// holds classes 2j and 2j + 1: step t = j + 256 r, r = c + C s.
__global__ void __launch_bounds__(kCoupleThreads, kCoupleBlocks)
cvar_coupling_kernel(const float* __restrict__ noise,
                     const float* __restrict__ u,
                     const float* __restrict__ u_std,
                     float* __restrict__ out, int K, int T, int log_c,
                     int kblocks) {
  extern __shared__ __align__(16) uint32_t ring_words[];
  __shared__ __align__(16) float cs[kCoupleRows][kCoupleH];
  constexpr int kCols = 2 * kCoupleRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / kblocks;
  const int k0 = (blockIdx.x - b * kblocks) * kCoupleRows;
  const float var0 = u_std[2 * b] * u_std[2 * b];
  const float var1 = u_std[2 * b + 1] * u_std[2 * b + 1];
  const float2* ub = reinterpret_cast<const float2*>(u) +
                     static_cast<size_t>(b) * T;
  const float2* nz[kCoupleRows];
  bool live[kCoupleRows];
#pragma unroll
  for (int q = 0; q < kCoupleRows; ++q) {
    live[q] = k0 + q < K;
    nz[q] = reinterpret_cast<const float2*>(noise) +
            (static_cast<size_t>(b) * K + (live[q] ? k0 + q : k0)) * T;
  }
  const int C = 1 << log_c;
  const int inner = min(C, kCoupleStack);
  const int log_in = tree::ilog2_run(inner);
  float2* ring = reinterpret_cast<float2*>(ring_words);
  auto slot = [&](int stage, int s, int col) {
    return ring + ((stage * kCoupleLeaves + s) * (kCoupleRows + 1) + col) *
                      kCoupleThreads + tid;
  };
  // Group i's copies (each thread its own slots), one commit a group.
  auto issue = [&](int i) {
    if (i < C) {
      const int c = tree::bit_reverse_bits(i, log_c);
      const int stage = i % kCoupleStages;
#pragma unroll
      for (int s = 0; s < kCoupleLeaves; ++s) {
        const int t = tid + kCoupleThreads * (c + C * s);
        if (t < T) {
          __pipeline_memcpy_async(slot(stage, s, 0), ub + t, 8);
#pragma unroll
          for (int q = 0; q < kCoupleRows; ++q)
            if (live[q]) __pipeline_memcpy_async(slot(stage, s, 1 + q),
                                                 nz[q] + t, 8);
        }
      }
    }
    __pipeline_commit();
  };

  // Group i's leaves of each column (row q's x or y class), from its
  // stage (positions past 2T are -0.0, whatever the slot holds), halved
  // over s, then pushed onto the register stack as leaf push_as; then the
  // copies of group i + 2 into the stage just read.
  auto group = [&](int i, tree::Pairwise<kCoupleStack, kCols>& st,
                   int push_as) {
    const int c = tree::bit_reverse_bits(i, log_c);
    float2 us[kCoupleLeaves];
    float2 v[kCoupleRows][kCoupleLeaves];
    __pipeline_wait_prior(kCoupleStages - 2);
#pragma unroll
    for (int s = 0; s < kCoupleLeaves; ++s) {
      us[s] = *slot(i % kCoupleStages, s, 0);
#pragma unroll
      for (int q = 0; q < kCoupleRows; ++q)
        v[q][s] = *slot(i % kCoupleStages, s, 1 + q);
    }
    float y[kCols][kCoupleLeaves];
#pragma unroll
    for (int s = 0; s < kCoupleLeaves; ++s) {
      const bool ok = tid + kCoupleThreads * (c + C * s) < T;
      const float s0 = us[s].x / var0, s1 = us[s].y / var1;
#pragma unroll
      for (int q = 0; q < kCoupleRows; ++q) {
        y[2 * q][s] = ok ? v[q][s].x * s0 : -0.0f;
        y[2 * q + 1][s] = ok ? v[q][s].y * s1 : -0.0f;
      }
    }
    float leaf[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      tree::halve<kCoupleLeaves>(y[j]);
      leaf[j] = y[j][0];
    }
    st.push(push_as, leaf);
    issue(i + kCoupleStages - 1);
  };
  // The stack's sum after `inner` pushes: acc[log_in], read with constant
  // indices.
  auto top = [&](const tree::Pairwise<kCoupleStack, kCols>& st, int j) {
    float x = 0.0f;
#pragma unroll
    for (int l = 0; l <= tree::Pairwise<kCoupleStack, kCols>::kLog; ++l)
      if (l == log_in) x = st.acc[l][j];
    return x;
  };

  for (int n = 0; n < kCoupleStages - 1; ++n) issue(n);
  float part[kCols];
  if (C <= kCoupleStack) {
    tree::Pairwise<kCoupleStack, kCols> st;
    for (int i = 0; i < C; ++i) group(i, st, i);
#pragma unroll
    for (int j = 0; j < kCols; ++j) part[j] = top(st, j);
  } else {
    // Super-groups of 16 groups, their sums pushed in order onto stacks
    // in local memory (one push every 16 groups).
    tree::Streamed outer[kCols];
    for (int o = 0; o < C / kCoupleStack; ++o) {
      tree::Pairwise<kCoupleStack, kCols> st;
      for (int i = 0; i < kCoupleStack; ++i)
        group(o * kCoupleStack + i, st, i);
#pragma unroll
      for (int j = 0; j < kCols; ++j) outer[j].push(o, top(st, j));
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      part[j] = outer[j].sum(log_c - tree::ilog2(kCoupleStack));
  }
#pragma unroll
  for (int q = 0; q < kCoupleRows; ++q)
    reinterpret_cast<float2*>(cs[q])[tid] =
        make_float2(part[2 * q], part[2 * q + 1]);
  __syncthreads();
  if (warp < kCoupleRows) {
    const float x = coupling_of_partials<kCoupleH>(cs[warp], kCoupleH, lane);
    if (lane == 0 && live[warp])
      out[static_cast<size_t>(b) * K + k0 + warp] = x;
  }
}

// -- the wide CVaR ----------------------------------------------------------

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
// x[win_slot(p + off0)], p < c, off0 = (st.s[0] + win_lo(n0)) & 31.
// last: no term follows (any still missing are zeros, which change no
// sum).  Every thread of the block calls it; wa, wb and carry are the
// block's level buffers, st its progress, in shared memory (registers are
// what the rounds' sort runs short of; for a static count of M, which
// sorts nothing, registers measured slower on an H100), which thread 0
// moves on once every thread has read a level's.  Returns the sum in
// thread 0 after the last round (+0.0 when no term came), 0.0 elsewhere.
__device__ float window_round(WinState& st, int n0, const float* x,
                              float* wa, float* wb, float* carry, int c,
                              bool last, int tid) {
  float result = 0.0f;
  const float* in = x;
  int n = n0;
  // Each level's progress is read before the barrier after which thread 0
  // moves the level below it on (level 0's at the start, its own barrier
  // only when it is the top: a row of at most 32 terms).
  int s = st.s[0], ph = st.ph[0];
  for (int k = 0; k < kWinLevels; ++k) {
    const int m = (n + 31) >> 5;
    const int lo = win_lo(n);
    const bool top = n <= 32;
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
    int s_next = 0, ph_next = 0;
    if (!top && k + 1 < kWinLevels) {
      s_next = st.s[k + 1];
      ph_next = st.ph[k + 1];
    }
    if (!top || k == 0) __syncthreads();  // level k read (its sums written)
    if (tid == 0) {
      st.s[k] = s + c;
      if (ncomp < nwin) st.ph[k] = ph ^ 1;
    }
    if (top) break;
    if (ncomp == 0 && !last) break;
    c = ncomp;
    in = out;
    n = m;
    s = s_next;
    ph = ph_next;
  }
  return result;
}

constexpr int kWideWarps = kWideTPR / 32;
constexpr int kWideKPT = kSortedM / kWideTPR;  // a round's keys a thread
constexpr int kSweep = 8;                      // keys a thread a step
constexpr int kSweepStages = 3;                // steps staged a sweep
constexpr int kRadixFrom = 8192;               // rounds past it: radix sort
static_assert(kRadixFrom <= 8 * kWideTPR, "the bitonic rounds' E <= 8");
static_assert(kSweepStages * kSweep * kWideTPR >=
                  kSortedM + kSortedM / kWideKPT,
              "the sweeps' ring holds a radix round's keys");
constexpr int kGather = 0, kRefine = 1, kCopies = 2;

// The histograms' levels: a key's top 12 bits, then 8, 8 and its last 4
// (a bin of the last level is one key).  Level L's digit: bits [shift,
// shift + bits); its bins at lh[level_base(L) ..).
constexpr int kLevels = 4;
__host__ __device__ constexpr int level_bits(int L) {
  return L == 0 ? 12 : L == 3 ? 4 : 8;
}
__host__ __device__ constexpr int level_shift(int L) {
  return L == 0 ? 20 : L == 1 ? 12 : L == 2 ? 4 : 0;
}
__host__ __device__ constexpr int level_base(int L) {
  return L == 0 ? 0 : (1 << 12) + kBins * (L - 1);
}
constexpr int kLevelWords = (1 << 12) + kBins * 3;

// The walk over the row's histograms, the same in every thread, in shared
// memory (registers are what the rounds' sort runs short of): the bound
// below which the keys left lie, the deepest level built, each level's
// next bin (walking down; -1: done) and its prefix (the key bits above its
// digit), the round being planned (its keys so far, its least key bound,
// and what the block does next), and the sum.
struct WideWalk {
  uint64_t hi;  // the keys left lie below hi
  int level;
  int cursor[kLevels];
  uint32_t prefix[kLevels];
  int acc;
  uint32_t lo;
  int action;
  float sum;    // the windowed sum, once its last round is folded
};

// Every thread: the row's costs as keys (0 past M), a step of kSweep a
// thread at a time, f(k) on each step's (every lane of a warp at once).
// Each thread copies its own costs of the next kSweepStages - 1 steps
// into its slots of the ring (cp.async, 4 bytes each) while it works on
// this step: no barrier, and the loads in flight take no registers.
// (16-byte copies of aligned rows measured no faster on an H100.)
template <class F>
__device__ __forceinline__ void sweep_row(const float* c, int M,
                                          float* ring, int tid, F f) {
  constexpr int kStep = kSweep * kWideTPR;
  const int steps = (M + kStep - 1) / kStep;
  auto issue = [&](int n) {
    if (n < steps) {
      float* st = ring + (n % kSweepStages) * kStep + tid;
#pragma unroll
      for (int j = 0; j < kSweep; ++j) {
        const int i = n * kStep + j * kWideTPR + tid;
        if (i < M) __pipeline_memcpy_async(st + j * kWideTPR, c + i, 4);
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int n = 0; n < kSweepStages - 1; ++n) issue(n);
  for (int n = 0; n < steps; ++n) {
    __pipeline_wait_prior(kSweepStages - 2);
    const float* st = ring + (n % kSweepStages) * kStep + tid;
    uint32_t k[kSweep];
#pragma unroll
    for (int j = 0; j < kSweep; ++j)
      k[j] = n * kStep + j * kWideTPR + tid < M ? order_key(st[j * kWideTPR])
                                                : 0u;
    issue(n + kSweepStages - 1);  // into the stage read a step ago
    f(k);
  }
}

// Level L's histogram h of the row's keys under the walk's prefix there
// (the keys whose bits above the level's digit are the prefix's), by
// digit, one shared atomic a key (measured on an H100 faster than
// aggregating a warp's equal digits first, by ballots or __match_any_sync,
// and than a histogram a warp); with kCountNonFinite, the row's NaN and
// +inf keys and its -inf keys added to nf[0] and nf[1].
template <bool kCountNonFinite>
__device__ void wide_histogram(const float* c, int M, int L,
                               uint32_t prefix, int* h, float* ring,
                               int* nf, int tid) {
  const int lane = tid & 31;
  const int bins = 1 << level_bits(L), shift = level_shift(L);
  for (int i = tid; i < bins; i += kWideTPR) h[i] = 0;
  __syncthreads();
  const uint32_t mask = L == 0 ? 0u : ~0u << (shift + level_bits(L));
  const uint32_t want = prefix & mask;
  int hi_n = 0, lo_n = 0;
  sweep_row(c, M, ring, tid, [&](const uint32_t (&k)[kSweep]) {
#pragma unroll
    for (int j = 0; j < kSweep; ++j) {
      if (k[j] != 0u && (k[j] & mask) == want)
        atomicAdd(&h[(k[j] >> shift) & (bins - 1)], 1);
      if (kCountNonFinite) {
        hi_n += k[j] >= kKeyPosInf;
        lo_n += k[j] == kKeyNegInf;
      }
    }
  });
  if (kCountNonFinite) {
    hi_n = __reduce_add_sync(tree::kFull, hi_n);
    lo_n = __reduce_add_sync(tree::kFull, lo_n);
    if (lane == 0 && (hi_n | lo_n)) {
      atomicAdd(&nf[0], hi_n);
      atomicAdd(&nf[1], lo_n);
    }
  }
  __syncthreads();
}

// Warp 0: the next round's plan from the walk, need the terms still
// wanted (>= 1; the round's keys so far fewer).  Takes whole bins from
// each level's cursor down, 256 at a time, while the round's keys fit in
// kSortedM; stops (kGather) at the bin whose keys reach need, or before a
// bin that does not fit; a bin that does not fit alone, or one that does
// not fit where the take ends, is refined (kRefine: the next level's
// prefix, its histogram for the block to build), or at the last level,
// where a bin is one key, summed as copies (kCopies: acc of them, the key
// in lo) when the round holds nothing else.
__device__ void plan_round(WideWalk* w, const int* lh, int need, int lane) {
  for (;;) {
    const int L = w->level, cur = w->cursor[L];
    if (cur < 0) {
      if (L == 0) {  // no key left (the counts reach every take)
        if (lane == 0) w->action = kGather;
        __syncwarp();
        return;
      }
      if (lane == 0) w->level = L - 1;
      __syncwarp();
      continue;
    }
    // Lane l: the bins cur - 8 l - j, j < 8, from the top.
    const int* h = lh + level_base(L);
    const int acc = w->acc;
    int cnt[8], s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int bin = cur - 8 * lane - j;
      cnt[j] = bin >= 0 ? h[bin] : 0;
      s += cnt[j];
    }
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(tree::kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(tree::kFull, incl, 31);
    // The first bin (its distance below cur) whose running count reaches
    // need, and the first whose running count passes kSortedM: each holds
    // a key, so it lies at or above bin 0.
    int first_need = kBins, first_over = kBins;
    int run = acc + incl - s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      run += cnt[j];
      if (run >= need && first_need == kBins) first_need = 8 * lane + j;
      if (run > kSortedM && first_over == kBins) first_over = 8 * lane + j;
    }
    first_need = __reduce_min_sync(tree::kFull, first_need);
    first_over = __reduce_min_sync(tree::kFull, first_over);
    const int shift = level_shift(L);
    const uint32_t prefix = w->prefix[L];
    if (first_over == kBins && first_need == kBins) {
      // These 256 bins all fit and do not reach need: take them all.
      const int low = max(cur - (kBins - 1), 0);
      if (lane == 0) {
        w->acc = acc + total;
        w->lo = prefix | (static_cast<uint32_t>(low) << shift);
        w->cursor[L] = low - 1;
      }
      __syncwarp();
      continue;
    }
    // The running count at bin e (its distance below cur) and e's count.
    const int e_at = first_need < first_over ? first_need : first_over;
    int run_e = 0, cnt_e = 0;
    {
      int r = acc + incl - s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        r += cnt[j];
        if (8 * lane + j == e_at) {
          run_e = r;
          cnt_e = cnt[j];
        }
      }
      run_e = __shfl_sync(tree::kFull, run_e, e_at >> 3);
      cnt_e = __shfl_sync(tree::kFull, cnt_e, e_at >> 3);
    }
    const int e = cur - e_at;
    if (first_need < first_over) {
      // Bins cur .. e fit and reach need: the round ends with them.
      if (lane == 0) {
        w->acc = run_e;
        w->lo = prefix | (static_cast<uint32_t>(e) << shift);
        w->cursor[L] = e - 1;
        w->action = kGather;
      }
      __syncwarp();
      return;
    }
    // Bin e does not fit: the round takes the bins above it.
    const int above = run_e - cnt_e;
    if (lane == 0) {
      if (e < cur) {
        w->acc = above;
        w->lo = prefix | (static_cast<uint32_t>(e + 1) << shift);
      }
      w->cursor[L] = e;
      w->action = kGather;
      // Refined: a bin too large for any round, or the one where the take
      // ends (its sub-bins fill this round, not a round of their own).
      if (cnt_e > kSortedM || run_e >= need) {
        if (L + 1 < kLevels) {
          w->cursor[L] = e - 1;
          w->level = L + 1;
          w->cursor[L + 1] = (1 << level_bits(L + 1)) - 1;
          w->prefix[L + 1] = prefix | (static_cast<uint32_t>(e) << shift);
          w->action = kRefine;
        } else if (cnt_e > kSortedM && above == 0) {
          w->cursor[L] = e - 1;
          w->acc = cnt_e;
          w->lo = prefix | static_cast<uint32_t>(e);
          w->action = kCopies;
        }
      }
    }
    __syncwarp();
    return;
  }
}

// Where a round's key p waits for its sort: one word of padding after
// every kWideKPT for the radix sort (thread t's keys kWideKPT t + i at
// (kWideKPT + 1) t + i: no bank conflict), none for the bitonic network.
__device__ __forceinline__ int sort_slot(int p, bool radix) {
  return radix ? p + p / kWideKPT : p;
}
constexpr int kRoundWords =
    round4(win_words(kSortedM) > kSortedM + kSortedM / kWideKPT
               ? win_words(kSortedM)
               : kSortedM + kSortedM / kWideKPT);

// The block's exclusive prefix sums of the 16 * kWideTPR 16-bit counts in
// a (8 words, 16 counts a thread), in place; sums: kWideWarps words.
__device__ void block_exclusive_scan16(int* a, int* sums, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  int4* a4 = reinterpret_cast<int4*>(a) + 2 * tid;
  const int4 p = a4[0], q = a4[1];
  const int w[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += (w[j] & 0xffff) + (w[j] >> 16);
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(tree::kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = sums[lane];
    int x = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(tree::kFull, x, o);
      if (lane >= o) x += y;
    }
    sums[lane] = x - t;
  }
  __syncthreads();
  int base = sums[warp] + incl - s;
  int out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lo = base;
    base += w[j] & 0xffff;
    out[j] = lo | (base << 16);
    base += w[j] >> 16;
  }
  a4[0] = make_int4(out[0], out[1], out[2], out[3]);
  a4[1] = make_int4(out[4], out[5], out[6], out[7]);
}

// A round's got keys (at sort_slot(p, true) of x, any order; vary: the
// bits they do not all share) sorted descending by a stable LSD radix
// sort, 4 bits a pass over the digits that vary, each pass from x to
// spare or back (the keys read twice from shared memory, never held in
// registers: with them held, 1,024 threads at 64 registers spilled), and
// the first min(got, need) written as values to the terms p at
// x[win_slot(p + off)].  Blocked:
// thread t holds the keys at positions kWideKPT t + i.  It counts its
// keys' digits in cnt16[(15 - digit) * threads + t] (16 bits each, its
// own: no atomic; counting in registers measured slower), a key's rank
// among its thread's keys of its digit kept in 4 bits of a register, and
// the counts' scan places its keys after those of larger digits and of
// earlier threads.
__device__ void round_sort(uint32_t* x, uint32_t* spare, int got, int need,
                           int off, uint32_t vary, int* cntw, int* sums,
                           int tid) {
  float* fb = reinterpret_cast<float*>(x);
  unsigned short* cnt16 = reinterpret_cast<unsigned short*>(cntw);
  const int emit = min(got, need);
  if (vary == 0u) {  // one key value: no order to find
    const uint32_t k = x[0];
    __syncthreads();
    const float val = key_value(k);
    for (int p = tid; p < emit; p += kWideTPR) fb[win_slot(p + off)] = val;
    return;
  }
  constexpr int kE = kWideKPT;
  int passes = 0;
  for (int dp = 0; dp < 8; ++dp) passes += ((vary >> (4 * dp)) & 0xfu) != 0u;
  // The passes alternate between x and spare, and the last reads spare
  // (it writes the terms into x): an odd count starts with a copy.
  uint32_t* src = x;
  uint32_t* dst = spare;
  if (passes & 1) {
    for (int i = 0; i < kE; ++i) {
      const int slot = (kE + 1) * tid + i;
      if (kE * tid + i < got) spare[slot] = x[slot];
    }
    src = spare;
    dst = x;
  }
  int pass = 0;
  for (int dp = 0; dp < 8; ++dp) {
    if (((vary >> (4 * dp)) & 0xfu) == 0u) continue;
    const int shift = 4 * dp;
    const bool last = ++pass == passes;
    uint32_t rk[kE / 8] = {};
    int4* c4 = reinterpret_cast<int4*>(cntw);
    for (int i = tid; i < kBins * kWideWarps / 4; i += kWideTPR)
      c4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      if (kE * tid + i < got) {
        const uint32_t d = (src[(kE + 1) * tid + i] >> shift) & 0xfu;
        const int idx = (15 - static_cast<int>(d)) * kWideTPR + tid;
        const uint32_t seen = cnt16[idx];
        cnt16[idx] = static_cast<unsigned short>(seen + 1);
        rk[i >> 3] |= seen << (4 * (i & 7));
      }
    }
    __syncthreads();
    block_exclusive_scan16(cntw, sums, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      if (kE * tid + i < got) {
        const uint32_t k = src[(kE + 1) * tid + i];
        const uint32_t d = (k >> shift) & 0xfu;
        const int pos = cnt16[(15 - static_cast<int>(d)) * kWideTPR + tid] +
                        static_cast<int>((rk[i >> 3] >> (4 * (i & 7))) & 0xfu);
        if (last) {
          if (pos < emit) fb[win_slot(pos + off)] = key_value(k);
        } else {
          dst[sort_slot(pos, true)] = k;
        }
      }
    }
    __syncthreads();  // the bases read before the next pass zeroes them
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
}

// A row a block of kWideTPR threads, M > kSortedM: the worst take keys in
// rounds of at most kSortedM (see the top of the file); the coupling
// summed here (T <= kStagedT) or read from out (past it, written by
// cvar_coupling_kernel).  Shared memory: a round's keys and terms
// (padded; at the end the coupling's partial sums), the counts below, the
// windows' level buffers and carries (wide_words(true): all that a static
// count of M uses), then the radix sort's counts, the levels' histograms
// and the sweeps' ring (wide_words(false)).
constexpr int kWideMisc = 8 + kWideWarps;  // gathered count, OR and AND of
                                           // its keys, non-finite counts
                                           // (2), spare; the scan's sums

__host__ __device__ constexpr int wide_words(bool unsorted) {
  return kRoundWords + kWideMisc + win_words(win_count(kSortedM)) +
         win_words(win_count(win_count(kSortedM))) + 2 * kWinLevels +
         (unsorted ? 0
                   : kBins * kWideWarps + kLevelWords +
                         kSweepStages * kSweep * kWideTPR);
}

// kUnsorted: a static count of M (the launcher's choice), an
// instantiation of its own, whose code ptxas allocates apart from the
// rounds' sort (sharing one instantiation with it, this path measured
// 2-4% slower on an H100).
template <bool kUnsorted>
__global__ void __launch_bounds__(kWideTPR, 1)
cvar_wide_kernel(const float* __restrict__ costs,
                 const float* __restrict__ noise,
                 const float* __restrict__ u,
                 const float* __restrict__ u_std,
                 const float* __restrict__ lam,
                 const float* __restrict__ alpha, float* __restrict__ out,
                 int K, int M, int T, int numel, int Lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ WideWalk walk;
  __shared__ WinState win;
  uint32_t* x = smem;
  int* misc = reinterpret_cast<int*>(smem + kRoundWords);
  float* wa = reinterpret_cast<float*>(misc + kWideMisc);
  float* wb = wa + win_words(win_count(kSortedM));
  float* carry = wb + win_words(win_count(win_count(kSortedM)));
  int* cnt = reinterpret_cast<int*>(carry + 2 * kWinLevels);
  int* lh = cnt + kBins * kWideWarps;
  float* ring = reinterpret_cast<float*>(lh + kLevelWords);
  uint32_t* orand = reinterpret_cast<uint32_t*>(misc + 1);
  int* nf = misc + 3;
  int* sums = misc + 8;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x;
  const int b = row / K;
  const float* c = costs + static_cast<size_t>(row) * M;
  const bool dyn = alpha != nullptr;
  const int n =
      dyn ? static_cast<int>(ceilf(static_cast<float>(M) * alpha[b])) : numel;
  const int take = min(max(n, 0), M);
  const int Lw = dyn ? M : take;
  const int lo = win_lo(Lw);
  float* fb = reinterpret_cast<float*>(x);

  // One round: the cnt terms at fb[win_slot(p + (done + lo) & 31)],
  // summed on; the sum when they are the last.
  if (tid < kWinLevels) win.s[tid] = win.ph[tid] = 0;  // read after a barrier
  if (tid == 0) walk.sum = 0.0f;  // read after a barrier
  auto sum_round = [&](int done, int cnt_round) {
    const bool last = done + cnt_round >= take;
    const float r = Lw == 1 ? fb[win_slot(lo)]
                            : window_round(win, Lw, fb, wa, wb, carry,
                                           cnt_round, last, tid);
    if (last && tid == 0) walk.sum = r;
  };
  const bool count_nf = dyn && take < M;
  if constexpr (kUnsorted) {
    for (int done = 0; done < M; done += kSortedM) {
      const int cnt_round = min(kSortedM, M - done);
      const int off = (done + lo) & 31;
      for (int i = tid; i < cnt_round; i += kWideTPR)
        fb[win_slot(i + off)] = c[done + i];
      __syncthreads();
      sum_round(done, cnt_round);
      __syncthreads();  // the terms are read before the next round's
    }
  } else {
    // The level-0 histogram, and (a run-time alpha's mask times an
    // infinite or NaN cost is NaN: 0 * inf) the row's non-finite keys.
    if (tid == 0) {
      nf[0] = nf[1] = 0;
      walk.hi = uint64_t{1} << 32;
      walk.level = 0;
      walk.cursor[0] = (1 << level_bits(0)) - 1;
      walk.prefix[0] = 0u;
      walk.acc = 0;
    }
    if (count_nf) {
      wide_histogram<true>(c, M, 0, 0u, lh, ring, nf, tid);
    } else {
      wide_histogram<false>(c, M, 0, 0u, lh, ring, nf, tid);
    }
    int done = 0;  // the terms summed
    while (done < take) {
      for (;;) {
        if (tid == 0) {
          misc[0] = 0;
          orand[0] = 0u;
          orand[1] = ~0u;
        }
        __syncthreads();
        if (tid < 32) plan_round(&walk, lh, take - done, lane);
        __syncthreads();
        if (walk.action != kRefine) break;
        wide_histogram<false>(c, M, walk.level, walk.prefix[walk.level],
                              lh + level_base(walk.level), ring, nf, tid);
      }
      const int need = take - done;
      const int got = walk.acc;
      const uint32_t round_lo = walk.lo;
      if (got == 0) break;  // no key left: the counts cover every take
      if (walk.action == kCopies) {
        const float tv = key_value(round_lo);
        for (int copies = min(got, need); copies > 0;) {
          const int cnt_round = min(copies, kSortedM);
          const int off = (done + lo) & 31;
          for (int i = tid; i < cnt_round; i += kWideTPR)
            fb[win_slot(i + off)] = tv;
          __syncthreads();
          sum_round(done, cnt_round);
          __syncthreads();
          done += cnt_round;
          copies -= cnt_round;
        }
      } else {
        // Gather the round's keys [round_lo, hi): a warp counts its picks
        // of a step's kSweep keys a thread and takes their slots with one
        // atomic.
        const bool radix = got > kRadixFrom;
        const uint64_t hi = walk.hi;
        uint32_t any_bits = 0u, all_bits = ~0u;
        sweep_row(c, M, ring, tid, [&](const uint32_t (&k)[kSweep]) {
          unsigned m[kSweep];
          int total = 0;
#pragma unroll
          for (int j = 0; j < kSweep; ++j) {
            m[j] = __ballot_sync(tree::kFull, k[j] != 0u && k[j] >= round_lo &&
                                                  k[j] < hi);
            total += __popc(m[j]);
          }
          if (total == 0) return;
          int base = 0;
          if (lane == 0) base = atomicAdd(&misc[0], total);
          base = __shfl_sync(tree::kFull, base, 0);
#pragma unroll
          for (int j = 0; j < kSweep; ++j) {
            const int slot = base + __popc(m[j] & ((1u << lane) - 1u));
            if (((m[j] >> lane) & 1u) && slot < kSortedM) {
              x[sort_slot(slot, radix)] = k[j];
              any_bits |= k[j];
              all_bits &= k[j];
            }
            base += __popc(m[j]);
          }
        });
        any_bits = __reduce_or_sync(tree::kFull, any_bits);
        all_bits = __reduce_and_sync(tree::kFull, all_bits);
        if (lane == 0) {
          atomicOr(&orand[0], any_bits);
          atomicAnd(&orand[1], all_bits);
        }
        __syncthreads();
        // Sorted: past kRadixFrom keys by the radix sort, else by the
        // bitonic network (sort_gathered: at 8,192 keys and fewer it
        // measured faster on an H100, at 14,000 slower).
        const int off = (done + lo) & 31;
        if (radix) {
          round_sort(x, reinterpret_cast<uint32_t*>(ring), got, need, off,
                     orand[0] ^ orand[1], cnt, sums, tid);
        } else {
          const int e = max(1, pow2_at_least(got, 1) / kWideTPR);
#define CVAR_WIDE_BITONIC(E_) \
  if (e == E_) sort_gathered<kWideTPR, E_>(x, got, min(got, need), 0u, off, tid);
          CVAR_WIDE_BITONIC(1)
          CVAR_WIDE_BITONIC(2)
          CVAR_WIDE_BITONIC(4)
          CVAR_WIDE_BITONIC(8)
#undef CVAR_WIDE_BITONIC
        }
        __syncthreads();
        const int emit = min(got, need);
        sum_round(done, emit);
        done += emit;
        __syncthreads();  // x is read before the next round writes it
      }
      if (tid == 0) {
        walk.hi = round_lo;
        walk.acc = 0;
      }
    }
  }

  // The coupling: past kStagedT the row's, from out; else its 2T <= 8192
  // terms here, at most 8 a thread (positions tid + 1024 r, halved over
  // r), then the block's partial sums (where the rounds' terms were).
  float coupling = 0.0f;
  if (T > kStagedT) {
    if (tid == 0) coupling = out[row];
  } else {
    const float* nz = noise + static_cast<size_t>(row) * T * 2;
    const float* ub = u + static_cast<size_t>(b) * T * 2;
    const float var0 = u_std[2 * b] * u_std[2 * b];
    const float var1 = u_std[2 * b + 1] * u_std[2 * b + 1];
    constexpr int kR = 8192 / kWideTPR;
    float y[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) y[r] = -0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {  // no division past 2T
      const int p = tid + kWideTPR * r;
      if (p >= 2 * T) break;
      y[r] = nz[p] * (ub[p] / ((p & 1) ? var1 : var0));
    }
    tree::halve<kR>(y);
    fb[tid] = y[0];
    __syncthreads();
    if (tid < 32) coupling = coupling_of_partials<kWideTPR>(fb, Lc, tid);
  }
  if (tid == 0) {
    // The row's scenario and count again from the arguments: held in
    // registers through the rounds, they made ptxas spill at 64.
    const int b_row = blockIdx.x / K;
    const int n_row = alpha != nullptr
        ? static_cast<int>(ceilf(static_cast<float>(M) * alpha[b_row])) : numel;
    const int take_row = min(max(n_row, 0), M);
    const float sum = alpha != nullptr && take_row < M &&
                              masked_nonfinite(nf[0], nf[1], take_row, M)
                          ? __int_as_float(0x7fffffff)
                          : walk.sum;
    out[blockIdx.x] = (alpha != nullptr ? sum / static_cast<float>(n_row)
                    : sum * (1.0f / static_cast<float>(n_row))) +
               lam[b_row] * coupling;
  }
}

}  // namespace cvar

using namespace cvar;

// Lets the STREAM twins, the wide kernel and the coupling kernel take a
// block's whole opt-in shared memory on the current device (less what each
// holds statically).  Call once a card, before a launch and outside a
// capture.  Returns the first failing call's cudaError_t.
extern "C" int cvar_wide_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
#define CVAR_PREPARE_ONE(F_)                                               \
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, F_);          \
  if (err == cudaSuccess)                                                  \
    err = cudaFuncSetAttribute(                                            \
        F_, cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
        optin - static_cast<int>(attr.sharedSizeBytes));
#define CVAR_PREPARE(TPR_, E_) CVAR_PREPARE_ONE((cvar_costs_kernel<TPR_, E_, true>))
  CVAR_SHAPES(CVAR_PREPARE)
  CVAR_PREPARE_ONE(cvar_wide_kernel<true>)
  CVAR_PREPARE_ONE(cvar_wide_kernel<false>)
  CVAR_PREPARE_ONE(cvar_coupling_kernel)
#undef CVAR_PREPARE
#undef CVAR_PREPARE_ONE
  return static_cast<int>(err);
}

// The coupling past kStagedT: noise (B, K, T, 2), u (B, T, 2), u_std (B,
// 2), float32, contiguous, on the current device; out (B, K) gets each
// row's halving-tree sum of noise * (u / u_std^2) (without lambda).  B * K
// < 2^31.  Returns the launch's cudaError_t.
extern "C" int cvar_coupling_launch(const float* noise, const float* u,
                                    const float* u_std, float* out, int B,
                                    int K, int T, void* stream) {
  const long long kblocks = (static_cast<long long>(K) + kCoupleRows - 1) /
                            kCoupleRows;
  const long long blocks = kblocks * B;
  if (B < 1 || K < 1 || T < 1 || static_cast<long long>(B) * K >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cvar_coupling_kernel<<<static_cast<unsigned>(blocks), kCoupleThreads,
                         coupling_ring_bytes(),
                         static_cast<cudaStream_t>(stream)>>>(
      noise, u, u_std, out, K, T, coupling_log_groups(T),
      static_cast<int>(kblocks));
  return static_cast<int>(cudaGetLastError());
}

// Arguments as csrc/cvar_costs.cu's cvar_costs_launch, on the shapes it
// refuses: M > kSortedM (the wide kernel, tpr 1024), else T > kStagedT
// (the team tpr's STREAM twin).  Past T = kStagedT, out must hold each
// row's coupling (cvar_coupling_launch, on the same stream, before).  B *
// K < 2^31.  Returns the launch's cudaError_t.
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
    const bool unsorted = alpha == nullptr && numel >= M;
    const size_t shm = sizeof(uint32_t) * wide_words(unsorted);
    if (unsorted) {
      cvar_wide_kernel<true><<<rows, kWideTPR, shm, st>>>(
          costs, noise, u, u_std, lam, alpha, out, K, M, T, numel, Lc);
    } else {
      cvar_wide_kernel<false><<<rows, kWideTPR, shm, st>>>(
          costs, noise, u, u_std, lam, alpha, out, K, M, T, numel, Lc);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int L = pow2_at_least(M, tpr);
  const int teams = tpr == 32 ? kWarpTeams : 1;
  const dim3 grid((rows + teams - 1) / teams), block(tpr * teams);
  const size_t shm =
      sizeof(uint32_t) * static_cast<size_t>(teams) * team_words(L, 0);
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
