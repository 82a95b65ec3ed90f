// What the CVaR plus coupling kernels share (csrc/cvar_costs.cu, the
// teams whose coupling is staged in shared memory; csrc/cvar_wide.cu,
// their twins that read a coupling launched before them, and the wide
// kernel): the float order keys, the team's bitonic sort, the MSD radix
// select, the CVaR's windowed sum (XLA's CPU order) and the team kernel
// itself.  See csrc/cvar_costs.cu for the design.
#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tree_sum.cuh"

// A named namespace (not an anonymous one, whose mangled names carry a
// hash of the source's path): the kernels' names, and so ptxas's input and
// its register allocation, do not depend on where the repository is.
namespace cvar {

constexpr int kBins = 256;       // an 8-bit digit's histogram
constexpr int kMisc = 8;         // bin, keys above it, keys in it, the
                                 // gathered count; spare
constexpr int kWarpTeams = 4;    // rows a block when a warp takes a row
constexpr int kSelectFrom = 256; // the padded rows that select first
constexpr int kStagedT = 4096;   // the longest horizon staged in shared
                                 // memory (Lc = 8192 words)
constexpr int kSortedM = 1024 * 16;  // the longest row a team sorts
                                     // (1,024 x 16), and a wide round's
                                     // most keys
constexpr int kWideTPR = 1024;   // cvar_wide_kernel's threads, a row

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

__host__ __device__ __forceinline__ int pow2_at_least(int n, int floor) {
  int p = floor;
  while (p < n) p <<= 1;
  return p;
}

template <int TPR>
__device__ __forceinline__ void team_sync() {
  if constexpr (TPR == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The CVaR's sum in XLA's CPU order (ops/tree.py::window_sum): a level
// of n terms is padded with +0.0 to m = ceil(n / 32) windows of 32, lo =
// (32 m - n) / 2 zeros in front; each window folds left to right from
// +0.0; the m partial sums are the next level's terms, up to the level of
// at most 32 terms, whose one window is the sum (one term alone: itself).
//
// A team holds a level's terms in shared memory one word of padding
// after every 32 (term q of the round's first window at win_slot(q)), so
// that the 32 lanes folding 32 windows read 32 different banks at each
// step.  A team's terms come in one round (window_sum_team); the wide
// kernel's in rounds (its window_round).
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ int win_slot(int q) { return q + (q >> 5); }

// The most windows a round of c terms at an offset < 32 touches (and so
// the most terms it gives the level above), and the padded words they
// take: 33 a window, every position of each readable.
__host__ __device__ constexpr int win_count(int c) { return (c + 30) / 32 + 1; }
__host__ __device__ constexpr int win_words(int c) {
  return round4(33 * win_count(c));
}

// A team's shared memory: the row's keys, sorted values and terms (L keys,
// padded), the coupling's words Ls, two histograms, kMisc counts, the
// windows' two level buffers (levels 1, 3, .. and 2, 4, ..).
__host__ __device__ constexpr int team_words(int L, int Ls) {
  return win_words(L) + Ls + 2 * kBins + kMisc + win_words(win_count(L)) +
         win_words(win_count(win_count(L)));
}

// The padding in front of a level of n terms.
__device__ __forceinline__ int win_lo(int n) {
  return ((32 * ((n + 31) >> 5)) - n) >> 1;
}

// Window t of a level's round: its 32 padded positions at in[33 t + j],
// the terms those of j in [jlo, jhi), folded onto acc in order.  The
// other positions add +0.0, which changes no sum that started from +0.0
// (it is never -0.0), so every lane runs the same adds, 8 loads ahead,
// and a group of 8 with no term is skipped.
__device__ __forceinline__ float win_fold(const float* in, int t, int jlo,
                                          int jhi, float acc) {
  const float* w = in + 33 * t;
#pragma unroll
  for (int g = 0; g < 32; g += 8) {
    if (g >= jhi || g + 8 <= jlo) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = g + j >= jlo && g + j < jhi ? w[g + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = acc + v[j];
  }
  return acc;
}

// The windowed sum of a row whose terms come in one round (a team's): the
// first c of its n0 terms at x[win_slot(p + win_lo(n0))], p < c, the rest
// zeros.  window_round's first and last round at once, with no carry and
// no state: every level starts at its term 0 (cvar_wide.cu's
// window_round is the general case).  Every thread of the team
// calls it; returns the sum in thread 0 (+0.0 when c = 0).
template <int TPR>
__device__ __forceinline__ float window_sum_team(int n0, const float* x,
                                                 float* wa, float* wb, int c,
                                                 int tid) {
  float result = 0.0f;
  const float* in = x;
  int n = n0;
  for (int k = 0; c > 0; ++k) {
    const int lo = win_lo(n);
    const int m = (n + 31) >> 5;
    const int nwin = ((c - 1 + lo) >> 5) + 1;
    const bool top = n <= 32;
    const int off1 = top ? 0 : win_lo(m);
    float* out = (k & 1) ? wb : wa;
    for (int t = tid; t < nwin; t += TPR) {
      const float acc = win_fold(in, t, lo - 32 * t, lo + c - 32 * t, 0.0f);
      if (top) {
        result = acc;
      } else {
        out[win_slot(t + off1)] = acc;
      }
    }
    if (top) break;
    team_sync<TPR>();
    c = nwin;
    in = out;
    n = m;
  }
  return result;
}

// Non-finite keys: NaN and +inf (the largest keys), -inf (the least).
constexpr uint32_t kKeyPosInf = 0xff800000u, kKeyNegInf = 0x007fffffu;

// Whether a run-time alpha's mask multiplies a non-finite cost by 0 (a NaN
// term, as srt * mask makes it): hi of the row's keys are NaN or +inf (the
// first of the descending row), lo are -inf (the last); take of M kept.
__device__ __forceinline__ bool masked_nonfinite(int hi, int lo, int take,
                                                 int M) {
  return max(0, hi - take) + min(lo, M - take) > 0;
}

// Bitonic sort, descending, of the team's TPR * E keys, position
// tid * E + r in v[r].  x: TPR * E words of shared memory for the stages
// that pair threads of two warps.
template <int TPR, int E>
__device__ __forceinline__ void team_sort(uint32_t (&v)[E], uint32_t* x,
                                          int tid) {
  constexpr int kLog = tree::ilog2(TPR * E);
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < E) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & j) == 0) {
            const bool desc = (((tid * E) | r) & k) == 0;
            const uint32_t a = v[r], b = v[r | j];
            const uint32_t hi = max(a, b), lo = min(a, b);
            v[r] = desc ? hi : lo;
            v[r | j] = desc ? lo : hi;
          }
        }
      } else {
        // k > j >= E: the direction is the thread's; the lower position
        // of a descending pair keeps the larger key.
        const int other = j / E;
        const bool keep_hi = (((tid * E) & k) == 0) != ((tid & other) != 0);
        if (j < 32 * E) {
#pragma unroll
          for (int r = 0; r < E; ++r) {
            const uint32_t o = __shfl_xor_sync(tree::kFull, v[r], other);
            v[r] = keep_hi ? max(v[r], o) : min(v[r], o);
          }
        } else {
#pragma unroll
          for (int r = 0; r < E; ++r) x[r * TPR + tid] = v[r];
          team_sync<TPR>();
#pragma unroll
          for (int r = 0; r < E; ++r) {
            const uint32_t o = x[r * TPR + (tid ^ other)];
            v[r] = keep_hi ? max(v[r], o) : min(v[r], o);
          }
          team_sync<TPR>();
        }
      }
    }
  }
}

// Warp 0 of a team: the bin, counted from the top, that holds the need-th
// largest of the histogram's keys (1 <= need <= their count).  misc[0]
// the bin, misc[1] the keys in the bins above it, misc[2] the keys in it.
__device__ __forceinline__ void pick_bin(const int* hist, int need,
                                         int* misc, int lane) {
  // Lane l: bins 255 - 8 l - j, j < 8, largest first (two vector loads).
  const int4 lo = reinterpret_cast<const int4*>(hist)[2 * (31 - lane)];
  const int4 hi = reinterpret_cast<const int4*>(hist)[2 * (31 - lane) + 1];
  const int cnt[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += cnt[j];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(tree::kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const int excl = incl - s;
  const unsigned hit =
      __ballot_sync(tree::kFull, excl < need && need <= incl);
  if (lane == __ffs(hit) - 1) {
    int above = excl, bin = -1, inbin = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (bin < 0) {
        if (above + cnt[j] >= need) {
          bin = kBins - 1 - 8 * lane - j;
          inbin = cnt[j];
        } else {
          above += cnt[j];
        }
      }
    }
    misc[0] = bin;
    misc[1] = above;
    misc[2] = inbin;
  }
}

// The gathered keys (got of them, in x) sorted by the team as TPR * E
// positions, then written as values to the terms p < min(got, take), and
// the threshold's copies to got <= p < take, term p at
// x[win_slot(p + off)].
template <int TPR, int E>
__device__ __forceinline__ void sort_gathered(uint32_t* x, int got, int take,
                                              uint32_t tau, int off,
                                              int tid) {
  uint32_t w[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * TPR + tid;
    w[r] = i < got ? x[i] : 0u;
  }
  team_sync<TPR>();
  if (got > 1) team_sort<TPR, E>(w, x, tid);
  float* fb = reinterpret_cast<float*>(x);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int p = tid * E + r;
    if (p < take && p < got) fb[win_slot(p + off)] = key_value(w[r]);
  }
  const float tv = key_value(tau);
  for (int p = got + tid; p < take; p += TPR) fb[win_slot(p + off)] = tv;
}

// The team's keys v (positions any) that the fold takes, gathered into x
// and sorted: the take-th largest found by an MSD radix select; then
// either the keys from its bin up (got >= take of them) or those above it
// and its copies.  Writes the values, largest first, as the terms p <
// take at x[win_slot(p + off)].
template <int TPR, int EMAX>
__device__ __forceinline__ void select_then_sort(const uint32_t (&v)[EMAX],
                                                 uint32_t* x, int* hist,
                                                 int* misc, int take,
                                                 int off, int tid) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0u;
  int need = take, shift = 24, buf = 0;
  bool whole = false;
  for (int i = tid; i < 2 * kBins; i += TPR) hist[i] = 0;
  if (tid == 0) misc[3] = 0;
  team_sync<TPR>();
  for (;;) {
    int* h = hist + buf * kBins;
    const uint32_t high = shift == 24 ? 0u : ~0u << (shift + 8);
#pragma unroll
    for (int r = 0; r < EMAX; ++r)
      if (v[r] != 0u && (v[r] & high) == prefix)
        atomicAdd(&h[(v[r] >> shift) & 0xffu], 1);
    team_sync<TPR>();
    if (tid < 32) pick_bin(h, need, misc, tid);
    // The other histogram, last read before the previous barrier, is
    // cleared for the next pass meanwhile.
    int* other = hist + (buf ^ 1) * kBins;
    for (int i = tid; i < kBins; i += TPR) other[i] = 0;
    team_sync<TPR>();
    need -= misc[1];
    prefix |= static_cast<uint32_t>(misc[0]) << shift;
    if (take - need + misc[2] <= pow2_at_least(take, 1)) {
      whole = true;  // the bin fits the sort the take needs: gather it
      break;
    }
    if (shift == 0) break;  // prefix is the threshold key
    shift -= 8;
    buf ^= 1;
  }
  // Gather: a warp counts its picks, takes its slots with one atomic,
  // then writes them.
  const uint32_t floor_key = whole ? prefix >> shift : prefix;
  auto picked = [&](uint32_t k) {
    return k != 0u && (whole ? (k >> shift) >= floor_key : k > floor_key);
  };
  int count = 0;
#pragma unroll
  for (int r = 0; r < EMAX; ++r)
    count += __popc(__ballot_sync(tree::kFull, picked(v[r])));
  int base = 0;
  if (lane == 0 && count > 0) base = atomicAdd(&misc[3], count);
  base = __shfl_sync(tree::kFull, base, 0);
#pragma unroll
  for (int r = 0; r < EMAX; ++r) {
    const bool pick = picked(v[r]);
    const unsigned m = __ballot_sync(tree::kFull, pick);
    if (pick) x[base + __popc(m & ((1u << lane) - 1u))] = v[r];
    base += __popc(m);
  }
  team_sync<TPR>();
  const int got = misc[3];
  const int e = max(1, pow2_at_least(got, 1) / TPR);
#define CVAR_SORT_GATHERED(E_)                                      \
  if constexpr (E_ <= EMAX) {                                       \
    if (e == E_) sort_gathered<TPR, E_>(x, got, take, prefix, off, tid); \
  }
  CVAR_SORT_GATHERED(1)
  CVAR_SORT_GATHERED(2)
  CVAR_SORT_GATHERED(4)
  CVAR_SORT_GATHERED(8)
  CVAR_SORT_GATHERED(16)
#undef CVAR_SORT_GATHERED
}

// One row a team of TPR threads; the row padded to L = TPR * EMAX keys.
// Lc: the coupling's padded terms, staged in Lc words of shared memory,
// or (STREAM, past kStagedT) none: out[row] holds the row's coupling,
// written by cvar_coupling_kernel (csrc/cvar_wide.cu) before this
// launch, and the team reads it back.  The launch bounds' blocks an SM:
// without them ptxas spilled a few long-lived values; with 1 everywhere it
// gave the warp teams 100 registers, and their full sorts ran slower.  The windowed sum's code
// raised the short rows' warp teams (M <= 128) from 32-34 registers to
// 48, 10 blocks an SM where they had 12-16, and the 128-thread teams to
// 71, 7 blocks an SM and world (a)'s 1,024 rows a second wave: the
// bounds hold them to what they had.
template <int TPR, int EMAX>
constexpr int team_blocks_per_sm() {
  if constexpr (TPR == 32) return EMAX <= 2 ? 16 : EMAX == 4 ? 12 : 6;
  return TPR == 128 ? 8 : TPR == 512 ? 2 : 1;
}

template <int TPR, int EMAX, bool STREAM>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kWarpTeams : TPR,
                                  (team_blocks_per_sm<TPR, EMAX>()))
cvar_costs_kernel(const float* __restrict__ costs,
                  const float* __restrict__ noise,
                  const float* __restrict__ u,
                  const float* __restrict__ u_std,
                  const float* __restrict__ lam,
                  const float* __restrict__ alpha, float* __restrict__ out,
                  int rows, int K, int M, int T, int numel, int Lc) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int L = TPR * EMAX;
  const int tid = threadIdx.x & (TPR - 1);
  const int team = threadIdx.x / TPR;
  const int row = blockIdx.x * (blockDim.x / TPR) + team;
  if (row >= rows) return;  // a whole team: one warp, or an empty block
  const int Ls = STREAM ? 0 : Lc;
  uint32_t* x = smem + team * team_words(L, Ls);
  float* cs = reinterpret_cast<float*>(x + win_words(L));
  int* hist = reinterpret_cast<int*>(cs + Ls);
  int* misc = hist + 2 * kBins;
  float* wa = reinterpret_cast<float*>(misc + kMisc);
  float* wb = wa + win_words(win_count(L));
  const int b = row / K;
  const float* c = costs + static_cast<size_t>(row) * M;

  // Any start order serves a sort: coalesced loads.  Then the coupling's
  // noise, copied while the row sorts.
  uint32_t v[EMAX];
#pragma unroll
  for (int r = 0; r < EMAX; ++r) {
    const int i = r * TPR + tid;
    v[r] = i < M ? order_key(c[i]) : 0u;
  }
  if constexpr (!STREAM) {
    const float* nz = noise + static_cast<size_t>(row) * T * 2;
    for (int i = tid; i < 2 * T; i += TPR)
      __pipeline_memcpy_async(cs + i, nz + i, 4);
    __pipeline_commit();
  }
  const bool dyn = alpha != nullptr;
  const int n =
      dyn ? static_cast<int>(ceilf(static_cast<float>(M) * alpha[b])) : numel;
  // The team's count, broadcast from lane 0 (the same on every lane).
  const int take = __shfl_sync(tree::kFull, min(max(n, 0), M), 0);
  // The windowed sum's terms: a static count's worst take (all M, as
  // stored, when it is M: no sort), or a run-time alpha's sorted row of M
  // whose terms past the take are zeros.
  const bool unsorted = !dyn && take == M;
  const int Lw = dyn ? M : take;
  const int off = win_lo(Lw);

  float* fb = reinterpret_cast<float*>(x);
  if (M > 1 && take > 0) {
    if (unsorted) {
      // The row as stored, read again (from L2): reading the keys v here
      // cost the warp teams' sort its register allocation (B = 30 and K =
      // 10240 ran 1.3-1.6x slower).
      for (int i = tid; i < M; i += TPR) fb[win_slot(i + off)] = c[i];
    } else if (L >= kSelectFrom && pow2_at_least(take, 1) < L) {
      select_then_sort<TPR, EMAX>(v, x, hist, misc, take, off, tid);
    } else {
      team_sort<TPR, EMAX>(v, x, tid);
#pragma unroll
      for (int r = 0; r < EMAX; ++r) {
        const int p = tid * EMAX + r;
        if (p < take) fb[win_slot(p + off)] = key_value(v[r]);
      }
    }
  }
  team_sync<TPR>();

  // A run-time alpha's mask times an infinite or NaN cost is NaN (0 *
  // inf), and so is the sum: count the row's non-finite keys (the team's
  // registers hold every key still, the sort having only moved them), a
  // warp's counts in the histograms' words, which are free now; thread 0
  // adds them after the coupling's barrier.  (M = 1: the product below.)
  const bool count_nf = dyn && take < M && M > 1;
  int nf_hi = 0, nf_lo = 0;
  if (count_nf) {
#pragma unroll
    for (int r = 0; r < EMAX; ++r) {
      nf_hi += v[r] >= kKeyPosInf;
      nf_lo += v[r] == kKeyNegInf;
    }
    nf_hi = __reduce_add_sync(tree::kFull, nf_hi);
    nf_lo = __reduce_add_sync(tree::kFull, nf_lo);
    if constexpr (TPR > 32) {
      if ((tid & 31) == 0) {
        hist[tid >> 5] = nf_hi;
        hist[32 + (tid >> 5)] = nf_lo;
      }
    }
  }

  // The sum: one term alone is itself (M = 1: thread 0 holds it; the
  // worst 1: the sort's first); else the windows, every thread folding.
  float sum = 0.0f;
  if (Lw == 1) {
    if (M == 1) {
      sum = key_value(v[0]);
      if (dyn) sum = sum * (take >= 1 ? 1.0f : 0.0f);
    } else {
      sum = fb[win_slot(off)];
    }
  } else {
    sum = window_sum_team<TPR>(Lw, fb, wa, wb, take, tid);
  }

  // The coupling: each thread's terms are its own copies (i = tid mod
  // TPR), and so are the tree's levels of stride >= TPR: no barrier until
  // they are done.
  if constexpr (!STREAM) {
    __pipeline_wait_prior(0);
    const float* ub = u + static_cast<size_t>(b) * T * 2;
    const float var0 = u_std[2 * b] * u_std[2 * b];
    const float var1 = u_std[2 * b + 1] * u_std[2 * b + 1];
    for (int i = tid; i < Lc; i += TPR)
      cs[i] = i < 2 * T ? cs[i] * (ub[i] / ((i & 1) ? var1 : var0)) : -0.0f;
    for (int h = Lc >> 1; h >= TPR; h >>= 1)
      for (int i = tid; i < h; i += TPR) cs[i] = cs[i] + cs[i + h];
  }
  if constexpr (TPR > 32) __syncthreads();
  if (tid < 32) {  // the team's first warp
    float coupling;
    if constexpr (STREAM) {
      coupling = out[row];
    } else {
      // Positions lane + 32 m (past Lc: -0.0), halved over m, then lanes.
      constexpr int kM = TPR / 32;
      const int lane = tid;
      float y[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m)
        y[m] = lane + 32 * m < Lc ? cs[lane + 32 * m] : -0.0f;
      tree::halve<kM>(y);
      coupling = y[0];
#pragma unroll
      for (int l = 4; l >= 0; --l)
        coupling = coupling + __shfl_down_sync(tree::kFull, coupling, 1 << l);
    }
    // The mean as JAX's: a static count times float32(1 / n) (XLA's
    // reciprocal of a constant), a run-time one divided.
    if (tid == 0) {
      if (count_nf) {
        if constexpr (TPR > 32) {
          nf_hi = nf_lo = 0;
          for (int w = 0; w < TPR / 32; ++w) {
            nf_hi += hist[w];
            nf_lo += hist[32 + w];
          }
        }
        if (masked_nonfinite(nf_hi, nf_lo, take, M))
          sum = __int_as_float(0x7fffffff);
      }
      out[row] = (dyn ? sum / static_cast<float>(n)
                      : sum * (1.0f / static_cast<float>(n))) +
                 lam[b] * coupling;
    }
  }
}

// The instantiations: (threads a row, keys a thread of the padded row).
#define CVAR_SHAPES(X_)                                                  \
  X_(32, 1) X_(32, 2) X_(32, 4) X_(32, 8) X_(32, 16) X_(32, 32)          \
  X_(128, 1) X_(128, 2) X_(128, 4) X_(128, 8)                            \
  X_(512, 4) X_(512, 8) X_(512, 16) X_(1024, 16)

}  // namespace cvar
