// What the CVaR plus coupling kernels share (csrc/cvar_costs.cu, the
// teams whose coupling is staged in shared memory; csrc/cvar_wide.cu,
// their streamed twins and the wide kernel): the float order keys, the
// team's bitonic sort, the MSD radix select, the coupling's halving tree
// and the team kernel itself.  See csrc/cvar_costs.cu for the design.
#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tree_sum.cuh"

namespace {

constexpr int kBins = 256;       // an 8-bit digit's histogram
constexpr int kMisc = 4;         // bin, keys above it, keys in it, a count
constexpr int kWarpTeams = 4;    // rows a block when a warp takes a row
constexpr int kSelectFrom = 256; // the padded rows that select first
constexpr int kStagedT = 4096;   // the longest horizon staged in shared
                                 // memory (Lc = 8192 words)
constexpr int kWideTPR = 1024;   // cvar_wide_kernel's threads, a row
constexpr int kSortedM = kWideTPR * 16;  // the longest row a team sorts

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
// positions, then written as values to fb[0, min(got, take)), and the
// threshold's copies to fb[got, take).
template <int TPR, int E>
__device__ __forceinline__ void sort_gathered(uint32_t* x, int got, int take,
                                              uint32_t tau, int tid) {
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
    if (p < take && p < got) fb[p] = key_value(w[r]);
  }
  const float tv = key_value(tau);
  for (int p = got + tid; p < take; p += TPR) fb[p] = tv;
}

// The team's keys v (positions any) that the fold takes, gathered into x
// and sorted: the take-th largest found by an MSD radix select; then
// either the keys from its bin up (got >= take of them) or those above it
// and its copies.  Writes the values, largest first, to x[0, take).
template <int TPR, int EMAX>
__device__ __forceinline__ void select_then_sort(const uint32_t (&v)[EMAX],
                                                 uint32_t* x, int* hist,
                                                 int* misc, int take,
                                                 int tid) {
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
    if (e == E_) sort_gathered<TPR, E_>(x, got, take, prefix, tid); \
  }
  CVAR_SORT_GATHERED(1)
  CVAR_SORT_GATHERED(2)
  CVAR_SORT_GATHERED(4)
  CVAR_SORT_GATHERED(8)
  CVAR_SORT_GATHERED(16)
#undef CVAR_SORT_GATHERED
}

// Thread tid's share of the coupling, its positions tid + r * TPR of the
// Lc padded terms (r < max(1, Lc / TPR)) summed in the halving tree over
// r, read from global memory in bit-reversed order of r.  Positions past
// 2T are -0.0, past Lc too.
constexpr int kGroup = 16;  // the streamed coupling's leaves in registers

template <int TPR>
__device__ __forceinline__ float streamed_coupling(const float* nz,
                                                   const float* ub,
                                                   float var0, float var1,
                                                   int T, int Lc, int tid) {
  const int R = Lc > TPR ? Lc / TPR : 1;
  const int log_r = tree::ilog2_run(R);
  auto term = [&](int i) {
    const int p = tid + TPR * tree::bit_reverse_bits(i, log_r);
    return p < 2 * T ? nz[p] * (ub[p] / ((p & 1) ? var1 : var0)) : -0.0f;
  };
  tree::Streamed st;
  if (R < kGroup) {
    for (int i = 0; i < R; ++i) st.push(i, term(i));
    return st.sum(log_r);
  }
  // Groups of kGroup leaves, their loads in flight together, each group a
  // whole subtree of the pairwise tree summed in registers (adjacent
  // pairs, then pairs of pairs), then pushed as one leaf of the stack.
  for (int i = 0; i < R; i += kGroup) {
    float leaf[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) leaf[j] = term(i + j);
#pragma unroll
    for (int w = 1; w < kGroup; w *= 2)
#pragma unroll
      for (int j = 0; j < kGroup; j += 2 * w) leaf[j] = leaf[j] + leaf[j + w];
    st.push(i / kGroup, leaf[0]);
  }
  return st.sum(log_r - tree::ilog2(kGroup));
}

// One row a team of TPR threads; the row padded to L = TPR * EMAX keys.
// Lc: the coupling's padded terms, staged in Lc words of shared memory,
// or (STREAM) streamed, TPR words a team holding the threads' partial
// sums.  The launch bounds' blocks an SM (6 of
// the warp teams' blocks, 2 of 512 threads, else 1): without them ptxas
// spilled a few long-lived values; with 1 everywhere it gave the warp
// teams 100 registers, and their full sorts ran slower.
template <int TPR, int EMAX, bool STREAM>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kWarpTeams : TPR,
                                  TPR == 32 ? 6 : TPR == 512 ? 2 : 1)
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
  const int Ls = STREAM ? TPR : Lc;
  uint32_t* x = smem + team * (L + Ls + 2 * kBins + kMisc);
  float* cs = reinterpret_cast<float*>(x + L);
  int* hist = reinterpret_cast<int*>(x + L + Ls);
  int* misc = hist + 2 * kBins;
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
  const float* nz = noise + static_cast<size_t>(row) * T * 2;
  if constexpr (!STREAM) {
    for (int i = tid; i < 2 * T; i += TPR)
      __pipeline_memcpy_async(cs + i, nz + i, 4);
    __pipeline_commit();
  }
  const int n =
      alpha != nullptr ? static_cast<int>(ceilf(static_cast<float>(M) * alpha[b]))
                       : numel;
  // The team's count, broadcast from lane 0 (the same on every lane).
  const int take = __shfl_sync(tree::kFull, min(max(n, 0), M), 0);

  float* fb = reinterpret_cast<float*>(x);
  if (M > 1 && take > 0) {
    if (L >= kSelectFrom && pow2_at_least(take, 1) < L) {
      select_then_sort<TPR, EMAX>(v, x, hist, misc, take, tid);
    } else {
      team_sort<TPR, EMAX>(v, x, tid);
#pragma unroll
      for (int r = 0; r < EMAX; ++r) {
        const int p = tid * EMAX + r;
        if (p < take) fb[p] = key_value(v[r]);
      }
    }
    team_sync<TPR>();
  }

  // The fold (thread 0; -0.0 + x == x) beside the coupling's terms.
  float sum = -0.0f;
  if (tid == 0) {
    if (M == 1) {
      if (take == 1) sum = sum + key_value(v[0]);  // thread 0 holds it
    } else {
      int i = 0;
      for (; i + 4 <= take; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(fb + i);
        sum = sum + q.x;
        sum = sum + q.y;
        sum = sum + q.z;
        sum = sum + q.w;
      }
      for (; i < take; ++i) sum = sum + fb[i];
    }
  }
  // Each thread's terms are its own copies (i = tid mod TPR), and so are
  // the tree's levels of stride >= TPR: no barrier until they are done.
  if constexpr (!STREAM) __pipeline_wait_prior(0);
  const float* ub = u + static_cast<size_t>(b) * T * 2;
  const float var0 = u_std[2 * b] * u_std[2 * b];
  const float var1 = u_std[2 * b + 1] * u_std[2 * b + 1];
  if constexpr (STREAM) {
    cs[tid] = streamed_coupling<TPR>(nz, ub, var0, var1, T, Lc, tid);
  } else {
    for (int i = tid; i < Lc; i += TPR)
      cs[i] = i < 2 * T ? cs[i] * (ub[i] / ((i & 1) ? var1 : var0)) : -0.0f;
    for (int h = Lc >> 1; h >= TPR; h >>= 1)
      for (int i = tid; i < h; i += TPR) cs[i] = cs[i] + cs[i + h];
  }
  if constexpr (TPR > 32) __syncthreads();
  if (tid < 32) {  // the team's first warp
    // Positions lane + 32 m (past Lc: -0.0), halved over m, then lanes.
    constexpr int kM = TPR / 32;
    const int lane = tid;
    float y[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m)
      y[m] = lane + 32 * m < Lc ? cs[lane + 32 * m] : -0.0f;
    tree::halve<kM>(y);
    float coupling = y[0];
#pragma unroll
    for (int l = 4; l >= 0; --l)
      coupling = coupling + __shfl_down_sync(tree::kFull, coupling, 1 << l);
    if (tid == 0)
      out[row] = sum / static_cast<float>(n) + lam[b] * coupling;
  }
}

// The instantiations: (threads a row, keys a thread of the padded row).
#define CVAR_SHAPES(X_)                                                  \
  X_(32, 1) X_(32, 2) X_(32, 4) X_(32, 8) X_(32, 16) X_(32, 32)          \
  X_(128, 1) X_(128, 2) X_(128, 4) X_(128, 8)                            \
  X_(512, 4) X_(512, 8) X_(512, 16) X_(1024, 16)

}  // namespace
