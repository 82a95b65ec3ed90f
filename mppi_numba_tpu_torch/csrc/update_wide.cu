// The MPPI control update past K = kFusedK rollouts (32,768: the
// one-launch kernel's 64 positions a thread of 512, csrc/update_useq.cu),
// for Hopper (sm_90a), up to the barebone Config's 1e6 and beyond.  There
// every block deriving beta and eta from all K costs would not scale (4
// MB a block at K = 1e6).  The same update, bit for bit with the plain
// version (ops/kernels/update_useq.py), in four launches in order on the
// stream, the padded K positions split by their low bits over G = L /
// kWidePer blocks, block g owning positions g + G s, s = a W + tid (a <
// kWideA).  A position's bits are then [a | tid | g]: the halving tree's
// levels run over a in registers, over tid in the block, and over g last.
//
//   update_wide_min    (G, B)            beta's partials: each block the
//                                        minimum order key of a
//                                        contiguous run of costs (order-
//                                        free)
//   update_wide_eta    (G, B)            beta from the G minima; eta's
//                                        partial over the block's
//                                        positions
//   update_wide_noise  (chunks x G, B)   eta from the G partials (the
//                                        tree's last levels, the same
//                                        sum in every block), the weights,
//                                        and each of the chunk's kCols
//                                        columns' partial over the
//                                        block's positions
//   update_wide_finish (chunks, B)       each column's G partials summed
//                                        (the last levels), added to u
//                                        and clamped
//
// The scratch (minima, eta's and the columns' partials) is the caller's.
#include <cstdint>
#include <cuda_runtime.h>

#include "tree_sum.cuh"
#include "update_common.cuh"

namespace {

constexpr int kWideW = 256;                  // the wide path's block
constexpr int kWideA = 16;                   // positions a thread
constexpr int kWidePer = kWideW * kWideA;    // positions a block
constexpr int kFusedK = kMaxBlock * 64;      // the one-launch path's K

// The block's minimum of v over its threads (every thread gets it).
__device__ __forceinline__ uint32_t block_min(uint32_t v, uint32_t* sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  v = __reduce_min_sync(tree::kFull, v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) v = min(v, sh[i]);
  return v;
}

// beta of scenario b from the G minima (each a block's).
__device__ __forceinline__ float wide_beta(const uint32_t* mins, int G,
                                           uint32_t* sh) {
  uint32_t mk = ~0u;
  for (int i = threadIdx.x; i < G; i += blockDim.x) mk = min(mk, mins[i]);
  return min_value(block_min(mk, sh));
}

__global__ void __launch_bounds__(kWideW)
update_wide_min(const float* __restrict__ costs, uint32_t* __restrict__ mins,
                int K, int G) {
  __shared__ uint32_t sh[kWideW / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const float* cb = costs + static_cast<size_t>(b) * K;
  uint32_t mk = ~0u;  // no float's key
#pragma unroll
  for (int a = 0; a < kWideA; ++a) {
    const long long k =
        static_cast<long long>(g) * kWidePer + a * kWideW + threadIdx.x;
    if (k < K) mk = min(mk, min_key(cb[k]));
  }
  mk = block_min(mk, sh);
  if (threadIdx.x == 0) mins[static_cast<size_t>(b) * G + g] = mk;
}

__global__ void __launch_bounds__(kWideW)
update_wide_eta(const float* __restrict__ costs,
                const float* __restrict__ lam,
                const uint32_t* __restrict__ mins, float* __restrict__ etas,
                int K, int G) {
  __shared__ uint32_t shm[kWideW / 32];
  __shared__ float sh[kWideW];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* cb = costs + static_cast<size_t>(b) * K;
  const float beta = wide_beta(mins + static_cast<size_t>(b) * G, G, shm);
  const float lam_b = lam[b];
  Pairwise<kWideA, 1> part;
#pragma unroll
  for (int i = 0; i < kWideA; ++i) {
    const int a = tree::bit_reverse<kWideA>(i);
    const long long k =
        g + static_cast<long long>(G) * (a * kWideW + tid);
    float leaf[1] = {k < K ? expf(-(cb[k] - beta) / lam_b) : -0.0f};
    part.push(i, leaf);
  }
  sh[tid] = part.acc[Pairwise<kWideA, 1>::kLog][0];
  __syncthreads();
  if (tid < 32) {
    const float x = warp_tree([&](int p) { return sh[p]; }, kWideW, tid);
    if (tid == 0) etas[static_cast<size_t>(b) * G + g] = x;
  }
}

__global__ void __launch_bounds__(kWideW)
update_wide_noise(const float* __restrict__ costs,
                  const float* __restrict__ noise,
                  const float* __restrict__ lam,
                  const uint32_t* __restrict__ mins,
                  const float* __restrict__ etas,
                  float* __restrict__ weights, float* __restrict__ parts,
                  int K, int T, int G) {
  __shared__ uint32_t shm[kWideW / 32];
  __shared__ float sh_eta;
  __shared__ float part[kCols * kWideW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x / G, g = blockIdx.x % G, b = blockIdx.y;
  const int chunks = (T + kSteps - 1) / kSteps;
  const int t0 = chunk * kSteps;
  const int cols = min(kCols, 2 * (T - t0));
  const float* cb = costs + static_cast<size_t>(b) * K;
  const float beta = wide_beta(mins + static_cast<size_t>(b) * G, G, shm);
  if (warp == 0) {
    const float* e = etas + static_cast<size_t>(b) * G;
    const float x = tree::lane_tree([&](int p) { return e[p]; }, G, lane);
    if (lane == 0) sh_eta = x;
  }
  __syncthreads();
  const float eta = sh_eta, lam_b = lam[b];
  Pairwise<kWideA, kCols> col;
#pragma unroll
  for (int i = 0; i < kWideA; ++i) {
    const int a = tree::bit_reverse<kWideA>(i);
    const long long k =
        g + static_cast<long long>(G) * (a * kWideW + tid);
    float leaf[kCols];
    if (k < K) {
      const float w = expf(-(cb[k] - beta) / lam_b) / eta;
      if (chunk == 0) weights[static_cast<size_t>(b) * K + k] = w;
      const float2* row = reinterpret_cast<const float2*>(
          noise + (static_cast<size_t>(b) * K + k) * T * 2 + 2 * t0);
#pragma unroll
      for (int j = 0; j < kCols; j += 2) {
        const float2 q = j < cols ? row[j / 2] : make_float2(0.0f, 0.0f);
        leaf[j] = j < cols ? w * q.x : -0.0f;
        leaf[j + 1] = j + 1 < cols ? w * q.y : -0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) leaf[j] = -0.0f;
    }
    col.push(i, leaf);
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    part[j * kWideW + tid] = col.acc[Pairwise<kWideA, kCols>::kLog][j];
  __syncthreads();
  // Warp j (kWideW / 32 == kCols warps) sums column j over the threads.
  const float x = warp_tree([&](int p) { return part[warp * kWideW + p]; },
                            kWideW, lane);
  if (lane == 0)
    parts[((static_cast<size_t>(b) * chunks + chunk) * kCols + warp) * G +
          g] = x;
}

__global__ void __launch_bounds__(kWideW)
update_wide_finish(const float* __restrict__ u,
                   const float* __restrict__ vrange,
                   const float* __restrict__ wrange,
                   const float* __restrict__ parts,
                   float* __restrict__ u_out, int T, int G) {
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int chunks = (T + kSteps - 1) / kSteps;
  const int t0 = chunk * kSteps;
  const int cols = min(kCols, 2 * (T - t0));
  const float* p =
      parts + ((static_cast<size_t>(b) * chunks + chunk) * kCols + j) * G;
  const float x = tree::lane_tree([&](int i) { return p[i]; }, G, lane);
  if (lane == 0 && j < cols) {
    const size_t o = (static_cast<size_t>(b) * T + t0) * 2 + j;
    const float* range = (j & 1) ? wrange : vrange;
    u_out[o] = clamp_like_torch(u[o] + x, range[2 * b], range[2 * b + 1]);
  }
}

static_assert(kWideW / 32 == kCols, "a warp a column of the chunk");

}  // namespace

// The wide path (K > kFusedK): arguments as update_useq_launch's, and the
// caller's scratch: mins (B, G) 32-bit words, etas (B, G) and parts (B,
// chunks, 8, G) float32, G = update_wide_blocks(K), chunks = ceil(T / 4).
// Four launches on the stream; returns the first one's cudaError_t that
// is not cudaSuccess.
extern "C" int update_wide_blocks(int K) {
  long long L = kWidePer;
  while (L < K) L <<= 1;
  return static_cast<int>(L / kWidePer);
}

extern "C" int update_useq_wide_launch(const float* costs, const float* noise,
                                       const float* u, const float* lam,
                                       const float* vrange,
                                       const float* wrange, float* u_out,
                                       float* weights, void* mins,
                                       float* etas, float* parts, int B,
                                       int K, int T, void* stream) {
  if (K <= kFusedK || B < 1 || B > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = update_wide_blocks(K);
  const int chunks = (T + kSteps - 1) / kSteps;
  if (static_cast<long long>(chunks) * G >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* mk = static_cast<uint32_t*>(mins);
  update_wide_min<<<dim3(G, B), kWideW, 0, st>>>(costs, mk, K, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  update_wide_eta<<<dim3(G, B), kWideW, 0, st>>>(costs, lam, mk, etas, K, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  update_wide_noise<<<dim3(chunks * G, B), kWideW, 0, st>>>(
      costs, noise, lam, mk, etas, weights, parts, K, T, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  update_wide_finish<<<dim3(chunks, B), kWideW, 0, st>>>(
      u, vrange, wrange, parts, u_out, T, G);
  return static_cast<int>(cudaGetLastError());
}
