// The MPPI control update past K = kFusedK rollouts (32,768: the
// one-launch kernel's 64 positions a thread of 512, csrc/update_useq.cu),
// for Hopper (sm_90a), up to the barebone Config's 1e6 and beyond.  There
// every block deriving beta and eta from all K costs would not scale (4
// MB a block at K = 1e6).  The same update, bit for bit with the plain
// version (ops/kernels/update_useq.py), in three launches in order on the
// stream.  The padded K positions (L = next_pow2(K)) split by their low
// bits into G = kWideG groups: group g owns the P = L / G positions
// g + G s, s < P, so a position's bits are [s | g], and the halving
// tree's levels run over s inside a block and over g last.  (Fewer,
// larger groups measured slower on an H100 at every K: fewer blocks in
// flight.)
//
//   update_wide_min    (G, B)    beta's partials: each block the minimum
//                                order key of a contiguous run of P
//                                costs (order-free); block (g, b) also
//                                zeroes the scenario's finishing counters
//   update_wide_eta    (G, B)    beta from the G minima; eta's partial
//                                over group g's P positions
//   update_wide_noise  (chunks   eta from the G partials (the tree's last
//                      x G, B)   levels), each of group g's weights once,
//                                and each of the chunk's CJ columns'
//                                partial over its P positions; the last
//                                of a chunk's G blocks to finish (an
//                                atomic ticket) sums each column's G
//                                partials (the last levels), adds u and
//                                clamps
//
// Bound: the bytes, the noise read once (400 MB at K = 1e6, T = 50, some
// 0.12 ms at HBM rate); the costs are 1% of it.  update_wide_noise streams the noise as whole row segments (a chunk's CJ
// <= 256 columns: all 100 of a row at T = 50) through shared memory, a
// ring of kRing stages of kStage Q rows: where T is even one bulk copy of
// the Tensor Memory Accelerator a row, completing on the stage's
// mbarrier (cp.async pieces kept a block's memory requests too few in
// flight: 0.255 against 0.202 ms at K = 1e6 on an H100), else 8-byte
// cp.async pieces.  Its thread (j, q) owns column j and the positions s
// with s % Q == q: the levels over s / Q run in its registers (pairwise
// over kStage leaves a stage, in bit-reversed order, then streamed over
// the stages), those over q in shared memory, and a stage holds exactly
// the rows of its threads' next kStage leaves.  Each weight is computed
// once (a thread a row of the stage) and, in the first chunk, written
// out.  Two blocks an SM (launch bounds: at most 64 registers).

// The scratch (minima, eta's and the columns' partials, the counters) is
// the caller's.  Replays are deterministic: every sum runs in the tree's
// order whichever block finishes last.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tree_sum.cuh"
#include "update_common.cuh"

// A named namespace, so that the kernels' names, and ptxas's input, do not
// depend on where the repository is checked out (as barebone_rollout.cu).
namespace update_wide {

constexpr int kWideW = 256;        // update_wide_min's and _eta's block
constexpr int kWideG = 256;        // position groups a scenario
constexpr int kStage = 32;         // leaves a thread a stage
constexpr int kRing = 2;           // stages in shared memory
constexpr int kNoiseMax = 512;     // update_wide_noise's threads at most
constexpr int kMaxCols = 256;      // columns a chunk at most
constexpr int kMaxQ = 8;           // position classes a column at most
constexpr int kFusedK = kMaxBlock * 64;   // the one-launch path's K

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

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A 16-byte copy into shared memory that bypasses L1 (cp.async.cg).
__device__ __forceinline__ void copy16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_address(dst)),
               "l"(src)
               : "memory");
}

// The Tensor Memory Accelerator's bulk copy (global to shared, bytes a
// multiple of 16, both ends 16-byte aligned), completing on an mbarrier.
__device__ __forceinline__ void mbarrier_init(uint64_t* bar, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbarrier_expect(uint64_t* bar,
                                                unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_address(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// Waits for the mbarrier's phase of this parity; traps (a launch error)
// rather than hang if it never completes.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar,
                                              unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_address(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 22)) __trap();
  }
}

__global__ void __launch_bounds__(kWideW)
update_wide_min(const float* __restrict__ costs, uint32_t* __restrict__ mins,
                unsigned* __restrict__ counters, int K, int P, int chunks) {
  __shared__ uint32_t sh[kWideW / 32];
  const int g = blockIdx.x, b = blockIdx.y, G = gridDim.x;
  for (int c = g + G * threadIdx.x; c < chunks; c += G * kWideW)
    counters[static_cast<size_t>(b) * chunks + c] = 0u;
  const float* cb = costs + static_cast<size_t>(b) * K;
  const long long lo = static_cast<long long>(g) * P;
  const long long hi = min(lo + P, static_cast<long long>(K));
  uint32_t mk = ~0u;  // no float's key
#pragma unroll 4
  for (long long k = lo + threadIdx.x; k < hi; k += kWideW)
    mk = min(mk, min_key(cb[k]));
  mk = block_min(mk, sh);
  if (threadIdx.x == 0) mins[static_cast<size_t>(b) * G + g] = mk;
}

// Thread tid holds positions s = a kWideW + tid, a < P / kWideW: the levels
// over a pairwise in registers, 16 leaves at a time (bit-reversed; leaves
// past P are -0.0 pads at the end of the tree), streamed past 16; then the
// levels over tid.
__global__ void __launch_bounds__(kWideW)
update_wide_eta(const float* __restrict__ costs,
                const float* __restrict__ lam,
                const uint32_t* __restrict__ mins, float* __restrict__ etas,
                int K, int P) {
  __shared__ uint32_t shm[kWideW / 32];
  __shared__ float sh[kWideW];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = gridDim.x;
  const float* cb = costs + static_cast<size_t>(b) * K;
  const float beta = wide_beta(mins + static_cast<size_t>(b) * G, G, shm);
  const float lam_b = lam[b];
  const int per = P / kWideW, log_per = tree::ilog2_run(per);
  auto group = [&](int o) {
    Pairwise<16, 1> part;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int i = 16 * o + m;
      const int a = per >= 16 ? tree::bit_reverse_bits(i, log_per)
                              : tree::bit_reverse<16>(m);
      const long long k =
          g + static_cast<long long>(G) * (a * kWideW + tid);
      float leaf[1] = {a < per && k < K ? expf(-(cb[k] - beta) / lam_b)
                                        : -0.0f};
      part.push(m, leaf);
    }
    return part.acc[Pairwise<16, 1>::kLog][0];
  };
  float x;
  if (per <= 16) {
    x = group(0);
  } else {
    tree::Streamed st;
    for (int o = 0; o < per / 16; ++o) st.push(o, group(o));
    x = st.sum(log_per - 4);
  }
  sh[tid] = x;
  __syncthreads();
  if (tid < 32) {
    const float y = warp_tree([&](int p) { return sh[p]; }, kWideW, tid);
    if (tid == 0) etas[static_cast<size_t>(b) * G + g] = y;
  }
}

// The levels over q of thread (j, q)'s value x (Q a power of two): red[q
// CJ + j], halved in place; red[j] ends as column j's sum.
__device__ __forceinline__ void class_levels(float* red, float x, int j,
                                             int q, int CJ, int Q,
                                             bool active) {
  if (active) red[q * CJ + j] = x;
  __syncthreads();
  for (int h = Q >> 1; h >= 1; h >>= 1) {
    if (active && q < h)
      red[q * CJ + j] = red[q * CJ + j] + red[(q + h) * CJ + j];
    __syncthreads();
  }
}

// kBulk (T even, CJ a multiple of 4): each row segment one bulk copy of
// the Tensor Memory Accelerator, on the stage buffer's mbarrier; else
// 8-byte cp.async pieces.  Shared memory: kRing stages of R = kStage Q
// rows x CJ floats, their costs, the current stage's weights.
template <bool kBulk>
__global__ void __launch_bounds__(kNoiseMax, 2)
update_wide_noise(const float* __restrict__ costs,
                  const float* __restrict__ noise,
                  const float* __restrict__ u,
                  const float* __restrict__ lam,
                  const float* __restrict__ vrange,
                  const float* __restrict__ wrange,
                  const uint32_t* __restrict__ mins,
                  const float* __restrict__ etas,
                  float* __restrict__ weights, float* __restrict__ parts,
                  unsigned* __restrict__ counters, float* __restrict__ u_out,
                  int K, int T, int P, int CJ, int Q) {
  extern __shared__ float4 smem4[];
  __shared__ uint32_t shk[kWideG];
  __shared__ float she[kWideG];
  __shared__ float red[kNoiseMax];
  __shared__ float sh_beta, sh_eta;
  __shared__ bool sh_last;
  __shared__ alignas(8) uint64_t bars[kRing];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  constexpr int G = kWideG;
  const int chunk = blockIdx.x / G, g = blockIdx.x % G, b = blockIdx.y;
  const int chunks = gridDim.x / G;
  const int j0 = chunk * CJ, cols = min(CJ, 2 * T - j0);
  const int R = kStage * Q, log_q = tree::ilog2_run(Q);
  const int log_hi = tree::ilog2_run(P / Q), stages = P / R;
  float* sx = reinterpret_cast<float*>(smem4);  // [kRing][R][CJ]
  float* sc = sx + kRing * R * CJ;              // [kRing][R]
  float* sw = sc + kRing * R;                   // [R]
  const float* cb = costs + static_cast<size_t>(b) * K;
  const float* nb = noise + static_cast<size_t>(b) * K * T * 2;

  // Stage n's row r = m Q + q holds position s = bit_reverse(n kStage + m)
  // Q + q: thread (j, q)'s leaves n kStage .. n kStage + kStage - 1.
  auto row_of = [&](int n, int r) {
    const long long s =
        static_cast<long long>(
            tree::bit_reverse_bits(n * kStage + (r >> log_q), log_hi))
            * Q + (r & (Q - 1));
    return g + static_cast<long long>(G) * s;
  };
  // A row's CJ columns, and its cost; a padding row's columns are +0.0
  // (its weight -0.0: a -0.0 leaf).  Bulk: a thread a row, each row an
  // arrival on the buffer's mbarrier with the bytes it brings.  Else a
  // warp a row in 8-byte pieces.  The costs (and the pieces) in a
  // cp.async group, an empty one past the last stage, so that every wait
  // counts alike.
  auto issue = [&](int n) {
    float* dx = sx + (n % kRing) * R * CJ;
    float* dc = sc + (n % kRing) * R;
    if (n >= stages) {
    } else if constexpr (kBulk) {
      uint64_t* bar = bars + n % kRing;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int r = tid; r < R; r += nthreads) {
        const long long k = row_of(n, r);
        if (k < K) {
          mbarrier_expect(bar, 4 * cols);
          bulk_copy(dx + r * CJ, nb + k * 2 * T + j0, 4 * cols, bar);
          __pipeline_memcpy_async(dc + r, cb + k, 4);
        } else {
          for (int c = 0; c < cols; ++c) dx[r * CJ + c] = 0.0f;
          mbarrier_expect(bar, 0);
        }
      }
    } else {
      for (int r = warp; r < R; r += nwarps) {
        const long long k = row_of(n, r);
        if (k < K) {
          const float* src = nb + k * 2 * T + j0;
          for (int c = lane; c < cols / 2; c += 32)
            __pipeline_memcpy_async(dx + r * CJ + 2 * c, src + 2 * c, 8);
          if (lane == 0) __pipeline_memcpy_async(dc + r, cb + k, 4);
        } else {
          for (int c = lane; c < cols; c += 32) dx[r * CJ + c] = 0.0f;
        }
      }
    }
    __pipeline_commit();
  };
  if (kBulk && tid == 0) {
    for (int i = 0; i < kRing; ++i) mbarrier_init(bars + i, R);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kBulk) __syncthreads();
  for (int n = 0; n < kRing - 1; ++n) issue(n);

  // beta and eta (warp 0, from the G minima and partials) while the first
  // stages land.
  for (int i = tid; i < G; i += nthreads) {
    shk[i] = mins[static_cast<size_t>(b) * G + i];
    she[i] = etas[static_cast<size_t>(b) * G + i];
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t mk = ~0u;
    for (int i = lane; i < G; i += 32) mk = min(mk, shk[i]);
    mk = __reduce_min_sync(tree::kFull, mk);
    const float x = warp_tree([&](int p) { return she[p]; }, G, lane);
    if (lane == 0) {
      sh_beta = min_value(mk);
      sh_eta = x;
    }
  }
  const float lam_b = lam[b];

  const int j = tid % CJ, q = tid / CJ;
  const bool active = tid < CJ * Q;
  tree::Streamed outer;
  for (int n = 0; n < stages; ++n) {
    issue(n + kRing - 1);
    __pipeline_wait_prior(kRing - 1);
    if (kBulk) mbarrier_wait(bars + n % kRing, (n / kRing) & 1);
    __syncthreads();  // stage n landed (and beta and eta are in shared)
    const float beta = sh_beta, eta = sh_eta;
    const float* xs = sx + (n % kRing) * R * CJ;
    const float* cs = sc + (n % kRing) * R;
    for (int r = tid; r < R; r += nthreads) {
      const long long k = row_of(n, r);
      float w = -0.0f;
      if (k < K) {
        w = expf(-(cs[r] - beta) / lam_b) / eta;
        if (chunk == 0) weights[static_cast<size_t>(b) * K + k] = w;
      }
      sw[r] = w;
    }
    __syncthreads();  // the stage's weights
    if (active) {
      Pairwise<kStage, 1> col;
#pragma unroll
      for (int m = 0; m < kStage; ++m) {
        const int r = m * Q + q;
        float leaf[1] = {sw[r] * xs[r * CJ + j]};
        col.push(m, leaf);
      }
      outer.push(n, col.acc[Pairwise<kStage, 1>::kLog][0]);
    }
    __syncthreads();  // stage n read before stage n + kRing overwrites it
  }

  // The levels over q, then the block's partial of each column.
  class_levels(red, active ? outer.sum(tree::ilog2_run(stages)) : 0.0f, j,
               q, CJ, Q, active);
  float* pc = parts + (static_cast<size_t>(b) * chunks + chunk) * CJ * G;
  if (tid < cols) pc[static_cast<size_t>(tid) * G + g] = red[tid];

  // The chunk's last block sums each column's G partials, a round of
  // columns at a time through shared memory.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    sh_last = atomicAdd(counters + static_cast<size_t>(b) * chunks + chunk,
                        1u) == static_cast<unsigned>(G - 1);
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  const int per_round = kRing * R * CJ / G;
  for (int c0 = 0; c0 < cols; c0 += per_round) {
    const int nr = min(per_round, cols - c0);
    const float* src = pc + static_cast<size_t>(c0) * G;
    for (int i = 4 * tid; i < nr * G; i += 4 * nthreads)
      copy16_cg(sx + i, src + i);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // A warp a column: lane l holds groups l + 32 m, the levels over m in
    // registers, then xor shuffles (conflict-free reads).
    for (int jj = warp; jj < nr; jj += nwarps) {
      const float x =
          warp_tree([&](int p) { return sx[jj * G + p]; }, G, lane);
      if (lane == 0) {
        const int c = j0 + c0 + jj;
        const size_t o = static_cast<size_t>(b) * T * 2 + c;
        const float* range = (c & 1) ? wrange : vrange;
        u_out[o] = clamp_like_torch(u[o] + x, range[2 * b],
                                    range[2 * b + 1]);
      }
    }
    __syncthreads();
  }
}

size_t noise_shared_bytes(int CJ, int Q) {
  const size_t R = static_cast<size_t>(kStage) * Q;
  return sizeof(float) * (kRing * R * CJ + (kRing + 1) * R);
}

}  // namespace update_wide

using namespace update_wide;

// Lets update_wide_noise take a block's whole opt-in shared memory on the
// current device.  Call once a card, before a launch and outside a
// capture.  Returns the first failing call's cudaError_t.
extern "C" int update_wide_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
#define WIDE_PREPARE(V_)                                                  \
  if (err == cudaSuccess) {                                               \
    cudaFuncAttributes fa;                                                \
    err = cudaFuncGetAttributes(&fa, update_wide_noise<V_>);              \
    if (err == cudaSuccess)                                               \
      err = cudaFuncSetAttribute(                                         \
          update_wide_noise<V_>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          optin - static_cast<int>(fa.sharedSizeBytes));                  \
  }
  WIDE_PREPARE(true)
  WIDE_PREPARE(false)
#undef WIDE_PREPARE
  return static_cast<int>(err);
}

// The wide path (K > kFusedK): costs, noise (16-byte aligned), u, lam,
// vrange, wrange, u_out and weights as update_useq_launch's; the caller's
// scratch: mins (B, G) 32-bit words, etas (B, G) float32, parts (B,
// chunks, CJ, G) float32 and counters (B, chunks) 32-bit words, chunks =
// ceil(2 T / CJ), G = kWideG.  The launch shape (CJ: columns a
// chunk, even, a multiple of 4 where T is even, at most kMaxCols; Q:
// position classes a column, a power of two up to kMaxQ with kStage Q <=
// P; threads
// CJ Q rounded up to a warp, at most kNoiseMax) is
// ops/kernels/update_useq.py::wide_launch_shape's.  Three launches on the
// stream; returns the first one's cudaError_t that is not cudaSuccess.
extern "C" int update_useq_wide_launch(
    const float* costs, const float* noise, const float* u, const float* lam,
    const float* vrange, const float* wrange, float* u_out, float* weights,
    void* mins, float* etas, float* parts, void* counters, int B, int K,
    int T, int CJ, int Q, void* stream) {
  long long L = 1;
  while (L < K) L <<= 1;
  const long long P = L / kWideG;
  const int threads = (CJ * Q + 31) / 32 * 32;
  const bool bulk = T % 2 == 0 && CJ % 4 == 0;
  if (K <= kFusedK || B < 1 || B > 65535 || T < 1 || CJ < 2 || CJ % 2 ||
      CJ > kMaxCols || Q < 1 || Q > kMaxQ || (Q & (Q - 1)) ||
      static_cast<long long>(kStage) * Q > P || threads > kNoiseMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (2LL * T + CJ - 1) / CJ;
  if (chunks * kWideG >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* mk = static_cast<uint32_t*>(mins);
  unsigned* ctr = static_cast<unsigned*>(counters);
  const dim3 grid(kWideG, B);
  update_wide_min<<<grid, kWideW, 0, st>>>(costs, mk, ctr, K,
                                           static_cast<int>(P),
                                           static_cast<int>(chunks));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  update_wide_eta<<<grid, kWideW, 0, st>>>(costs, lam, mk, etas, K,
                                           static_cast<int>(P));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 ngrid(static_cast<unsigned>(chunks * kWideG), B);
  const size_t smem = noise_shared_bytes(CJ, Q);
  if (bulk) {
    update_wide_noise<true><<<ngrid, threads, smem, st>>>(
        costs, noise, u, lam, vrange, wrange, mk, etas, weights, parts, ctr,
        u_out, K, T, static_cast<int>(P), CJ, Q);
  } else {
    update_wide_noise<false><<<ngrid, threads, smem, st>>>(
        costs, noise, u, lam, vrange, wrange, mk, etas, weights, parts, ctr,
        u_out, K, T, static_cast<int>(P), CJ, Q);
  }
  return static_cast<int>(cudaGetLastError());
}
