// The barebone engine's rollout costs, for Hopper (sm_90a): K noisy
// control sequences of T steps under nominal unicycle dynamics against N
// circle obstacles, one thread a rollout, its state in registers.
//
// Replaces the JAX package's XLA-compiled lax.scan barebone_rollout_costs
// (mppi_numba_tpu/ops/rollout.py:181-229), which has no Pallas kernel; in
// torch ops it was a T-step loop of some 34 launches a step.  For rollout
// k, from (x, y, th) = x0, cost 0, not reached, dist2 = 1e9, each step t:
//
//   v, w      = clamp(u[t] + noise[k, t], vrange), clamp(..., wrange)
//   x', y'    = x + (dt * v) * cos(th), y + (dt * v) * sin(th)
//   th        = th + dt * w
//   d2        = (gx - x')^2 + (gy - y')^2
//   hits      = obstacles i with (x' - ox_i)^2 + (y' - oy_i)^2 <= r_i^2
//   step      = dist_weight * d2 + hits * obs_penalty
//   if not reached: cost += step, dist2 = d2, reached = d2 <= tol^2
//                   (else cost += 0)
//
// and out[k] = cost + (1 - reached) * dist2.  The order of operations is
// the plain version's (ops/rollout.py::barebone_rollout_costs), each
// product and sum rounded on its own (-fmad=false), cosf / sinf accurate
// as torch.cos / torch.sin on CUDA (no fast math), the clamp as
// torch.clamp's (NaN passes through): the kernel equals the plain loop bit
// for bit.  Every task value is read on the card from its tensor: no host
// read, so the launch captures into the solve's CUDA graph.
//
// Bound: the bytes, the noise read once (8 T bytes a rollout: 400 MB at K
// = 1e6, T = 50, some 0.12 ms at HBM rate); at K = 1,000 the T dependent
// steps of one thread (latency).  On an H100 the step's own instructions
// (the accurate trigonometry and torch's NaN-aware clamps, in order) take
// more than the bytes: leaving the noise copies out hardly shortens the
// kernel.  So:
//
// - A block of R rollouts (rows k0 .. k0 + R - 1 of the (K, T, 2) noise)
//   stages its noise through shared memory in tiles of kTs steps,
//   double-buffered with cp.async: tile j + 1 is in flight while tile j is
//   stepped.  The copies are coalesced (consecutive threads take
//   consecutive steps of a row: 8 kTs contiguous bytes a row), off every
//   thread's dependency chain, and a row's tile sits at an odd stride of
//   float2s, so the 64-bit reads of a step hit distinct banks.  The
//   nominal controls u[t] come with each tile.
// - A full tile's steps are unrolled kUnroll at a time, so the compiler
//   overlaps the trigonometry of neighbouring steps (th needs only the w
//   of the steps before it); a partial last tile runs the same step in a
//   loop.  kUnroll is the fastest unroll on an H100 at which ptxas spills
//   nothing (2 to 8 tried; the spills sit around sincosf's large-argument
//   reduction).
// - The copies of a whole tile advance two pointers a row; the clamps'
//   NaN rules for the bounds are decided once (torch.clamp returns a NaN
//   bound), so a step clamps without a branch.
// - The task's scalars are read once into registers, and so are the
//   obstacles (x, y and r^2, the loop unrolled) at the counts the engine
//   sends: 1 and 2 (BareboneMPPI adds a dummy obstacle where a task has
//   none; the example and the Config have two).  Every other count runs
//   one generic instantiation, its obstacles read from global memory (L1)
//   each step, a step at a time.  The hits are counted in float (exact
//   below 2^24), which spares a conversion a step.
// - sin and cos of the heading come from one sincosf, which gives sinf's
//   and cosf's bits for every float32 (all 2^32 inputs checked on an
//   H100) from one range reduction.
// - R is chosen from K (ops/kernels/barebone_rollout.py::launch_shape):
//   128 where K fills the card, down to 32 so that K = 1,000 runs on 32
//   SMs, one warp each.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// A named namespace (not an anonymous one, whose mangled names carry a
// hash of the source's path): ptxas then gets the same input, and makes
// the same register allocation, wherever the repository is checked out.
namespace barebone {

constexpr int kMaxThreads = 128;   // rollouts a block at most
constexpr int kTileSteps = 8;      // kTs: steps a staged tile
constexpr int kUnroll = 4;         // steps of a tile unrolled together
                                   // (obstacles in registers; generic: 1)

// torch.clamp(v, lo, hi) on CUDA: a NaN among the three is returned (v
// first, then lo, then hi).  The bounds' part is decided once, so a step
// clamps without a branch.
struct Clamp {
  float lo, hi, nan_bound;
  bool bound_is_nan;

  __device__ __forceinline__ void set(float lo_, float hi_) {
    lo = lo_;
    hi = hi_;
    bound_is_nan = isnan(lo) || isnan(hi);
    nan_bound = isnan(lo) ? lo : hi;
  }

  __device__ __forceinline__ float operator()(float v) const {
    const float m = fminf(fmaxf(v, lo), hi);
    return isnan(v) ? v : (bound_is_nan ? nan_bound : m);
  }
};

// The task's values, read once a thread.  kN > 0: its kN obstacles in
// registers; kN < 0: any N, its obstacles read from global memory each
// step.
template <int kN>
struct Task {
  static constexpr int kHeld = kN > 0 ? kN : 0;
  float gx, gy, tol2, dt, dw, pen;
  Clamp v, w;
  float ox[kHeld > 0 ? kHeld : 1], oy[kHeld > 0 ? kHeld : 1],
      r2[kHeld > 0 ? kHeld : 1];
  const float* obs_pos;
  const float* obs_r;
  int N;

  // The obstacles (x', y') lies in, counted in float as the plain
  // version's sum of 0/1 floats.
  __device__ __forceinline__ float hits(float xn, float yn) const {
    float n = 0.0f;
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const float ex = xn - ox[i], ey = yn - oy[i];
      n += (ex * ex + ey * ey) <= r2[i] ? 1.0f : 0.0f;
    }
    if constexpr (kN < 0) {
      for (int i = 0; i < N; ++i) {
        const float ex = xn - obs_pos[2 * i], ey = yn - obs_pos[2 * i + 1];
        n += (ex * ex + ey * ey) <= obs_r[i] * obs_r[i] ? 1.0f : 0.0f;
      }
    }
    return n;
  }
};

struct State {
  float x, y, th, cost, dist2;
  bool reached;
};

// One step of the rollout, in the plain loop's order of operations.
template <int kN>
__device__ __forceinline__ void step(State& s, float2 e, float2 ut,
                                     const Task<kN>& p) {
  const float v = p.v(ut.x + e.x);
  const float w = p.w(ut.y + e.y);
  float sn, cs;
  sincosf(s.th, &sn, &cs);
  const float xn = s.x + p.dt * v * cs;
  const float yn = s.y + p.dt * v * sn;
  s.th = s.th + p.dt * w;
  const float dx = p.gx - xn, dy = p.gy - yn;
  const float d2 = dx * dx + dy * dy;
  const float stp = p.dw * d2 + p.hits(xn, yn) * p.pen;
  const bool active = !s.reached;
  s.cost = s.cost + (active ? stp : 0.0f);
  if (active) s.dist2 = d2;
  s.reached = s.reached || (active && d2 <= p.tol2);
  s.x = xn;
  s.y = yn;
}

// Shared memory: two tiles of R rows x kStride float2s, two tiles of u.
constexpr int kStride = kTileSteps | 1;

__host__ __device__ constexpr size_t shared_bytes(int R) {
  return sizeof(float2) *
         (2 * static_cast<size_t>(R) * kStride + 2 * kTileSteps);
}

template <int kN>
__global__ void __launch_bounds__(kMaxThreads)
barebone_rollout_kernel(const float* __restrict__ u,
                        const float* __restrict__ noise,
                        const float* __restrict__ x0,
                        const float* __restrict__ xgoal,
                        const float* __restrict__ goal_tolerance,
                        const float* __restrict__ dt_p,
                        const float* __restrict__ dist_weight,
                        const float* __restrict__ obs_penalty,
                        const float* __restrict__ vrange,
                        const float* __restrict__ wrange,
                        const float* __restrict__ obs_pos,
                        const float* __restrict__ obs_r,
                        float* __restrict__ out, int K, int T, int N) {
  extern __shared__ float2 smem[];
  const int R = blockDim.x, tid = threadIdx.x;
  float2* tiles = smem;                      // [2][R][kStride]
  float2* utiles = smem + 2 * R * kStride;   // [2][kTileSteps]
  const long long k0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), K - k0));
  const int ntiles = (T + kTileSteps - 1) / kTileSteps;
  const float2* nb = reinterpret_cast<const float2*>(noise) + k0 * T;
  const float2* uu = reinterpret_cast<const float2*>(u);

  // Tile j: rows x min(kTs, T - t0) steps, a thread's copies consecutive
  // steps of a row.  Every thread commits a group, copies or not.
  auto issue = [&](int j) {
    const int t0 = j * kTileSteps, w = min(kTileSteps, T - t0);
    float2* dst = tiles + (j & 1) * R * kStride;
    if (w == kTileSteps) {
      // Thread tid copies step tid % kTs of rows tid / kTs, + R / kTs, ...
      const int r0 = tid / kTileSteps, c = tid % kTileSteps;
      const int dr = R / kTileSteps;
      const float2* src = nb + static_cast<size_t>(r0) * T + t0 + c;
      const size_t src_step = static_cast<size_t>(dr) * T;
      float2* d = dst + r0 * kStride + c;
      for (int r = r0; r < rows; r += dr, src += src_step, d += dr * kStride)
        __pipeline_memcpy_async(d, src, 8);
    } else {
      for (int i = tid; i < rows * w; i += R) {
        const int r = i / w, c = i - r * w;
        __pipeline_memcpy_async(dst + r * kStride + c,
                                nb + static_cast<size_t>(r) * T + t0 + c, 8);
      }
    }
    if (tid < w)
      __pipeline_memcpy_async(utiles + (j & 1) * kTileSteps + tid,
                              uu + t0 + tid, 8);
    __pipeline_commit();
  };
  issue(0);

  Task<kN> p;
#pragma unroll
  for (int i = 0; i < Task<kN>::kHeld; ++i) {
    p.ox[i] = obs_pos[2 * i];
    p.oy[i] = obs_pos[2 * i + 1];
    p.r2[i] = obs_r[i] * obs_r[i];
  }
  p.N = N;
  p.obs_pos = obs_pos;
  p.obs_r = obs_r;
  p.gx = xgoal[0];
  p.gy = xgoal[1];
  p.tol2 = goal_tolerance[0] * goal_tolerance[0];
  p.dt = dt_p[0];
  p.dw = dist_weight[0];
  p.pen = obs_penalty[0];
  p.v.set(vrange[0], vrange[1]);
  p.w.set(wrange[0], wrange[1]);
  State s{x0[0], x0[1], x0[2], 0.0f, 1e9f, false};

  constexpr int kSteps = kN < 0 ? 1 : kUnroll;
  const bool live = tid < rows;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      issue(j + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // tile j landed for every thread
    const float2* row = tiles + (j & 1) * R * kStride + tid * kStride;
    const float2* ut = utiles + (j & 1) * kTileSteps;
    const int w = T - j * kTileSteps;
    if (live) {
      if (w >= kTileSteps) {
#pragma unroll kSteps
        for (int t = 0; t < kTileSteps; ++t) step(s, row[t], ut[t], p);
      } else {
        for (int t = 0; t < w; ++t) step(s, row[t], ut[t], p);
      }
    }
    __syncthreads();  // tile j read before tile j + 2 overwrites it
  }
  if (live)
    out[k0 + tid] = s.cost + (1.0f - (s.reached ? 1.0f : 0.0f)) * s.dist2;
}

}  // namespace barebone

// u (T, 2), noise (K, T, 2) (both 8-byte aligned), x0 (3,), xgoal (2,),
// goal_tolerance, dt, dist_weight and obs_penalty (one float each), vrange
// and wrange (2,), obs_pos (N, 2), obs_r (N,): float32, contiguous, on the
// current device.  out: float32 (K,).  K >= 1, T >= 1, N >= 0; threads:
// rollouts a block, 32, 64 or 128.  Returns the launch's cudaError_t.
extern "C" int barebone_rollout_launch(
    const float* u, const float* noise, const float* x0, const float* xgoal,
    const float* goal_tolerance, const float* dt, const float* dist_weight,
    const float* obs_penalty, const float* vrange, const float* wrange,
    const float* obs_pos, const float* obs_r, float* out, int K, int T,
    int N, int threads, void* stream) {
  if (K < 1 || T < 1 || N < 0 ||
      (threads != 32 && threads != 64 && threads != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((static_cast<long long>(K) + threads -
                                       1) / threads);
  const size_t smem = barebone::shared_bytes(threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BAREBONE_LAUNCH(N_)                                                 \
  barebone::barebone_rollout_kernel<N_><<<blocks, threads, smem, st>>>(    \
      u, noise, x0, xgoal, goal_tolerance, dt, dist_weight, obs_penalty,   \
      vrange, wrange, obs_pos, obs_r, out, K, T, N)
  switch (N) {
    case 1: BAREBONE_LAUNCH(1); break;
    case 2: BAREBONE_LAUNCH(2); break;
    default: BAREBONE_LAUNCH(-1);
  }
#undef BAREBONE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

