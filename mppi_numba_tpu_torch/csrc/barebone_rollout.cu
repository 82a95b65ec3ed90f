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
// = 1e6, T = 50, some 0.12 ms at HBM rate).  A thread reads its own
// (v, w) noise pair a step, 8 bytes at a stride of 8 T between
// neighbouring threads: each 32-byte sector serves 4 steps of one
// rollout, from L1 while it stays there.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// torch.clamp(v, lo, hi) on CUDA: a NaN among the three is returned.
__device__ __forceinline__ float clamp_as_torch(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
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
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  const float gx = xgoal[0], gy = xgoal[1];
  const float tol2 = goal_tolerance[0] * goal_tolerance[0];
  const float dt = dt_p[0], dw = dist_weight[0], pen = obs_penalty[0];
  const float vlo = vrange[0], vhi = vrange[1];
  const float wlo = wrange[0], whi = wrange[1];
  const float2* nz =
      reinterpret_cast<const float2*>(noise) + static_cast<size_t>(k) * T;
  const float2* uu = reinterpret_cast<const float2*>(u);
  float x = x0[0], y = x0[1], th = x0[2];
  float cost = 0.0f, dist2 = 1e9f;
  bool reached = false;
  for (int t = 0; t < T; ++t) {
    const float2 e = nz[t];
    const float2 ut = uu[t];
    const float v = clamp_as_torch(ut.x + e.x, vlo, vhi);
    const float w = clamp_as_torch(ut.y + e.y, wlo, whi);
    const float xn = x + dt * v * cosf(th);
    const float yn = y + dt * v * sinf(th);
    th = th + dt * w;
    const float dx = gx - xn, dy = gy - yn;
    const float d2 = dx * dx + dy * dy;
    int hits = 0;
    for (int i = 0; i < N; ++i) {
      const float ex = xn - obs_pos[2 * i], ey = yn - obs_pos[2 * i + 1];
      hits += (ex * ex + ey * ey) <= obs_r[i] * obs_r[i];
    }
    const float step = dw * d2 + static_cast<float>(hits) * pen;
    const bool active = !reached;
    cost = cost + (active ? step : 0.0f);
    if (active) dist2 = d2;
    reached = reached || (active && d2 <= tol2);
    x = xn;
    y = yn;
  }
  out[k] = cost + (1.0f - (reached ? 1.0f : 0.0f)) * dist2;
}

}  // namespace

// u (T, 2), noise (K, T, 2), x0 (3,), xgoal (2,), goal_tolerance, dt,
// dist_weight and obs_penalty (one float each), vrange and wrange (2,),
// obs_pos (N, 2), obs_r (N,): float32, contiguous, on the current device.
// out: float32 (K,).  K >= 1, T >= 1, N >= 0.  Returns the launch's
// cudaError_t.
extern "C" int barebone_rollout_launch(
    const float* u, const float* noise, const float* x0, const float* xgoal,
    const float* goal_tolerance, const float* dt, const float* dist_weight,
    const float* obs_penalty, const float* vrange, const float* wrange,
    const float* obs_pos, const float* obs_r, float* out, int K, int T,
    int N, void* stream) {
  if (K < 1 || T < 1 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (K + kThreads - 1) / kThreads;
  barebone_rollout_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      u, noise, x0, xgoal, goal_tolerance, dt, dist_weight, obs_penalty,
      vrange, wrange, obs_pos, obs_r, out, K, T, N);
  return static_cast<int>(cudaGetLastError());
}
