// Fused rollout over a byte-packed traction map, for Hopper (sm_90a).
//
// Replaces: mppi_numba_tpu/ops/pallas/rollout_kernel.py::_rollout_kernel
// (wrapper terrain_rollout_costs_pallas).  Computes the float32 (K, M)
// rollout cost of every (control sequence k, map sample m) pair, terminal
// cost included, coupling excluded -- the semantics of
// mppi_numba_tpu_torch/ops/rollout.py::terrain_rollout_costs, in the float
// masking form of the TPU kernel (reachedf / active * x).
//
// Design.  One thread per (k, m): k on threadIdx.x / blockIdx.x, m on
// blockIdx.y.  The T-step loop runs in registers.  A warp's 32 lanes share
// one map sample, so each step's 32 word loads fall in that sample's H*W
// words (484 B at the 11x11 flagship, L1-resident), and the per-step
// controls v[t, k], w[t, k] load coalesced.  None of the TPU kernel's lane
// padding of K, chunk transpose, (8, 128) task tile, m_tile or t_unroll
// exists here: the ragged edges of K are masked and M is the grid's y.
//
// What bounds it: float32 ALU work plus one sqrtf (and, in exact mode, one
// sinf and one cosf) per lane-step.  The bytes are tiny (words, controls
// and costs are ~5.5 MB at K = M = 1024, T = 100), so it is bound by
// operations, not memory.  A first version, right and simple; no tuning.
//
// Numerics: built without --use_fast_math (IEEE sqrtf and division,
// accurate sinf/cosf) and with -fmad=false, so every a*b+c rounds twice as
// in the plain PyTorch version it is held against.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 128;

// Maclaurin coefficients exactly as the TPU kernel has them: Python
// doubles rounded once to float32.
constexpr float kInv6 = (float)(1.0 / 6.0);
constexpr float kInv24 = (float)(1.0 / 24.0);
constexpr float kInv120 = (float)(1.0 / 120.0);

template <bool FAST_TRIG, bool SPEED_MAP>
__global__ void __launch_bounds__(kBlockK)
rollout_byte_kernel(const int32_t* __restrict__ words,
                    const float* __restrict__ task,
                    const float* __restrict__ v_all,
                    const float* __restrict__ w_all,
                    float* __restrict__ cost_out,
                    int K, int M, int H, int W, int T) {
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int m = blockIdx.y;
  if (k >= K) return;

  // Task vector layout: ops/kernels/rollout_byte.py::build_task_vec.
  const float x0x = task[0], x0y = task[1], x0th = task[2];
  const float gx = task[3], gy = task[4];
  const float tol = task[5];
  const float v_post = task[6];
  const float dt = task[7];
  const float dist_w = task[8];
  const float obs_pen = task[9], unk_pen = task[10];
  const float inv_res = task[11];
  const float xlim0 = task[12], ylim0 = task[13];
  const float lin_lb = task[14], lin_ratio = task[15];
  const float ang_lb = task[16], ang_ratio = task[17];
  const float tol2 = tol * tol;
  const float x_hi = (float)(W - 1), y_hi = (float)(H - 1);

  const int32_t* __restrict__ map = words + (size_t)m * H * W;

  float x = x0x, y = x0y;
  // Heading: theta in exact mode, (cos, sin) in fast-trig mode.
  float th = x0th, cth = 0.0f, sth = 0.0f;
  if (FAST_TRIG) {
    cth = cosf(x0th);
    sth = sinf(x0th);
  }
  float cost = 0.0f, dist2 = 1e9f, reachedf = 0.0f;

  for (int t = 0; t < T; ++t) {
    const float v = v_all[(size_t)t * K + k];
    const float w = w_all[(size_t)t * K + k];

    // Cell of the PRE-update state, clamped to the map (clamped in float
    // before the cast: equal to a saturating cast followed by a clip).
    const int xi = (int)fminf(fmaxf(floorf((x - xlim0) * inv_res), 0.0f), x_hi);
    const int yi = (int)fminf(fmaxf(floorf((y - ylim0) * inv_res), 0.0f), y_hi);
    // Signed word: bytes were sign-extended when packed; the masks below
    // decode them as the TPU kernel does.
    const int32_t word = map[yi * W + xi];

    const float lin_tr = lin_lb + lin_ratio * (float)(word & 0xFF);
    const float ang_tr = ang_lb + ang_ratio * (float)((word >> 8) & 0xFF);
    const float obs = (float)((word >> 16) & 1);
    const float unk = (float)((word >> 17) & 1);

    float x_new, y_new;
    if (FAST_TRIG) {
      const float dth = dt * ang_tr * w;
      const float z2 = dth * dth;
      const float cd = 1.0f - z2 * (0.5f - z2 * kInv24);
      const float sd = dth * (1.0f - z2 * (kInv6 - z2 * kInv120));
      x_new = x + dt * lin_tr * v * cth;
      y_new = y + dt * lin_tr * v * sth;
      const float c_new = cth * cd - sth * sd;
      const float s_new = sth * cd + cth * sd;
      cth = c_new;
      sth = s_new;
    } else {
      x_new = x + dt * lin_tr * v * cosf(th);
      y_new = y + dt * lin_tr * v * sinf(th);
      th = th + dt * ang_tr * w;
    }

    const float dx = gx - x_new, dy = gy - y_new;
    const float dist2_new = dx * dx + dy * dy;
    float dt_eff = dt;
    if (SPEED_MAP) {
      const float eff = lin_lb + lin_ratio * (float)((word >> 18) & 0xFF);
      dt_eff = dt / (eff + 1e-6f);
    }
    const float step_cost = dt_eff + dist_w * sqrtf(dist2_new)
                            + obs * obs_pen + unk * unk_pen;

    const float active = 1.0f - reachedf;
    cost = cost + active * step_cost;
    dist2 = dist2 + active * (dist2_new - dist2);
    reachedf = fmaxf(reachedf, active * (dist2_new <= tol2 ? 1.0f : 0.0f));
    x = x_new;
    y = y_new;
  }
  cost_out[(size_t)k * M + m] =
      cost + (1.0f - reachedf) * sqrtf(dist2) / (v_post + 1e-6f);
}

template <bool FAST_TRIG, bool SPEED_MAP>
void launch(const int32_t* words, const float* task, const float* v,
            const float* w, float* out, int K, int M, int H, int W, int T,
            cudaStream_t stream) {
  const dim3 grid((K + kBlockK - 1) / kBlockK, M);
  rollout_byte_kernel<FAST_TRIG, SPEED_MAP><<<grid, kBlockK, 0, stream>>>(
      words, task, v, w, out, K, M, H, W, T);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers:
// words int32 (M, H, W), task float32 (>= 18), v / w float32 (T, K),
// out float32 (K, M).  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so the caller sees a refused launch.
extern "C" int rollout_byte_launch(const void* words, const void* task,
                                   const void* v, const void* w, void* out,
                                   int K, int M, int H, int W, int T,
                                   int speed_map, int fast_trig,
                                   void* stream) {
  const int32_t* wd = static_cast<const int32_t*>(words);
  const float* tk = static_cast<const float*>(task);
  const float* vv = static_cast<const float*>(v);
  const float* ww = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_trig) {
    if (speed_map) launch<true, true>(wd, tk, vv, ww, o, K, M, H, W, T, s);
    else launch<true, false>(wd, tk, vv, ww, o, K, M, H, W, T, s);
  } else {
    if (speed_map) launch<false, true>(wd, tk, vv, ww, o, K, M, H, W, T, s);
    else launch<false, false>(wd, tk, vv, ww, o, K, M, H, W, T, s);
  }
  return static_cast<int>(cudaGetLastError());
}
