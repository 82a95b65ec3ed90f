// The rollout kernels' shared step loop (csrc/rollout_byte.cu,
// csrc/rollout_binned.cu), for Hopper (sm_90a).
//
// Each kernel supplies a map decoder; this header holds everything else:
// the task scalars, the cell index, the dynamics, the stage cost, the
// masking of reached rollouts and the terminal cost, in the float32
// operations and order of the plain PyTorch version
// (ops/kernels/rollout_byte.py::plain_rollout).  Built with -fmad=false and
// without --use_fast_math, so every a*b+c rounds twice and sqrtf, sinf,
// cosf, tanf and division are IEEE / accurate, as there.
//
// What bounds the kernels: instruction issue.  The bytes are small (the
// map sample a warp walks sits in L1), and a lane-step is ~60 float32
// operations plus the integer and conversion work around them.  So the
// step is written for few instructions:
//   - the cell index is clamped in float and floored by an add in
//     round-down mode against 2^23, whose bits are the integer: no
//     FRND / F2I on the conversion pipe (the floor of a value clamped to
//     [0, hi], hi an integer, equals the clamp of its floor; fmaxf maps a
//     NaN coordinate to cell 0 either way);
//   - byte fields become floats the same way (PRMT into a 2^23-biased
//     float, one FADD): no I2F;
//   - obstacle and unknown penalties are selects between 0 * pen and
//     1 * pen, computed once: the same bits as the product of the 0/1
//     flag with the penalty;
//   - reached rollouts keep an `active` factor in {0, 1} (1 - reachedf of
//     the plain version, exactly) updated by a select;
//   - the speed-map step time dt / (eff + 1e-6) depends only on the risk
//     byte: a 256-entry shared table built in each block's prologue with
//     the same operations replaces the IEEE division per step;
//   - exact trig takes sin and cos of one heading from one sincosf (one
//     range reduction);
//   - the controls v[t, k], w[t, k] of step t + 1 are loaded while step t
//     computes, and a thread walks kSamples map samples with one load of
//     the controls and, for the bicycle, one tanf(w) per (t, k).
// The tiling (block width, samples per thread) is a compile-time property
// of each instantiation (Tiling below); the wrappers read it back from
// the library, never pass it.
//
// The scenario axis: a launch rolls out B scenarios (the episodes of a
// batch, the JAX package's rollout under jax.vmap), blockIdx.z the
// scenario b.  Each kernel offsets its inputs by b's strides (the task
// vector, the controls (T, K), the map planes); this loop writes
// cost_out[b, k, m].  Offsets are size_t: B * M * H * W passes 2^31 at
// B = 120, M = 1024 and 250 x 250.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rollout {

// Dynamics models (ops: models.KERNEL_MODELS).
constexpr int kUnicycle = 0;
constexpr int kBicycle = 1;

// Shared memory a launch may hold, static plus dynamic, without an opt-in.
constexpr int kMaxSharedBytes = 48 * 1024;
// Entries of the speed-map step-time table: every value of a risk byte.
constexpr int kStepTable = 256;

// Maclaurin coefficients exactly as the TPU kernel has them: Python
// doubles rounded once to float32.
constexpr float kInv6 = (float)(1.0 / 6.0);
constexpr float kInv24 = (float)(1.0 / 24.0);
constexpr float kInv120 = (float)(1.0 / 120.0);

// 2^23: a float in [2^23, 2^24) has an ulp of 1 and holds its integer in
// the low 23 bits of its pattern.
constexpr float kTwo23 = 8388608.0f;
constexpr uint32_t kTwo23Bits = 0x4B000000u;

// Block width and map samples per thread of an instantiation.  The
// bicycle shares each step's controls and tanf(w) across two samples; the
// unicycle, whose per-(t, k) work is the two control loads alone, keeps
// one sample a thread.
template <int MODEL>
struct Tiling {
  static constexpr int kBlock = 128;
  static constexpr int kSamples = MODEL == kBicycle ? 2 : 1;
  // Blocks per SM the register budget is cut for: 8 x 128 threads leaves
  // 64 registers a thread, so no instantiation spills.
  static constexpr int kMinBlocks = 8;
};

// An opaque copy of a pointer: address arithmetic on it stays a base plus
// a 32-bit offset in the loop, not a 64-bit sum re-formed every step.
template <class P>
__device__ __forceinline__ P* opaque(P* p) {
  asm("" : "+l"(p));
  return p;
}

// Task vector layout: ops/kernels/rollout_byte.py::build_task_vec.
struct Task {
  float x0x, x0y, x0th, gx, gy, tol2, v_post, dt, dist_w;
  float obs_pen, unk_pen, inv_res, xlim0, ylim0;
  float lin_lb, lin_ratio, ang_lb, ang_ratio;

  __device__ explicit Task(const float* __restrict__ t)
      : x0x(t[0]), x0y(t[1]), x0th(t[2]), gx(t[3]), gy(t[4]),
        tol2(t[5] * t[5]), v_post(t[6]), dt(t[7]), dist_w(t[8]),
        obs_pen(t[9]), unk_pen(t[10]), inv_res(t[11]), xlim0(t[12]),
        ylim0(t[13]), lin_lb(t[14]), lin_ratio(t[15]), ang_lb(t[16]),
        ang_ratio(t[17]) {}
};

// A byte (bits 0-7 of `b` after the selector) as an exact float: PRMT the
// byte under a 2^23 exponent, subtract 2^23.  sel 0x7650 takes byte 0 of
// x, 0x7651 byte 1.
__device__ __forceinline__ float byte_float(uint32_t x, uint32_t sel) {
  return __uint_as_float(__byte_perm(x, kTwo23Bits, sel)) - kTwo23;
}

// lb + ratio * byte, the decode of a byte field (two rounded operations).
__device__ __forceinline__ float decode_byte(uint32_t x, uint32_t sel,
                                             float lb, float ratio) {
  return lb + ratio * byte_float(x, sel);
}

// 2^23 + floor(clamp((p - lo) * inv_res, 0, hi)), as bits.
__device__ __forceinline__ uint32_t biased_cell(float p, float lo,
                                                float inv_res, float hi) {
  const float c = fminf(fmaxf((p - lo) * inv_res, 0.0f), hi);
  return __float_as_uint(__fadd_rd(c, kTwo23));
}

// The fields of one cell the step reads.
struct Cell {
  float lin_tr, ang_tr;
  bool obs, unk;
  uint32_t risk;          // the risk byte (speed-map mode only)
};

// Fills the block's speed-map step-time table: entry r is
// dt / ((lin_lb + lin_ratio * r) + 1e-6), the plain version's step time
// at risk byte r.  Call before any early return; ends in a barrier.
__device__ __forceinline__ void fill_step_table(float* s_step,
                                                const Task& tk) {
  for (int r = threadIdx.x; r < kStepTable; r += blockDim.x) {
    const float eff = tk.lin_lb + tk.lin_ratio * (float)r;
    s_step[r] = tk.dt / (eff + 1e-6f);
  }
}

// The T-step loop of thread (k, samples m0 .. m0 + S - 1) of scenario b,
// written to cost_out[b, k, m] for m < M; v_all and w_all are b's (T, K).
// dec(s, cell) decodes flat cell `cell` of the thread's s-th sample (a
// sample past M re-reads sample M - 1).
template <int S, bool FAST_TRIG, bool SPEED_MAP, int MODEL, class Decoder>
__device__ __forceinline__ void rollout_loop(
    const Decoder& dec, const Task& tk, const float* __restrict__ v_all,
    const float* __restrict__ w_all, const float* s_step,
    float* __restrict__ cost_out, int b, int k, int K, int m0, int M, int H,
    int W, int T, float wheelbase) {
  const float x_hi = (float)(W - 1), y_hi = (float)(H - 1);
  // Flat cell = yb * W + xb - bias, in 32-bit unsigned arithmetic, from
  // the 2^23-biased patterns xb, yb of the clamped floors.
  const uint32_t bias = kTwo23Bits * (uint32_t)(W + 1);
  // 1 * pen and 0 * pen: what the plain version's flag * pen gives.
  const float obs_on = 1.0f * tk.obs_pen, obs_off = 0.0f * tk.obs_pen;
  const float unk_on = 1.0f * tk.unk_pen, unk_off = 0.0f * tk.unk_pen;

  float x[S], y[S], th[S], cth[S], sth[S], cost[S], dist2[S], active[S];
  float c0 = 0.0f, s0 = 0.0f;
  if (FAST_TRIG) {
    c0 = cosf(tk.x0th);
    s0 = sinf(tk.x0th);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    x[s] = tk.x0x;
    y[s] = tk.x0y;
    th[s] = tk.x0th;
    cth[s] = c0;
    sth[s] = s0;
    cost[s] = 0.0f;
    dist2[s] = 1e9f;
    active[s] = 1.0f;
  }

  const float* vp = v_all + k;                   // v[t, k], w[t, k]
  const float* wp = w_all + k;
  float v_next = *vp, w_next = *wp;
  for (int t = 0; t < T; ++t) {
    const float v = v_next, w = w_next;
    // Prefetch step t + 1's controls (the last step re-reads its own).
    const int stride = t + 1 < T ? K : 0;
    vp += stride;
    wp += stride;
    v_next = *vp;
    w_next = *wp;
    float tan_w = 0.0f;
    if (MODEL == kBicycle) tan_w = tanf(w);

#pragma unroll
    for (int s = 0; s < S; ++s) {
      // Cell of the PRE-update state, clamped to the map.
      const uint32_t xb = biased_cell(x[s], tk.xlim0, tk.inv_res, x_hi);
      const uint32_t yb = biased_cell(y[s], tk.ylim0, tk.inv_res, y_hi);
      const Cell c = dec(s, yb * (uint32_t)W + xb - bias);

      float x_new, y_new;
      if (FAST_TRIG) {
        const float dth = tk.dt * c.ang_tr * w;
        const float z2 = dth * dth;
        const float cd = 1.0f - z2 * (0.5f - z2 * kInv24);
        const float sd = dth * (1.0f - z2 * (kInv6 - z2 * kInv120));
        const float step = tk.dt * c.lin_tr * v;
        x_new = x[s] + step * cth[s];
        y_new = y[s] + step * sth[s];
        const float c_new = cth[s] * cd - sth[s] * sd;
        const float s_new = sth[s] * cd + cth[s] * sd;
        cth[s] = c_new;
        sth[s] = s_new;
      } else {
        float sn, cs;
        sincosf(th[s], &sn, &cs);
        if (MODEL == kBicycle) {
          // dt * (lin_tr * v), not the unicycle's (dt * lin_tr) * v;
          // heading ((dt * ang_tr * v) * tan(w)) / wheelbase.
          const float step = tk.dt * (c.lin_tr * v);
          x_new = x[s] + step * cs;
          y_new = y[s] + step * sn;
          th[s] = th[s] + tk.dt * c.ang_tr * v * tan_w / wheelbase;
        } else {
          const float step = tk.dt * c.lin_tr * v;
          x_new = x[s] + step * cs;
          y_new = y[s] + step * sn;
          th[s] = th[s] + tk.dt * c.ang_tr * w;
        }
      }

      const float dx = tk.gx - x_new, dy = tk.gy - y_new;
      const float dist2_new = dx * dx + dy * dy;
      const float dt_eff = SPEED_MAP ? s_step[c.risk] : tk.dt;
      const float step_cost = dt_eff + tk.dist_w * sqrtf(dist2_new)
                              + (c.obs ? obs_on : obs_off)
                              + (c.unk ? unk_on : unk_off);

      cost[s] = cost[s] + active[s] * step_cost;
      dist2[s] = dist2[s] + active[s] * (dist2_new - dist2[s]);
      active[s] = dist2_new <= tk.tol2 ? 0.0f : active[s];
      x[s] = x_new;
      y[s] = y_new;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (m0 + s < M)
      cost_out[((size_t)b * K + k) * M + m0 + s] =
          cost[s] + active[s] * sqrtf(dist2[s]) / (tk.v_post + 1e-6f);
  }
}

// Whether an instantiation's static shared memory, plus the dynamic
// shared memory its launches ask for (none: nothing is staged), fits the
// 48 KB a launch may hold without an opt-in.  Returns
// cudaErrorInvalidValue when over, so the wrapper raises.
template <auto KERNEL>
int check_shared(cudaFuncAttributes* attr) {
  const cudaError_t err = cudaFuncGetAttributes(attr, KERNEL);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t kDynamicShared = 0;
  return attr->sharedSizeBytes + kDynamicShared <= (size_t)kMaxSharedBytes
             ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// check_shared, made once per instantiation (one static per KERNEL).
template <auto KERNEL>
int cached_check() {
  static const int status = [] {
    cudaFuncAttributes attr;
    return check_shared<KERNEL>(&attr);
  }();
  return status;
}

// The tiling and resources of an instantiation, for the wrappers:
// info[0] block width, [1] samples per thread, [2] static shared bytes,
// [3] registers per thread, [4] local (spill and stack) bytes per thread.
template <int MODEL, auto KERNEL>
int tiling_info(int* info) {
  cudaFuncAttributes attr{};
  const int err = check_shared<KERNEL>(&attr);
  info[0] = Tiling<MODEL>::kBlock;
  info[1] = Tiling<MODEL>::kSamples;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace rollout
