// Fused rollout over a binned (packed-cell) traction map, for Hopper
// (sm_90a).
//
// Replaces: mppi_numba_tpu/ops/pallas/rollout_kernel.py::
// _rollout_kernel_binned (wrapper terrain_rollout_costs_pallas_binned).
// Computes the float32 (K, M) rollout cost of every (control sequence k,
// map sample m) pair, terminal cost included, coupling excluded: the byte
// kernel's costs (csrc/rollout_byte.cu), read from smaller planes.
//
// Planes (mppi_numba_tpu_torch/ops/packing.py).  Per map sample, a cell
// plane of n_words int32 words, a cell holding lin | ang << CELL_BITS:
//   CELL_BITS 2  crumbs, 8 cells per word, bin indices, LUT decode;
//   CELL_BITS 4  nibbles, 4 cells per word, bin indices, LUT decode;
//   CELL_BITS 8  byte pairs, 2 cells per word, decoded values, inline
//                decode lin_lb + lin_ratio * value.
// Shared by all samples: the mask plane (obstacle | unknown << 1, 16 cells
// per word) and, in speed-map mode, the risk plane (one byte per cell, 4
// cells per word).  Fields are selected with the JAX package's shifts on
// signed int32, so >> is arithmetic and bit patterns that spill across a
// field (a bin index one past the last, a sign-extended -128 value)
// decode as they do there.  The LUT (ops/kernels/rollout_binned.py::
// build_bin_luts: lb + ratio * qbin, two rounded operations, zero past the
// bins) is read, not recomputed, so a binned layout equals the byte kernel
// bit for bit on maps whose PMF columns sum to 100.
//
// Design.  One thread per (k, m), as in the byte kernel: k on threadIdx.x /
// blockIdx.x, m on blockIdx.y; the T-step loop runs in registers.  A
// warp's 32 lanes share one map sample, so each step's 32 loads fall in
// that sample's plane (62.5 KB of nibbles at 250x250, against 250 KB of
// byte words); the 2 x 16 LUT floats sit in shared memory.  Hopper indexes
// the planes directly: none of the TPU kernel's chunk walks, occupancy
// bands, HBM streaming windows, m_tile, t_unroll, lane padding or (8, 128)
// task tile exists here.  Ragged K is masked.
//
// Dynamics (MODEL): the unicycle or the kinematic bicycle, in the
// operations and order of the byte kernel (csrc/rollout_byte.cu); fast
// trig is the unicycle's only.
//
// What bounds it: float32 ALU work plus one sqrtf (and, in exact mode, one
// sinf and one cosf, and for the bicycle one tanf and a division) per
// lane-step, as in the byte kernel; the planes are
// 2-8x smaller than the byte layout's words, and the bytes are small
// beside the operations.  A first version, right and simple; no tuning.
//
// Numerics: built like the byte kernel, without --use_fast_math and with
// -fmad=false, so every a*b+c rounds twice as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 128;
constexpr int kLutBins = 16;   // LUT entries per row (ops: LUT_BINS)

// Dynamics models (ops: models.KERNEL_MODELS).
constexpr int kUnicycle = 0;
constexpr int kBicycle = 1;

constexpr float kInv6 = (float)(1.0 / 6.0);
constexpr float kInv24 = (float)(1.0 / 24.0);
constexpr float kInv120 = (float)(1.0 / 120.0);

template <int CELL_BITS, bool FAST_TRIG, bool SPEED_MAP, int MODEL>
__global__ void __launch_bounds__(kBlockK)
rollout_binned_kernel(const int32_t* __restrict__ cells,
                      const int32_t* __restrict__ mask,
                      const float* __restrict__ lut,
                      const int32_t* __restrict__ risk,
                      const float* __restrict__ task,
                      const float* __restrict__ v_all,
                      const float* __restrict__ w_all,
                      float* __restrict__ cost_out,
                      int K, int M, int H, int W, int T, int n_words,
                      float wheelbase) {
  constexpr int kCellsPerWord = 32 / (2 * CELL_BITS);
  constexpr int kWordShift = CELL_BITS == 2 ? 3 : (CELL_BITS == 4 ? 2 : 1);
  constexpr int32_t kLow = (1 << CELL_BITS) - 1;

  __shared__ float s_lut[2 * kLutBins];
  if (CELL_BITS != 8) {
    if (threadIdx.x < 2 * kLutBins) s_lut[threadIdx.x] = lut[threadIdx.x];
    __syncthreads();
  }

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

  const int32_t* __restrict__ plane = cells + (size_t)m * n_words;

  float x = x0x, y = x0y;
  float th = x0th, cth = 0.0f, sth = 0.0f;
  if (FAST_TRIG) {
    cth = cosf(x0th);
    sth = sinf(x0th);
  }
  float cost = 0.0f, dist2 = 1e9f, reachedf = 0.0f;

  for (int t = 0; t < T; ++t) {
    const float v = v_all[(size_t)t * K + k];
    const float w = w_all[(size_t)t * K + k];

    // Cell of the PRE-update state, clamped to the map.
    const int xi = (int)fminf(fmaxf(floorf((x - xlim0) * inv_res), 0.0f), x_hi);
    const int yi = (int)fminf(fmaxf(floorf((y - ylim0) * inv_res), 0.0f), y_hi);
    const int cell = yi * W + xi;

    const int32_t code = plane[cell >> kWordShift]
                         >> ((cell & (kCellsPerWord - 1)) * (2 * CELL_BITS));
    const int32_t lin_f = code & kLow;
    const int32_t ang_f = (code >> CELL_BITS) & kLow;
    float lin_tr, ang_tr;
    if (CELL_BITS == 8) {
      lin_tr = lin_lb + lin_ratio * (float)lin_f;
      ang_tr = ang_lb + ang_ratio * (float)ang_f;
    } else {
      lin_tr = s_lut[lin_f];
      ang_tr = s_lut[kLutBins + ang_f];
    }
    const int32_t mcode = mask[cell >> 4] >> ((cell & 15) << 1);
    const float obs = (float)(mcode & 1);
    const float unk = (float)((mcode >> 1) & 1);

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
    } else if (MODEL == kBicycle) {
      // dt * (lin_tr * v), not the unicycle's (dt * lin_tr) * v.
      const float v_eff = lin_tr * v;
      x_new = x + dt * v_eff * cosf(th);
      y_new = y + dt * v_eff * sinf(th);
      th = th + dt * ang_tr * v * tanf(w) / wheelbase;
    } else {
      x_new = x + dt * lin_tr * v * cosf(th);
      y_new = y + dt * lin_tr * v * sinf(th);
      th = th + dt * ang_tr * w;
    }

    const float dx = gx - x_new, dy = gy - y_new;
    const float dist2_new = dx * dx + dy * dy;
    float dt_eff = dt;
    if (SPEED_MAP) {
      const int32_t rbyte = (risk[cell >> 2] >> ((cell & 3) << 3)) & 0xFF;
      const float eff = lin_lb + lin_ratio * (float)rbyte;
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

// The arguments every instantiation takes, bundled for the dispatch.
struct Args {
  const int32_t* cells;
  const int32_t* mask;
  const float* lut;
  const int32_t* risk;
  const float* task;
  const float* v;
  const float* w;
  float* out;
  int K, M, H, W, T, n_words;
  float wheelbase;
  cudaStream_t stream;
};

template <int CELL_BITS, bool FAST_TRIG, bool SPEED_MAP, int MODEL>
void launch(const Args& a) {
  const dim3 grid((a.K + kBlockK - 1) / kBlockK, a.M);
  rollout_binned_kernel<CELL_BITS, FAST_TRIG, SPEED_MAP, MODEL>
      <<<grid, kBlockK, 0, a.stream>>>(a.cells, a.mask, a.lut, a.risk, a.task,
                                       a.v, a.w, a.out, a.K, a.M, a.H, a.W,
                                       a.T, a.n_words, a.wheelbase);
}

// The (fast_trig, model) pairs that exist: fast trig is the unicycle's
// only.  Returns false for any other pair.
template <int CELL_BITS, bool SPEED_MAP>
bool launch_model(const Args& a, int fast_trig, int model) {
  if (fast_trig && model == kUnicycle)
    launch<CELL_BITS, true, SPEED_MAP, kUnicycle>(a);
  else if (!fast_trig && model == kUnicycle)
    launch<CELL_BITS, false, SPEED_MAP, kUnicycle>(a);
  else if (!fast_trig && model == kBicycle)
    launch<CELL_BITS, false, SPEED_MAP, kBicycle>(a);
  else
    return false;
  return true;
}

template <int CELL_BITS>
bool launch_bits(const Args& a, int speed_map, int fast_trig, int model) {
  return speed_map ? launch_model<CELL_BITS, true>(a, fast_trig, model)
                   : launch_model<CELL_BITS, false>(a, fast_trig, model);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers:
// cells int32 (M, n_words), mask int32 (ceil(H*W/16),), lut float32
// (2, 16) (unused, may be null, for cell_bits 8), risk int32
// (ceil(H*W/4),) (read only when speed_map), task float32 (>= 18),
// v / w float32 (T, K), out float32 (K, M).  model: 0 unicycle, 1 bicycle
// (wheelbase read only then).  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() so the caller sees a refused launch; an
// unknown cell_bits or model, or fast trig with a model other than the
// unicycle, returns cudaErrorInvalidValue.
extern "C" int rollout_binned_launch(const void* cells, const void* mask,
                                     const void* lut, const void* risk,
                                     const void* task, const void* v,
                                     const void* w, void* out, int K, int M,
                                     int H, int W, int T, int n_words,
                                     int cell_bits, int speed_map,
                                     int fast_trig, int model,
                                     float wheelbase, void* stream) {
  const Args a{static_cast<const int32_t*>(cells),
               static_cast<const int32_t*>(mask),
               static_cast<const float*>(lut),
               static_cast<const int32_t*>(risk),
               static_cast<const float*>(task),
               static_cast<const float*>(v),
               static_cast<const float*>(w),
               static_cast<float*>(out),
               K, M, H, W, T, n_words, wheelbase,
               static_cast<cudaStream_t>(stream)};
  bool ok;
  switch (cell_bits) {
    case 2: ok = launch_bits<2>(a, speed_map, fast_trig, model); break;
    case 4: ok = launch_bits<4>(a, speed_map, fast_trig, model); break;
    case 8: ok = launch_bits<8>(a, speed_map, fast_trig, model); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
