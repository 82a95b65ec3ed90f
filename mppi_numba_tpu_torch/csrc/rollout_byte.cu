// Fused rollout over a byte-packed traction map, for Hopper (sm_90a).
//
// Replaces: mppi_numba_tpu/ops/pallas/rollout_kernel.py::_rollout_kernel
// (wrapper terrain_rollout_costs_pallas).  Computes the float32 (K, M)
// rollout cost of every (control sequence k, map sample m) pair, terminal
// cost included, coupling excluded -- the semantics of
// mppi_numba_tpu_torch/ops/rollout.py::terrain_rollout_costs, in the float
// masking form of the TPU kernel.
//
// Design.  A thread walks one control sequence k (threadIdx.x /
// blockIdx.x) over Tiling<MODEL>::kSamples map samples (blockIdx.y), the
// T-step loop in registers (csrc/rollout_step.cuh).  A warp's 32 lanes
// share their map samples, so each step's loads fall in those samples'
// H*W words (484 B at the 11x11 flagship, L1-resident), and the controls
// v[t, k], w[t, k] load coalesced, one step ahead.  None of the TPU
// kernel's lane padding of K, chunk transpose, (8, 128) task tile, m_tile
// or t_unroll exists here: the ragged edges of K and M are masked.
//
// Scenario axis: blockIdx.z is the scenario b; words (B, M, H, W), task
// (B, task_stride), v / w (B, T, K), out (B, K, M), and the optional
// skip mask (B,) (rollout_step.cuh).
//
// Decode: one int32 word per cell, lin | ang << 8 | obs << 16 | unk << 17
// | risk << 18 (ops/packing.py::pack_map_words; bytes sign-extended when
// packed, fields selected as the TPU kernel does).
//
// Dynamics (MODEL): the unicycle, or the kinematic bicycle of
// models/bicycle.py; fast trig (a rotation polynomial) is the unicycle's
// only.  What bounds it, and what the step does about it: see
// csrc/rollout_step.cuh.

#include "rollout_step.cuh"

namespace {

using namespace rollout;

// Decodes the words of the thread's map samples.
template <int S, bool SPEED_MAP>
struct ByteDecoder {
  const int32_t* __restrict__ map[S];
  float lin_lb, lin_ratio, ang_lb, ang_ratio;

  __device__ Cell operator()(int s, uint32_t cell) const {
    const uint32_t word = (uint32_t)map[s][cell];
    Cell c;
    c.lin_tr = decode_byte(word, 0x7650u, lin_lb, lin_ratio);
    c.ang_tr = decode_byte(word, 0x7651u, ang_lb, ang_ratio);
    c.obs = word & (1u << 16);
    c.unk = word & (1u << 17);
    c.risk = SPEED_MAP ? (word >> 18) & 0xFFu : 0u;
    return c;
  }
};

template <bool FAST_TRIG, bool SPEED_MAP, int MODEL>
__global__ void __launch_bounds__(Tiling<MODEL>::kBlock,
                                      Tiling<MODEL>::kMinBlocks)
rollout_byte_kernel(const int32_t* __restrict__ words,
                    const float* __restrict__ task,
                    const float* __restrict__ v_all,
                    const float* __restrict__ w_all,
                    float* __restrict__ cost_out,
                    const uint8_t* __restrict__ skip,
                    int K, int M, int H, int W, int T, int task_stride,
                    float wheelbase) {
  constexpr int S = Tiling<MODEL>::kSamples;
  __shared__ float s_step[SPEED_MAP ? kStepTable : 1];
  const int b = blockIdx.z;                       // the scenario
  if (skip_scenario(skip, cost_out, b, K, M)) return;
  const Task tk(task + (size_t)b * task_stride);
  if (SPEED_MAP) {
    fill_step_table(s_step, tk);
    __syncthreads();
  }
  const int k = blockIdx.x * Tiling<MODEL>::kBlock + threadIdx.x;
  if (k >= K) return;
  const int m0 = blockIdx.y * S;

  ByteDecoder<S, SPEED_MAP> dec;
#pragma unroll
  for (int s = 0; s < S; ++s)
    dec.map[s] = opaque(words + ((size_t)b * M + min(m0 + s, M - 1)) * H * W);
  dec.lin_lb = tk.lin_lb;
  dec.lin_ratio = tk.lin_ratio;
  dec.ang_lb = tk.ang_lb;
  dec.ang_ratio = tk.ang_ratio;
  const size_t tk_off = (size_t)b * T * K;
  rollout_loop<S, FAST_TRIG, SPEED_MAP, MODEL>(
      dec, tk, v_all + tk_off, w_all + tk_off, s_step, cost_out, b, k, K, m0,
      M, H, W, T, wheelbase);
}

// Calls F<fast_trig, speed_map, model>::run(args...) for the pairs that
// exist: fast trig is the unicycle's only.  Any other pair returns
// cudaErrorInvalidValue.
template <template <bool, bool, int> class F, class... Args>
int dispatch(int speed_map, int fast_trig, int model, Args... args) {
  if (fast_trig && model == kUnicycle)
    return speed_map ? F<true, true, kUnicycle>::run(args...)
                     : F<true, false, kUnicycle>::run(args...);
  if (!fast_trig && model == kUnicycle)
    return speed_map ? F<false, true, kUnicycle>::run(args...)
                     : F<false, false, kUnicycle>::run(args...);
  if (!fast_trig && model == kBicycle)
    return speed_map ? F<false, true, kBicycle>::run(args...)
                     : F<false, false, kBicycle>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool FAST_TRIG, bool SPEED_MAP, int MODEL>
struct Launch {
  static int run(const int32_t* words, const float* task, const float* v,
                 const float* w, float* out, const uint8_t* skip, int K,
                 int M, int H, int W, int T, int B, int task_stride,
                 float wheelbase, cudaStream_t stream) {
    constexpr auto kernel = rollout_byte_kernel<FAST_TRIG, SPEED_MAP, MODEL>;
    const int err = cached_check<kernel>();
    if (err != 0) return err;
    using Tl = Tiling<MODEL>;
    if (B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((K + Tl::kBlock - 1) / Tl::kBlock,
                    (M + Tl::kSamples - 1) / Tl::kSamples, B);
    kernel<<<grid, Tl::kBlock, 0, stream>>>(words, task, v, w, out, skip, K,
                                            M, H, W, T, task_stride,
                                            wheelbase);
    return static_cast<int>(cudaGetLastError());
  }
};

template <bool FAST_TRIG, bool SPEED_MAP, int MODEL>
struct Info {
  static int run(int* out) {
    return tiling_info<MODEL,
                       rollout_byte_kernel<FAST_TRIG, SPEED_MAP, MODEL>>(out);
  }
};

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers
// of B scenarios: words int32 (B, M, H, W), task float32 (B, task_stride)
// (task_stride >= 18), v / w float32 (B, T, K), out float32 (B, K, M),
// skip bytes (B,) or null: a scenario whose byte is non-zero gets zero
// costs and no rollout.  model: 0 unicycle, 1 bicycle (wheelbase read only
// then).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so the caller sees a refused launch; fast trig with a
// model other than the unicycle, an unknown model, B outside 1..65535, or
// an instantiation whose shared memory exceeds 48 KB returns
// cudaErrorInvalidValue.
extern "C" int rollout_byte_launch(const void* words, const void* task,
                                   const void* v, const void* w, void* out,
                                   const void* skip, int K, int M, int H,
                                   int W, int T, int B, int task_stride,
                                   int speed_map, int fast_trig, int model,
                                   float wheelbase, void* stream) {
  return dispatch<Launch>(
      speed_map, fast_trig, model, static_cast<const int32_t*>(words),
      static_cast<const float*>(task), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<const uint8_t*>(skip), K, M, H, W, T, B, task_stride,
      wheelbase, static_cast<cudaStream_t>(stream));
}

// The tiling and resources of the instantiation a launch with these
// arguments runs, into info[0..4]: block width, map samples per thread,
// static shared bytes, registers, local bytes per thread.  Returns as
// rollout_byte_launch would for the shared-memory check.
extern "C" int rollout_byte_info(int speed_map, int fast_trig, int model,
                                 int* info) {
  return dispatch<Info>(speed_map, fast_trig, model, info);
}
