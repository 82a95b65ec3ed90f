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
// Scenario axis: blockIdx.z is the scenario b; cells (B, M, n_words), mask
// (B, ceil(H*W/16)), risk (B, ceil(H*W/4)), lut (B, 2, 16), task
// (B, task_stride), v / w (B, T, K), out (B, K, M) (rollout_step.cuh).
//
// Design: the byte kernel's (csrc/rollout_step.cuh holds the step loop
// and its tiling).  For 2- and 4-bit cells each block expands the 2 x 16
// LUT into a shared table of (lin, ang) pairs indexed by a cell's whole
// code, so a cell decodes with one 8-byte shared load; a nibble cell's
// code is a byte of its word, taken by one PRMT.  Hopper
// indexes the planes directly: none of the TPU kernel's chunk walks,
// occupancy bands, HBM streaming windows, m_tile, t_unroll, lane padding
// or (8, 128) task tile exists here.
//
// What bounds it: instruction issue, as the byte kernel; the planes are
// 2-8x smaller than the byte layout's words, and the bytes are small
// beside the operations.

#include "rollout_step.cuh"

namespace {

using namespace rollout;

constexpr int kLutBins = 16;   // LUT entries per row (ops: LUT_BINS)

// Decodes the planes of the thread's map samples.
template <int CELL_BITS, int S, bool SPEED_MAP>
struct BinnedDecoder {
  static constexpr int kWordShift =
      CELL_BITS == 2 ? 3 : (CELL_BITS == 4 ? 2 : 1);

  const int32_t* __restrict__ plane[S];
  const int32_t* __restrict__ mask;
  const int32_t* __restrict__ risk;
  const float2* pairs;           // shared memory, kPairs (2- and 4-bit)
  float lin_lb, lin_ratio, ang_lb, ang_ratio;

  __device__ Cell operator()(int s, uint32_t cell) const {
    const int32_t word = plane[s][cell >> kWordShift];
    Cell c;
    if (CELL_BITS == 8) {
      const uint32_t code = (uint32_t)(word >> ((cell & 1u) << 4));
      c.lin_tr = decode_byte(code, 0x7650u, lin_lb, lin_ratio);
      c.ang_tr = decode_byte(code, 0x7651u, ang_lb, ang_ratio);
    } else {
      // The cell's code lin | ang << CELL_BITS: byte (cell & 3) of a
      // nibble word, bits 4 * (cell & 7) of a crumb word.
      const uint32_t code =
          CELL_BITS == 4
              ? __byte_perm((uint32_t)word, 0u, 0x4440u | (cell & 3u))
              : ((uint32_t)word >> ((cell & 7u) << 2)) & 0xFu;
      const float2 pair = pairs[code];
      c.lin_tr = pair.x;
      c.ang_tr = pair.y;
    }
    const uint32_t mcode = (uint32_t)mask[cell >> 4] >> ((cell & 15u) << 1);
    c.obs = mcode & 1u;
    c.unk = mcode & 2u;
    // Byte (cell & 3) of the risk word.
    c.risk = SPEED_MAP ? __byte_perm((uint32_t)risk[cell >> 2], 0u,
                                     0x4440u | (cell & 3u))
                       : 0u;
    return c;
  }
};

template <int CELL_BITS, bool FAST_TRIG, bool SPEED_MAP, int MODEL>
__global__ void __launch_bounds__(Tiling<MODEL>::kBlock,
                                      Tiling<MODEL>::kMinBlocks)
rollout_binned_kernel(const int32_t* __restrict__ cells,
                      const int32_t* __restrict__ mask,
                      const float* __restrict__ lut,
                      const int32_t* __restrict__ risk,
                      const float* __restrict__ task,
                      const float* __restrict__ v_all,
                      const float* __restrict__ w_all,
                      float* __restrict__ cost_out,
                      int K, int M, int H, int W, int T, int n_words,
                      int task_stride, float wheelbase) {
  constexpr int S = Tiling<MODEL>::kSamples;
  // (lut[0][code & low], lut[1][(code >> CELL_BITS) & low]) for every
  // code of a 2- or 4-bit cell.
  constexpr int kPairs = CELL_BITS != 8 ? 1 << (2 * CELL_BITS) : 1;
  constexpr int kLow = (1 << CELL_BITS) - 1;
  __shared__ float2 s_pairs[kPairs];
  __shared__ float s_step[SPEED_MAP ? kStepTable : 1];
  const int b = blockIdx.z;                       // the scenario
  const Task tk(task + (size_t)b * task_stride);
  if (CELL_BITS != 8) {
    const float* lut_b = lut + b * 2 * kLutBins;
    for (int code = threadIdx.x; code < kPairs; code += blockDim.x)
      s_pairs[code] = make_float2(
          lut_b[code & kLow], lut_b[kLutBins + ((code >> CELL_BITS) & kLow)]);
  }
  if (SPEED_MAP) fill_step_table(s_step, tk);
  if (CELL_BITS != 8 || SPEED_MAP) __syncthreads();
  const int k = blockIdx.x * Tiling<MODEL>::kBlock + threadIdx.x;
  if (k >= K) return;
  const int m0 = blockIdx.y * S;

  BinnedDecoder<CELL_BITS, S, SPEED_MAP> dec;
#pragma unroll
  for (int s = 0; s < S; ++s)
    dec.plane[s] =
        opaque(cells + ((size_t)b * M + min(m0 + s, M - 1)) * n_words);
  const size_t hw = (size_t)H * W;
  dec.mask = opaque(mask + (size_t)b * ((hw + 15) / 16));
  dec.risk = SPEED_MAP ? opaque(risk + (size_t)b * ((hw + 3) / 4)) : risk;
  dec.pairs = s_pairs;
  dec.lin_lb = tk.lin_lb;
  dec.lin_ratio = tk.lin_ratio;
  dec.ang_lb = tk.ang_lb;
  dec.ang_ratio = tk.ang_ratio;
  const size_t tk_off = (size_t)b * T * K;
  rollout_loop<S, FAST_TRIG, SPEED_MAP, MODEL>(
      dec, tk, v_all + tk_off, w_all + tk_off, s_step, cost_out, b, k, K, m0,
      M, H, W, T, wheelbase);
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
  int K, M, H, W, T, n_words, B, task_stride;
  float wheelbase;
  cudaStream_t stream;
};

template <int CELL_BITS, bool FAST_TRIG, bool SPEED_MAP, int MODEL>
struct Launch {
  static int run(const Args& a) {
    constexpr auto kernel =
        rollout_binned_kernel<CELL_BITS, FAST_TRIG, SPEED_MAP, MODEL>;
    const int err = cached_check<kernel>();
    if (err != 0) return err;
    using Tl = Tiling<MODEL>;
    if (a.B < 1 || a.B > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((a.K + Tl::kBlock - 1) / Tl::kBlock,
                    (a.M + Tl::kSamples - 1) / Tl::kSamples, a.B);
    kernel<<<grid, Tl::kBlock, 0, a.stream>>>(
        a.cells, a.mask, a.lut, a.risk, a.task, a.v, a.w, a.out, a.K, a.M,
        a.H, a.W, a.T, a.n_words, a.task_stride, a.wheelbase);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int CELL_BITS, bool FAST_TRIG, bool SPEED_MAP, int MODEL>
struct Info {
  static int run(int* out) {
    return tiling_info<MODEL, rollout_binned_kernel<CELL_BITS, FAST_TRIG,
                                                    SPEED_MAP, MODEL>>(out);
  }
};

// Calls F<cell_bits, fast_trig, speed_map, model>::run(arg) for the
// combinations that exist: cell_bits 2, 4 or 8, and fast trig the
// unicycle's only.  Any other returns cudaErrorInvalidValue.
template <template <int, bool, bool, int> class F, int CB, class A>
int dispatch_model(int speed_map, int fast_trig, int model, A arg) {
  if (fast_trig && model == kUnicycle)
    return speed_map ? F<CB, true, true, kUnicycle>::run(arg)
                     : F<CB, true, false, kUnicycle>::run(arg);
  if (!fast_trig && model == kUnicycle)
    return speed_map ? F<CB, false, true, kUnicycle>::run(arg)
                     : F<CB, false, false, kUnicycle>::run(arg);
  if (!fast_trig && model == kBicycle)
    return speed_map ? F<CB, false, true, kBicycle>::run(arg)
                     : F<CB, false, false, kBicycle>::run(arg);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <template <int, bool, bool, int> class F, class A>
int dispatch(int cell_bits, int speed_map, int fast_trig, int model, A arg) {
  switch (cell_bits) {
    case 2: return dispatch_model<F, 2>(speed_map, fast_trig, model, arg);
    case 4: return dispatch_model<F, 4>(speed_map, fast_trig, model, arg);
    case 8: return dispatch_model<F, 8>(speed_map, fast_trig, model, arg);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers
// of B scenarios: cells int32 (B, M, n_words), mask int32
// (B, ceil(H*W/16)), lut float32 (B, 2, 16) (unused, may be null, for
// cell_bits 8), risk int32 (B, ceil(H*W/4)) (read only when speed_map),
// task float32 (B, task_stride) (task_stride >= 18), v / w float32
// (B, T, K), out float32 (B, K, M).  model: 0 unicycle, 1 bicycle
// (wheelbase read only then).  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() so the caller sees a refused launch; an
// unknown cell_bits or model, fast trig with a model other than the
// unicycle, or an instantiation whose shared memory exceeds 48 KB returns
// cudaErrorInvalidValue.
extern "C" int rollout_binned_launch(const void* cells, const void* mask,
                                     const void* lut, const void* risk,
                                     const void* task, const void* v,
                                     const void* w, void* out, int K, int M,
                                     int H, int W, int T, int n_words,
                                     int B, int task_stride, int cell_bits,
                                     int speed_map, int fast_trig, int model,
                                     float wheelbase, void* stream) {
  const Args a{static_cast<const int32_t*>(cells),
               static_cast<const int32_t*>(mask),
               static_cast<const float*>(lut),
               static_cast<const int32_t*>(risk),
               static_cast<const float*>(task),
               static_cast<const float*>(v),
               static_cast<const float*>(w),
               static_cast<float*>(out),
               K, M, H, W, T, n_words, B, task_stride, wheelbase,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Launch>(cell_bits, speed_map, fast_trig, model, a);
}

// The tiling and resources of the instantiation a launch with these
// arguments runs, into info[0..4]: block width, map samples per thread,
// static shared bytes, registers, local bytes per thread.  Returns as
// rollout_binned_launch would for the shared-memory check.
extern "C" int rollout_binned_info(int cell_bits, int speed_map,
                                   int fast_trig, int model, int* info) {
  return dispatch<Info>(cell_bits, speed_map, fast_trig, model, info);
}
