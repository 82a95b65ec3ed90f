// The reachable-window (ROI) crop, for Hopper (sm_90a): the window's start
// around the robot, the shifted map limits and the window of every map
// plane, in one launch.
//
// Replaces the JAX package's XLA-fused crop (no Pallas kernel):
// mppi_numba_tpu/solver.py::_roi_start (:127), _crop_maps (:144) and
// _shift_task_limits (:158).  From the task's x0, xlim0, ylim0 and res
// (device scalars, read here, never on the host):
//
//   cx, cy   = floor((x0 - lim0) / res)                (float32, IEEE /)
//   oy       = clamp(clamp(cy, 0, H - 1) - rH / 2, 0, H - rH)    (ox alike)
//   offset   = (oy, ox)                                       int32 (2,)
//   lims     = (xlim0 + ox * res, ylim0 + oy * res)          float32 (2,)
//   out[p]   = plane[p][oy : oy + rH, ox : ox + rW]   for every int8 plane
//
// The planes are the lin and ang PMFs (B, H, W) and the obstacle, unknown
// and risk grids (H, W).  The semantics are the plain version's
// (ops/kernels/roi_window.py::crop_window_plain), bit for bit: every float
// operation is an explicit round-to-nearest intrinsic, as torch rounds
// each of its elementwise passes.
//
// Design.  One thread per cell of the window; each thread computes the
// offsets itself (a handful of operations on four broadcast loads) and
// copies its cell of every plane, so neighbouring threads read and write
// neighbouring bytes.  Thread 0 writes the offsets and the limits.  What
// bounds it: bytes, each window byte read and written once, a few hundred
// KB at the planner's sizes: a launch costs its latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void copy_planes(const int8_t* __restrict__ src,
                                            int8_t* __restrict__ dst, int B,
                                            int src_off, int cell,
                                            size_t HW, size_t n) {
  for (int b = 0; b < B; ++b) dst[b * n + cell] = src[b * HW + src_off];
}

__global__ void __launch_bounds__(kBlock)
roi_window_kernel(const float* __restrict__ x0,
                  const float* __restrict__ xlim0,
                  const float* __restrict__ ylim0,
                  const float* __restrict__ res,
                  const int8_t* __restrict__ lin_pmf,
                  const int8_t* __restrict__ ang_pmf,
                  const int8_t* __restrict__ obstacle,
                  const int8_t* __restrict__ unknown,
                  const int8_t* __restrict__ risk,
                  int8_t* __restrict__ lin_out, int8_t* __restrict__ ang_out,
                  int8_t* __restrict__ obstacle_out,
                  int8_t* __restrict__ unknown_out,
                  int8_t* __restrict__ risk_out, int32_t* __restrict__ offset,
                  float* __restrict__ lims, int H, int W, int rH, int rW,
                  int B_lin, int B_ang) {
  const float r = *res;
  const int cx = static_cast<int>(floorf(__fdiv_rn(__fsub_rn(x0[0], *xlim0), r)));
  const int cy = static_cast<int>(floorf(__fdiv_rn(__fsub_rn(x0[1], *ylim0), r)));
  const int oy = clampi(clampi(cy, 0, H - 1) - rH / 2, 0, H - rH);
  const int ox = clampi(clampi(cx, 0, W - 1) - rW / 2, 0, W - rW);
  const int n_cells = rH * rW;
  const int cell = blockIdx.x * kBlock + threadIdx.x;
  if (cell == 0) {
    offset[0] = oy;
    offset[1] = ox;
    lims[0] = __fadd_rn(*xlim0, __fmul_rn(static_cast<float>(ox), r));
    lims[1] = __fadd_rn(*ylim0, __fmul_rn(static_cast<float>(oy), r));
  }
  if (cell >= n_cells) return;
  const int dy = cell / rW;
  const int src = (oy + dy) * W + ox + (cell - dy * rW);
  const size_t HW = static_cast<size_t>(H) * W;
  const size_t n = static_cast<size_t>(n_cells);
  copy_planes(lin_pmf, lin_out, B_lin, src, cell, HW, n);
  copy_planes(ang_pmf, ang_out, B_ang, src, cell, HW, n);
  obstacle_out[cell] = obstacle[src];
  unknown_out[cell] = unknown[src];
  risk_out[cell] = risk[src];
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers:
// x0 float32 (3,); xlim0 / ylim0 / res float32 scalars; lin_pmf / ang_pmf
// int8 (B, H, W); obstacle / unknown / risk int8 (H, W); outputs: the
// windows, int8 (B, rH, rW) and (rH, rW), offset int32 (2,) = (oy, ox),
// lims float32 (2,) = the shifted (xlim0, ylim0).  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() so the caller sees
// a refused launch.
extern "C" int roi_window_launch(const void* x0, const void* xlim0,
                                 const void* ylim0, const void* res,
                                 const void* lin_pmf, const void* ang_pmf,
                                 const void* obstacle, const void* unknown,
                                 const void* risk, void* lin_out,
                                 void* ang_out, void* obstacle_out,
                                 void* unknown_out, void* risk_out,
                                 void* offset, void* lims, int H, int W,
                                 int rH, int rW, int B_lin, int B_ang,
                                 void* stream) {
  const int grid = (rH * rW + kBlock - 1) / kBlock;
  roi_window_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(xlim0),
      static_cast<const float*>(ylim0), static_cast<const float*>(res),
      static_cast<const int8_t*>(lin_pmf), static_cast<const int8_t*>(ang_pmf),
      static_cast<const int8_t*>(obstacle), static_cast<const int8_t*>(unknown),
      static_cast<const int8_t*>(risk), static_cast<int8_t*>(lin_out),
      static_cast<int8_t*>(ang_out), static_cast<int8_t*>(obstacle_out),
      static_cast<int8_t*>(unknown_out), static_cast<int8_t*>(risk_out),
      static_cast<int32_t*>(offset), static_cast<float*>(lims), H, W, rH, rW,
      B_lin, B_ang);
  return static_cast<int>(cudaGetLastError());
}
