// Traction-map sampling, for Hopper (sm_90a): counter-addressed uniforms,
// the rank against the cumulative PMF and the decode, in one pass.
//
// Replaces the JAX package's XLA-fused map draw (no Pallas kernel):
// mppi_numba_tpu/ops/sampling.py::uniform_window (:156) feeding
// sample_traction_bins (:219) and decode_bins (:246), for the lin and the
// ang PMF of one solve.  For every (m, cell) of an (M, rH, rW) window of an
// (H, W) map:
//
//   counter  = (m_offset + m) * H * W + (oy + dy) * W + (ox + dx)
//   (b1, b2) = threefry2x32(key, (0, counter))       (jax._src.prng)
//   u        = float((b1 ^ b2) >> 9 | 0x3F800000) - 1       in [0, 1)
//   sampled  = (int) ceilf(u * (100 * alpha_dyn))
//   rank     = sum_b (cum[b, cell] < sampled)     cum: the PMF's int32 cumsum
//   grid     = rank < B ? qbins[rank] : -128
//
// lin and ang take their ranks from the same uniform (the reference seeds
// both TDM streams alike, so their draws are comonotone).  Out: int32 bins
// and int8 grids, (M, rH, rW) each.  The semantics are the plain version's
// (ops/kernels/map_sample.py::sample_traction_window_plain), bit for bit:
// the uniform is integer work plus one exact float subtraction, and
// u * s and ceilf round as torch does (-fmad=false; s = 100 * alpha_dyn is
// rounded once to float32, as the plain version rounds it).
//
// Design.  One thread per cell of the window (blockIdx.x, threadIdx.x), a
// loop over map samples m strided by gridDim.y.  The thread's counter base
// and its cell's PMF column offsets are computed once; each m adds
// (m_offset + m) * H * W.  The cumulative is summed in registers from the
// int8 PMF, B bytes a plane, which the block's threads read as neighbouring
// bytes: the window's PMF planes (a few MB at most) stay in L1 and L2.
//
// What bounds it: integer operations.  Per element the hash is 20 rounds
// of add, rotate (one funnel shift) and xor plus 5 key injections; the
// ranks are an add, a compare and an add per bin and plane.  The bytes are
// 10 written per element and the PMF planes read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// Blocks along y (map samples) are capped so that a launch is a few waves
// of the card's 132 SMs; each thread walks the rest of M.
constexpr int kTargetBlocks = 132 * 16;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// threefry2x32 on the counter pair (0, counter): the bits b1 ^ b2.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t counter) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;                 // 0 + k0
  uint32_t x1 = counter + k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__device__ __forceinline__ int rank(const int8_t* __restrict__ pmf, int B,
                                    int stride, int sampled) {
  int cum = 0, r = 0;
  for (int b = 0; b < B; ++b) {
    cum += pmf[b * stride];
    r += cum < sampled;
  }
  return r;
}

__global__ void __launch_bounds__(kBlock)
map_sample_kernel(const int64_t* __restrict__ key,
                  const int32_t* __restrict__ oy_ptr,
                  const int32_t* __restrict__ ox_ptr,
                  const float* __restrict__ alpha_dyn,
                  const int8_t* __restrict__ lin_pmf,
                  const int8_t* __restrict__ ang_pmf,
                  const int8_t* __restrict__ lin_q,
                  const int8_t* __restrict__ ang_q,
                  int32_t* __restrict__ lin_bins, int32_t* __restrict__ ang_bins,
                  int8_t* __restrict__ lin_grid, int8_t* __restrict__ ang_grid,
                  int M, int rH, int rW, int B_lin, int B_ang, int W,
                  uint32_t HW, uint32_t m_offset) {
  const int n_cells = rH * rW;
  const int cell = blockIdx.x * kBlock + threadIdx.x;
  if (cell >= n_cells) return;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const uint32_t oy = oy_ptr ? static_cast<uint32_t>(*oy_ptr) : 0u;
  const uint32_t ox = ox_ptr ? static_cast<uint32_t>(*ox_ptr) : 0u;
  const float s = 100.0f * *alpha_dyn;
  const int dy = cell / rW;
  const int dx = cell - dy * rW;
  const uint32_t base = (oy + dy) * static_cast<uint32_t>(W) + (ox + dx);
  const int8_t* lp = lin_pmf + cell;
  const int8_t* ap = ang_pmf + cell;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const uint32_t bits =
        threefry_bits(k0, k1, (m_offset + m) * HW + base);
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const int sampled = static_cast<int>(ceilf(u * s));
    const int rl = rank(lp, B_lin, n_cells, sampled);
    const size_t e = static_cast<size_t>(m) * n_cells + cell;
    lin_bins[e] = rl;
    lin_grid[e] = rl < B_lin ? lin_q[rl] : static_cast<int8_t>(-128);
    if (ang_bins) {
      const int ra = rank(ap, B_ang, n_cells, sampled);
      ang_bins[e] = ra;
      ang_grid[e] = ra < B_ang ? ang_q[ra] : static_cast<int8_t>(-128);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers:
// key int64 (2,) of uint32 words; oy / ox int32 scalars, or null for 0;
// alpha_dyn float32 scalar; lin_pmf / ang_pmf int8 (B, rH, rW) windows;
// lin_q / ang_q int8 (B,); outputs (M, rH, rW): bins int32, grids int8.
// With no ang plane (ang_pmf, ang_q, ang_bins and ang_grid null, B_ang 0)
// only the lin plane is ranked and written.
// H * W is the full map's cell count and W its width (the counter's
// strides).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int map_sample_launch(const void* key, const void* oy,
                                 const void* ox, const void* alpha_dyn,
                                 const void* lin_pmf, const void* ang_pmf,
                                 const void* lin_q, const void* ang_q,
                                 void* lin_bins, void* ang_bins,
                                 void* lin_grid, void* ang_grid, int M,
                                 int rH, int rW, int B_lin, int B_ang, int H,
                                 int W, int m_offset, void* stream) {
  const int n_cells = rH * rW;
  const int gx = (n_cells + kBlock - 1) / kBlock;
  int gy = (kTargetBlocks + gx - 1) / gx;
  if (gy > M) gy = M;
  if (gy > 65535) gy = 65535;
  const dim3 grid(gx, gy);
  map_sample_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<const int32_t*>(oy),
      static_cast<const int32_t*>(ox), static_cast<const float*>(alpha_dyn),
      static_cast<const int8_t*>(lin_pmf), static_cast<const int8_t*>(ang_pmf),
      static_cast<const int8_t*>(lin_q), static_cast<const int8_t*>(ang_q),
      static_cast<int32_t*>(lin_bins), static_cast<int32_t*>(ang_bins),
      static_cast<int8_t*>(lin_grid), static_cast<int8_t*>(ang_grid), M, rH,
      rW, B_lin, B_ang, W,
      static_cast<uint32_t>(H) * static_cast<uint32_t>(W),
      static_cast<uint32_t>(m_offset));
  return static_cast<int>(cudaGetLastError());
}
