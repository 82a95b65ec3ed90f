// Traction-map sampling, for Hopper (sm_90a): counter-addressed uniforms,
// the lin and ang ranks, the decode and the rollout's packed payload, in
// one pass.
//
// Replaces the JAX package's XLA-fused map draw and the pack that follows
// it in the jitted solve (no Pallas kernel):
// mppi_numba_tpu/ops/sampling.py::uniform_window (:156) feeding
// sample_traction_bins (:219) and decode_bins (:246), then
// mppi_numba_tpu/solver.py:200-215 (ops/packing.py).  For every (m, cell)
// of an (M, rH, rW) window of an (H, W) map:
//
//   counter  = (m_offset + m) * H * W + (oy + dy) * W + (ox + dx)
//   (b1, b2) = threefry2x32(key, (0, counter))       (jax._src.prng)
//   u        = float((b1 ^ b2) >> 9 | 0x3F800000) - 1       in [0, 1)
//   sampled  = (int) ceilf(u * (100 * alpha_dyn))
//   rank     = sum_b (cum[b, cell] < sampled)     cum: the PMF's int32 cumsum
//   grid     = rank < B ? qbins[rank] : -128
//
// In crop mode (x0 given) the planes are the whole (H, W) map's and the
// window is the reachable window around the robot, its start worked out
// here from the task's device scalars (ops/roi.py::roi_start, bit for bit:
// a true float32 division, floor, two clamps; IEEE intrinsics, no fast
// math):
//
//   cx, cy   = floor((x0 - lim0) / res)
//   oy       = clamp(clamp(cy, 0, H - 1) - rH / 2, 0, H - rH)    (ox alike)
//
// Every block computes (oy, ox) itself (blocks run in no order; an M = 1
// launch has few of them) and reads each plane at the window's cells in
// the map; block (0, 0)'s thread 0 also writes the int32 offset (oy, ox)
// and the shifted limits (xlim0 + ox * res, ylim0 + oy * res).  That is
// the JAX package's XLA-fused _roi_start + _crop_maps + _shift_task_limits
// (mppi_numba_tpu/solver.py:127,144,158) folded into the draw: no copy of
// the window is written, and the solve makes no launch for the crop.  The
// crop mode is a template parameter: the window mode's instantiations are
// compiled as if it did not exist (the crop's branches and addressing
// would otherwise cost them registers, and so blocks per SM).
//
// lin and ang take their ranks from the same uniform (the reference seeds
// both TDM streams alike, so their draws are comonotone).  The outputs are
// the int8 grids of both planes, (M, rH, rW), and one of (LAYOUT):
//
//   kBins    int32 bins of both planes (M, rH, rW): sample_traction_window
//   kByte    int32 words (M, rH, rW): lin | ang << 8 | obstacle << 16 |
//            unknown << 17 | risk << 18   (packing.py::pack_map_words)
//   kCells2  int32 (M, ceil(n/8)): 8 cells a word of lin | ang << 2 bins
//   kCells4  int32 (M, ceil(n/4)): 4 cells a word of lin | ang << 4 bins
//   kCells8  int32 (M, ceil(n/2)): 2 cells a word of lin | ang << 8 values
//
// and for the three cell layouts the shared words too: obstacle | unknown
// << 1, 16 cells a word, and (with a risk plane) the risk byte, 4 cells a
// word.  Every field is widened to int32 before its shift, as packing.py
// does: a -128 value sign-extends over every bit above it, a rank of 4 or
// 16 spills into the ang field, and a ragged last word of an m row is
// zero-padded.  The semantics are the plain versions'
// (ops/kernels/map_sample.py), bit for bit: the uniform is integer work
// plus one exact float subtraction, and u * s and ceilf round as torch does
// (-fmad=false; s = 100 * alpha_dyn is rounded once to float32, as the
// plain version rounds it).
//
// The scenario axis.  A launch samples the maps of B scenarios (the
// episodes of a batch: the JAX package's solve under jax.vmap), each with
// its own key, alpha_dyn, planes, bin values and, cropping, its own robot
// and limits: blockIdx.z is the scenario b, and every input and output has
// a scenario stride (the key 2 words, a PMF B * its plane, a mask or risk
// plane its cells, the outputs' rows b * M + m, the shared words their
// count).  Each scenario's counters are its own (m * HW + cell under its
// own key), so the 2^32 guard holds per scenario.  A single solve is
// B = 1 of the same launch; that addressing costs the large single launches
// 2-5% on the H100 against the kernel without a scenario axis (PERF.md
// section 6), whether the scenario's key, alpha_dyn and output row
// are held in registers (as here) or read from shared memory.
//
// Design.  `sampled` is an integer in [0, 100] (u < 1, alpha_dyn in (0, 1]),
// so a cell's rank is a function of 101 values.  A block owns a tile of
// kTile = 128 cells and a run of map samples.  It first builds, for each
// cell of its tile and each plane, the inverse-CDF table
// rank[s] = #{b : cum_b < s}, s = 0..100, as bytes in shared memory: one
// thread per (cell, plane) sums the column's cumulative from the int8 PMF
// and counts each cum_b + 1 (clamped below at 0) into a histogram over s,
// then takes its prefix sum.  That counts per s, so it is exact for any
// int8 column: unnormalized, negative entries, ranks of B.  Then every
// element's rank is one shared load and its decode a second, from the
// plane's qbins held in shared memory with the entries from B on set to
// -128.  An element whose `sampled` lies outside [0, 100] (alpha_dyn
// outside its documented range) ranks by the loop over the bins instead.
// The table is stored s-major, [plane][s][cell]: a warp's lookups at
// random s then fall in distinct banks (a row is 128 bytes, 32 banks, and
// each thread owns 4 consecutive cells); 2-way for 8 cells a thread.
//
// A thread owns whole payload words: 4 consecutive cells of one m row (8
// for kCells2), so 4, 2 or 1 words of int32 payload and 4 bytes of each
// grid; it stores them as one 16-, 8- or 4-byte vector where the address is
// aligned (m rows of an odd cell count are not), else one by one.  The
// cell constants stay in registers: the counter bases, and in kByte the
// mask and risk bits.  Two map samples are in flight a thread (8 or 16
// independent hashes).  The shared mask and risk words are written by the
// threads of the y = 0 blocks' first m row, which own those cells.
//
// Amortising the table: building it costs one thread per (cell, plane)
// about B + 101 shared-memory read-modify-writes (~125 at 22 bins); an
// element costs ~80 integer operations, and a block of 128 cells over Ms
// samples spends 128 * Ms * 2 planes of them, 256 threads' worth per
// sample.  The launch therefore caps gridDim.y at M / kMinSamplesPerBlock
// (kMinSamplesPerBlock = 16), so a block walks at least 8 samples where
// M >= 16 (the table then costs at most a few elements a thread per sample
// against 8 elements a thread per sample of sampling); below the cap
// gridDim.y is the number of sample runs that gives about kTargetBlocks
// blocks.  Where M itself is smaller (the det modes' M = 1) the blocks
// still build their tables: ranking those launches by the loop instead
// measured no faster on the H100 (PERF.md section 7), and its registers
// slowed the large launches.
//
// What bounds it: integer operations on the ALU pipe.  Per element the
// hash is 20 rounds of add, rotate (one funnel shift) and xor plus 5 key
// injections; then the uniform's bits, a table lookup and a decode lookup
// per plane (shared-memory loads), and the pack's shift and OR.  The
// rotates, the xors, the uniform's shift and ORs and the pack (~45 an
// element) run only on the ALU pipe (64 lanes an SM a clock); the adds may
// also issue on the FMA pipe.  Bytes: the grids (2 an element) and the
// bins or payload (8, 4, 2, 1 or 1/2 an element by layout) written once,
// the PMF planes read once a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 128;          // cells per block; kBlock == 2 * kTile
constexpr int kLevels = 101;        // sampled = 0..100
constexpr int kLut = 256;           // decode entries a plane: B <= 255
constexpr int kTargetBlocks = 132 * 16;
constexpr int kMinSamplesPerBlock = 16;

enum Layout { kBins = 0, kByte = 1, kCells2 = 2, kCells4 = 3, kCells8 = 4 };

// Every pointer is scenario 0's; scenario b's lies a scenario stride on
// (the shapes below are one scenario's).
struct Params {
  const int64_t* key;           // (2,) uint32 words
  const int32_t* oy;            // window start, or null for 0
  const int32_t* ox;
  // Crop mode: x0 (3,) and the xlim0 / ylim0 / res scalars, null
  // otherwise; then the planes are the (H, W) map's, and offset_out (2,)
  // and lims_out (2,) receive the window's start and shifted limits.
  const float* x0;
  const float* xlim0;
  const float* ylim0;
  const float* res;
  int32_t* offset_out;
  float* lims_out;
  const float* alpha_dyn;
  const int8_t* pmf[2];         // (B, rH, rW) lin, ang (ang null: lin only)
  const int8_t* qbins[2];       // (B,)
  const int8_t* obstacle;       // (rH, rW), the cell layouts and kByte
  const int8_t* unknown;
  const int8_t* risk;           // (rH, rW) or null
  int32_t* bins[2];             // kBins: (M, rH, rW)
  int8_t* grid[2];              // (M, rH, rW)
  int32_t* payload;             // kByte and the cell layouts
  int32_t* mask_words;          // the cell layouts: (ceil(n/16),)
  int32_t* risk_words;          // the cell layouts with a risk plane
  int B[2];
  int M, n_cells, rH, rW, H, W, words_per_row, samples_per_block;
  uint32_t HW, m_offset;
  size_t plane_stride;          // a PMF bin's stride: n_cells, or HW cropping
  // Scenario strides: a PMF's (B * plane_stride), an obstacle, unknown or
  // risk plane's (plane_stride), the shared mask and risk words'.
  size_t pmf_scenario[2];
  int mask_count, risk_count;
};

// Scenario b's plane `pl` of the PMFs.
__device__ __forceinline__ const int8_t* scenario_pmf(const Params& p,
                                                      int pl, int b) {
  return p.pmf[pl] + static_cast<size_t>(b) * p.pmf_scenario[pl];
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The window's start: the reachable window around x0 in crop mode
// (ops/roi.py::roi_start, every float operation round-to-nearest), else
// the given offsets or 0.
template <bool CROP>
__device__ __forceinline__ void window_start(const Params& p, int b, int& oy,
                                             int& ox) {
  if (!CROP) {
    oy = p.oy ? p.oy[b] : 0;
    ox = p.ox ? p.ox[b] : 0;
    return;
  }
  const float r = p.res[b];
  const float* x0 = p.x0 + 3 * b;
  const int cx =
      static_cast<int>(floorf(__fdiv_rn(__fsub_rn(x0[0], p.xlim0[b]), r)));
  const int cy =
      static_cast<int>(floorf(__fdiv_rn(__fsub_rn(x0[1], p.ylim0[b]), r)));
  oy = clampi(clampi(cy, 0, p.H - 1) - p.rH / 2, 0, p.H - p.rH);
  ox = clampi(clampi(cx, 0, p.W - 1) - p.rW / 2, 0, p.W - p.rW);
}

// Where a window cell's planes lie: the cell itself when the planes are
// the window's, its cell in the map when cropping.
template <bool CROP>
__device__ __forceinline__ int source_cell(const Params& p, int cell, int oy,
                                           int ox) {
  if (!CROP) return cell;
  const int dy = cell / p.rW;
  return (oy + dy) * p.W + ox + (cell - dy * p.rW);
}

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

// The rank by the loop over the bins: the cold path for `sampled` outside
// the table's 0..100.  The plane's scenario offset is taken here, so that
// the hot loop does no address arithmetic for a branch it rarely takes.
__device__ __noinline__ int rank_loop(const int8_t* __restrict__ pmf,
                                      size_t scenario_stride, int B,
                                      size_t stride, int src, int sampled) {
  pmf += blockIdx.z * scenario_stride + src;
  int cum = 0, r = 0;
  for (int bin = 0; bin < B; ++bin) {
    cum += pmf[bin * stride];
    r += cum < sampled;
  }
  return r;
}

// An int8 field widened to int32, as packing.py widens it, in uint32 bits.
__device__ __forceinline__ uint32_t widen(int v) {
  return static_cast<uint32_t>(v);
}

// Stores N consecutive 32-bit values at dst: one vector store where dst is
// aligned for it and all N are inside the row, else the first `valid`.
template <int N>
__device__ __forceinline__ void store_words(int32_t* dst, const uint32_t* v,
                                            int valid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (N == 4 && valid == 4 && a % 16 == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if (N == 2 && valid == 2 && a % 8 == 0) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < valid) dst[i] = static_cast<int32_t>(v[i]);
  }
}

// Stores P int8 values at dst: 4-byte stores where aligned and whole.
template <int P>
__device__ __forceinline__ void store_bytes(int8_t* dst, const int* v,
                                            int valid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (valid == P && a % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      *reinterpret_cast<uint32_t*>(dst + i) =
          (v[i] & 0xFFu) | (v[i + 1] & 0xFFu) << 8 |
          (v[i + 2] & 0xFFu) << 16 | static_cast<uint32_t>(v[i + 3]) << 24;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < valid) dst[i] = static_cast<int8_t>(v[i]);
  }
}

// At most 64 registers a thread (4 blocks an SM; 2-bit cells, whose 8
// cells a thread need more, 2 blocks): left to itself ptxas gave the crop
// instantiations and the bins mode 79-128, and with fewer blocks an SM
// they ran slower on the H100 (PERF.md section 6).
template <int LAYOUT, bool CROP>
__global__ void __launch_bounds__(kBlock, LAYOUT == kCells2 ? 2 : 4)
    map_sample_kernel(const Params p) {
  constexpr int P = LAYOUT == kCells2 ? 8 : 4;     // cells a thread
  constexpr int R = kTile / P;                     // threads an m row
  constexpr int RB = kBlock / R;                   // m rows a block
  constexpr bool kCells = LAYOUT >= kCells2;
  __shared__ uint8_t table[2][kLevels][kTile];     // 25,856 bytes
  __shared__ int8_t lut[2][kLut];                  // 512 bytes
 
  const int tid = threadIdx.x;
  const int tile0 = blockIdx.x * kTile;
  const int b = blockIdx.z;                        // the scenario
  const bool has_ang = p.pmf[1] != nullptr;
  int oy, ox;
  window_start<CROP>(p, b, oy, ox);
  if (CROP && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    const float r = p.res[b];
    p.offset_out[2 * b] = oy;
    p.offset_out[2 * b + 1] = ox;
    p.lims_out[2 * b] =
        __fadd_rn(p.xlim0[b], __fmul_rn(static_cast<float>(ox), r));
    p.lims_out[2 * b + 1] =
        __fadd_rn(p.ylim0[b], __fmul_rn(static_cast<float>(oy), r));
  }

  // -- the inverse-CDF tables of this tile, and the decode LUTs ------------
  {
    uint32_t* t32 = reinterpret_cast<uint32_t*>(&table[0][0][0]);
    for (int i = tid; i < 2 * kLevels * kTile / 4; i += kBlock) t32[i] = 0u;
    for (int i = tid; i < 2 * kLut; i += kBlock) {
      const int pl = i / kLut;
      const int bin = i % kLut;
      lut[pl][bin] = (pl == 0 || has_ang) && bin < p.B[pl]
                         ? p.qbins[pl][b * p.B[pl] + bin]
                         : static_cast<int8_t>(-128);
    }
    __syncthreads();
    const int pl = tid / kTile, c = tid % kTile;
    const int cell = tile0 + c;
    if (cell < p.n_cells && (pl == 0 || has_ang)) {
      const int8_t* col =
          scenario_pmf(p, pl, b) + source_cell<CROP>(p, cell, oy, ox);
      int cum = 0;
#pragma unroll 4
      for (int bin = 0; bin < p.B[pl]; ++bin) {
        cum += col[bin * p.plane_stride];
        // cum_b < s  <=>  s >= cum_b + 1: counted from level cum_b + 1 on.
        const int v = cum + 1 > 0 ? cum + 1 : 0;
        if (v < kLevels) table[pl][v][c] += 1;
      }
      uint32_t run = 0;
#pragma unroll
      for (int s = 0; s < kLevels; ++s) {
        run += table[pl][s][c];
        table[pl][s][c] = static_cast<uint8_t>(run);
      }
    }
    __syncthreads();
  }

  const int g = tid % R, row = tid / R;
  const int c0 = g * P;                    // the thread's first tile cell
  const int cell0 = tile0 + c0;
  if (cell0 >= p.n_cells) return;          // no barrier follows
  const int valid = min(P, p.n_cells - cell0);

  const uint32_t k0 = static_cast<uint32_t>(p.key[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(p.key[2 * b + 1]);
  const float s = 100.0f * p.alpha_dyn[b];
  const int row0 = b * p.M;           // B * M < 2^31 (gridDim.z < 2^16)
  // The scenario's obstacle, unknown and risk planes (read before the
  // sample loop), and its first output row.
  const size_t plane_off = static_cast<size_t>(b) * p.plane_stride;
  const int8_t* obstacle = p.obstacle + plane_off;
  const int8_t* unknown = p.unknown + plane_off;
  const int8_t* risk = p.risk ? p.risk + plane_off : nullptr;

  // base: the cell's index in the map, the counter's and, cropping, where
  // its planes lie (else at the cell itself: see src below).
  uint32_t base[P], fixed[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int cell = cell0 + (j < valid ? j : 0);
    const int dy = cell / p.rW;
    const int dx = cell - dy * p.rW;
    base[j] = static_cast<uint32_t>(oy + dy) * static_cast<uint32_t>(p.W) +
              static_cast<uint32_t>(ox + dx);
    fixed[j] = 0u;
    if (LAYOUT == kByte) {
      const int src = CROP ? static_cast<int>(base[j]) : cell;
      fixed[j] = widen(obstacle[src]) << 16 | widen(unknown[src]) << 17;
      if (risk) fixed[j] |= widen(risk[src]) << 18;
    }
  }

  // The shared per-cell words, once a launch: mask words of 16 cells, risk
  // words of 4, by the first m row of the y = 0 blocks.
  if (kCells && blockIdx.y == 0 && row == 0) {
    if (cell0 % 16 == 0) {
      uint32_t w = 0u;
      for (int q = 0; q < 16 && cell0 + q < p.n_cells; ++q) {
        const int c = source_cell<CROP>(p, cell0 + q, oy, ox);
        w |= (widen(obstacle[c]) | widen(unknown[c]) << 1) << (2 * q);
      }
      p.mask_words[b * p.mask_count + cell0 / 16] = static_cast<int32_t>(w);
    }
    if (risk) {
#pragma unroll
      for (int i = 0; i < P; i += 4) {
        if (cell0 + i >= p.n_cells) break;
        uint32_t w = 0u;
        for (int q = 0; q < 4 && cell0 + i + q < p.n_cells; ++q)
          w |= widen(risk[source_cell<CROP>(p, cell0 + i + q, oy, ox)])
               << (8 * q);
        p.risk_words[b * p.risk_count + (cell0 + i) / 4] =
            static_cast<int32_t>(w);
      }
    }
  }

  const int m_begin = blockIdx.y * p.samples_per_block;
  const int m_end = min(p.M, m_begin + p.samples_per_block);
  for (int m = m_begin + row; m < m_end; m += 2 * RB) {
    // Two map samples in flight: m and m + RB (the second may be past the
    // run's end; its hashes are then discarded).
    uint32_t bits[2][P];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t mb = (p.m_offset + m + u * RB) * p.HW;
#pragma unroll
      for (int j = 0; j < P; ++j)
        bits[u][j] = threefry_bits(k0, k1, mb + base[j]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int mm = m + u * RB;
      if (mm >= m_end) break;
      int rl[P], ra[P], gl[P], ga[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float uf =
            __uint_as_float((bits[u][j] >> 9) | 0x3F800000u) - 1.0f;
        const int sampled = static_cast<int>(ceilf(uf * s));
        rl[j] = ra[j] = 0;
        if (j < valid) {
          if (static_cast<unsigned>(sampled) < unsigned{kLevels}) {
            rl[j] = table[0][sampled][c0 + j];
            if (has_ang) ra[j] = table[1][sampled][c0 + j];
          } else {
            const int src = CROP ? static_cast<int>(base[j]) : cell0 + j;
            rl[j] = rank_loop(p.pmf[0], p.pmf_scenario[0], p.B[0],
                              p.plane_stride, src, sampled);
            if (has_ang)
              ra[j] = rank_loop(p.pmf[1], p.pmf_scenario[1], p.B[1],
                                p.plane_stride, src, sampled);
          }
        }
        gl[j] = lut[0][rl[j]];
        ga[j] = has_ang ? lut[1][ra[j]] : 0;
        if (j >= valid) gl[j] = ga[j] = 0;
      }

      const size_t row_out = static_cast<size_t>(row0 + mm);
      const size_t e0 = row_out * p.n_cells + cell0;
      store_bytes<P>(p.grid[0] + e0, gl, valid);
      if (has_ang) store_bytes<P>(p.grid[1] + e0, ga, valid);

      if (LAYOUT == kBins) {
        uint32_t w[P];
#pragma unroll
        for (int j = 0; j < P; ++j) w[j] = rl[j];
        store_words<P>(p.bins[0] + e0, w, valid);
        if (has_ang) {
#pragma unroll
          for (int j = 0; j < P; ++j) w[j] = ra[j];
          store_words<P>(p.bins[1] + e0, w, valid);
        }
      } else if (LAYOUT == kByte) {
        uint32_t w[P];
#pragma unroll
        for (int j = 0; j < P; ++j)
          w[j] = widen(gl[j]) | widen(ga[j]) << 8 | fixed[j];
        store_words<P>(p.payload + e0, w, valid);
      } else {
        int32_t* row_words = p.payload + row_out * p.words_per_row;
        if (LAYOUT == kCells8) {
          uint32_t h[P], w[2];
#pragma unroll
          for (int j = 0; j < P; ++j) h[j] = widen(gl[j]) | widen(ga[j]) << 8;
          w[0] = h[0] | h[1] << 16;
          w[1] = h[2] | h[3] << 16;
          store_words<2>(row_words + cell0 / 2, w, (valid + 1) / 2);
        } else {
          constexpr int kBits = LAYOUT == kCells4 ? 4 : 2;   // ang's shift
          constexpr int kField = 32 / P;                     // 8 or 4 bits
          uint32_t w = 0u;
#pragma unroll
          for (int j = 0; j < P; ++j)
            w |= (widen(rl[j]) | widen(ra[j]) << kBits) << (kField * j);
          row_words[cell0 / P] = static_cast<int32_t>(w);
        }
      }
    }
  }
}

// One launch of the instantiation for `layout`; the crop mode has no bins
// layout.
template <bool CROP>
int launch(int layout, dim3 grid, cudaStream_t st, const Params& p) {
  switch (layout) {
    case kBins:
      if (CROP) return static_cast<int>(cudaErrorInvalidValue);
      map_sample_kernel<kBins, false><<<grid, kBlock, 0, st>>>(p);
      break;
    case kByte:
      map_sample_kernel<kByte, CROP><<<grid, kBlock, 0, st>>>(p);
      break;
    case kCells2:
      map_sample_kernel<kCells2, CROP><<<grid, kBlock, 0, st>>>(p);
      break;
    case kCells4:
      map_sample_kernel<kCells4, CROP><<<grid, kBlock, 0, st>>>(p);
      break;
    case kCells8:
      map_sample_kernel<kCells8, CROP><<<grid, kBlock, 0, st>>>(p);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers:
// key int64 (2,) of uint32 words; oy / ox int32 scalars, or null for 0;
// alpha_dyn float32 scalar; lin_pmf / ang_pmf int8 (B, rH, rW) windows
// (B <= 255); lin_q / ang_q int8 (B,); obstacle / unknown / risk int8
// (rH, rW) windows (risk may be null; all three unused by layout 0);
// lin_bins / ang_bins int32 (M, rH, rW), layout 0 only; lin_grid /
// ang_grid int8 (M, rH, rW); payload, mask_words and risk_words int32 as
// the layout gives them (see the top of this file).  Crop mode: x0
// float32 (3,), xlim0 / ylim0 / res float32 scalars, offset_out int32 (2,)
// and lims_out float32 (2,), all non-null (else all null); the planes are
// then the (H, W) map's, (B, H, W) and (H, W), oy / ox are null and the
// outputs are the (rH, rW) window's.  num_scenarios (B) scenarios, each
// a scenario stride from scenario 0's pointers: key (B, 2); oy / ox,
// alpha_dyn, xlim0 / ylim0 / res (B,); x0 (B, 3); offset_out and lims_out
// (B, 2); the PMFs (B, bins, ., .), qbins (B, bins), obstacle / unknown /
// risk (B, ., .); the grids, bins and payload (B, M, ...); the mask and
// risk words (B, words).  With no ang plane
// (ang_pmf, ang_q and the ang outputs null, B_ang 0) only the lin plane is
// ranked and the ang fields of the payload are 0.  H * W is the full map's
// cell count and W its width (the counter's strides).  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() so the
// caller sees a refused launch (cudaErrorInvalidValue for an unknown
// layout, or layout 0 in crop mode).
extern "C" int map_sample_launch(
    int layout, const void* key, const void* oy, const void* ox,
    const void* alpha_dyn, const void* lin_pmf, const void* ang_pmf,
    const void* lin_q, const void* ang_q, const void* obstacle,
    const void* unknown, const void* risk, void* lin_bins, void* ang_bins,
    void* lin_grid, void* ang_grid, void* payload, void* mask_words,
    void* risk_words, const void* x0, const void* xlim0, const void* ylim0,
    const void* res, void* offset_out, void* lims_out, int M, int rH, int rW,
    int B_lin, int B_ang, int H, int W, int m_offset, int num_scenarios,
    void* stream) {
  Params p;
  p.key = static_cast<const int64_t*>(key);
  p.oy = static_cast<const int32_t*>(oy);
  p.ox = static_cast<const int32_t*>(ox);
  p.x0 = static_cast<const float*>(x0);
  p.xlim0 = static_cast<const float*>(xlim0);
  p.ylim0 = static_cast<const float*>(ylim0);
  p.res = static_cast<const float*>(res);
  p.offset_out = static_cast<int32_t*>(offset_out);
  p.lims_out = static_cast<float*>(lims_out);
  p.alpha_dyn = static_cast<const float*>(alpha_dyn);
  p.pmf[0] = static_cast<const int8_t*>(lin_pmf);
  p.pmf[1] = static_cast<const int8_t*>(ang_pmf);
  p.qbins[0] = static_cast<const int8_t*>(lin_q);
  p.qbins[1] = static_cast<const int8_t*>(ang_q);
  p.obstacle = static_cast<const int8_t*>(obstacle);
  p.unknown = static_cast<const int8_t*>(unknown);
  p.risk = static_cast<const int8_t*>(risk);
  p.bins[0] = static_cast<int32_t*>(lin_bins);
  p.bins[1] = static_cast<int32_t*>(ang_bins);
  p.grid[0] = static_cast<int8_t*>(lin_grid);
  p.grid[1] = static_cast<int8_t*>(ang_grid);
  p.payload = static_cast<int32_t*>(payload);
  p.mask_words = static_cast<int32_t*>(mask_words);
  p.risk_words = static_cast<int32_t*>(risk_words);
  p.B[0] = B_lin;
  p.B[1] = B_ang;
  p.M = M;
  p.n_cells = rH * rW;
  p.rH = rH;
  p.rW = rW;
  p.H = H;
  p.W = W;
  p.plane_stride = x0 != nullptr ? static_cast<size_t>(H) * W
                                 : static_cast<size_t>(p.n_cells);
  p.pmf_scenario[0] = static_cast<size_t>(B_lin) * p.plane_stride;
  p.pmf_scenario[1] = static_cast<size_t>(B_ang) * p.plane_stride;
  p.mask_count = (p.n_cells + 15) / 16;
  p.risk_count = (p.n_cells + 3) / 4;
  const int per_word = layout == kCells2 ? 8 : layout == kCells4 ? 4 : 2;
  p.words_per_row = (p.n_cells + per_word - 1) / per_word;
  p.HW = static_cast<uint32_t>(H) * static_cast<uint32_t>(W);
  p.m_offset = static_cast<uint32_t>(m_offset);

  if (num_scenarios < 1 || num_scenarios > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gx = (p.n_cells + kTile - 1) / kTile;
  // About kTargetBlocks blocks over all the scenarios.
  int gy = (kTargetBlocks + gx * num_scenarios - 1) / (gx * num_scenarios);
  const int most = (M + kMinSamplesPerBlock - 1) / kMinSamplesPerBlock;
  if (gy > most) gy = most;
  if (gy > 65535) gy = 65535;
  if (gy < 1) gy = 1;
  p.samples_per_block = (M + gy - 1) / gy;
  gy = (M + p.samples_per_block - 1) / p.samples_per_block;
  const dim3 grid(gx, gy, num_scenarios);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x0 != nullptr ? launch<true>(layout, grid, st, p)
                       : launch<false>(layout, grid, st, p);
}
