"""The yardstick: the published peaks of one H100 SXM and the least time
that each measured call needs, frozen here so that no change to the
program moves them.

Each least time is the larger of the call's bytes over the HBM bandwidth
and its operations over the rate of the pipe that runs them.  The
operations are what the algorithm needs, counted from the plain version's
arithmetic (``mppi_numba_tpu_torch/ops``), whatever the kernels spend;
the bytes are each input read once and each output written once, at the
least that any of the program's layouts reads or writes, so that neither
a layout nor a routing choice moves the bound.

Published peaks (NVIDIA's H100 SXM data sheet, 700 W): 3.35 TB/s of HBM,
67 TFLOP/s float32 outside the tensor cores; integer rates at the
1,980 MHz boost clock on 132 SMs: the ALU pipe's 64 INT32 lanes an SM a
clock, and the four schedulers' issue of one warp instruction each a
clock, 128 lanes an SM (the Hopper white paper).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9
SCHEDULER_OPS_PER_S = 132 * 128 * 1.98e9

# float32 operations a lane-step of the rollout, from the plain version
# (a sqrtf, sinf or cosf counts as one): cell index 10, decode 4 (lb +
# ratio * value for both planes), dynamics (fast-trig rotation 24, exact
# unicycle 11: x and y share dt * lin_tr * v), goal distance 5, stage cost
# 7, masking 9.  A lane once: 6 for the terminal cost, 2 more for the
# start heading's cos and sin in fast-trig mode.  The speed map's step
# time is a table over the 256 values of a risk byte, 4 operations an
# entry.  A layout that decodes through a table saves the decode's 4, so
# the least count leaves them out.
OPS_STEP_FAST, OPS_STEP_EXACT, OPS_DECODE = 59, 46, 4
OPS_STEP_TABLE = 4 * 256
# The map draw an element: threefry2x32's 20 rounds of add, rotate and
# xor, 5 key injections of 2 adds and the counter's multiply-add (72 with
# the uniform's xor, shift and or: 75), of which the rotates, the xors and
# the uniform's 3 (43) must run on the ALU pipe; 4 float operations
# (multiply, subtract, ceil, convert).  A cell and plane once: the
# cumulative's add and the count a bin, and a prefix over the 101 sampled
# values.
OPS_MAP_HASH, FLOPS_MAP_SAMPLE, ALU_OPS_MAP_HASH = 75, 4, 43
OPS_TABLE_PER_BIN, TABLE_LEVELS = 2, 101
# Cells a 32-bit word holds in the binned layouts, by bits a cell.
CELLS_PER_WORD = {2: 8, 4: 4, 8: 2}
# Bytes an element of the least payload the map draw writes beside its two
# int8 grids (2-bit cells).
MAP_OUT_BYTES = 0.5


def _ceil_div(a, b):
    return -(-a // b)


def rollout_ops_s(K, M, T, fast_trig, speed_map):
    """The rollout's float32 operations over the float32 peak, seconds."""
    per_step = (OPS_STEP_FAST if fast_trig else OPS_STEP_EXACT) - OPS_DECODE
    ops = (K * M * (T * per_step + 6 + (2 if fast_trig else 0))
           + (OPS_STEP_TABLE if speed_map else 0))
    return ops / FP32_OPS_PER_S


def rollout_least_s(K, M, T, H, W, fast_trig, speed_map):
    """Least time of one scenario's rollout call on an (H, W) map: bytes
    the least of the layouts' map words (one word a cell and sample, or
    2-, 4- or 8-bit cells with the shared mask, risk and table words),
    the task, the clipped controls in, the (K, M) costs out."""
    hw = H * W
    words = [M * hw] + [
        M * _ceil_div(hw, cpw) + _ceil_div(hw, 16)
        + (_ceil_div(hw, 4) if speed_map else 0) + (32 if bits != 8 else 0)
        for bits, cpw in CELLS_PER_WORD.items()]
    nbytes = 4 * (min(words) + 19 + 2 * T * K + K * M)
    return max(nbytes / HBM_BYTES_PER_S,
               rollout_ops_s(K, M, T, fast_trig, speed_map))


def map_sample_ops_s(M, rH, rW, bins):
    """The map draw's operations over their pipes' rates, seconds."""
    cells = rH * rW
    n = M * cells
    alu = n * ALU_OPS_MAP_HASH
    every = (n * (OPS_MAP_HASH + FLOPS_MAP_SAMPLE)
             + cells * (OPS_TABLE_PER_BIN * bins + 2 * TABLE_LEVELS))
    return max(alu / ALU_OPS_PER_S, every / SCHEDULER_OPS_PER_S)


def map_sample_least_s(M, rH, rW, bins):
    """Least time of one scenario's map draw on an (rH, rW) window with
    ``bins`` PMF bins over both planes: bytes the two int8 PMF windows,
    their bin values and the key in; the two int8 grids and the least
    payload out."""
    cells = rH * rW
    n = M * cells
    nbytes = bins * (cells + 1) + 16 + (2 + MAP_OUT_BYTES) * n
    return max(nbytes / HBM_BYTES_PER_S, map_sample_ops_s(M, rH, rW, bins))


def tail_ops_s(K, M, T, numel):
    """The CVaR, coupling and update of one scenario's solve: integer
    comparisons over the ALU rate plus float32 operations over the float32
    peak, seconds.  The CVaR selects the worst ``numel`` of M costs a row
    and orders them (M + numel log2 numel comparisons; none where it takes
    every cost), folds them and divides once; the coupling a division, a
    product and an add a term (2T terms); the update a subtraction, a
    negation, a division, an exp and two sums' adds a rollout, a product
    and an add a rollout and (t, c), an add and a clamp a (t, c)."""
    comps = 0 if numel >= M else K * (
        M + numel * max(1.0, math.log2(max(numel, 1))))
    flops = (K * (min(numel, M) + 1 + 3 * 2 * T + 2)
             + K * 7 + K * T * 2 * 2 + T * 2 * 3)
    return comps / ALU_OPS_PER_S + flops / FP32_OPS_PER_S


def solve_least_s(s):
    """Least time of one scenario's solve of shape ``s`` (a dict: K, M,
    T, the window rH, rW, bins over both planes, numel, fast_trig,
    speed_map): the map draw's, the rollout's and the tail's operations
    at their rates, or the solve's bytes (the PMF windows and bin values,
    the task and the controls in, the controls out), the larger."""
    ops = (map_sample_ops_s(s["M"], s["rH"], s["rW"], s["bins"])
           + rollout_ops_s(s["K"], s["M"], s["T"], s["fast_trig"],
                           s["speed_map"])
           + tail_ops_s(s["K"], s["M"], s["T"], s["numel"]))
    nbytes = (s["bins"] * (s["rH"] * s["rW"] + 1) + 4 * 27
              + 2 * 4 * s["T"] * 2)
    return max(nbytes / HBM_BYTES_PER_S, ops)


def rollout_call_least_s(s):
    return rollout_least_s(s["K"], s["M"], s["T"], s["rH"], s["rW"],
                           s["fast_trig"], s["speed_map"])


def map_sample_call_least_s(s):
    return map_sample_least_s(s["M"], s["rH"], s["rW"], s["bins"])
