"""Flagship-shape solve latency on realistic map sizes, every layout and
mode; the port's counterpart of ``scripts/bigmap_bench.py``.

Each row runs the whole solve (map sampling and packing in one
``map_sample`` launch, the rollout kernel of the row's layout, the CVaR
and the update) at K = M = 1024, T = 100 on the forest TDM's 140x84 map
or the reference's 250x250 maximum, uncropped or cropped to the
planner's reachable window (``roi_for``), under tdm, det_dyn or speed_map.
Each is replayed from a CUDA graph and timed in chains on the device
clock (``profiling.chained_solve_time``), the least of three chains.

    python -m mppi_numba_tpu_torch.drivers.bigmap_bench [PATTERN ...] [--device cpu]

Patterns keep the rows whose name contains one of them.  Each row prints
the JAX script's keys, its backend being the port's resolved layout
(``solver.resolve_backend``: 'byte', 'binned2', 'binned' or 'binned8'; the
JAX names map as in ``solver.py``: 'pallas_binned' is 'binned').  This is
the whole-solve layout sweep that the routing decision (ROADMAP B4) waits
for; it changes no routing.

Rows of the JAX script left out, with no counterpart in the port:
``forest_140x84_xla`` (XLA's generic fallback; the port's plain versions
run on CPU tensors only) and the three ``*_stream`` rows
(``max_250x250_stream_full``, ``forest_140x84_stream``,
``max_250x250_stream_speed``: the TPU's HBM-streaming cell plane; the port
has no streaming layout).  Left out as TPU artefacts: the liveness probe,
the 30 ms fetch round trip subtracted from each chain, the compile cache.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..config import SolverStatic
from ..solver import resolve_backend
from ..terrain import resolve_device
from ._common import (SMALL_CHAIN, add_device_arg, add_small_arg,
                      chained_ms, clock, emit, flagship_task, launch_counts,
                      launched_since, pmf_maps, resized, start)

K, M, T = 1024, 1024, 100
B = 12                      # forest-TDM bin count
RES = 0.5
VMAX = 2.0
CVAR_ALPHA = 0.2

# (label, H, W, roi, backend, mode, chained solves): the JAX script's rows
# with a counterpart in the port; roi True is ``roi_for(H, W)``.
SCENARIOS = (
    ("forest_140x84_binned", 140, 84, False, "auto", "tdm", 30),
    ("forest_140x84_binned_roi", 140, 84, True, "auto", "tdm", 30),
    ("max_250x250_binned_roi", 250, 250, True, "auto", "tdm", 30),
    ("max_250x250_binned_full", 250, 250, False, "auto", "tdm", 10),
    ("forest_140x84_det", 140, 84, False, "auto", "det_dyn", 30),
    ("max_250x250_det_full", 250, 250, False, "auto", "det_dyn", 30),
    ("forest_140x84_speed", 140, 84, False, "auto", "speed_map", 30),
    ("max_250x250_speed_full", 250, 250, False, "auto", "speed_map", 30),
    ("max_250x250_speed_roi", 250, 250, True, "auto", "speed_map", 30),
    ("forest_140x84_byte2_22bin", 140, 84, False, "auto", "tdm", 10),
    ("max_250x250_byte2_22bin_roi", 250, 250, True, "auto", "tdm", 10),
    ("max_250x250_byte2_22bin_full", 250, 250, False, "auto", "tdm", 5),
    ("max_250x250_crumb_4bin_full", 250, 250, False, "auto", "tdm", 10),
    ("forest_140x84_crumb_4bin", 140, 84, False, "auto", "tdm", 30),
    ("forest_140x84_speed_2bin_crumb", 140, 84, False, "auto", "speed_map",
     30),
    ("forest_140x84_speed_2bin_nibble", 140, 84, False, "binned",
     "speed_map", 30),
    ("max_250x250_speed_2bin_crumb", 250, 250, False, "auto", "speed_map",
     30),
    ("max_250x250_speed_2bin_nibble", 250, 250, False, "binned",
     "speed_map", 30),
    ("max_250x250_det_4bin_crumb", 250, 250, False, "auto", "det_dyn", 30),
    ("max_250x250_det_4bin_nibble", 250, 250, False, "binned", "det_dyn",
     30),
)


def row_bins(label):
    """The PMF bins of a row, from its name as in the JAX script."""
    return (22 if "22bin" in label else 4 if "4bin" in label
            else 2 if "2bin" in label else B)


def build(H, W, roi, backend="auto", mode="tdm", B=B, device=None):
    """``scripts/bigmap_bench.py::build``'s ``(static, maps, task)``, the
    tensors on ``device`` (default: the card)."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    maps = pmf_maps(rng, B, H, W, device)
    maps = maps._replace(risk=torch.tensor(
        rng.randint(30, 101, (H, W)).astype(np.int8), device=device))
    task = flagship_task([W * RES / 2, H * RES / 2, 0.785],
                         [W * RES - 2, H * RES - 2], vmax=VMAX, res=RES,
                         lim=0.0, device=device)
    m = M if mode == "tdm" else 1      # det modes roll one condensed map
    static = SolverStatic(mode=mode, num_steps=T, num_control_rollouts=K,
                          num_grid_samples=m, map_shape=(H, W),
                          num_obstacles=0,
                          cvar_numel=math.ceil(m * CVAR_ALPHA) if m > 1 else 1,
                          num_opt=1,
                          num_vis_state_rollouts=1, fast_trig=True,
                          backend=backend, roi_shape=roi, num_pmf_bins=B)
    return static, maps, task


def roi_for(H, W):
    """The planner's reachable-window size (``mppi.py::_roi_shape``)."""
    cells = int(math.ceil(VMAX * T * 0.1 / RES)) + 2
    r = 2 * cells + 1
    return (min(H, r), min(W, r))


def measure(static, maps, task, n=30, device=None):
    """The least of three chains of ``n`` solves, ms per solve
    (``_common.chained_ms``: graph replays on the device clock on a
    card)."""
    return min(chained_ms(static, maps, task, n, 3,
                          resolve_device(device)))


def rows(patterns=()):
    """The rows whose name contains one of ``patterns`` (all without)."""
    return [s for s in SCENARIOS
            if not patterns or any(p in s[0] for p in patterns)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("patterns", nargs="*",
                    help="keep the rows whose name contains one of these")
    add_device_arg(ap)
    add_small_arg(ap)
    args = ap.parse_args(argv)
    device, card = start(args)
    for label, H, W, roi, backend, mode, n in rows(args.patterns):
        window = roi_for(H, W) if roi else None
        static, maps, task = build(H, W, window, backend, mode,
                                   B=row_bins(label), device=device)
        if args.small:
            static, n = resized(static), SMALL_CHAIN
        before = launch_counts()
        ms = measure(static, maps, task, n, device)
        emit({"scenario": label,
              "backend": resolve_backend(static, device), "mode": mode,
              "roi": list(window) if window else None,
              "ms_per_solve": ms, "budget_50ms": ms <= 50.0,
              "card": card, "clock": clock(device),
              "launches": launched_since(before)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
