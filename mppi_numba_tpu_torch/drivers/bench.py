"""Headline figure: the flagship stochastic solve's latency on one card;
the port's counterpart of the JAX package's ``bench.py``.

The workload is ``bench.py``'s: K = 1024 control rollouts x M = 1024
sampled traction maps x T = 100 steps over the reference benchmark's 9x9
map with its padding ring (11x11), 22 PMF bins, CVaR alpha 0.2, fast trig.
The solve replays from a CUDA graph (``TerrainSolver.capture``: what the
planner runs on a card), and chains of 50 solves, each fed the last one's
controls, are timed with CUDA events (``profiling.chained_solve_time``);
the figure is the median of the chains.

    python -m mppi_numba_tpu_torch.drivers.bench [--device cpu]

Prints the card's name and power limit, then ONE JSON line.

Left out from ``bench.py``, all TPU artefacts: the 30 ms fetch round trip
subtracted from each chain (CUDA events bracket the chain on the device),
the liveness probe and ``main_with_retry``'s re-exec of a wedged worker (a
failure here raises and exits non-zero), the compile cache, and the
``vs_baseline`` ratio against the reference's RTX 3070 (another card).
"""

from __future__ import annotations

import argparse
import math
import statistics

import numpy as np

from ..config import SolverStatic
from ..terrain import resolve_device
from ._common import (add_device_arg, chained_ms, clock, emit, flagship_task,
                      launch_counts, launched_since, pmf_maps, start)

METRIC = "stochastic_solve_latency_K1024_M1024_T100"
CHAINS = 5


def build_flagship(K=1024, M=1024, T=100, H=11, W=11, B=22, cvar_alpha=0.2,
                   device=None):
    """``bench.py::build_flagship``'s ``(static, maps, task)``, the tensors
    on ``device`` (default: the card)."""
    device = resolve_device(device)
    maps = pmf_maps(np.random.RandomState(0), B, H, W, device)
    task = flagship_task([0.5, 0.5, 0.785], [8.5, 8.5], vmax=3.0, res=1.0,
                         lim=-3.0, device=device)
    static = SolverStatic(mode="tdm", num_steps=T, num_control_rollouts=K,
                          num_grid_samples=M, map_shape=(H, W),
                          num_obstacles=0,
                          cvar_numel=math.ceil(M * cvar_alpha), num_opt=1,
                          num_vis_state_rollouts=1, fast_trig=True)
    return static, maps, task


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    # K, M, T and the chain's length, to be cut for a quick run.
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--t", type=int, default=100)
    ap.add_argument("--iters", type=int, default=50,
                    help="solves a chain")
    args = ap.parse_args(argv)
    device, card = start(args)
    static, maps, task = build_flagship(args.k, args.m, args.t,
                                        device=device)
    before = launch_counts()
    runs = chained_ms(static, maps, task, args.iters, CHAINS, device)
    emit({"metric": METRIC, "value": statistics.median(runs), "unit": "ms",
          "card": card, "clock": clock(device),
          "chains_ms": runs, "solves_per_chain": args.iters,
          "shape": dict(K=args.k, M=args.m, T=args.t),
          "launches": launched_since(before)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
