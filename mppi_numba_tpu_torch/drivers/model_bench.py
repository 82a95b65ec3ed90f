"""Model-family and barebone-engine solve latency; the port's counterpart
of ``scripts/model_bench.py``.

* The barebone engine at the reference's own benchmark shape (K = 1000,
  T = 50, two circle obstacles: ``barebone_mppi_numba.ipynb``'s), chained
  solves on the device clock, replayed from a CUDA graph
  (``BareboneSolver.capture``) as the planner replays them on a card,
  with the same chain of eager solves beside them (``eager_ms_per_solve``:
  there the host's launches set the pace) and the kernels one replay
  launches (``captured_launches``).
* The unicycle (fast trig) and the bicycle (exact trig), both inside the
  rollout kernels, at K = M = 1024, T = 100 on an 11x11 map with 12 bins
  (``bigmap_bench.build``), replayed from a CUDA graph.
* The scale rows on the same map: K = 1024 and 10240 under det_dyn and
  K = 10240 under tdm.

    python -m mppi_numba_tpu_torch.drivers.model_bench [--device cpu]

Left out of the JAX script: the ``("bicycle", "xla")`` row (XLA's generic
rollout; the port's plain versions run on CPU tensors only), the
``reference_rtx3070_ms`` column (a figure of another card, not to be set
beside this one as a ratio), the liveness probe, the 30 ms fetch round
trip subtracted from each chain and the compile cache.  A failing row
raises: no row is skipped.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from ..barebone import BareboneConfig, BareboneMPPI
from ..profiling import chained_solve_time
from ..solver import get_barebone_solver
from ..terrain import resolve_device
from . import bigmap_bench as bb
from ._common import (SMALL_CHAIN, add_device_arg, add_small_arg, clock,
                      emit, launch_counts, launched_since, resized, start)

BAREBONE_CHAIN = 20


def barebone_planner(K=1000, device=None):
    """``scripts/model_bench.py::bench_barebone``'s planner, set up."""
    cfg = BareboneConfig(T=5.0, dt=0.1, num_control_rollouts=K, seed=0)
    planner = BareboneMPPI(cfg, device=resolve_device(device))
    params = dict(dt=cfg.dt, x0=np.array([0.0, 0.0, 0.0]),
                  xgoal=np.array([8.0, 8.0]), goal_tolerance=0.3,
                  lambda_weight=1.0, num_opt=1,
                  u_std=np.array([1.0, 1.0]), vrange=np.array([0.0, 2.0]),
                  wrange=np.array([-1.5, 1.5]), dist_weight=10.0,
                  obs_penalty=1e3,
                  obstacle_positions=np.array([[3.0, 3.0], [5.5, 6.0]]),
                  obstacle_radius=np.array([1.0, 1.0]))
    planner.setup(params)
    return planner


def bench_barebone(K=1000, n=BAREBONE_CHAIN, device=None):
    """The barebone engine's chained solves, ms per solve (device clock on
    a card): ``(graph ms, eager ms, kernels a replay)``, each the least of
    three chains of ``n`` solves, graph and eager in turns.  On the CPU
    there is no graph: ``(eager ms, eager ms, None)`` from one set of
    chains."""
    planner = barebone_planner(K, device)
    static = planner._static()
    solver = get_barebone_solver(static, planner.device)
    task = planner._task_device
    u0 = torch.zeros((static.num_steps, 2), device=planner.device)
    gens = {name: torch.Generator(device=planner.device).manual_seed(1)
            for name in ("graph", "eager")}
    fns = {"eager": solver}
    if planner.device.type == "cuda":
        fns["graph"] = solver.capture(gens["graph"], task,
                                      torch.zeros_like(u0))
    ms = {name: [] for name in fns}
    for r in range(3):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fn = fns[name]
            ms[name].append(1e3 * chained_solve_time(
                lambda g, _maps, t, u: fn(g, t, u), None, task, u0,
                num_iters=n, generator=gens[name]))
    graph = fns.get("graph")
    return (min(ms["graph" if graph else "eager"]), min(ms["eager"]),
            graph.kernel_nodes if graph else None)


def bench_terrain_model(model, backend="auto", device=None, small=False):
    """A model inside the rollout kernel at K = M = 1024, T = 100, 11x11,
    12 bins (fast trig for the unicycle only)."""
    static, maps, task = bb.build(11, 11, None, backend, device=device)
    static = dataclasses.replace(static, model=model, num_pmf_bins=12,
                                 fast_trig=(model == "unicycle"))
    return _measure(static, maps, task, 30, device, small)


def bench_scale(K, mode, n=20, device=None, small=False):
    """The scale rows: K rollouts under ``mode`` on the 11x11 world."""
    static, maps, task = bb.build(11, 11, None, "auto", mode=mode,
                                  device=device)
    m = static.num_grid_samples
    static = dataclasses.replace(
        static, num_control_rollouts=K, num_pmf_bins=12,
        cvar_numel=math.ceil(m * bb.CVAR_ALPHA) if m > 1 else 1)
    return _measure(static, maps, task, n, device, small)


def _measure(static, maps, task, n, device, small):
    if small:
        static, n = resized(static), SMALL_CHAIN
    return bb.measure(static, maps, task, n, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    add_small_arg(ap)
    args = ap.parse_args(argv)
    device, card = start(args)
    tag = dict(card=card, clock=clock(device))
    # --small cuts the barebone engine's chains only: its config sets a
    # floor of 100 rollouts.
    ms, eager_ms, kernels = bench_barebone(
        n=SMALL_CHAIN if args.small else BAREBONE_CHAIN, device=device)
    emit(dict(scenario="barebone_K1000_T50", ms_per_solve=ms,
              eager_ms_per_solve=eager_ms, captured_launches=kernels,
              **tag))
    for model in ("unicycle", "bicycle"):
        before = launch_counts()
        ms = bench_terrain_model(model, "auto", device, args.small)
        emit(dict(scenario="terrain_K1024_M1024_T100_{}".format(model),
                  backend="auto", ms_per_solve=ms,
                  launches=launched_since(before), **tag))
    for K, mode in ((1024, "det_dyn"), (10240, "det_dyn"), (10240, "tdm")):
        before = launch_counts()
        ms = bench_scale(K, mode, device=device, small=args.small)
        emit(dict(scenario="scale_K{}_{}".format(K, mode), ms_per_solve=ms,
                  launches=launched_since(before), **tag))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
