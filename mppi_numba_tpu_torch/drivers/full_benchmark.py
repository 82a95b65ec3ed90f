"""The full reference-scale benchmark on the card; the port's counterpart of
``scripts/run_full_benchmark.py`` (reference: benchmark.ipynb[cells 5-7]).

3 methods x 4 vegetation densities x 10 environments x 5 alphas x 3
realizations = 1,800 closed-loop trials, or with ``--paper`` 40
environments x 5 realizations x 4 methods (the nominal 'baseline' too) =
16,000, at K = M = 1024, T = 100, at most 150 steps, through the
device-batched engine (``benchmark.run_trials_device_rows``: one CUDA graph
steps a chunk of ``BATCH_CHUNK`` episodes), one method after another in
this process.  The environments and realizations are drawn once, so the
trials are paired across methods.

    python -m mppi_numba_tpu_torch.drivers.full_benchmark [--paper] [--envs N] [--trials N] [--methods a,b] [--u-std-ang S | --paper-u-std] [--dist-weight W] [--out-dir DIR]

Prints the card line, then JSON lines: the script's three tables (success
by method, by method x alpha, and the mean time to goal on successes)
with the trial count, the wall clock of the sweep (host clock, ended by a
synchronize) and each method's engine figures (captures, chunk steps,
seconds), then the kernel launches.  Writes the experiment pickle with the
script's keys (``engine`` 'device'), and the card line beside it in
``<pickle>.card``, into ``--out-dir`` (default
``build/mppi_benchmark_torch/``; ``mppi_benchmark/`` holds the TPU runs'
pickles): ``logger`` is a pandas DataFrame where pandas imports, else a
dict of numpy columns, and ``checkpoint.load_experiment`` reads either;
``tables(logger_rows(load_experiment(path)["logger"]), ...)`` gives the
three tables of any experiment pickle, the JAX package's too.

Left out of the JAX script: one subprocess a method with a watchdog,
retries and partial pickles, and the compile cache.  It ran them because
the TPU's tethered worker crashed and hung under sustained load; here a
failure raises.  ``BATCH_CHUNK`` is 30 for every method: the JAX script's
10 for noisy_dyn was a deadline of that worker.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

from .. import benchmark
from ..config import Config
from ._common import (SMALL_CONFIG_K, SMALL_M, SMALL_STEPS, SMALL_T,
                      add_device_arg, emit, launch_counts, launched_since,
                      start, sync)

GRASS_DENSITY_LIST = [1.0, 0.7, 0.4, 0.1]
ENVS_PER_DENSITY = 10
TRIALS_PER_ENV = 3
ALPHA_LIST = [1.0, 0.8, 0.6, 0.4, 0.2]
METHOD_LIST = ["noisy_dyn", "risk_dyn", "nom_dyn_risk_cost"]
PAPER_METHOD_LIST = METHOD_LIST + ["baseline"]
GRID_SHAPE = (9, 9)
MUD_MARGIN = 1
RES = 1.0
MAX_STEPS = 150
OUT_DIR = os.path.join("build", "mppi_benchmark_torch")
# The committed reference notebook says u_std=[2, 3]; the paper pickle's
# embedded config records u_std=[2, 2] (--paper-u-std).
U_STD_ANG = 3.0
DIST_WEIGHT = 1.0
# Episodes a batched step, every method alike.
BATCH_CHUNK = 30


def build_problem(u_std_ang=U_STD_ANG, dist_weight=DIST_WEIGHT,
                  small=False):
    """The script's ``(world, cfg, params)``; ``small`` cuts K, M and T to
    ``--small``'s."""
    world = benchmark.make_benchmark_world(num_bins=20,
                                           rng=np.random.RandomState(0))
    K, M, T = ((SMALL_CONFIG_K, SMALL_M, SMALL_T * 0.1) if small
               else (1024, 1024, 10.0))
    cfg = Config(T=T, dt=0.1, num_grid_samples=M,
                 num_control_rollouts=K, max_speed_padding=5.0,
                 num_vis_state_rollouts=50, max_map_dim=(15, 15), seed=1,
                 use_tdm=True)
    params = benchmark.default_benchmark_params(cfg, GRID_SHAPE, MUD_MARGIN)
    params["u_std"] = np.array([2.0, u_std_ang])
    if dist_weight != 1.0:
        params["dist_weight"] = dist_weight
    return world, cfg, params


def file_tag(methods, u_std_ang=U_STD_ANG, dist_weight=DIST_WEIGHT):
    """The script's file-name tag of a run's settings."""
    tag = "" if u_std_ang == 3.0 else "_us{:g}".format(u_std_ang)
    if dist_weight != 1.0:
        tag += "_dw{:g}".format(dist_weight)
    if sorted(methods) not in (sorted(METHOD_LIST),
                               sorted(PAPER_METHOD_LIST)):
        tag += "_" + "-".join(methods)
    return tag


def tables(rows, methods, alphas):
    """The script's three tables from the logger rows: success by method,
    by method x alpha, and the mean time to goal on successes (None where
    a method has none)."""
    def mean(values):
        values = [float(v) for v in values]
        return float(np.mean(values)) if values else None

    def of(method, alpha=None):
        return [r for r in rows if r["method"] == method
                and (alpha is None or float(r["alpha"]) == float(alpha))]

    return dict(
        success_by_method={m: mean(r["success"] for r in of(m))
                           for m in methods},
        success_by_method_alpha={m: {str(a): mean(r["success"]
                                                  for r in of(m, a))
                                     for a in alphas} for m in methods},
        time_to_goal_on_success={m: mean(r["time_to_goal"] for r in of(m)
                                         if r["success"])
                                 for m in methods})


def logger_table(rows):
    """The rows as the pickle's ``logger``: a pandas DataFrame where pandas
    imports, else a dict of numpy columns."""
    try:
        import pandas as pd
    except ImportError:
        return {k: np.array([r[k] for r in rows]) for k in rows[0]}
    return pd.DataFrame(rows)


def logger_rows(logger):
    """An experiment pickle's ``logger`` (DataFrame or dict of columns) as
    a list of row dicts."""
    if hasattr(logger, "to_dict"):
        return logger.to_dict("records")
    n = len(next(iter(logger.values())))
    return [{k: v[i] for k, v in logger.items()} for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=ENVS_PER_DENSITY,
                    help="environments per density (reference: 10; paper "
                         "run: 40)")
    ap.add_argument("--trials", type=int, default=TRIALS_PER_ENV,
                    help="ground-truth realizations per env (reference: 3; "
                         "paper run: 5)")
    ap.add_argument("--paper", action="store_true",
                    help="full paper reproduction: 40 envs x 5 "
                         "realizations x 4 methods incl. the nominal "
                         "'baseline' = 16,000 trials")
    ap.add_argument("--u-std-ang", type=float, default=U_STD_ANG,
                    help="angular control-noise std (committed notebook: "
                         "3.0; the paper pickle's recorded config: 2.0)")
    ap.add_argument("--paper-u-std", action="store_true",
                    help="shorthand for --u-std-ang 2.0")
    ap.add_argument("--dist-weight", type=float, default=DIST_WEIGHT,
                    help="stage-cost distance weight")
    ap.add_argument("--methods", default=None,
                    help="comma list restricting the sweep methods")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="directory for the experiment pickle "
                         "(default: %(default)s)")
    add_device_arg(ap)
    ap.add_argument("--small", action="store_true",
                    help="K = {}, M = {}, T = {} and {} steps: a quick run, "
                         "e.g. with --device cpu".format(
                             SMALL_CONFIG_K, SMALL_M, SMALL_T, SMALL_STEPS))
    args = ap.parse_args(argv)
    envs, trials, methods = args.envs, args.trials, METHOD_LIST
    u_std_ang = 2.0 if args.paper_u_std else args.u_std_ang
    if args.paper:
        envs, trials, methods = 40, 5, PAPER_METHOD_LIST
    if args.methods:
        methods = args.methods.split(",")
    max_steps = SMALL_STEPS if args.small else MAX_STEPS

    device, card = start(args)
    world, cfg, params = build_problem(u_std_ang, args.dist_weight,
                                       args.small)
    before = launch_counts()
    stats = {}
    t0 = time.perf_counter()
    rows = benchmark.run_trials_device_rows(
        cfg, world, max_steps, GRID_SHAPE, MUD_MARGIN, RES, params,
        GRASS_DENSITY_LIST, envs, trials, ALPHA_LIST, methods,
        verbose=False, batch_chunk=BATCH_CHUNK, device=device, stats=stats)
    sync(device)
    wall = time.perf_counter() - t0
    emit(dict(trials=len(rows), wall_clock_s=wall,
              clock="host clock, ended by a synchronize",
              batch_chunk=BATCH_CHUNK, max_steps=max_steps,
              **tables(rows, methods, ALPHA_LIST),
              engine={m: dict(captures=s["captures"], seconds=s["seconds"],
                              episodes=s["episodes"],
                              chunk_steps=s["chunk_steps"])
                      for m, s in stats.items()}))

    fname = os.path.join(args.out_dir,
                         "envs_{}_trials_{}_densities_{}_device{}.pickle"
                         .format(envs, trials, len(GRASS_DENSITY_LIST),
                                 file_tag(methods, u_std_ang,
                                          args.dist_weight)))
    out = dict(
        logger=logger_table(rows), cfg=cfg, max_speed=3.0,
        max_steps=max_steps, grid_shape=GRID_SHAPE, mud_margin=MUD_MARGIN,
        res=RES, num_pmf_bins=world["num_pmf_bins"],
        bin_values=world["bin_values"],
        bin_values_bounds=world["bin_values_bounds"],
        default_mppi_params=params,
        grass_density_list=GRASS_DENSITY_LIST,
        envs_per_density=envs, trials_per_env=trials,
        alpha_list=ALPHA_LIST, method_list=methods,
        pmf_bounds=[0, 1.0], bush_weights=[0.6, 0.4], bush_means=[0, 0.8],
        bush_std=[0.15, 0.1], dirt_weights=[1], dirt_means=[0.65],
        dirt_std=[0.1], wall_clock_s=wall, engine="device")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(fname, "wb") as fh:
        pickle.dump(out, fh)
    # The card beside the pickle, whose keys are the JAX script's.
    with open(fname + ".card", "w") as fh:
        fh.write(card + "\n")
    emit(dict(saved=fname, launches=launched_since(before)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
