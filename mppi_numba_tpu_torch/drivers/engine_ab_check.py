"""The host trial engine against the device trial engine on identical paired
environments; the port's counterpart of ``scripts/engine_ab_check.py``.

The two benchmark engines intentionally differ in one semantic:

* ``benchmark.run_trials_rows`` (host) keeps the reference's sequencing
  (reference: benchmark.ipynb[cell 4]): the planner is not reset between
  the realizations of an environment, so the warm-started controls (and
  the stale ``params['x0']``) carry into the next trial's first solve;
* ``benchmark.run_trials_device_rows`` starts every episode from a fresh
  warm start (the episodes run as batches, so nothing carries over).

The engines draw their noise and map samples from different streams, so
single trials are not comparable; this quantifies the engine effect
statistically on the same (density x env x realization) grid: each
method's success rate and mean time to goal under each engine, and the
share of paired trials with the same outcome.

    python -m mppi_numba_tpu_torch.drivers.engine_ab_check [--envs 5] [--trials 3] [--max-steps 150] [--methods noisy_dyn,risk_dyn] [--alphas 1.0,0.5] [--small] [--device cpu | --cpu]

Prints the card line, then the JAX script's JSON (``n_trials_per_engine``
and a dict a method), then a line with each engine's wall seconds (host
clock, ended by a synchronize) and the kernel launches.  K = M = 1024, or
256 / 64 with ``--small``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import benchmark
from ..config import Config
from ._common import (add_device_arg, emit, launch_counts, launched_since,
                      start, sync)

# The rows' join: one paired trial.
KEYS = ("method", "alpha", "grass_density_index", "sem_map_index",
        "map_sample_index")


def build(envs, trials, methods, alphas, max_steps, host, small=False,
          densities=(1.0, 0.4), device=None):
    """One engine's rows on the script's problem (``host``: the sequential
    engine, else the batched one), the world rebuilt so that both engines
    see the same realizations."""
    world = benchmark.make_benchmark_world(num_bins=20,
                                           rng=np.random.RandomState(0))
    K, M = (256, 64) if small else (1024, 1024)
    cfg = Config(T=10.0, dt=0.1, num_grid_samples=M,
                 num_control_rollouts=K, max_speed_padding=5.0,
                 num_vis_state_rollouts=1, max_map_dim=(15, 15), seed=1,
                 use_tdm=True)
    params = benchmark.default_benchmark_params(cfg, (9, 9), 1)
    params["u_std"] = np.array([2.0, 2.0])
    fn = (benchmark.run_trials_rows if host
          else benchmark.run_trials_device_rows)
    return fn(cfg, world, max_steps, (9, 9), 1, 1.0, params,
              grass_density_list=list(densities), envs_per_density=envs,
              trials_per_env=trials, alpha_list=alphas,
              method_list=methods, verbose=False, device=device)


def compare(host_rows, dev_rows, methods):
    """The script's statistics of the two engines' rows, joined on
    ``KEYS``."""
    dev = {tuple(r[k] for k in KEYS): r for r in dev_rows}
    pairs = [(h, dev.get(tuple(h[k] for k in KEYS))) for h in host_rows]
    if (any(d is None for _, d in pairs)
            or not len(pairs) == len(dev_rows) == len(dev)):
        raise RuntimeError("the engines' rows do not pair one to one")
    out = {"n_trials_per_engine": len(host_rows)}
    for meth in methods:
        sub = [(h, d) for h, d in pairs if h["method"] == meth]
        sh = float(np.mean([h["success"] for h, _ in sub]))
        sd = float(np.mean([d["success"] for _, d in sub]))
        # Zero successes give null, not NaN (strict JSON).
        th = [h["time_to_goal"] for h, _ in sub if h["success"]]
        td = [d["time_to_goal"] for _, d in sub if d["success"]]
        th = float(np.mean(th)) if th else None
        td = float(np.mean(td)) if td else None
        agree = float(np.mean([bool(h["success"]) == bool(d["success"])
                               for h, d in sub]))
        out[meth] = dict(
            success_host=round(sh, 4), success_dev=round(sd, 4),
            success_delta=round(sd - sh, 4),
            ttg_host_s=None if th is None else round(th, 3),
            ttg_dev_s=None if td is None else round(td, 3),
            ttg_delta_s=(None if th is None or td is None
                         else round(td - th, 3)),
            paired_outcome_agreement=round(agree, 4))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=5)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=150)
    ap.add_argument("--methods", default="noisy_dyn,risk_dyn")
    ap.add_argument("--alphas", default="1.0,0.5")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--small", action="store_true",
                    help="K=256/M=64 instead of flagship shapes")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    device, _ = start(args)

    methods = args.methods.split(",")
    alphas = [float(a) for a in args.alphas.split(",")]
    before = launch_counts()
    rows, seconds = {}, {}
    for engine, host in (("host", True), ("device", False)):
        t0 = time.perf_counter()
        rows[engine] = build(args.envs, args.trials, methods, alphas,
                             args.max_steps, host, args.small, device=device)
        sync(device)
        seconds[engine] = time.perf_counter() - t0
    emit(compare(rows["host"], rows["device"], methods))
    emit(dict(seconds=seconds, clock="host clock, ended by a synchronize",
              launches=launched_since(before)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
