"""The barebone planner's two kernels at the shapes its engine gives them,
each held bit for bit against its plain version and timed over launches
captured in a CUDA graph, then the engine's chained solves.

* The rollout (``barebone_rollout_fused``) at T = 50 with the engine's two
  obstacles at the example's K = 1,000, the lifted 40,000 and the
  Config's 1e6, at K = 1e6 with no obstacle, 5 and 9 (the generic
  instantiation), and at T = 51 (a partial tile).
* The update past K = 32,768 (``update_useq_wide``), one scenario, T =
  50, at K = 40,000, 1e5 and 1e6 (``tail_bench``'s inputs), and each of
  its launches' own device time (``torch.profiler``, by kernel name).
* ``model_bench.bench_barebone``'s chained graph-replayed solves at K =
  1,000 and 1e6.

    python -m mppi_numba_tpu_torch.drivers.barebone_kernels
    python mppi_numba_tpu_torch/drivers/barebone_kernels.py --tree DIR

Run as a file, ``--tree`` names the checkout whose package is timed
(default: this file's own), so that an earlier commit unpacked with ``git
archive`` is timed by the same script: run the two in turns, each in a
process of its own (parent, change, change, parent).  Prints the card
line, then one JSON line a shape.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from pathlib import Path

ROLLOUT_SHAPES = ((1000, 50, 2), (40000, 50, 2), (1000000, 50, 2),
                  (1000000, 50, 0), (1000000, 50, 5), (1000000, 50, 9),
                  (1000000, 51, 2))
WIDE_KS = (40000, 100000, 1000000)
SOLVE_KS = (1000, 1000000)
REPS, RUNS = 20, 3


def rollout_case(torch, dev, K, T, N, seed):
    """``chip_smoke.py::barebone_case``'s inputs: the example's task with N
    obstacles past a goal at (2, 1.5), controls and noise (sigma 1.5)
    that reach the goal, hit obstacles and clip."""
    from mppi_numba_tpu_torch.types import BareboneTask

    g = torch.Generator(device=dev).manual_seed(seed)

    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    obs = torch.rand((N, 2), generator=g, device=dev) * 2.5 + f([2.5, 2.0])
    task = BareboneTask(
        x0=f([0.0, 0.0, math.pi / 4]), xgoal=f([2.0, 1.5]),
        goal_tolerance=f(0.5), lambda_weight=f(1.0), u_std=f([1.0, 1.0]),
        vrange=f([0.0, 2.0]), wrange=f([-math.pi, math.pi]), dt=f(0.1),
        dist_weight=f(10.0), obs_penalty=f(1e6), obs_pos=obs,
        obs_r=torch.rand((N,), generator=g, device=dev) * 0.5 + 0.5)
    u = torch.stack([torch.rand((T,), generator=g, device=dev) * 2 + 0.5,
                     torch.rand((T,), generator=g, device=dev) - 0.5], -1)
    noise = torch.randn((K, T, 2), generator=g, device=dev) * 1.5
    return task, u, noise


def same_bits(torch, a, b):
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def launch_us(torch, fn, pattern, calls=20):
    """The device time in us a call of ``fn`` of each CUDA kernel whose
    name matches ``pattern`` (``torch.profiler`` over ``calls`` eager
    calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        name = re.search(pattern, e.key)
        if e.device_type == DeviceType.CUDA and name:
            us[name.group(0)] = (us.get(name.group(0), 0.0)
                                 + float(e.device_time_total) / calls)
    return us


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="the checkout whose package is timed (run as a "
                         "file; default: this file's own)")
    args = ap.parse_args(argv)
    if __package__:
        if args.tree is not None:
            raise SystemExit("--tree needs the script run as a file")
    else:
        tree = args.tree or str(Path(__file__).resolve().parents[2])
        sys.path.insert(0, os.path.abspath(tree))
    import torch

    from mppi_numba_tpu_torch._card import card_line, time_cuda_graph
    from mppi_numba_tpu_torch.drivers.model_bench import bench_barebone
    from mppi_numba_tpu_torch.drivers.tail_bench import tail_case_inputs
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku
    from mppi_numba_tpu_torch.ops.kernels.barebone_rollout import (
        barebone_rollout_fused)
    from mppi_numba_tpu_torch.ops.rollout import barebone_rollout_costs

    if not torch.cuda.is_available():
        raise SystemExit("barebone_kernels: no CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    import mppi_numba_tpu_torch
    tag = dict(card=card, tree=str(Path(mppi_numba_tpu_torch.__file__)
                                   .resolve().parents[1]))

    def timed(fn):
        return [time_cuda_graph(fn, REPS, 2) for _ in range(RUNS)]

    for K, T, N in ROLLOUT_SHAPES:
        task, u, noise = rollout_case(torch, dev, K, T, N, seed=7)
        got = barebone_rollout_fused(task, u, noise)
        want = barebone_rollout_costs(task, u, noise)
        if not same_bits(torch, got, want):
            raise RuntimeError("barebone rollout K {} T {} N {}: differs "
                               "from the plain loop".format(K, T, N))
        runs = timed(lambda: barebone_rollout_fused(task, u, noise))
        print(json.dumps(dict(kernel="barebone_rollout", K=K, T=T, N=N,
                              ms=min(runs), runs=runs, **tag)), flush=True)
        del task, u, noise, got, want
    for K in WIDE_KS:
        (costs, noise, u, _, lam), _, (_, vr, wr) = tail_case_inputs(
            ("wide_update", 1, K, 1, 50, 1), dev, seed=K)
        costs = costs[..., 0].contiguous()
        got = ku.update_useq_wide(costs, noise, u, lam, vr, wr)
        want = ku.update_useq_plain(costs, noise, u, lam, vr, wr)
        if not all(same_bits(torch, a, b) for a, b in zip(got, want)):
            raise RuntimeError("wide update K {}: differs from the plain "
                               "version".format(K))

        def call():
            return ku.update_useq_wide(costs, noise, u, lam, vr, wr)

        runs = timed(call)
        print(json.dumps(dict(kernel="update_useq_wide", K=K, T=50,
                              ms=min(runs), runs=runs,
                              launch_us=launch_us(torch, call,
                                                  r"update_wide_[a-z]+"),
                              **tag)),
              flush=True)
        del costs, noise, u, got, want
    for K in SOLVE_KS:
        ms, eager_ms, kernels = bench_barebone(K=K, device=dev)
        print(json.dumps(dict(solve="barebone", K=K, T=50, ms_per_solve=ms,
                              eager_ms_per_solve=eager_ms,
                              kernels_per_replay=kernels, **tag)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
