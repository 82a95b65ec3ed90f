"""What the drivers share: the ``--device`` and ``--small`` arguments, the
benchmark scripts' random PMF maps and task, the card line, JSON output
and chained solve timing."""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from .. import _card
from ..config import rec_min_control_rollouts
from ..graphs import counted_wrappers
from ..profiling import chained_solve_time
from ..solver import get_terrain_solver
from ..terrain import resolve_device
from ..types import MapInputs, TerrainTask

# ``--small``: a quick run on the CPU, each solve at K = 32, M = 8 (1 where
# the solve rolls one map), T = 5, and chains of 2 solves.
SMALL_K, SMALL_M, SMALL_T, SMALL_CHAIN = 32, 8, 5, 2
# ``--small`` of the episode batches: episodes and their steps.
SMALL_EPISODES, SMALL_STEPS = 2, 2
# ``--small``'s K where a planner's ``Config`` sets it (the examples, the
# sweep): the least K a ``Config`` keeps.
SMALL_CONFIG_K = max(SMALL_K, rec_min_control_rollouts)


def add_device_arg(parser):
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without a "
                             "card; 'cpu' runs the plain versions on the "
                             "host clock)")


def add_small_arg(parser):
    parser.add_argument("--small", action="store_true",
                        help="K = {}, M = {}, T = {} and a few solves: a "
                             "quick run, e.g. with --device cpu".format(
                                 SMALL_K, SMALL_M, SMALL_T))


def resized(static):
    """``static`` at ``--small``'s K, M and T (M kept at 1 where the solve
    rolls one map), its CVaR the same share of M."""
    M = static.num_grid_samples
    m = SMALL_M if M > 1 else 1
    return dataclasses.replace(
        static, num_control_rollouts=SMALL_K, num_grid_samples=m,
        num_steps=SMALL_T,
        cvar_numel=max(1, math.ceil(m * static.cvar_numel / M)))


def pmf_maps(rng, B, H, W, device):
    """The benchmark scripts' maps: one random PMF grid of B bins over HxW
    drawn from ``rng`` (each cell's bins summing to 100), the same grid for
    lin and ang, B evenly spaced int8 bin values, no obstacle, unknown or
    risk cells; copies on ``device``."""
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    qbins = np.linspace(0, 100, B).astype(np.int8)
    zeros = np.zeros((H, W), np.int8)

    def t(x):
        return torch.tensor(x, device=device)

    return MapInputs(lin_pmf=t(pmf), ang_pmf=t(pmf), lin_qbins=t(qbins),
                     ang_qbins=t(qbins), obstacle=t(zeros), unknown=t(zeros),
                     risk=t(zeros))


def flagship_task(x0, goal, vmax, res, lim, device):
    """The benchmark scripts' task, float32 on ``device``: they differ only
    in the start, the goal, the top speed, the cell size and the map's
    lower corner (``lim`` in x and y)."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return TerrainTask(
        x0=t(x0), xgoal=t(goal), goal_tolerance=t(0.5),
        v_post_rollout=t(0.01), lambda_weight=t(1.0), u_std=t([2.0, 3.0]),
        vrange=t([0.0, vmax]), wrange=t([-3.14, 3.14]), dt=t(0.1),
        dist_weight=t(1.0), obs_penalty=t(1e5), unknown_penalty=t(1e2),
        alpha_dyn=t(1.0), res=t(res), xlim0=t(lim), ylim0=t(lim),
        lin_lb=t(0.0), lin_ratio=t(0.01), ang_lb=t(0.0), ang_ratio=t(0.01))


def card_line(device):
    """``nvidia-smi``'s name and power limit of the card, or a label that
    says the run is on the host."""
    if device.type == "cuda":
        return _card.card_line()
    return "cpu: host run, no card (not a device figure)"


def start(args):
    """``(device, card line)``: the driver's device
    (``terrain.resolve_device``) and its card line, printed first."""
    device = resolve_device(args.device)
    card = card_line(device)
    print(card, flush=True)
    return device, card


def emit(record):
    print(json.dumps(record), flush=True)


def launch_counts():
    """Every kernel wrapper's launch count (``graphs.counted_wrappers``;
    a wrapper counts only the launches of its kernel, on a card)."""
    return {w.__name__: w.launches for w in counted_wrappers()}


def launched_since(before):
    """The launches each wrapper made since ``launch_counts()`` gave
    ``before`` (the wrappers that made any)."""
    now = launch_counts()
    return {k: n - before[k] for k, n in now.items() if n != before[k]}


def sync(device):
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock(device):
    """How ``chained_ms`` times on ``device``."""
    return ("device clock, CUDA-graph replays" if device.type == "cuda"
            else "host clock, eager (cpu)")


def chained_ms(static, maps, task, num_iters, chains, device, seed=1):
    """``chains`` chained-solve timings of ``num_iters`` solves each, ms per
    solve (``profiling.chained_solve_time``): on a card the solve replayed
    from one CUDA graph (``TerrainSolver.capture``), on the CPU eager."""
    solver = get_terrain_solver(static, device)
    lead = tuple(task.x0.shape[:-1])
    u0 = torch.zeros(lead + (static.num_steps, 2), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    fn = (solver.capture(gen, maps, task, torch.zeros_like(u0))
          if device.type == "cuda" else solver)
    return [1e3 * chained_solve_time(fn, maps, task, u0, num_iters=num_iters,
                                     generator=gen)
            for _ in range(chains)]
