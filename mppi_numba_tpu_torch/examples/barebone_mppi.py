"""Barebone MPPI example: goal reaching with analytic circle obstacles; the
port's counterpart of ``examples/barebone_mppi.py``.

K = 1000 rollouts, a 5 s horizon (T = 50), two circle obstacles: a timing
probe (25 ``solve()`` calls after one, replayed from the planner's CUDA
graph on a card), then a closed loop of up to 151 steps from a fresh
planner, and the visualisation rollouts of its last solve.

    python -m mppi_numba_tpu_torch.examples.barebone_mppi [--device cpu] [--small]

Prints the card line, then JSON lines: the probe's ms a solve (host
clock) with the kernels one graph replay holds, and the outcome (``success``,
``time_to_goal``, ``steps``) with the solve times and graphs.  The figure
(trajectory, obstacles, rollouts, controls) goes to ``--out-dir`` where
matplotlib imports.
"""

from __future__ import annotations

import time
import types

import numpy as np

from .. import BareboneConfig, BareboneMPPI
from ..drivers._common import SMALL_CHAIN, emit, launch_counts, start
from . import _common as ex

EXAMPLE = "barebone_mppi"
PROBE_SOLVES = 25
MAX_STEPS = 151


def build(device=None, small=False):
    """The script's config, params and planner (set up) on ``device``
    (default: the card)."""
    K, _, T, steps = ex.sizes(small, 1000, 1, 5.0, 0.1, MAX_STEPS)
    cfg = BareboneConfig(T=T, dt=0.1, num_control_rollouts=K,
                         num_vis_state_rollouts=20, seed=1)
    x0 = np.array([0, 0, np.pi / 4])
    xgoal = np.array([7, 5])
    params = dict(
        dt=cfg.dt, x0=x0, xgoal=xgoal,
        goal_tolerance=0.5, dist_weight=10,
        lambda_weight=1.0, num_opt=1,
        u_std=np.array([1.0, 1.0]),
        vrange=np.array([0.0, 2.0]),
        wrange=np.array([-np.pi, np.pi]),
        obstacle_positions=np.array([[5, 4.5], [2, 1]]),
        obstacle_radius=np.array([1.5, 1]),
        obs_penalty=1e6)
    planner = BareboneMPPI(cfg, device=device)
    planner.setup(params)
    return types.SimpleNamespace(cfg=cfg, params=params, planner=planner,
                                 max_steps=steps)


def unicycle_step(dt):
    """The script's step: nominal unicycle, no traction."""
    def step(x, u):
        return np.array([x[0] + dt * np.cos(x[2]) * u[0],
                         x[1] + dt * np.sin(x[2]) * u[0],
                         x[2] + dt * u[1]])
    return step


def plot(w, states, uhist, rollouts, out_dir):
    plt = ex.pyplot()
    if plt is None:
        return []
    p, x0, xgoal = w.params, w.params["x0"], w.params["xgoal"]
    fig, (ax, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    ax.plot(states[:, 0], states[:, 1], "r", label="Trajectory")
    ax.plot(*x0[:2], "ro", markersize=10, markerfacecolor="none",
            label="Start")
    ax.add_patch(plt.Circle(xgoal, p["goal_tolerance"], color="b",
                            fill=False, label="Goal"))
    for pos, r in zip(p["obstacle_positions"], p["obstacle_radius"]):
        ax.add_patch(plt.Circle(pos, r, color="k"))
    ax.plot(rollouts[:, :, 0].T, rollouts[:, :, 1].T, "k", alpha=0.3)
    ax.set_aspect("equal")
    ax.legend()
    ax2.plot(uhist[:, 0], label="v")
    ax2.plot(uhist[:, 1], label="w")
    ax2.legend()
    fig.tight_layout()
    path = ex.out_path(out_dir, EXAMPLE + ".png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]


def main(argv=None):
    args = ex.parser(__doc__).parse_args(argv)
    device, _ = start(args)
    w = build(device, args.small)
    planner = w.planner
    before = launch_counts()

    # Timing probe (reference cell 6): one solve, then the timed ones.
    n = SMALL_CHAIN if args.small else PROBE_SOLVES
    planner.solve()
    t0 = time.perf_counter()
    for _ in range(n):
        planner.solve()
    probe_ms = 1e3 * (time.perf_counter() - t0) / n
    emit(ex.jsonable(dict(example=EXAMPLE, probe_solves=n,
                          ms_per_solve=probe_ms, clock=ex.clock(device),
                          **ex.graphs(planner))))

    planner.reset()
    planner.setup(w.params)
    timed = ex.TimedPlanner(planner)
    states, uhist, outcome = ex.closed_loop(
        timed, unicycle_step(w.cfg.dt), w.params["x0"], w.params["xgoal"],
        w.params["goal_tolerance"], w.cfg.dt, w.max_steps)
    rollouts = planner.get_state_rollout()
    figures = plot(w, states, uhist, rollouts, args.out_dir)
    ex.report(EXAMPLE, None, planner, timed, outcome, before, device,
              vis_shape=list(rollouts.shape), figures=figures,
              **ex.final(states))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
