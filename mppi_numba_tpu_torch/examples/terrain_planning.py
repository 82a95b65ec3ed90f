"""Terrain-aware planning: a random 9x9 Dirt/Vegetation world, closed loop;
the port's counterpart of ``examples/terrain_planning.py``.

The reference benchmark's Gaussian-mixture world and a random semantic
grid (``RandomState(1)``), planned under one of the three risk-aware
modes at K = M = 1024 (M = 1 outside tdm), T = 100, and a closed loop of
up to 151 steps against one realization of the true traction field
(``TDM.sample_grids_true_dist``), stepped on the host by ``sim.trial``,
the script's own loop.

    python -m mppi_numba_tpu_torch.examples.terrain_planning [tdm|det|speed] [--device cpu] [--small]

Prints the card line, then JSON lines: the solver's shape and layout, and
the outcome (``success``, ``time_to_goal``, ``steps``) with the solve
times, the kernel launches and the graphs.  The map, trajectory and
rollouts go to ``--out-dir`` as ``terrain_planning_<mode>.png`` where
matplotlib imports.
"""

from __future__ import annotations

import types

import numpy as np

from .. import (Config, MPPIPlanner, TDM, make_benchmark_world,
                make_semantic_grid)
from ..drivers._common import launch_counts, start
from ..sim import trial
from . import _common as ex

EXAMPLE = "terrain_planning"
MODES = ("tdm", "det", "speed")
MAX_STEPS = 151


def build(mode="tdm", device=None, small=False):
    """The script's world, config, params, TDMs and planner (set up) on
    ``device`` (default: the card), and the ground truth drawn after the
    setup, in the script's order of draws."""
    rng = np.random.RandomState(1)
    world = make_benchmark_world(num_bins=20, rng=rng)
    grid_shape = (9, 9)
    mud_margin = 1
    res = 1.0
    sg = make_semantic_grid(grid_shape, mud_margin, 0.4, rng)
    xlimits = (0, grid_shape[1] * res)
    ylimits = (0, grid_shape[0] * res)
    max_speed = 3.0

    K, M, T, steps = ex.sizes(small, 1024, 1024, 10.0, 0.1, MAX_STEPS)
    cfg = Config(
        T=T, dt=0.1, num_grid_samples=M, num_control_rollouts=K,
        max_speed_padding=max_speed + 2.0,
        num_vis_state_rollouts=100 if mode == "tdm" else 1,
        max_map_dim=(15, 15), seed=1,
        use_tdm=mode == "tdm", use_det_dynamics=mode == "det",
        use_nom_dynamics_with_speed_map=mode == "speed")

    cvar_alpha = 0.2 if mode == "tdm" else 1.0
    alpha_dyn = 1.0 if mode == "tdm" else 0.2

    x0 = np.array([mud_margin / 2, mud_margin / 2, np.pi / 4])
    xgoal = np.array([grid_shape[0] - mud_margin / 2,
                      grid_shape[0] - mud_margin / 2])
    params = dict(
        dt=cfg.dt, x0=x0, xgoal=xgoal, goal_tolerance=0.5,
        v_post_rollout=0.01, cvar_alpha=cvar_alpha, alpha_dyn=alpha_dyn,
        dist_weight=1, lambda_weight=1.0, num_opt=1,
        u_std=np.array([2.0, 3.0]), vrange=np.array([0.0, max_speed]),
        wrange=np.array([-np.pi, np.pi]))

    lin_tdm, ang_tdm = TDM(cfg, device=device), TDM(cfg, device=device)
    det_alpha = None if mode == "tdm" else alpha_dyn
    for tdm, key in ((lin_tdm, "lin_terrain2pmf"),
                     (ang_tdm, "ang_terrain2pmf")):
        tdm.set_TDM_from_semantic_grid(
            sg, res, world["num_pmf_bins"], world["bin_values"],
            world["bin_values_bounds"], xlimits, ylimits, world["id2name"],
            world["name2terrain"], world[key],
            det_dynamics_cvar_alpha=det_alpha)

    planner = MPPIPlanner(cfg, device=device)
    planner.setup(params, lin_tdm, ang_tdm)
    truth = lin_tdm.sample_grids_true_dist()
    return types.SimpleNamespace(cfg=cfg, params=params, planner=planner,
                                 lin_tdm=lin_tdm, ang_tdm=ang_tdm,
                                 truth=truth, max_steps=steps)


def plot(w, mode, states, rollouts, out_dir):
    plt = ex.pyplot()
    if plt is None:
        return []
    from ..visualization import TDMVisualizer

    p = w.params
    fig, ax = TDMVisualizer(w.lin_tdm).draw(figsize=(6, 6))
    ax.plot(states[:, 0], states[:, 1], "r", linewidth=2,
            label="Trajectory")
    ax.plot(rollouts[:, :, 0].T, rollouts[:, :, 1].T, "b", alpha=0.2)
    ax.plot(*p["x0"][:2], "ko", markersize=10, markerfacecolor="none")
    ax.add_patch(plt.Circle(p["xgoal"], p["goal_tolerance"], color="r",
                            fill=False))
    path = ex.out_path(out_dir, "{}_{}.png".format(EXAMPLE, mode))
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]


def main(argv=None):
    ap = ex.parser(__doc__)
    ap.add_argument("mode", nargs="?", default="tdm", choices=MODES)
    args = ap.parse_args(argv)
    device, _ = start(args)
    w = build(args.mode, device, args.small)
    planner = w.planner
    ex.describe(EXAMPLE, args.mode, planner)
    before = launch_counts()
    timed = ex.TimedPlanner(planner)
    logger = trial(timed, w.truth, w.cfg.dt, max_steps=w.max_steps,
                   mppi_params=w.params, return_history=True)
    states = logger.pop("xhist")
    logger["steps"] = len(logger.pop("uhist"))
    rollouts = planner.get_state_rollout()
    figures = plot(w, args.mode, states, rollouts, args.out_dir)
    ex.report(EXAMPLE, args.mode, planner, timed, logger, before, device,
              vis_shape=list(rollouts.shape), figures=figures,
              **ex.final(states, w.truth))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
