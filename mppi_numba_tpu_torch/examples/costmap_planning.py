"""Planning from an occupancy costmap (the ROS costmap2d-shaped interface);
the port's counterpart of ``examples/costmap_planning.py``.

The costmap carries no traction information, so the dynamics are
nominal: lethal cells (above the threshold) become the obstacle mask,
no-information cells (255) the unknown mask, and the planner runs the
speed-map solve at full nominal speed, one map (M = 1), K = 1024, T = 40,
on the script's 24x30 costmap of 0.5 m cells: a lethal wall with an
off-axis gap, an unexplored corner and scattered lethal debris.  The
closed loop runs through ``sim.trial``, up to 200 steps, on a ground
truth of full traction with the lethal cells blocked.

    python -m mppi_numba_tpu_torch.examples.costmap_planning [--device cpu] [--small]

Prints the card line, then JSON lines: the solver's shape and layout, and
the outcome (``sim.trial``'s dict and the steps) with the solve times, the
kernel launches and the graphs.  The costmap and trajectory go to
``--out-dir`` as ``costmap_planning.png`` where matplotlib imports.
"""

from __future__ import annotations

import types

import numpy as np

from .. import Config, MPPIPlanner, TDM, TractionGrid, trial
from ..drivers._common import launch_counts, start
from . import _common as ex

EXAMPLE = "costmap_planning"
MAX_STEPS = 200


def make_costmap(H=24, W=30):
    """A lethal wall with an off-axis gap + an unexplored region the
    planner should treat cautiously + scattered lethal debris."""
    rng = np.random.RandomState(3)
    cm = np.zeros((H, W), dtype=np.uint8)
    cm[:, 14:16] = 220
    cm[14:19, 14:16] = 0     # gap, offset from the start-goal line
    cm[:8, 20:] = 255        # unexplored corner
    debris = (rng.rand(H, W) < 0.015) & (cm == 0)
    cm[debris] = 180                   # scattered lethal debris
    cm[4:13, :8] = np.where(cm[4:13, :8] == 220, 220, 0)   # clear start area
    cm[15:23, 22:29] = 0                                   # clear goal area
    return cm


def build(device=None, small=False):
    """The script's costmap, config, params, TDMs, planner (set up) on
    ``device`` (default: the card) and ground-truth grid."""
    cm = make_costmap()
    H, W = cm.shape
    res = 0.5
    K, M, T, steps = ex.sizes(small, 1024, 1, 4.0, 0.1, MAX_STEPS)
    cfg = Config(T=T, dt=0.1, num_grid_samples=M,
                 num_control_rollouts=K, max_speed_padding=2.0,
                 max_map_dim=(H + 4, W + 4), seed=0, use_costmap=True)
    lin_tdm, ang_tdm = TDM(cfg, device=device), TDM(cfg, device=device)
    costmap_dict = dict(costmap=cm, res=res, xlimits=(0.0, W * res),
                        ylimits=(0.0, H * res), costmap_lethal_threshold=100)
    lin_tdm.set_TDM_from_costmap(costmap_dict)
    ang_tdm.set_TDM_from_costmap(costmap_dict)

    params = dict(dt=cfg.dt, x0=np.array([2.0, 4.0, 0.5]),
                  xgoal=np.array([13.0, 9.5]), goal_tolerance=0.5,
                  v_post_rollout=0.5, cvar_alpha=1.0, alpha_dyn=1.0,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([1.5, 2.0]), vrange=np.array([0.0, 2.0]),
                  wrange=np.array([-np.pi, np.pi]),
                  obs_penalty=1e5, unknown_penalty=1e3)
    planner = MPPIPlanner(cfg, device=device)
    planner.setup(params, lin_tdm, ang_tdm)

    # Ground truth for simulation: full traction except lethal cells block.
    gt = np.ones((H, W), dtype=np.float32)
    gt[(cm > 100) & (cm != 255)] = 0.0
    grid = TractionGrid(gt, gt, res=res, xlimits=(0.0, W * res),
                        ylimits=(0.0, H * res))
    return types.SimpleNamespace(cfg=cfg, params=params, planner=planner,
                                 lin_tdm=lin_tdm, ang_tdm=ang_tdm,
                                 costmap=cm, res=res, truth=grid,
                                 max_steps=steps)


def plot(w, xhist, out_dir):
    plt = ex.pyplot()
    if plt is None:
        return []
    H, W = w.costmap.shape
    p = w.params
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(w.costmap, origin="lower", cmap="Reds",
              extent=(0, W * w.res, 0, H * w.res), alpha=0.8)
    ax.plot(xhist[:, 0], xhist[:, 1], "b.-", ms=3, label="trajectory")
    ax.plot(*p["x0"][:2], "go", ms=9, label="start")
    ax.plot(*p["xgoal"], "r*", ms=14, label="goal")
    ax.legend(loc="upper left")
    ax.set_title("Costmap planning: lethal walls (dark), unknown (255)")
    path = ex.out_path(out_dir, EXAMPLE + ".png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return [path]


def main(argv=None):
    args = ex.parser(__doc__).parse_args(argv)
    device, _ = start(args)
    w = build(device, args.small)
    planner = w.planner
    ex.describe(EXAMPLE, None, planner)
    before = launch_counts()
    timed = ex.TimedPlanner(planner)
    logger = trial(timed, w.truth, w.cfg.dt, max_steps=w.max_steps,
                   mppi_params=w.params, return_history=True)
    xhist = logger.pop("xhist")
    logger["steps"] = len(logger.pop("uhist"))
    rollouts = planner.get_state_rollout()
    figures = plot(w, xhist, args.out_dir)
    ex.report(EXAMPLE, None, planner, timed, logger, before, device,
              vis_shape=list(rollouts.shape), figures=figures,
              **ex.final(xhist, w.truth))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
