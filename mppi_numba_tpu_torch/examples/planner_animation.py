"""Closed-loop planning animation on a fixed hand-written semantic map; the
port's counterpart of ``examples/planner_animation.py``.

A 12x6 world with a vegetation belt (the benchmark's Gaussian-mixture
terrain, ``RandomState(2)``), replanned every step at K = M = 1024 (M = 1
outside tdm), T = 80, for up to 150 steps, with the visualisation
rollouts of every solve (``get_state_rollout()``, replayed from the
planner's vis graph on a card) kept as the frames of an animated GIF.

    python -m mppi_numba_tpu_torch.examples.planner_animation [tdm|det|speed|example] [alpha] [--device cpu] [--small]

``alpha`` is the CVaR alpha of the objective in tdm mode and of the
dynamics in det and speed mode (default 0.4): the reference's GIF set
sweeps 0.4 and 1.0.  ``example`` is the reference notebook's own world
(``reference_example_grid``: 12 rows of 6 cells), task (x0 = (1, 1), the far
corner, CVaR alpha 0.8, u_std (2, 2)) and 150 steps without a stop at the
goal, T = 100, rendered reference-styled
(``visualization.render_episode_gif``).

Prints the card line, then JSON lines: the solver's shape and layout, and
the outcome (``success``, ``time_to_goal``, ``steps``) with the solve
times, each frame's ``get_state_rollout()`` time (``vis_ms``), the kernel
launches, the graphs and the frames.  The GIF goes to
``--out-dir`` (``planner_<mode>_cvar_{obj,dyn}_alpha_<alpha>.gif``, or
``planner_example_vis.gif``) where matplotlib imports.
"""

from __future__ import annotations

import time
import types

import numpy as np

from .. import Config, MPPIPlanner, TDM, make_benchmark_world
from ..drivers._common import launch_counts, start
from . import _common as ex

EXAMPLE = "planner_animation"
MODES = ("tdm", "det", "speed", "example")
MAX_STEPS = 150


def fixed_semantic_map():
    """A 12x6 map with a vegetation belt across the middle."""
    sg = np.zeros((6, 12), dtype=np.int8)
    sg[2:4, 2:10] = 1
    sg[1, 5:8] = 1
    sg[4, 4:6] = 1
    return sg


def reference_example_grid():
    """The exact 12x6 world of planner_example_vis_gif.ipynb[cell 3]."""
    sg = np.zeros((12, 6), dtype=np.int8)
    sg[2:5, 0:4] = 1
    sg[7:10, 3:6] = 1
    return sg


def build(mode="tdm", alpha=None, device=None, small=False):
    """The script's world, config, params, TDMs and planner (set up) on
    ``device`` (default: the card), and the ground truth drawn after the
    setup, in the script's order of draws.  ``alpha`` None is 0.4 (unused
    by ``example``)."""
    world = make_benchmark_world(num_bins=20, rng=np.random.RandomState(2))
    res = 1.0
    max_speed = 3.0
    if mode == "example":
        sg = reference_example_grid()
        H, W = sg.shape
        K, M, T, steps = ex.sizes(small, 1024, 1024, 10.0, 0.1, MAX_STEPS)
        cfg = Config(T=T, dt=0.1, num_grid_samples=M,
                     num_control_rollouts=K, max_speed_padding=5.0,
                     num_vis_state_rollouts=100, max_map_dim=(15, 15),
                     seed=1, use_tdm=True)
        x0 = np.array([1.0, 1.0, 0.0])
        xgoal = np.array([W - 1.0, H - 1.0])
        params = dict(dt=cfg.dt, x0=x0, xgoal=xgoal, goal_tolerance=1.0,
                      v_post_rollout=0.01, cvar_alpha=0.8, alpha_dyn=1.0,
                      dist_weight=1, lambda_weight=1.0, num_opt=1,
                      u_std=np.array([2.0, 2.0]),
                      vrange=np.array([0.0, max_speed]),
                      wrange=np.array([-np.pi, np.pi]))
        det_alpha = None
    else:
        sg = fixed_semantic_map()
        H, W = sg.shape
        K, M, T, steps = ex.sizes(small, 1024, 1024, 8.0, 0.1, MAX_STEPS)
        cfg = Config(T=T, dt=0.1, num_grid_samples=M,
                     num_control_rollouts=K,
                     max_speed_padding=max_speed + 2.0,
                     num_vis_state_rollouts=30 if mode == "tdm" else 1,
                     max_map_dim=(20, 26), seed=1,
                     use_tdm=mode == "tdm", use_det_dynamics=mode == "det",
                     use_nom_dynamics_with_speed_map=mode == "speed")
        if alpha is None:
            alpha = 0.4
        cvar_alpha = alpha if mode == "tdm" else 1.0
        alpha_dyn = 1.0 if mode == "tdm" else alpha
        x0 = np.array([0.5, 0.5, 0.0])
        xgoal = np.array([11.5, 5.5])
        params = dict(dt=cfg.dt, x0=x0, xgoal=xgoal, goal_tolerance=0.5,
                      v_post_rollout=0.01, cvar_alpha=cvar_alpha,
                      alpha_dyn=alpha_dyn, dist_weight=1, lambda_weight=1.0,
                      num_opt=1, u_std=np.array([2.0, 3.0]),
                      vrange=np.array([0.0, max_speed]),
                      wrange=np.array([-np.pi, np.pi]))
        det_alpha = None if mode == "tdm" else alpha_dyn

    lin_tdm, ang_tdm = TDM(cfg, device=device), TDM(cfg, device=device)
    for tdm, pmfs in ((lin_tdm, world["lin_terrain2pmf"]),
                      (ang_tdm, world["ang_terrain2pmf"])):
        tdm.set_TDM_from_semantic_grid(
            sg, res, world["num_pmf_bins"], world["bin_values"],
            world["bin_values_bounds"], (0, W * res), (0, H * res),
            world["id2name"], world["name2terrain"], pmfs,
            det_dynamics_cvar_alpha=det_alpha)

    planner = MPPIPlanner(cfg, device=device)
    planner.setup(params, lin_tdm, ang_tdm)
    truth = lin_tdm.sample_grids_true_dist()
    return types.SimpleNamespace(cfg=cfg, params=params, planner=planner,
                                 lin_tdm=lin_tdm, ang_tdm=ang_tdm,
                                 truth=truth, alpha=alpha, max_steps=steps)


def traction_step(truth, dt):
    """The script's step (its own order of the products)."""
    def step(x, u):
        lt, at = truth.get(x[0], x[1])
        return x + dt * np.array([lt * u[0] * np.cos(x[2]),
                                  lt * u[0] * np.sin(x[2]), at * u[1]])
    return step


def gif_name(mode, alpha):
    if mode == "example":
        return "planner_example_vis.gif"
    kind = "cvar_obj_alpha" if mode == "tdm" else "cvar_dyn_alpha"
    return "planner_{}_{}_{}.gif".format(mode, kind, alpha)


def plot(w, mode, frames, out_dir):
    plt = ex.pyplot()
    if plt is None:
        return []
    from matplotlib import animation

    from ..visualization import TDMVisualizer, render_episode_gif

    p = w.params
    path = ex.out_path(out_dir, gif_name(mode, w.alpha))
    if mode == "example":
        fig, ax = TDMVisualizer(w.lin_tdm).draw(figsize=(8, 8))
        return [render_episode_gif(fig, ax, frames, p["x0"], p["xgoal"],
                                   p["goal_tolerance"], w.cfg.dt, path)]
    fig, ax = TDMVisualizer(w.lin_tdm).draw(figsize=(8, 5))
    traj_line, = ax.plot([], [], "r", linewidth=2)
    roll_lines = [ax.plot([], [], "b", alpha=0.2)[0]
                  for _ in range(frames[0][1].shape[0])]
    ax.add_patch(plt.Circle(p["xgoal"], p["goal_tolerance"], color="r",
                            fill=False))

    def update(i):
        traj, rollouts = frames[i]
        traj_line.set_data(traj[:, 0], traj[:, 1])
        for line, states in zip(roll_lines, rollouts):
            line.set_data(states[:, 0], states[:, 1])
        return [traj_line] + roll_lines

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   interval=100, blit=True)
    anim.save(path, writer=animation.PillowWriter(fps=10))
    plt.close(fig)
    return [path]


def main(argv=None):
    ap = ex.parser(__doc__)
    ap.add_argument("mode", nargs="?", default="tdm", choices=MODES)
    ap.add_argument("alpha", nargs="?", type=float, default=None)
    args = ap.parse_args(argv)
    device, _ = start(args)
    w = build(args.mode, args.alpha, device, args.small)
    planner = w.planner
    ex.describe(EXAMPLE, args.mode, planner, alpha=w.alpha)
    frames, vis_ms = [], []

    def frame(t, states):
        t0 = time.perf_counter()
        rollouts = planner.get_state_rollout()
        vis_ms.append(1e3 * (time.perf_counter() - t0))
        frames.append((np.array(states), rollouts))

    before = launch_counts()
    timed = ex.TimedPlanner(planner)
    p = w.params
    states, _, outcome = ex.closed_loop(
        timed, traction_step(w.truth, w.cfg.dt), p["x0"], p["xgoal"],
        p["goal_tolerance"], w.cfg.dt, w.max_steps, on_step=frame,
        stop_at_goal=args.mode != "example")
    figures = plot(w, args.mode, frames, args.out_dir)
    ex.report(EXAMPLE, args.mode, planner, timed, outcome, before, device,
              alpha=w.alpha, frames=len(frames),
              vis_ms=dict(first=vis_ms[0], median=float(np.median(vis_ms)),
                          calls=len(vis_ms), clock=ex.clock(device)),
              vis_shape=list(frames[-1][1].shape), figures=figures,
              **ex.final(states, w.truth))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
