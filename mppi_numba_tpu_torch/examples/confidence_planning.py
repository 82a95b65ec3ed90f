"""Risk-aware planning on a learned traction model with an unfamiliar-terrain
confidence mask; the port's counterpart of
``examples/confidence_planning.py``.

A traversability model gives per-cell int8 PMF grids over linear and
angular traction and a normalized detector confidence per cell.  Cells
whose confidence falls below ``conf_thres`` (and never-observed cells) are
marked unknown and penalized in the rollouts.  The closed loop runs
through ``sim.trial``, up to 400 steps, on one realization of the
ground-truth PMF grids, from the lowest-corner traversable cell to a
reachable one about 25 m of path away (a breadth-first search over
8-connected cells of mean traction above 0.5 that are not unknown).  K =
1024, M = 64, T = 60.

The maps: the reference's ``tdm_models`` tree (the ``predicted`` and
``ground_truth`` ``tdm_info.pickle`` files, trusted input) when
``tdm_models_dir`` names one, else the script's synthetic 60x40 map with
the same structure (12 bins, a swamp band, a random confidence field).

    python -m mppi_numba_tpu_torch.examples.confidence_planning [conf_thres] [tdm_models_dir] [--gif | --gt-nn] [--device cpu] [--small]

``--gif`` renders the episode as ``conf_thres=<t>_trained_nn.gif`` (a
frame every two steps with the planned rollouts) and ``--gt-nn`` plans on
the in-domain model (the ground-truth PMFs, no confidence mask) and
renders ``gt_nn.gif`` over the map's semantic colour image, which only
the real tree has; without matplotlib both run the episode and draw
nothing.  Otherwise the mean traction and the unknown mask with the
trajectory go to ``confidence_planning.png``.  Every figure goes to
``--out-dir``.

Prints the card line, then JSON lines: the unknown share, the start and
goal, the solver's shape and layout, and the outcome (``sim.trial``'s
dict and the steps) with the solve times, the kernel launches and the
graphs.
"""

from __future__ import annotations

import os
import pickle
import types

import numpy as np

from .. import (Config, MPPIPlanner, TDM, sample_realization_from_pmf_grid,
                trial, unknown_mask_from_confidence)
from ..drivers._common import emit, launch_counts, start
from . import _common as ex

EXAMPLE = "confidence_planning"
MAX_STEPS = 400
GIF_STRIDE = 2


def load_real_tdm(models_dir, gt_name="wp_forest1",
                  pred_name="fells_nn_predicts_wp_forest1"):
    """Load (predicted, ground-truth) tdm_info dicts from a tdm_models tree
    (the reference's own pickles)."""
    def load(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    pred = load(os.path.join(models_dir, "predicted", pred_name,
                             "tdm_info.pickle"))
    gt = load(os.path.join(models_dir, "ground_truth", gt_name,
                           "tdm_info.pickle"))
    return pred, gt


def synth_tdm(rows=60, cols=40, num_bins=12, seed=0):
    """Synthetic stand-in with the tdm_info.pickle schema."""
    rng = np.random.RandomState(seed)
    bin_values = np.linspace(0.0, 1.0, num_bins)
    pmf = np.zeros((num_bins, rows, cols), dtype=np.int64)
    pmf[num_bins - 2] = 60
    pmf[num_bins - 1] = 40
    swamp = (slice(rows // 3, rows // 2), slice(None))
    pmf[:, swamp[0], :] = 0
    pmf[1, swamp[0], :] = 50
    pmf[num_bins - 2, swamp[0], :] = 50
    conf = np.clip(rng.normal(0.8, 0.3, size=(rows, cols)), -1, 1)
    info = dict(
        xlimits=np.array([0.0, cols * 0.5]),
        ylimits=np.array([0.0, rows * 0.5]), res=0.5,
        bin_values=bin_values,
        bin_values_bounds=np.array([0.0, 1.0]),
        height=rows, width=cols,
        lin_pmf_grid=pmf, ang_pmf_grid=pmf,
        normalized_confidence=conf,
        unknown_colors_mask=np.zeros((rows, cols), dtype=np.int64))
    return info, info


def start_and_goal(gt, unknown, res):
    """The script's start and goal cells ``((row, col), (row, col))``: the
    lowest-corner cell of mean ground-truth traction above 0.5 that is not
    unknown, and the farthest (straight-line) of the cells ``min(25 m /
    res, the largest)`` 8-connected steps of such cells from it."""
    bv = np.asarray(gt["bin_values"], dtype=float)
    mean_tr = (np.asarray(gt["lin_pmf_grid"]) / 100.0
               * bv[:, None, None]).sum(0)
    good = (mean_tr > 0.5) & (unknown == 0)
    ys, xs = np.nonzero(good)
    if len(ys) <= 1:
        raise ValueError("no traversable cells")
    start = (ys[np.argmin(ys + xs)], xs[np.argmin(ys + xs)])
    dist = np.full(good.shape, -1, dtype=int)
    dist[start] = 0
    frontier = [start]
    while frontier:
        nxt = []
        for (r, c) in frontier:
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    rr, cc = r + dr, c + dc
                    if (0 <= rr < good.shape[0] and 0 <= cc < good.shape[1]
                            and good[rr, cc] and dist[rr, cc] < 0):
                        dist[rr, cc] = dist[r, c] + 1
                        nxt.append((rr, cc))
        frontier = nxt
    target = min(int(25.0 / res), dist.max())
    gys, gxs = np.nonzero(dist == target)
    gi = np.argmax((gys - start[0]) ** 2 + (gxs - start[1]) ** 2)
    return start, (gys[gi], gxs[gi])


def build(conf_thres=0.3, models_dir=None, gt_nn=False, device=None,
          small=False):
    """The script's maps, unknown mask, config, TDMs, ground truth, start
    and goal, params and planner (set up) on ``device`` (default: the
    card), in its order of draws."""
    if models_dir is not None and os.path.isdir(models_dir):
        pred, gt = load_real_tdm(models_dir)
        source = models_dir
    else:
        pred, gt = synth_tdm()
        source = "synthetic"
    if gt_nn:
        # In-domain: no cross-domain confidence mask to threshold; only
        # never-observed cells stay unknown.
        pred = gt
        conf_thres = -1.0

    res = float(pred["res"])
    H, W = pred["lin_pmf_grid"].shape[1:]
    xlimits = tuple(np.asarray(pred["xlimits"], dtype=float))
    ylimits = tuple(np.asarray(pred["ylimits"], dtype=float))
    unknown = unknown_mask_from_confidence(
        pred["normalized_confidence"], conf_thres,
        pred.get("unknown_colors_mask"))

    max_speed = 2.0
    pad = int(np.ceil(max_speed * 0.1 / res))
    K, M, T, steps = ex.sizes(small, 1024, 64, 6.0, 0.1, MAX_STEPS)
    cfg = Config(T=T, dt=0.1, num_grid_samples=M,
                 num_control_rollouts=K, max_speed_padding=max_speed,
                 num_vis_state_rollouts=20,
                 max_map_dim=(H + 2 * pad + 2, W + 2 * pad + 2), seed=0,
                 use_tdm=True)

    tdm_dict = dict(res=res, xlimits=xlimits, ylimits=ylimits,
                    bin_values=np.asarray(pred["bin_values"]),
                    bin_values_bounds=np.asarray(pred["bin_values_bounds"]),
                    det_dynamics_cvar_alpha=1.0)
    lin_tdm, ang_tdm = TDM(cfg, device=device), TDM(cfg, device=device)
    lin_tdm.set_TDM_from_PMF_grid(np.asarray(pred["lin_pmf_grid"], np.int8),
                                  tdm_dict, unknown_map=unknown)
    ang_tdm.set_TDM_from_PMF_grid(np.asarray(pred["ang_pmf_grid"], np.int8),
                                  tdm_dict, unknown_map=unknown)

    # Ground truth for the simulator: one realization from the GT PMFs.
    rng = np.random.RandomState(1)
    gt_grid = sample_realization_from_pmf_grid(
        gt["lin_pmf_grid"], gt["ang_pmf_grid"], gt["bin_values"], rng,
        res=res, xlimits=xlimits, ylimits=ylimits)

    start_cell, goal_cell = start_and_goal(gt, unknown, res)

    def cell_xy(rc):
        return (xlimits[0] + (rc[1] + 0.5) * res,
                ylimits[0] + (rc[0] + 0.5) * res)

    sx, sy = cell_xy(start_cell)
    gx, gy = cell_xy(goal_cell)
    x0 = np.array([sx, sy, np.arctan2(gy - sy, gx - sx)])
    xgoal = np.array([gx, gy])
    params = dict(dt=cfg.dt, x0=x0, xgoal=xgoal, goal_tolerance=1.0,
                  v_post_rollout=0.01, cvar_alpha=0.5, alpha_dyn=1.0,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([1.5, 2.0]),
                  vrange=np.array([0.0, max_speed]),
                  wrange=np.array([-np.pi, np.pi]),
                  # Soft unknown cost: on a cross-domain prediction the
                  # detector flags ~half the traversable ground unfamiliar,
                  # so unknown cells must stay passable-at-a-price.
                  obs_penalty=1e5, unknown_penalty=2.0)
    planner = MPPIPlanner(cfg, device=device)
    planner.setup(params, lin_tdm, ang_tdm)
    return types.SimpleNamespace(
        cfg=cfg, params=params, planner=planner, lin_tdm=lin_tdm,
        ang_tdm=ang_tdm, pred=pred, gt=gt, unknown=unknown, truth=gt_grid,
        conf_thres=conf_thres, source=source, xlimits=xlimits,
        ylimits=ylimits, max_steps=steps)


def _pred_mean_extent(pred, xlimits, ylimits):
    """Mean predicted linear traction + imshow extent."""
    pred_mean = (np.asarray(pred["lin_pmf_grid"]) / 100.0
                 * np.asarray(pred["bin_values"],
                              dtype=float)[:, None, None]).sum(0)
    return pred_mean, [xlimits[0], xlimits[1], ylimits[0], ylimits[1]]


def _draw_unknown_overlay(ax, pred_mean, unknown, extent):
    """Gray traction background with the unfamiliar-cell mask shaded."""
    ax.imshow(pred_mean, origin="lower", extent=extent, cmap="gray",
              alpha=0.8)
    ax.imshow(np.ma.masked_where(unknown == 0, unknown), origin="lower",
              extent=extent, cmap="autumn", alpha=0.5)


def plot_static(plt, w, xhist, out_dir):
    """Mean predicted traction, the unknown mask and the trajectory."""
    p = w.params
    pred_mean, extent = _pred_mean_extent(w.pred, w.xlimits, w.ylimits)
    fig, axes = plt.subplots(1, 2, figsize=(11, 6))
    im = axes[0].imshow(pred_mean, origin="lower", extent=extent,
                        cmap="viridis", alpha=0.9)
    axes[0].set_title("predicted mean linear traction")
    _draw_unknown_overlay(axes[1], pred_mean, w.unknown, extent)
    axes[1].set_title("unknown (confidence < {})".format(w.conf_thres))
    for ax in axes:
        ax.plot(xhist[:, 0], xhist[:, 1], "c-", lw=2, label="trajectory")
        ax.plot(*p["x0"][:2], "go", ms=9, label="start")
        ax.plot(*p["xgoal"], "r*", ms=14, label="goal")
        ax.legend(loc="lower right", fontsize=8)
    fig.colorbar(im, ax=axes[1], shrink=0.7)
    path = ex.out_path(out_dir, EXAMPLE + ".png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_gif(plt, w, frames, out_dir):
    """The episode's frames over the unknown overlay
    (``conf_thres=<t>_trained_nn.gif``)."""
    from matplotlib import animation

    p = w.params
    pred_mean, extent = _pred_mean_extent(w.pred, w.xlimits, w.ylimits)
    fig, ax = plt.subplots(figsize=(8, 6))
    _draw_unknown_overlay(ax, pred_mean, w.unknown, extent)
    ax.plot(*p["x0"][:2], "go", ms=9)
    ax.plot(*p["xgoal"], "r*", ms=14)
    ax.add_patch(plt.Circle(tuple(p["xgoal"]), p["goal_tolerance"],
                            color="r", fill=False))
    ax.set_title("conf_thres={} (unfamiliar cells shaded)".format(
        w.conf_thres))
    traj_line, = ax.plot([], [], "c-", lw=2)
    roll_lines = [ax.plot([], [], "b", alpha=0.15, lw=1)[0]
                  for _ in range(frames[0][1].shape[0])]

    def update(i):
        traj, rollouts = frames[i]
        traj_line.set_data(traj[:, 0], traj[:, 1])
        for line, states in zip(roll_lines, rollouts):
            line.set_data(states[:, 0], states[:, 1])
        return [traj_line] + roll_lines

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   interval=100, blit=True)
    path = ex.out_path(out_dir,
                       "conf_thres={}_trained_nn.gif".format(w.conf_thres))
    anim.save(path, writer=animation.PillowWriter(fps=10))
    plt.close(fig)
    return path


def plot_gt_nn(plt, w, frames, out_dir):
    """The episode over the map's semantic colour image, reference-styled
    (``gt_nn.gif``)."""
    from ..visualization import render_episode_gif

    id2rgb = w.gt["id2rgb_map"]
    idx = np.asarray(w.gt["color_indices"])
    rgb = np.zeros(idx.shape + (3,), dtype=float)
    for cid, col in id2rgb.items():
        rgb[idx == cid] = np.asarray(col, dtype=float)[:3]
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    p = w.params
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(rgb, origin="lower", extent=[w.xlimits[0], w.xlimits[1],
                                           w.ylimits[0], w.ylimits[1]])
    ax.set_aspect("equal", adjustable="box")
    return render_episode_gif(
        fig, ax, frames, p["x0"], p["xgoal"], p["goal_tolerance"], w.cfg.dt,
        ex.out_path(out_dir, "gt_nn.gif"), steps_per_frame=GIF_STRIDE,
        past_color="w", caption="NN trained in this env.",
        legend_anchor=(1.0, 1.0), legend_loc="upper right")


def main(argv=None):
    ap = ex.parser(__doc__)
    ap.add_argument("conf_thres", nargs="?", type=float, default=0.3)
    ap.add_argument("tdm_models_dir", nargs="?", default=None,
                    help="a tdm_models tree (default: the synthetic map)")
    figure = ap.add_mutually_exclusive_group()
    figure.add_argument("--gif", action="store_true")
    figure.add_argument("--gt-nn", action="store_true")
    args = ap.parse_args(argv)
    device, _ = start(args)
    w = build(args.conf_thres, args.tdm_models_dir, args.gt_nn, device,
              args.small)
    p = w.params
    emit(ex.jsonable(dict(
        example=EXAMPLE, maps=w.source, conf_thres=w.conf_thres,
        unknown_share=float(w.unknown.mean()), x0=p["x0"],
        xgoal=p["xgoal"],
        start_goal_m=float(np.hypot(*(p["xgoal"] - p["x0"][:2]))))))
    planner = w.planner
    mode = "gt_nn" if args.gt_nn else "gif" if args.gif else None
    ex.describe(EXAMPLE, mode, planner)
    plt = ex.pyplot() if mode else None
    if args.gt_nn and plt is not None and "id2rgb_map" not in w.gt:
        raise ValueError("--gt-nn renders over the semantic colour image "
                         "of a tdm_models tree; the synthetic map has none")
    frames = []

    def capture(t, xhist_prefix):
        if t % GIF_STRIDE == 0:
            frames.append((xhist_prefix.copy(), planner.get_state_rollout()))

    before = launch_counts()
    timed = ex.TimedPlanner(planner)
    logger = trial(timed, w.truth, w.cfg.dt, max_steps=w.max_steps,
                   mppi_params=p, return_history=True,
                   on_step=capture if plt is not None else None)
    xhist = logger.pop("xhist")
    logger["steps"] = len(logger.pop("uhist"))
    rollouts = planner.get_state_rollout()
    figures = []
    if mode is None:
        plt = ex.pyplot()
        if plt is not None:
            figures.append(plot_static(plt, w, xhist, args.out_dir))
    elif plt is not None:
        frames.append((xhist, rollouts))
        draw = plot_gt_nn if args.gt_nn else plot_gif
        figures.append(draw(plt, w, frames, args.out_dir))
    ex.report(EXAMPLE, mode, planner, timed, logger, before, device,
              vis_shape=list(rollouts.shape), figures=figures,
              **ex.final(xhist, w.truth))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
