"""Visualization of traction distribution maps and densities (matplotlib,
host numpy).

API parity with the reference visualizer
(reference: mppi_numba/visualization.py) and the JAX package's
``visualization.py``: ``TDMVisualizer(tdm).draw(...)`` renders the padded
semantic grid of the port's ``TDM`` (its host fields: the semantic grid,
limits, padding and the padded shape) as colored cells (the padding ring
as a synthetic black "Padding" class), ``render_episode_gif`` animates a
closed-loop episode from ``sim.trial``'s ``on_step`` hook and
``MPPIPlanner.get_state_rollout()`` (host arrays), and ``vis_density`` /
``vis_density_as_pmf`` plot a ``Density`` and its PMF discretization.
Importing this module imports matplotlib; the package does not import it.
"""

from __future__ import annotations

import copy

import numpy as np

import matplotlib.pyplot as plt
from matplotlib.collections import LineCollection, PolyCollection


class TDMVisualizer:
    """Visualizer for a traction distribution map."""

    PREFERRED_MAX_FIG_WIDTH = 12
    PREFERRED_MAX_FIG_HEIGHT = 8

    def __init__(self, tdm, tdm_contains_semantic_grid=True):
        # Honor the TDM's actual state, not just the caller's flag: a TDM
        # built via set_TDM_from_PMF_grid has no semantic grid (id2name is
        # None) and must fall back to base-grid rendering.
        if tdm_contains_semantic_grid and tdm.semantic_grid_initialized:
            self.semantic_grid_initialized = True
            self.id2name = copy.deepcopy(tdm.id2name)
            self.id2rgb = {sid: tdm.id2terrain_fn(sid).rgb
                           for sid in self.id2name}
            # Padding ring rendered as its own class.
            self.id2name[-1] = "Padding"
            self.id2rgb[-1] = (0, 0, 0)
        else:
            self.semantic_grid_initialized = False
            self.id2rgb = None

        self.cell_dimensions = tdm.cell_dimensions
        self.xlimits = copy.deepcopy(tdm.padded_xlimits)
        self.ylimits = copy.deepcopy(tdm.padded_ylimits)
        self.pad_width = tdm.pad_cells

        dims = tdm.get_padded_grid_xy_dim()
        assert dims is not None, "Cannot get padded grid dimension from TDM."
        self.num_rows, self.num_cols = dims

        if tdm_contains_semantic_grid and self.semantic_grid_initialized:
            padded = -1 * np.ones((self.num_rows, self.num_cols), dtype=int)
            inner = tdm.semantic_grid[:self.num_rows - 2 * self.pad_width,
                                      :self.num_cols - 2 * self.pad_width]
            padded[self.pad_width:self.pad_width + inner.shape[0],
                   self.pad_width:self.pad_width + inner.shape[1]] = inner
            self.semantic_grid = padded

    # -- drawing --------------------------------------------------------------

    def calc_auto_figsize(self, xlimits, ylimits):
        (minx, maxx), (miny, maxy) = xlimits, ylimits
        width, height = maxx - minx, maxy - miny
        if width > height:
            return (self.PREFERRED_MAX_FIG_WIDTH,
                    height * self.PREFERRED_MAX_FIG_WIDTH / width)
        return (width * self.PREFERRED_MAX_FIG_HEIGHT / height,
                self.PREFERRED_MAX_FIG_HEIGHT)

    def draw(self, figsize=None, ax=None, semantic_grid=None, id2rgb_map=None):
        """Draw the padded semantic map; returns (fig, ax)."""
        if (not self.semantic_grid_initialized) and (
                semantic_grid is None or id2rgb_map is None):
            print("Semantic grid not initialized. Cannot invoke draw() function")
            return None

        if figsize is None:
            figsize = self.calc_auto_figsize(self.xlimits, self.ylimits)
        fig, ax = self.draw_base_grid(figsize, ax=ax)

        if self.semantic_grid_initialized:
            grid, colors = self.semantic_grid, self.id2rgb
        else:
            grid = -1 * np.ones((self.num_rows, self.num_cols), dtype=int)
            inner = np.asarray(semantic_grid)[
                :self.num_rows - 2 * self.pad_width,
                :self.num_cols - 2 * self.pad_width]
            grid[self.pad_width:self.pad_width + inner.shape[0],
                 self.pad_width:self.pad_width + inner.shape[1]] = inner
            colors = dict(id2rgb_map)
            colors.setdefault(-1, (0, 0, 0))
        self.draw_semantic_patches(ax, grid, colors)
        return fig, ax

    def draw_base_grid(self, figsize, ax=None):
        minx, _ = self.xlimits
        miny, _ = self.ylimits
        w, h = self.cell_dimensions
        xs = minx + w * np.arange(self.num_cols + 1)
        ys = miny + h * np.arange(self.num_rows + 1)
        hlines = [[(xs[0], y), (xs[-1], y)] for y in ys]
        vlines = [[(x, ys[0]), (x, ys[-1])] for x in xs]
        lc = LineCollection(hlines + vlines, color="black", linewidths=0.5,
                            alpha=0.5)
        if ax is None:
            fig, ax = plt.subplots(figsize=figsize)
        else:
            fig = plt.gcf()
        ax.add_collection(lc)
        ax.set_xlim(xs[0] - 1, xs[-1] + 1)
        ax.set_ylim(ys[0] - 1, ys[-1] + 1)
        ax.set_aspect("equal", adjustable="box")
        ax.axis("off")
        return fig, ax

    def cell_xy(self, ix, iy):
        """Center of cell (ix, iy) in world coordinates."""
        w, h = self.cell_dimensions
        return self.xlimits[0] + (ix + 0.5) * w, self.ylimits[0] + (iy + 0.5) * h

    def cell_verts(self, ix, iy):
        w, h = self.cell_dimensions
        x, y = self.cell_xy(ix, iy)
        return [(x + ox * 0.5 * w, y + oy * 0.5 * h)
                for ox, oy in [(-1, -1), (-1, 1), (1, 1), (1, -1)]]

    def draw_semantic_patches(self, ax, grid, id2rgb):
        verts = [self.cell_verts(ix, iy)
                 for iy in range(grid.shape[0]) for ix in range(grid.shape[1])]
        facecolors = [id2rgb[sid] for sid in grid.reshape(-1)]
        ax.add_collection(PolyCollection(verts, facecolors=facecolors))


# Backwards-compatible alias matching the reference class name.
TDM_Visualizer = TDMVisualizer


def render_episode_gif(fig, ax, frames, x0, xgoal, goal_tolerance, dt, out,
                       steps_per_frame=1, fps=10, caption=None,
                       past_color="k", fontsize=15, rollout_ends=True,
                       legend_anchor=(1.02, -0.02), legend_loc="lower right"):
    """Reference-styled closed-loop episode animation.

    Matches the committed media of the reference's
    ``planner_example_vis_gif.ipynb[cell 7]`` (example_gifs/
    planner_example_vis.gif, gt_nn.gif): open-circle Start, filled
    Curr. State, open red Goal circle, a Past-States line, blue
    predicted-state rollouts with red endpoints, and a ``t=..s`` title.

    Args:
      fig, ax: background axes (e.g. ``TDMVisualizer(tdm).draw(...)`` or an
        imshow of a real-world map).
      frames: list of ``(xhist_prefix (n, 3), rollouts (R, T, 3))`` per
        rendered step — exactly what ``sim.trial``'s ``on_step`` hook plus
        ``planner.get_state_rollout()`` produce.
      x0 / xgoal / goal_tolerance / dt: episode task (title timestamps are
        ``frame_index * steps_per_frame * dt``).
      out: output .gif path.
      caption: optional extra in-axes text (the reference's gt_nn.gif
        stamps "NN trained in this env.").
    """
    from matplotlib import animation

    # The legend dummy markers live at +-1e6; freeze the background's view
    # so they cannot autoscale the axes.
    xlim, ylim = ax.get_xlim(), ax.get_ylim()
    ax.set_autoscale_on(False)

    l_start, = ax.plot([x0[0]], [x0[1]], "o", color=past_color, ms=10,
                       markeredgewidth=3, markerfacecolor="none",
                       label="Start")
    l_curr, = ax.plot([x0[0]], [x0[1]], "o", color=past_color, ms=10,
                      label="Curr. State", zorder=5)
    ax.add_patch(plt.Circle(tuple(xgoal), goal_tolerance, color="r",
                            linewidth=3, fill=False, zorder=6))
    ax.plot([xgoal[0] - 1e6], [xgoal[1] - 1e6], "ro", ms=10,
            markeredgewidth=3, markerfacecolor="none", label="Goal",
            zorder=6)
    l_past, = ax.plot([], [], color=past_color, linewidth=3,
                      label="Past States")
    num_rollouts = frames[0][1].shape[0]
    l_rollouts = [ax.plot([], [], "b", lw=2, alpha=0.8, zorder=3)[0]
                  for _ in range(num_rollouts)]
    l_ends, = ax.plot([], [], "r.", alpha=0.8, ms=12, zorder=4)
    ax.plot([1e6], [1e6], "b-", label="Predicted States\nGiven Optimal Control")
    title = ax.set_title("t=0.0s", fontsize=fontsize, x=0.5, y=0.95)
    if caption:
        ax.text(0.55, 0.06, caption, transform=ax.transAxes, color="w",
                fontsize=fontsize - 2, ha="center",
                bbox=dict(facecolor="black", alpha=0.4, edgecolor="none"))
    ax.legend(ncol=2, fontsize=fontsize - 1, bbox_to_anchor=legend_anchor,
              loc=legend_loc)
    ax.set_xlim(xlim)
    ax.set_ylim(ylim)

    def update(i):
        traj, rollouts = frames[i]
        l_past.set_data(traj[:, 0], traj[:, 1])
        l_curr.set_data([traj[-1, 0]], [traj[-1, 1]])
        for line, states in zip(l_rollouts, rollouts):
            line.set_data(states[:, 0], states[:, 1])
        if rollout_ends:
            l_ends.set_data(rollouts[:, -1, 0], rollouts[:, -1, 1])
        title.set_text("t={:.1f}s".format(i * steps_per_frame * dt))
        return [l_past, l_curr, l_ends, title] + l_rollouts

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   interval=1000 // fps, blit=False)
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out


def vis_density(ax, density, terrain, vis_cvar_alpha=0.3, show_cvar=False,
                color="b", show_legend=True, title=None, hist_alpha=0.5,
                fontsize=12):
    """Histogram of a Density with optional CVaR threshold marker."""
    cvar, thres = density.cvar(alpha=vis_cvar_alpha)
    samples = density._saved_samples()
    ax.hist(samples, bins=100, density=True, color=color, alpha=hist_alpha,
            label=terrain.name)
    if show_cvar:
        ax.plot([thres, thres], [0, 5], "k--",
                label="{}-th Percentile".format(int(vis_cvar_alpha * 100.0)),
                linewidth=2)
    if density.sample_bounds is not None:
        ax.set_xlim(density.sample_bounds)
    if title is not None:
        ax.set_title(title, fontsize=fontsize)
    ax.set_xlabel("Traction", fontsize=fontsize)
    ax.set_ylabel("Density", fontsize=fontsize)
    if show_legend:
        ax.legend(fontsize=fontsize)
    return ax


def vis_density_as_pmf(ax, density, terrain, num_bins, include_min_max=True,
                       color="b", title=None, hist_alpha=0.5):
    """Stem plot of the PMF discretization of a Density."""
    values, pmf = density.get_pmf(num_bins=num_bins,
                                  include_min_max=include_min_max)
    markerline, stemlines, baseline = ax.stem(values, pmf, label=terrain.name)
    markerline.set_color(color)
    stemlines.set_color(color)
    baseline.set_color("r")
    if density.pmf_bounds is not None:
        ax.set_xlim(density.pmf_bounds)
    if title is not None:
        ax.set_title(title)
    ax.set_xlabel("Traction")
    ax.set_ylabel("PMF")
    ax.legend()
    return ax
