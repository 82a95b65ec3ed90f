"""Benchmark result plotting: success-rate curves and time-to-goal
distributions, reproducing the reference's paper-figure layout
(reference: benchmark_vis.ipynb[cells 8-10]), on the rows of
``benchmark.run_trials`` / ``run_trials_device`` as a pandas DataFrame
(the JAX package's ``benchmark_vis.py``).  Importing this module imports
matplotlib; the package does not import it.
"""

from __future__ import annotations

import numpy as np
import matplotlib.pyplot as plt

METHOD2RGB = {
    "noisy_dyn": "tab:red",
    "risk_dyn": "tab:green",
    "nom_dyn_risk_cost": "tab:blue",
    "baseline": "k",
}

METHOD2LABEL = {
    "noisy_dyn": "Stochastic Traction (Proposed)\nCVaR(alpha) of Objective",
    "risk_dyn": "Deterministic Traction\nCVaR(alpha) of Traction",
    "nom_dyn_risk_cost": "Nominal Traction\nTime Cost Adjusted by CVaR",
    "baseline": "Nominal Dynamics",
}


def collect_metric_by_alpha(df, column_name, method, alpha_list,
                            grass_density=None, successes_only=True):
    """Per-alpha value lists of one metric for one method."""
    mask = df["method"] == method
    if grass_density is not None:
        mask &= df["grass_density"] == grass_density
    if successes_only:
        mask &= df["success"].astype(bool)
    out = []
    for alpha in alpha_list:
        vals = df[mask & (df["alpha"] == alpha)][column_name].to_numpy()
        out.append(vals[np.isfinite(vals.astype(float))])
    return out


def success_rate_by_alpha(df, method, alpha_list, grass_density=None):
    mask = df["method"] == method
    if grass_density is not None:
        mask &= df["grass_density"] == grass_density
    return [df[mask & (df["alpha"] == alpha)]["success"].mean()
            for alpha in alpha_list]


def _grouped_positions(n_ticks, n_algs, group_length=2.0,
                       space_between_group=0.3, space_between_box=0.1):
    tick_group_width = group_length - space_between_group
    width = (tick_group_width - space_between_box * (n_algs - 1)) / n_algs
    pos = {}
    for idx in range(n_algs):
        offset = -tick_group_width / 2.0 + (width + space_between_box) * (idx + 0.5)
        pos[idx] = np.arange(n_ticks) * group_length + offset
    return pos, width


def make_violinplot(data, tick_labels, alg_names, colors, group_length=2.0,
                    space_between_group=0.3, space_between_box=0.1,
                    use_dividing_line=True, xlabel=None, ylabel=None,
                    title=None, alg2legends=None, ax=None, show_legend=True,
                    fontsize=10):
    """Grouped violins: data[alg] is a list (one array per tick)."""
    if ax is None:
        _, ax = plt.subplots()
    pos, width = _grouped_positions(len(tick_labels), len(alg_names),
                                    group_length, space_between_group,
                                    space_between_box)
    if use_dividing_line:
        for xpos in np.arange(len(tick_labels)) * group_length + group_length / 2.0:
            ax.axvline(xpos, color="gray", linestyle="--", alpha=0.5)

    for idx, alg in enumerate(alg_names):
        # violinplot chokes on empty groups; substitute NaN singleton
        groups = [g if len(g) else np.array([np.nan]) for g in data[alg]]
        bp = ax.violinplot(groups, positions=pos[idx], widths=width,
                           showmeans=False, showextrema=False)
        for body in bp["bodies"]:
            body.set_facecolor(colors[alg])
            body.set_edgecolor(colors[alg])
        label = alg2legends[alg] if alg2legends else alg
        ax.plot([], c=colors[alg], label=label)
    if show_legend:
        ax.legend(fontsize=fontsize)
    ax.set_xticks(np.arange(len(tick_labels)) * group_length)
    ax.set_xticklabels(tick_labels)
    ax.set_xlim(-0.5 * group_length,
                len(tick_labels) * group_length - 0.5 * group_length)
    if xlabel:
        ax.set_xlabel(xlabel, fontsize=fontsize)
    if ylabel:
        ax.set_ylabel(ylabel, fontsize=fontsize)
    if title:
        ax.set_title(title, fontsize=fontsize)
    return ax


def make_boxplot(data, tick_labels, alg_names, colors, **kwargs):
    """Grouped boxplots with the same conventions as make_violinplot."""
    ax = kwargs.pop("ax", None)
    if ax is None:
        _, ax = plt.subplots()
    fontsize = kwargs.pop("fontsize", 10)
    alg2legends = kwargs.pop("alg2legends", None)
    pos, width = _grouped_positions(len(tick_labels), len(alg_names))
    for idx, alg in enumerate(alg_names):
        groups = [g if len(g) else np.array([np.nan]) for g in data[alg]]
        bp = ax.boxplot(groups, positions=pos[idx], sym="", widths=width)
        for part in ("boxes", "whiskers", "caps", "medians"):
            plt.setp(bp[part], color=colors[alg])
        label = alg2legends[alg] if alg2legends else alg
        ax.plot([], c=colors[alg], label=label)
    ax.legend(fontsize=fontsize)
    ax.set_xticks(np.arange(len(tick_labels)) * 2.0)
    ax.set_xticklabels(tick_labels)
    return ax


def plot_joint_success_and_time(df, alpha_list, method_list=None,
                                method2label=None, method2rgb=None,
                                figsize=(13, 5), fontsize=14):
    """Two-panel paper figure: success rate vs alpha + time-to-goal violins
    (reference: benchmark_vis.ipynb[cell 10] ->
    plots/sim_benchmark_show_wayfast.png)."""
    method_list = method_list or sorted(df["method"].unique())
    method2label = method2label or METHOD2LABEL
    method2rgb = method2rgb or METHOD2RGB
    fig, axes = plt.subplots(1, 2, figsize=figsize)

    for method in method_list:
        rates = success_rate_by_alpha(df, method, alpha_list)
        axes[0].plot(alpha_list, rates, "o-", color=method2rgb[method],
                     label=method2label.get(method, method))
    axes[0].set_xlabel("alpha", fontsize=fontsize)
    axes[0].set_ylabel("Success rate", fontsize=fontsize)
    axes[0].set_ylim(0, 1.05)
    axes[0].legend(fontsize=fontsize * 0.6)

    data = {m: collect_metric_by_alpha(df, "time_to_goal", m, alpha_list)
            for m in method_list}
    make_violinplot(data, [str(a) for a in alpha_list], method_list,
                    method2rgb, xlabel="alpha", ylabel="Time to goal (s)",
                    alg2legends=method2label, ax=axes[1],
                    fontsize=fontsize * 0.6)
    return fig, axes
