"""Every input of a cell, made from ``--seed`` on the host: a frozen copy of
the reference protocol's generator (mit-acl/mppi_numba, benchmark.ipynb
cells 2, 4 and 5).

* the world: each terrain's linear and angular traction densities, a
  Gaussian mixture truncated to its bounds by rejection, and the PMF that
  its histogram gives (``num_bins`` bins plus a pinned bin at each bound);
* a semantic grid: dirt along a ``mud_margin`` edge, vegetation inside with
  probability ``grass_density``;
* a ground-truth realization: every cell's tractions drawn from its
  terrain's densities;
* the closed-loop episodes: starts and goals ``start_goal_m`` apart.

Both the program and the plain reference are handed these arrays; neither
makes them.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np


def sub_seeds(seed, names):
    """Independent 32-bit seeds, one a name, from ``seed`` (any whole
    number that fits in 64 bits)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    kids = ss.spawn(len(names))
    return {n: int(k.generate_state(1)[0]) for n, k in zip(names, kids)}


def mixture_sample(rng, mix, bounds, num):
    """``num`` draws of a Gaussian mixture ``{"weights", "means", "stds"}``
    kept inside ``bounds`` by rejection (density.py's GaussianMixture)."""
    w = np.asarray(mix["weights"], float)
    mu = np.asarray(mix["means"], float)
    sd = np.asarray(mix["stds"], float)
    out = np.empty(num, float)
    filled = 0
    while filled < num:
        want = num - filled
        n = max(16, int(want * 1.5))
        idx = rng.choice(len(w), size=n, p=w)
        draws = rng.normal(loc=mu[idx], scale=sd[idx])
        ok = draws[(draws >= bounds[0]) & (draws <= bounds[1])]
        take = min(len(ok), want)
        out[filled:filled + take] = ok[:take]
        filled += take
    return out


def histogram_pmf(samples, bounds, num_bins):
    """``(values, pmf)``: the density histogram of ``samples`` over
    ``bounds`` in ``num_bins`` bins at their centres, with an empty bin
    pinned at each bound, normalised to sum to 1 (Density.get_pmf)."""
    nums, _ = np.histogram(samples, num_bins, range=tuple(bounds),
                           density=True)
    width = (bounds[1] - bounds[0]) / num_bins
    values = np.linspace(bounds[0], bounds[1], num_bins,
                         endpoint=False) + width / 2
    values = np.append(np.insert(values, 0, bounds[0]), bounds[1])
    nums = np.append(np.insert(nums, 0, 0), 0)
    return values, nums / np.sum(nums)


def make_world(spec, seed):
    """The world of ``spec`` (a configuration's ``"world"``): per terrain
    its PMFs, from ``pmf_samples`` draws of each density.  Returns a dict
    with ``terrains`` (name -> {"id", "lin", "ang": (values, pmf)}),
    ``bin_values``, ``bin_values_bounds`` and ``num_pmf_bins``."""
    rng = np.random.RandomState(seed)
    bounds = spec["bounds"]
    terrains = {}
    for t in spec["terrains"]:
        pm = {}
        for plane in ("lin", "ang"):
            s = mixture_sample(rng, t[plane], bounds, spec["pmf_samples"])
            pm[plane] = histogram_pmf(s, bounds, spec["num_bins"])
        terrains[t["name"]] = dict(id=t["id"], spec=t, **pm)
    values = next(iter(terrains.values()))["lin"][0]
    return dict(terrains=terrains, bin_values=values,
                bin_values_bounds=(float(np.min(values)),
                                   float(np.max(values))),
                num_pmf_bins=len(values))


def program_world(world):
    """The world in the form the program's TDM builders take it
    (``benchmark.make_benchmark_world``'s keys): each terrain is keyed by
    its name."""
    ts = world["terrains"]
    return dict(id2name={t["id"]: n for n, t in ts.items()},
                name2terrain={n: n for n in ts},
                lin_terrain2pmf={n: t["lin"] for n, t in ts.items()},
                ang_terrain2pmf={n: t["ang"] for n, t in ts.items()},
                bin_values=world["bin_values"],
                bin_values_bounds=world["bin_values_bounds"],
                num_pmf_bins=world["num_pmf_bins"])


def semantic_grid(shape, mud_margin, grass_density, rng):
    """Terrain ids ``(rows, cols)``: 0 (dirt) on the ``mud_margin`` edge,
    1 (vegetation) inside where a uniform draw is below
    ``grass_density`` (make_semantic_grid, dirt along the edge)."""
    g = np.zeros(shape, np.int8)
    m = mud_margin
    u = rng.rand(shape[0] - 2 * m, shape[1] - 2 * m)
    g[m:-m, m:-m][u < grass_density] = 1
    return g


def realization(world, grid, rng):
    """One ground truth: float64 ``(lin, ang)`` tractions of every cell,
    drawn from its terrain's densities (TDM.sample_grids_true_dist)."""
    lin = np.zeros(grid.shape)
    ang = np.zeros(grid.shape)
    bounds = world["bounds"]
    for t in sorted(world["terrains"].values(), key=lambda t: t["id"]):
        mask = grid == t["id"]
        n = int(mask.sum())
        if n:
            lin[mask] = mixture_sample(rng, t["spec"]["lin"], bounds, n)
            ang[mask] = mixture_sample(rng, t["spec"]["ang"], bounds, n)
    return lin, ang


def protocol(cfg, seed):
    """The protocol's paired episodes: one semantic grid a (density, env),
    ``trials_per_env`` realizations each, in the protocol's order.
    Returns ``(world, grids, rows)``: ``grids`` {(density_i, env_i):
    grid}; ``rows`` one dict an episode with its indices and its ground
    truth ``gt = (lin, ang)``."""
    s = sub_seeds(seed, ("world", "grids", "truth"))
    world = make_world(cfg["world"], s["world"])
    world["bounds"] = cfg["world"]["bounds"]
    p, g = cfg["protocol"], cfg["grid"]
    grid_rng = np.random.RandomState(s["grids"])
    truth_rng = np.random.RandomState(s["truth"])
    grids, rows = {}, []
    for di, density in enumerate(p["densities"]):
        for ei in range(p["envs_per_density"]):
            sg = semantic_grid(g["shape"], g["mud_margin"], density,
                               grid_rng)
            grids[(di, ei)] = sg
            for ti in range(p["trials_per_env"]):
                rows.append(dict(density_i=di, grass_density=density,
                                 env_i=ei, trial_i=ti,
                                 gt=realization(world, sg, truth_rng)))
    return world, grids, rows


def one_map(cfg, seed, robots, density=None):
    """One semantic grid of vegetation ``density`` (default: the
    configuration's ``grass_density``), and ``robots`` ground truths on
    it.  Returns ``(world, grid, truths)``."""
    s = sub_seeds(seed, ("world", "grids", "truth"))
    world = make_world(cfg["world"], s["world"])
    world["bounds"] = cfg["world"]["bounds"]
    g = cfg["grid"]
    if density is None:
        density = g["grass_density"]
    sg = semantic_grid(g["shape"], g["mud_margin"], density,
                       np.random.RandomState(s["grids"]))
    truth_rng = np.random.RandomState(s["truth"])
    return world, sg, [realization(world, sg, truth_rng)
                       for _ in range(robots)]


def start_goal(rng, shape, res, margin, dist_m):
    """A start ``(x, y, heading)`` at least ``margin`` metres inside the
    map and a goal ``dist_m`` = [lo, hi] metres from it in a uniform
    direction, clipped 2 m inside the map (serve_bench.episodes)."""
    H, W = shape
    x0 = np.array([rng.uniform(margin, W * res - margin),
                   rng.uniform(margin, H * res - margin),
                   rng.uniform(-math.pi, math.pi)])
    ang = rng.uniform(0, 2 * math.pi)
    d = rng.uniform(*dist_m)
    goal = np.array([np.clip(x0[0] + d * math.cos(ang), 2, W * res - 2),
                     np.clip(x0[1] + d * math.sin(ang), 2, H * res - 2)])
    return x0, goal


def simulate_step(x, u, lin_traction, ang_traction, dt):
    """The host's Euler unicycle step on realized tractions (sim.py)."""
    return np.array([
        x[0] + dt * lin_traction * np.cos(x[2]) * u[0],
        x[1] + dt * lin_traction * np.sin(x[2]) * u[0],
        x[2] + dt * ang_traction * u[1],
    ])


def truth_at(truth, res, x, y):
    """A ground truth's tractions at ``(x, y)``, zero off the grid
    (TractionGrid.get, limits at the origin)."""
    lin, ang = truth
    xi = int(x // res)
    yi = int(y // res)
    if xi < 0 or xi >= lin.shape[1] or yi < 0 or yi >= lin.shape[0]:
        return 0, 0
    return lin[yi, xi], ang[yi, xi]
