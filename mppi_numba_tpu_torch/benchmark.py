"""Benchmark harness: the paired-environment factorial sweep.

Reproduces the reference's statistical benchmark
(reference: benchmark.ipynb[cells 2-5]), as the JAX package's
``benchmark.py`` does: the Vegetation/Dirt Gaussian-mixture world,
environments and ground-truth traction realizations generated once and
shared across methods (so method comparisons are paired on identical
semantic maps AND identical realizations), the methods x densities x envs
x alphas x realizations sweep, and the same row schema.

Two engines: ``run_trials`` steps each trial through ``sim.trial`` and one
``MPPIPlanner`` a method (on a card its solves replay a CUDA graph), in
the reference's order; ``run_trials_device`` runs every (density, env,
realization) episode of a (method, alpha) as one batch on the device
(``device_sim.make_device_trial_batch``: one map-sampling and one rollout
launch a step for the whole chunk, one CUDA graph a step on a card).
Each engine's sweep yields its rows as a list of dicts
(``run_trials_rows``, ``run_trials_device_rows``); ``run_trials`` and
``run_trials_device`` wrap them in a pandas DataFrame, importing pandas
only then.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from .config import Config, SolverStatic
from .density import GaussianMixture
from .mppi import MPPIPlanner
from .sim import trial
from .terrain import TDM, Terrain, resolve_device

METHODS = ("noisy_dyn", "risk_dyn", "nom_dyn_risk_cost")
# The reference's paper run (16,000 trials) additionally sweeps a 4th
# method, "baseline": standard MPPI under nominal dynamics -- the planner
# assumes perfect traction everywhere (its TDM is a one-hot PMF at the last
# bin, the FAQ-1 workflow; reference README.md:134-152) while the simulator
# still applies the realized tractions.  Pass method_list=PAPER_METHODS to
# reproduce the full paper sweep.
PAPER_METHODS = METHODS + ("baseline",)

# Each method's solver mode.
METHOD_MODES = {"noisy_dyn": "tdm", "risk_dyn": "det_dyn",
                "nom_dyn_risk_cost": "speed_map", "baseline": "det_dyn"}


def make_benchmark_world(num_bins=20, rng=None):
    """The two-terrain world of the reference benchmark
    (reference: benchmark.ipynb[cell 2]): Vegetation is bimodal {0, 0.8}
    traction, Dirt is unimodal 0.65.  The densities draw from ``rng`` (a
    numpy ``RandomState``, stateful: rebuild the world to repeat a sweep)."""
    pmf_bounds = [0, 1.0]
    bush_lin = GaussianMixture(pmf_bounds, pmf_bounds, [0.6, 0.4], [0, 0.8],
                               [0.15, 0.1], rng=rng)
    bush_ang = GaussianMixture(pmf_bounds, pmf_bounds, [0.6, 0.4], [0, 0.8],
                               [0.15, 0.1], rng=rng)
    dirt_lin = GaussianMixture(pmf_bounds, pmf_bounds, [1], [0.65], [0.1],
                               rng=rng)
    dirt_ang = GaussianMixture(pmf_bounds, pmf_bounds, [1], [0.65], [0.1],
                               rng=rng)

    bush = Terrain("Vegetation", np.array((0, 250, 0)) / 255.0,
                   bush_lin, bush_ang)
    dirt = Terrain("Dirt", np.array((200, 190, 160)) / 255.0,
                   dirt_lin, dirt_ang)

    id2name = {0: dirt.name, 1: bush.name}
    name2terrain = {bush.name: bush, dirt.name: dirt}
    lin_terrain2pmf = {bush: bush_lin.get_pmf(num_bins),
                       dirt: dirt_lin.get_pmf(num_bins)}
    ang_terrain2pmf = {bush: bush_ang.get_pmf(num_bins),
                       dirt: dirt_ang.get_pmf(num_bins)}
    bin_values = lin_terrain2pmf[bush][0]
    return dict(id2name=id2name, name2terrain=name2terrain,
                lin_terrain2pmf=lin_terrain2pmf,
                ang_terrain2pmf=ang_terrain2pmf,
                bin_values=bin_values,
                bin_values_bounds=(np.min(bin_values), np.max(bin_values)),
                num_pmf_bins=len(bin_values))


def make_semantic_grid(grid_shape, mud_margin, grass_density, rng,
                       dirt_along_edge=True):
    """Random semantic map with a dirt corridor near the edge
    (reference: benchmark.ipynb[cell 4])."""
    semantic_grid = np.zeros(grid_shape, dtype=np.int8)
    if dirt_along_edge:
        rand_num = rng.rand(grid_shape[0] - 2 * mud_margin,
                            grid_shape[1] - 2 * mud_margin)
        semantic_grid[mud_margin:-mud_margin,
                      mud_margin:-mud_margin][rand_num < grass_density] = 1
    else:
        rand_num = rng.rand(*grid_shape)
        semantic_grid[rand_num < grass_density] = 1
        semantic_grid[:mud_margin, :mud_margin] = 0
        semantic_grid[-mud_margin:, -mud_margin:] = 0
    return semantic_grid


def _nominal_pmf_inputs(world, grid_shape, res, xlimits, ylimits):
    """(pmf_grid, tdm_dict) for the baseline method: one-hot PMF at the
    last bin = perfect traction everywhere (reference FAQ-1 workflow)."""
    pmf = np.zeros((world["num_pmf_bins"],) + tuple(grid_shape), np.int8)
    pmf[-1] = 100
    tdm_dict = dict(res=res, xlimits=xlimits, ylimits=ylimits,
                    bin_values=world["bin_values"],
                    bin_values_bounds=np.asarray(world["bin_values_bounds"]),
                    det_dynamics_cvar_alpha=1.0)
    return pmf, tdm_dict


def _cfg_for_method(orig_cfg: Config, method: str) -> Config:
    kw = dict(T=orig_cfg.T, dt=orig_cfg.dt,
              num_grid_samples=orig_cfg.num_grid_samples,
              num_control_rollouts=orig_cfg.num_control_rollouts,
              max_speed_padding=orig_cfg.max_speed_padding,
              num_vis_state_rollouts=orig_cfg.num_vis_state_rollouts,
              max_map_dim=orig_cfg.max_map_dim, seed=orig_cfg.seed)
    if method in ("risk_dyn", "baseline"):
        return Config(use_det_dynamics=True, **kw)
    if method == "nom_dyn_risk_cost":
        return Config(use_nom_dynamics_with_speed_map=True, **kw)
    if method == "noisy_dyn":
        # noisy_dyn sweeps cvar_alpha across trials; reading it from the
        # task at run time (dynamic CVaR) lets one solver, and on a card
        # one graph, serve the whole alpha sweep.
        return Config(use_tdm=True, dynamic_cvar=True, **kw)
    raise ValueError(method)


def _method_alphas(method, alpha):
    """(det_alpha, cvar_alpha, alpha_dyn) of a method at sweep value
    ``alpha``: the maps depend on alpha only through det_alpha."""
    if method == "baseline":
        # Nominal-dynamics MPPI: the planner assumes traction 1 everywhere;
        # alpha is irrelevant and the maps are cached once.
        return "baseline", 1.0, 1.0
    if method == "noisy_dyn":
        return None, alpha, 1.0
    return alpha, 1.0, alpha


def _set_method_tdms(method, world, semantic_grid, res, xlimits, ylimits,
                     det_alpha, lin_tdm, ang_tdm):
    """Set a method's two TDMs for one environment (reset first)."""
    lin_tdm.reset()
    ang_tdm.reset()
    if method == "baseline":
        nominal_pmf, nominal_dict = _nominal_pmf_inputs(
            world, semantic_grid.shape, res, xlimits, ylimits)
        lin_tdm.set_TDM_from_PMF_grid(nominal_pmf, nominal_dict)
        ang_tdm.set_TDM_from_PMF_grid(nominal_pmf, nominal_dict)
        return
    for tdm, pmfs in ((lin_tdm, world["lin_terrain2pmf"]),
                      (ang_tdm, world["ang_terrain2pmf"])):
        tdm.set_TDM_from_semantic_grid(
            semantic_grid, res, world["num_pmf_bins"], world["bin_values"],
            world["bin_values_bounds"], xlimits, ylimits, world["id2name"],
            world["name2terrain"], pmfs,
            det_dynamics_cvar_alpha=None if method == "noisy_dyn"
            else det_alpha)


def _pregenerate(orig_cfg, world, grid_shape, mud_margin, res,
                 grass_density_list, envs_per_density, trials_per_env, seed,
                 device):
    """The paired environments: one semantic grid per (density, env) and
    ``trials_per_env`` ground-truth realizations each, in the JAX
    package's order of draws (``rng`` for the grids, the world's densities
    for the realizations).  Returns ``(env_grids, env_rows)``:
    ``{(density_i, env_i): grid}`` and one row per (density, env,
    realization) with its ``TractionGrid`` under ``gt``."""
    rng = np.random.RandomState(seed)
    xlimits = (0, grid_shape[1] * res)
    ylimits = (0, grid_shape[0] * res)
    gen_tdm = TDM(_cfg_for_method(orig_cfg, "noisy_dyn"), device=device)
    env_grids, env_rows = {}, []
    for density_i, grass_density in enumerate(grass_density_list):
        for env_i in range(envs_per_density):
            sg = make_semantic_grid(grid_shape, mud_margin, grass_density, rng)
            env_grids[(density_i, env_i)] = sg
            gen_tdm.reset()
            gen_tdm.set_TDM_from_semantic_grid(
                sg, res, world["num_pmf_bins"], world["bin_values"],
                world["bin_values_bounds"], xlimits, ylimits,
                world["id2name"], world["name2terrain"],
                world["lin_terrain2pmf"])
            for trial_i in range(trials_per_env):
                env_rows.append(dict(
                    density_i=density_i, grass_density=grass_density,
                    env_i=env_i, trial_i=trial_i,
                    gt=gen_tdm.sample_grids_true_dist()))
    return env_grids, env_rows


def run_trials_rows(orig_cfg, world, max_steps, grid_shape, mud_margin, res,
                    default_mppi_params, grass_density_list, envs_per_density,
                    trials_per_env, alpha_list, method_list=METHODS, seed=0,
                    verbose=True, device=None):
    """The sequential sweep: one ``sim.trial`` a (method, density, env,
    alpha, realization), one ``MPPIPlanner`` a method on ``device`` (CUDA
    by default).  Returns the logger rows (dicts) in the reference's
    schema and order.

    Environments and ground-truth realizations are generated ONCE and
    shared across methods/alphas (paired comparisons, reference:
    benchmark.ipynb[cell 4] ``density_to_grid_configs``).
    """
    dev = resolve_device(device)
    env_grids, env_rows = _pregenerate(
        orig_cfg, world, grid_shape, mud_margin, res, grass_density_list,
        envs_per_density, trials_per_env, seed, dev)
    xlimits = (0, grid_shape[1] * res)
    ylimits = (0, grid_shape[0] * res)
    rows = []
    for method_i, method in enumerate(method_list):
        cfg = _cfg_for_method(orig_cfg, method)
        mppi_planner = MPPIPlanner(cfg, device=dev)
        lin_tdm, ang_tdm = TDM(cfg, device=dev), TDM(cfg, device=dev)
        for (density_i, env_i), semantic_grid in env_grids.items():
            grass_density = grass_density_list[density_i]
            realizations = [r["gt"] for r in env_rows
                            if (r["density_i"], r["env_i"])
                            == (density_i, env_i)]
            t_alphas = time.time()
            for alpha_i, alpha in enumerate(alpha_list):
                if verbose:
                    print("method={}({}/{}), grass_density={} ({}/{}), "
                          "grid ({}/{}), alpha={}({}/{})".format(
                              method, method_i + 1, len(method_list),
                              grass_density, density_i + 1,
                              len(grass_density_list), env_i + 1,
                              envs_per_density, alpha, alpha_i + 1,
                              len(alpha_list)))
                det_alpha, cvar_alpha, alpha_dyn = _method_alphas(method,
                                                                  alpha)
                mppi_planner.reset()
                trial_params = copy.deepcopy(default_mppi_params)
                trial_params["alpha_dyn"] = alpha_dyn
                trial_params["cvar_alpha"] = cvar_alpha
                _set_method_tdms(method, world, semantic_grid, res, xlimits,
                                 ylimits, det_alpha, lin_tdm, ang_tdm)
                mppi_planner.setup(trial_params, lin_tdm, ang_tdm)

                # NOTE (reference fidelity): the planner is NOT reset
                # between realizations -- the warm-started control
                # sequence (and the stale params['x0'] mutated by
                # shift_and_update) carry into the next trial's first
                # solve, exactly as in benchmark.ipynb[cell 4].
                for map_sample_i, traction_grid in enumerate(realizations):
                    logger = trial(mppi_planner, traction_grid, cfg.dt,
                                   max_steps, trial_params)
                    logger.update(
                        dirt_along_edge=True, grass_density=grass_density,
                        grass_density_index=density_i, sem_map_index=env_i,
                        method=method, alpha=alpha,
                        map_sample_index=map_sample_i)
                    rows.append(logger)
            if verbose:
                t_elapsed = time.time() - t_alphas
                n = len(alpha_list) * len(realizations)
                print("{:.2f}s for {} alphas x {} realizations "
                      "({:.2f}s per trial)".format(
                          t_elapsed, len(alpha_list), len(realizations),
                          t_elapsed / n))
    return rows


def run_trials(*args, **kwargs):
    """``run_trials_rows`` as a pandas DataFrame with the reference
    schema (arguments as there)."""
    import pandas as pd

    return pd.DataFrame(run_trials_rows(*args, **kwargs))


def _batched_task(p, B, res, alpha_dyn, cvar_alpha, xlim0, ylim0, lb, ub,
                  device):
    """The sweep's ``TerrainTask``, every field with a leading B (one
    episode a row, all alike but for the state the episodes write)."""
    from .types import TerrainTask

    f32 = np.float32

    def batched(v):
        v = np.asarray(v, f32)
        return torch.tensor(np.broadcast_to(v, (B,) + v.shape).copy(),
                            device=device)

    return TerrainTask(
        x0=batched(p["x0"]), xgoal=batched(p["xgoal"]),
        goal_tolerance=batched(p["goal_tolerance"]),
        v_post_rollout=batched(p["v_post_rollout"]),
        lambda_weight=batched(p["lambda_weight"]),
        u_std=batched(p["u_std"]), vrange=batched(p["vrange"]),
        wrange=batched(p["wrange"]), dt=batched(p["dt"]),
        dist_weight=batched(p.get("dist_weight", 1.0)),
        obs_penalty=batched(p.get("obs_penalty", 1e5)),
        unknown_penalty=batched(p.get("unknown_penalty", 1e2)),
        alpha_dyn=batched(alpha_dyn), res=batched(res),
        xlim0=batched(xlim0), ylim0=batched(ylim0),
        lin_lb=batched(lb), lin_ratio=batched(0.01 * (ub - lb)),
        ang_lb=batched(lb), ang_ratio=batched(0.01 * (ub - lb)),
        cvar_alpha=batched(cvar_alpha))


class DeviceSweep:
    """The device sweep's inputs on ``device``: the paired episodes (one
    per density x env x realization, ``episodes`` rows, in the JAX
    package's order) with their ground truth ``gt = (gt_lin (B, H, W),
    gt_ang, gt_meta (B, 3))``, and for each (method, alpha)
    ``inputs(method, alpha) -> (cfg, static, maps, task)``: the solver's
    static and the batched ``MapInputs`` and ``TerrainTask`` of all B
    episodes (each environment's maps built once per method and det_alpha,
    then one row per episode)."""

    def __init__(self, orig_cfg, world, grid_shape, mud_margin, res,
                 default_mppi_params, grass_density_list, envs_per_density,
                 trials_per_env, seed=0, device=None):
        self.device = dev = resolve_device(device)
        self.orig_cfg, self.world, self.res = orig_cfg, world, res
        self.params = default_mppi_params
        self.env_grids, self.episodes = _pregenerate(
            orig_cfg, world, grid_shape, mud_margin, res, grass_density_list,
            envs_per_density, trials_per_env, seed, dev)
        self.limits = ((0, grid_shape[1] * res), (0, grid_shape[0] * res))
        B = len(self.episodes)
        self.gt = tuple(torch.tensor(a, device=dev) for a in (
            np.stack([r["gt"].lin_traction for r in self.episodes])
            .astype(np.float32),
            np.stack([r["gt"].ang_traction for r in self.episodes])
            .astype(np.float32),
            np.tile(np.array([0.0, 0.0, 1.0 / res], np.float32), (B, 1))))
        self._maps = {}

    def inputs(self, method, alpha):
        """``(cfg, static, maps, task)`` of every episode at (method,
        alpha)."""
        from .solver import DYNAMIC_CVAR
        from .types import MapInputs

        dev, world, p = self.device, self.world, self.params
        cfg = _cfg_for_method(self.orig_cfg, method)
        det_alpha, cvar_alpha, alpha_dyn = _method_alphas(method, alpha)
        key = (method, det_alpha)
        if key not in self._maps:
            lin_tdm, ang_tdm = TDM(cfg, device=dev), TDM(cfg, device=dev)
            env_maps = {}
            for env, sg in self.env_grids.items():
                _set_method_tdms(method, world, sg, self.res, *self.limits,
                                 det_alpha, lin_tdm, ang_tdm)
                env_maps[env] = (
                    lin_tdm.pmf_grid_device, ang_tdm.pmf_grid_device,
                    lin_tdm.qbin_values, ang_tdm.qbin_values,
                    lin_tdm.obstacle_map_device, lin_tdm.unknown_map_device,
                    lin_tdm.risk_traction_map_device)
            rows = [(r["density_i"], r["env_i"]) for r in self.episodes]
            self._maps[key] = (MapInputs(*(
                torch.stack([env_maps[e][i] for e in rows])
                for i in range(7))), (lin_tdm.padded_xlimits[0],
                                      lin_tdm.padded_ylimits[0]))
        maps, (xlim0, ylim0) = self._maps[key]
        lb, ub = world["bin_values_bounds"]
        task = _batched_task(p, len(self.episodes), self.res, alpha_dyn,
                             cvar_alpha, xlim0, ylim0, lb, ub, dev)
        M = 1 if method != "noisy_dyn" else cfg.num_grid_samples
        static = SolverStatic(
            mode=METHOD_MODES[method], num_steps=cfg.num_steps,
            num_control_rollouts=cfg.num_control_rollouts,
            num_grid_samples=M, map_shape=tuple(maps.lin_pmf.shape[-2:]),
            num_obstacles=0, cvar_numel=DYNAMIC_CVAR if M > 1 else 1,
            num_opt=1, num_vis_state_rollouts=1,
            fast_trig=(float(p["dt"]) * float(np.max(np.abs(p["wrange"])))
                       * float(ub) <= 0.6),
            num_pmf_bins=int(maps.lin_pmf.shape[-3]))
        return cfg, static, maps, task


def run_trials_device_rows(orig_cfg, world, max_steps, grid_shape,
                           mud_margin, res, default_mppi_params,
                           grass_density_list, envs_per_density,
                           trials_per_env, alpha_list, method_list=METHODS,
                           seed=0, verbose=True, batch_chunk=30, device=None,
                           draws_for_chunk=None, stats=None):
    """The device-batched sweep: for each (method, alpha), all (density x
    env x realization) episodes run as batches on the device
    (``device_sim.make_device_trial_batch``); returns the rows (dicts).

    Same paired generation and row schema as ``run_trials_rows``; trials
    are independent (no warm-start carry-over between realizations).  One
    solver per method serves its whole alpha sweep (dynamic CVaR); on a
    card one CUDA graph steps a whole chunk, captured once per method.

    ``batch_chunk`` caps the episodes a batch (the last chunk is padded by
    clamping the episode index, so every chunk has the same shape and
    replays the same graph); ``None`` runs all episodes in one batch.

    Draws: by default one ``torch.Generator`` per method, seeded from
    ``cfg.seed`` at each alpha (so the alphas see the same draws), drawing
    every chunk's map keys and noise.  ``draws_for_chunk(idx)``, given,
    returns the draws of the chunk of episodes ``idx`` (the int64 episode
    indices, clamped): a generator, or a callable ``step -> (map_keys (B,
    2), eps_list [(B, K, T, 2)])`` (the tests feed the JAX package's
    per-episode keys through it).  ``stats``, a dict, receives per method
    the engine's captures, the steps each chunk ran and the seconds.
    """
    from .device_sim import make_device_trial_batch

    sweep = DeviceSweep(orig_cfg, world, grid_shape, mud_margin, res,
                        default_mppi_params, grass_density_list,
                        envs_per_density, trials_per_env, seed, device)
    dev = sweep.device
    B = len(sweep.episodes)
    chunk = B if batch_chunk is None else min(batch_chunk, B)
    rows = []
    for method in method_list:
        t_method = time.perf_counter()
        engine = gen = None
        chunk_steps = []
        for alpha in alpha_list:
            if verbose:
                print("device sweep: method={} alpha={} ({} trials)".format(
                    method, alpha, B))
            cfg, static, maps, task = sweep.inputs(method, alpha)
            if engine is None:
                engine = make_device_trial_batch(static, max_steps)
                gen = torch.Generator(device=dev)
            gen.manual_seed(cfg.seed)
            parts = []
            for lo in range(0, B, chunk):
                # Fixed-size chunks (the tail padded by clamping), so that
                # every chunk replays the same graph.
                idx = np.clip(np.arange(lo, lo + chunk), 0, B - 1)
                tidx = torch.tensor(idx, device=dev)

                def take(tree):
                    return type(tree)(*(None if x is None else x[tidx]
                                        for x in tree))

                draws = (gen if draws_for_chunk is None
                         else draws_for_chunk(idx))
                out = engine(draws, take(maps), take(task),
                             *(g[tidx] for g in sweep.gt))
                chunk_steps.append(engine.steps_run)
                parts.append([f.cpu().numpy() for f in out])
            steps, success, dist, cum_dist, cum_obj = (
                np.concatenate(f)[:B] for f in zip(*parts))
            for bi, row in enumerate(sweep.episodes):
                ok = bool(success[bi])
                rows.append(dict(
                    time_to_goal=(steps[bi] * cfg.dt if ok else np.nan),
                    success=ok,
                    dist_to_goal=(np.nan if ok else float(dist[bi])),
                    cum_dist_to_goal=float(cum_dist[bi]),
                    avg_dist_to_goal=float(cum_dist[bi]
                                           / max(int(steps[bi]), 1)),
                    cum_obj=float(cum_obj[bi]),
                    dirt_along_edge=True,
                    grass_density=row["grass_density"],
                    grass_density_index=row["density_i"],
                    sem_map_index=row["env_i"],
                    method=method, alpha=alpha,
                    map_sample_index=row["trial_i"]))
        if stats is not None:
            stats[method] = dict(captures=engine.captures,
                                 chunk_steps=chunk_steps, chunk=chunk,
                                 episodes=B * len(alpha_list),
                                 seconds=time.perf_counter() - t_method)
    return rows


def run_trials_device(*args, **kwargs):
    """``run_trials_device_rows`` as a pandas DataFrame with the reference
    schema (arguments as there)."""
    import pandas as pd

    return pd.DataFrame(run_trials_device_rows(*args, **kwargs))


def default_benchmark_params(cfg, grid_shape, mud_margin, max_speed=3.0,
                             res=1.0):
    """Default problem params of the reference benchmark
    (reference: benchmark.ipynb[cell 5]; there the grid is square with
    res=1, hiding that x spans COLUMNS -- grid_shape[1] -- in world
    coordinates)."""
    return dict(
        dt=cfg.dt,
        x0=np.array([mud_margin * res / 2, mud_margin * res / 2, np.pi / 4]),
        xgoal=np.array([(grid_shape[1] - mud_margin / 2) * res,
                        (grid_shape[0] - mud_margin / 2) * res]),
        goal_tolerance=mud_margin * res / 2,
        v_post_rollout=0.01,
        cvar_alpha=1.0,
        alpha_dyn=1.0,
        lambda_weight=1.0,
        num_opt=1,
        u_std=np.array([2.0, 3.0]),
        vrange=np.array([0, max_speed]),
        wrange=np.array([-np.pi, np.pi]),
    )
