"""The port's benchmark harness (``mppi_numba_tpu_torch.benchmark``) against
the JAX package's on the CPU.

The worlds, semantic grids, realizations, default params, per-method
configs and nominal inputs are numpy and must equal JAX's exactly (the
sweep's pairing rests on the same ``RandomState`` draws).  The device
sweep is fed the JAX package's own per-episode keys (``fold_in`` of
``PRNGKey(cfg.seed)`` by episode index, then ``split`` a step) through
``draws_for_chunk``, at lambda 10 as the CPU solve tests use.

A closed loop amplifies float32 ordering differences between the two
packages (about 10x every two steps at these sizes: 5e-7 relative in
cum_obj after 4 steps, 3e-5 after 6, 4e-4 after 8, 2e-2 after 15, measured
on this benchmark's 5x5 world), through the simulator's traction cells and
the solve's dependence on the state.  So the sweep is held against JAX
over 6 steps at each reference test's shapes, steps and success exact and
the floats within rtol 2e-4 / atol 2e-5; over whole episodes the batched
engine is held against the port's own single-episode engine (bit for bit
on the CPU), and the step itself against JAX's step along JAX's own
trajectory (``tests/test_torch_device_sim.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mppi_numba_tpu import benchmark as jb
from mppi_numba_tpu import terrain as jterrain
from mppi_numba_tpu.config import Config as JConfig
from mppi_numba_tpu_torch import benchmark as tb
from mppi_numba_tpu_torch.config import Config as TConfig

RTOL, ATOL = 2e-4, 2e-5
SHORT_STEPS = 6
FLOATS = ("cum_obj", "cum_dist_to_goal", "dist_to_goal", "avg_dist_to_goal",
          "time_to_goal")
EXPECTED_COLUMNS = {
    "time_to_goal", "success", "dist_to_goal", "cum_dist_to_goal",
    "avg_dist_to_goal", "cum_obj", "dirt_along_edge", "grass_density",
    "grass_density_index", "sem_map_index", "method", "alpha",
    "map_sample_index",
}

# The shapes of the reference tests: (Config kwargs, grid, world bins,
# densities, envs, trials, alphas).
SIZES = {
    # tests/test_benchmark.py::test_run_trials_device_chunking_matches_unchunked
    "test_benchmark": (dict(T=2.0, dt=0.1, num_grid_samples=8,
                            num_control_rollouts=128, max_speed_padding=3.0,
                            max_map_dim=(11, 11), seed=1, use_tdm=True),
                       (5, 5), 8, [0.4], 3, 2, [0.6]),
    # tests/test_device_sim.py::test_run_trials_device_schema_and_success
    "test_device_sim": (dict(T=6.0, dt=0.1, num_grid_samples=16,
                             num_control_rollouts=128, max_speed_padding=3.0,
                             num_vis_state_rollouts=1, max_map_dim=(15, 15),
                             seed=1, use_tdm=True),
                        (9, 9), 10, [0.2], 1, 2, [1.0, 0.5]),
}



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The closed loops here step small tensors, where torch's intra-op
    threads cost more than they save on a busy host: one thread for each
    test, the setting put back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _problem(pkg, cfg_cls, size, lam=10.0):
    cfg_kw, grid, bins, dens, envs, trials, alphas = SIZES[size]
    world = pkg.make_benchmark_world(num_bins=bins,
                                     rng=np.random.RandomState(0))
    cfg = cfg_cls(**cfg_kw)
    params = pkg.default_benchmark_params(cfg, grid, 1)
    params["lambda_weight"] = lam
    return (cfg, world, grid, 1, 1.0, params, dens, envs, trials, alphas)


def _run(pkg, cfg_cls, size, max_steps, methods, **kw):
    cfg, world, grid, margin, res, params, dens, envs, trials, alphas = \
        _problem(pkg, cfg_cls, size)
    return pkg.run_trials_device(cfg, world, max_steps, grid, margin, res,
                                 params, dens, envs, trials, alphas,
                                 method_list=list(methods), verbose=False,
                                 **kw)


def jax_episode_draws(seed, B, K, T, max_steps):
    """``draws_for_chunk`` feeding the JAX package's per-episode draws:
    episode b's key is ``fold_in(PRNGKey(seed), b)``; each step splits it
    (``device_sim._make_step_core``), and the solve splits the step's key
    into the map key and the noise key (noise ``fold_in(knoise, 0)``)."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(seed),
                                                   jnp.arange(B))

    def step_draws(sub):
        kmap, knoise = jax.random.split(sub)
        return (jax.random.key_data(kmap),
                jax.random.normal(jax.random.fold_in(knoise, 0), (K, T, 2),
                                  dtype=jnp.float32))

    per_step = []
    for _ in range(max_steps):
        pair = jax.vmap(jax.random.split)(keys)
        keys, sub = pair[:, 0], pair[:, 1]
        mk, eps = jax.vmap(step_draws)(sub)
        per_step.append((np.asarray(mk).astype(np.int64), np.asarray(eps)))

    def draws_for_chunk(idx):
        def draws(t):
            mk, eps = per_step[t]
            return torch.tensor(mk[idx]), [torch.tensor(eps[idx])]
        return draws

    return draws_for_chunk


@functools.lru_cache(maxsize=None)
def _jax_short(size):
    return _run(jb, JConfig, size, SHORT_STEPS, jb.PAPER_METHODS)


def _port_short(size, batch_chunk=30):
    cfg_kw, _, _, dens, envs, trials, _ = SIZES[size]
    B = len(dens) * envs * trials
    draws = jax_episode_draws(cfg_kw["seed"], B,
                              cfg_kw["num_control_rollouts"],
                              int(cfg_kw["T"] / cfg_kw["dt"] + 1e-6),
                              SHORT_STEPS)
    return _run(tb, TConfig, size, SHORT_STEPS, tb.PAPER_METHODS,
                device="cpu", draws_for_chunk=draws, batch_chunk=batch_chunk)


def test_world_matches_jax():
    """The two-terrain world, its PMFs, bin values and the terrains' saved
    samples equal JAX's (the same RandomState draws in the same order)."""
    jw = jb.make_benchmark_world(num_bins=20, rng=np.random.RandomState(0))
    tw = tb.make_benchmark_world(num_bins=20, rng=np.random.RandomState(0))
    assert jw["id2name"] == tw["id2name"]
    assert jw["num_pmf_bins"] == tw["num_pmf_bins"] == 22
    np.testing.assert_array_equal(jw["bin_values"], tw["bin_values"])
    assert jw["bin_values_bounds"] == tw["bin_values_bounds"]
    for key in ("lin_terrain2pmf", "ang_terrain2pmf"):
        jp = {t.name: v for t, v in jw[key].items()}
        tp = {t.name: v for t, v in tw[key].items()}
        assert jp.keys() == tp.keys()
        for name in jp:
            for a, b in zip(jp[name], tp[name]):
                np.testing.assert_array_equal(a, b)
    for name in jw["name2terrain"]:
        jt, tt = jw["name2terrain"][name], tw["name2terrain"][name]
        np.testing.assert_array_equal(jt.lin_saved_samples,
                                      tt.lin_saved_samples)
        np.testing.assert_array_equal(jt.ang_saved_samples,
                                      tt.ang_saved_samples)
        np.testing.assert_array_equal(jt.rgb, tt.rgb)


@pytest.mark.parametrize("dirt_along_edge", [True, False])
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_semantic_grid_matches_jax(density, dirt_along_edge):
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    for shape, margin in (((9, 9), 1), ((11, 7), 2)):
        a = jb.make_semantic_grid(shape, margin, density, rj,
                                  dirt_along_edge)
        b = tb.make_semantic_grid(shape, margin, density, rt,
                                  dirt_along_edge)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_environments_and_realizations_match_jax():
    """The paired episodes: each (density, env) grid and each ground-truth
    realization equal the JAX harness's, generated as its sweeps generate
    them (``run_trials_device``'s loop), the world's densities drawing in
    the same order."""
    grid, res, dens, envs, trials = (9, 9), 1.0, [1.0, 0.4, 0.1], 3, 2
    cfg_kw = SIZES["test_device_sim"][0]
    jw = jb.make_benchmark_world(num_bins=20, rng=np.random.RandomState(0))
    tw = tb.make_benchmark_world(num_bins=20, rng=np.random.RandomState(0))
    rng = np.random.RandomState(5)
    jtdm = jterrain.TDM(jb._cfg_for_method(JConfig(**cfg_kw), "noisy_dyn"))
    want_grids, want_rows = {}, []
    for di, d in enumerate(dens):
        for ei in range(envs):
            sg = jb.make_semantic_grid(grid, 1, d, rng)
            want_grids[(di, ei)] = sg
            jtdm.reset()
            jtdm.set_TDM_from_semantic_grid(
                sg, res, jw["num_pmf_bins"], jw["bin_values"],
                jw["bin_values_bounds"], (0, 9.0), (0, 9.0), jw["id2name"],
                jw["name2terrain"], jw["lin_terrain2pmf"])
            want_rows += [jtdm.sample_grids_true_dist()
                          for _ in range(trials)]
    got_grids, got_rows = tb._pregenerate(TConfig(**cfg_kw), tw, grid, 1, res,
                                          dens, envs, trials, 5, "cpu")
    assert got_grids.keys() == want_grids.keys()
    for k in want_grids:
        np.testing.assert_array_equal(got_grids[k], want_grids[k])
    assert len(got_rows) == len(want_rows) == len(dens) * envs * trials
    for row, want in zip(got_rows, want_rows):
        for name in ("lin_traction", "ang_traction"):
            np.testing.assert_array_equal(getattr(row["gt"], name),
                                          getattr(want, name))
        assert (row["gt"].xlimits, row["gt"].res) == (want.xlimits, want.res)


def test_params_configs_and_nominal_inputs_match_jax():
    for grid, margin, speed, res in (((9, 9), 1, 3.0, 1.0),
                                     ((11, 7), 2, 2.0, 0.5)):
        cfg_kw = SIZES["test_device_sim"][0]
        a = jb.default_benchmark_params(JConfig(**cfg_kw), grid, margin,
                                        speed, res)
        b = tb.default_benchmark_params(TConfig(**cfg_kw), grid, margin,
                                        speed, res)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    orig = dict(SIZES["test_device_sim"][0], max_speed_padding=5.0)
    for method in jb.PAPER_METHODS:
        a = vars(jb._cfg_for_method(JConfig(**orig), method))
        b = vars(tb._cfg_for_method(TConfig(**orig), method))
        assert a == {k: v for k, v in b.items() if k in a}, method
    with pytest.raises(ValueError):
        tb._cfg_for_method(TConfig(**orig), "nope")
    world = tb.make_benchmark_world(num_bins=20,
                                    rng=np.random.RandomState(0))
    jpmf, jdict = jb._nominal_pmf_inputs(world, (9, 9), 1.0, (0, 9), (0, 9))
    tpmf, tdict = tb._nominal_pmf_inputs(world, (9, 9), 1.0, (0, 9), (0, 9))
    np.testing.assert_array_equal(jpmf, tpmf)
    assert jpmf.dtype == tpmf.dtype and (tpmf[-1] == 100).all()
    assert jdict.keys() == tdict.keys()
    for k in jdict:
        np.testing.assert_array_equal(np.asarray(jdict[k]),
                                      np.asarray(tdict[k]))
    assert tb.METHODS == jb.METHODS and tb.PAPER_METHODS == jb.PAPER_METHODS


def test_run_trials_schema_and_pairing():
    """The sequential sweep (``sim.trial`` through one planner a method) as
    ``tests/test_benchmark.py`` runs the JAX package's: the schema, the
    pairing of environments across methods, one solver per method for its
    whole alpha sweep."""
    from mppi_numba_tpu_torch.solver import _cached_solver

    world = tb.make_benchmark_world(num_bins=10,
                                    rng=np.random.RandomState(0))
    cfg = TConfig(T=3.0, dt=0.1, num_grid_samples=32,
                  num_control_rollouts=128, max_speed_padding=3.0,
                  num_vis_state_rollouts=1, max_map_dim=(15, 15), seed=1,
                  use_tdm=True)
    params = tb.default_benchmark_params(cfg, (9, 9), mud_margin=1)
    before = _cached_solver.cache_info().currsize
    df = tb.run_trials(cfg, world, max_steps=20, grid_shape=(9, 9),
                       mud_margin=1, res=1.0, default_mppi_params=params,
                       grass_density_list=[0.4], envs_per_density=1,
                       trials_per_env=2, alpha_list=[1.0, 0.5],
                       method_list=["noisy_dyn", "risk_dyn"], verbose=False,
                       device="cpu")
    assert _cached_solver.cache_info().currsize <= before + 2
    assert EXPECTED_COLUMNS.issubset(df.columns)
    assert len(df) == 8
    assert set(df["method"]) == {"noisy_dyn", "risk_dyn"}
    assert np.isfinite(df["cum_obj"]).all()
    keys = [set(map(tuple, df[df.method == m][
        ["sem_map_index", "map_sample_index", "alpha"]].values))
        for m in ("noisy_dyn", "risk_dyn")]
    assert keys[0] == keys[1]


@pytest.mark.parametrize("size", sorted(SIZES))
def test_run_trials_device_matches_jax(size):
    """All four paper methods over the JAX harness's own draws: the same
    rows in the same order, steps and success exact, the floats within the
    whole-solve tolerance (6 closed-loop steps: see the module
    docstring)."""
    want = _jax_short(size)
    got = _port_short(size)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for col in ("method", "alpha", "grass_density", "grass_density_index",
                "sem_map_index", "map_sample_index", "dirt_along_edge",
                "success"):
        assert list(got[col]) == list(want[col]), col
    for col in FLOATS:
        np.testing.assert_allclose(got[col].to_numpy(float),
                                   want[col].to_numpy(float), rtol=RTOL,
                                   atol=ATOL, err_msg=col)


def test_run_trials_device_chunked_equals_unchunked():
    """``batch_chunk`` changes no result (a padded final chunk included),
    each episode drawing its own JAX draws (``tests/test_benchmark.py``'s
    case: 6 episodes in chunks of 4)."""
    full = _port_short("test_benchmark", batch_chunk=None)
    chunked = _port_short("test_benchmark", batch_chunk=4)
    pd.testing.assert_frame_equal(chunked, full)


def test_baseline_method_does_not_depend_on_alpha():
    """The paper run's 4th method: nominal-dynamics MPPI (the planner
    assumes traction 1; the simulator applies the realized tractions).
    Its maps and its draws are the same at every alpha (the generator is
    seeded from cfg.seed at each alpha)."""
    world = tb.make_benchmark_world(num_bins=8, rng=np.random.RandomState(0))
    cfg = TConfig(T=2.0, dt=0.1, num_grid_samples=8,
                  num_control_rollouts=128, max_speed_padding=3.0,
                  max_map_dim=(11, 11), seed=1, use_tdm=True)
    p = tb.default_benchmark_params(cfg, (5, 5), 1)
    df = tb.run_trials_device(cfg, world, 12, (5, 5), 1, 1.0, p,
                              grass_density_list=[0.4], envs_per_density=2,
                              trials_per_env=1, alpha_list=[0.6, 1.0],
                              method_list=["baseline"], verbose=False,
                              device="cpu")
    assert len(df) == 4 and np.isfinite(df.cum_obj).all()
    np.testing.assert_array_equal(df[df.alpha == 0.6].cum_obj.values,
                                  df[df.alpha == 1.0].cum_obj.values)


def test_run_trials_device_schema_and_success():
    """``tests/test_device_sim.py``'s sweep on the port's own draws (one
    generator seeded from cfg.seed): low vegetation density and a generous
    horizon, so most episodes reach the goal, as there."""
    cfg, world, grid, margin, res, params, dens, envs, trials, alphas = \
        _problem(tb, TConfig, "test_device_sim", lam=1.0)
    stats = {}
    df = tb.run_trials_device(cfg, world, 120, grid, margin, res, params,
                              dens, envs, trials, alphas,
                              method_list=["noisy_dyn", "risk_dyn"],
                              verbose=False, device="cpu", stats=stats)
    assert EXPECTED_COLUMNS.issubset(df.columns) and len(df) == 8
    assert df["success"].mean() > 0.7
    assert np.isfinite(df["cum_obj"]).all()
    ttg = df[df["success"]]["time_to_goal"]
    assert (ttg > 0).all() and (ttg <= 12.0).all()
    assert set(stats) == {"noisy_dyn", "risk_dyn"}
    assert all(s["episodes"] == 4 and s["captures"] == 0
               for s in stats.values())      # the CPU runs eagerly


def test_package_exports_match_jax():
    import mppi_numba_tpu as jpkg
    import mppi_numba_tpu_torch as tpkg

    assert set(jpkg.__all__) <= set(tpkg.__all__)
    assert tpkg.TDM_Numba is tpkg.TDM and tpkg.MPPI_Numba is tpkg.MPPIPlanner
    assert tpkg.run_trials is tb.run_trials
