"""The port's TDM constructors and planner staging in the det_dyn,
speed_map and costmap modes vs the JAX package's: padded planes bit for
bit; the densities, terrains and CVaR condensations; the semantic-grid
world that chip_smoke.py builds."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mppi_numba_tpu as jpkg
import mppi_numba_tpu.terrain as jterrain
import mppi_numba_tpu_torch as tpkg
import mppi_numba_tpu_torch.terrain as tterrain
from mppi_numba_tpu.benchmark import make_benchmark_world, make_semantic_grid
from mppi_numba_tpu_torch.solver import resolve_backend

ROWS, COLS, RES, BINS = 21, 30, 0.5, 12
MODES = {
    "tdm": dict(use_tdm=True),
    "det_dyn": dict(use_det_dynamics=True),
    "speed_map": dict(use_nom_dynamics_with_speed_map=True),
}
# The planes a TDM stages for the solver, host and device.
PLANES = ("pmf_grid", "padded_pmf_host", "pmf_grid_device", "qbin_values",
          "risk_traction_map_device", "obstacle_map_device",
          "unknown_map_device", "padded_xlimits", "padded_ylimits")


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tdms_equal(got, want, names=PLANES):
    for name in names:
        a, b = _as_np(getattr(got, name)), _as_np(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_pmf_bins == want.num_pmf_bins


def _pmf_grid(seed=0):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 100, size=(BINS, ROWS, COLS)).astype(float)
    raw[rng.rand(BINS, ROWS, COLS) < 0.5] = 0.0
    raw[-1] += 1.0
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    return pmf


def _masks(seed=1):
    rng = np.random.RandomState(seed)
    return ((rng.rand(ROWS, COLS) < 0.05).astype(np.int8),
            (rng.rand(ROWS, COLS) < 0.05).astype(np.int8))


def _cfg(pkg, mode, **kw):
    flags = (dict(use_costmap=True) if mode == "costmap" else MODES[mode])
    return pkg.Config(T=2.0, dt=0.1, num_grid_samples=8,
                      num_control_rollouts=128, max_speed_padding=4.0,
                      max_map_dim=(40, 50), seed=0, **flags, **kw)


def _tdm(pkg, cfg, **kw):
    return pkg.TDM(cfg, **kw)


@pytest.mark.parametrize("alpha", [1.0, 0.3, 0.05])
def test_condensations_equal(alpha):
    pmf = _pmf_grid(2)
    bv = np.linspace(0.0, 1.0, BINS)
    np.testing.assert_array_equal(
        tterrain.condense_pmf_grid_det(pmf, bv, alpha),
        jterrain.condense_pmf_grid_det(pmf, bv, alpha))
    np.testing.assert_array_equal(
        tterrain.risk_map_from_pmf_grid(pmf, bv, (0.0, 1.0), alpha),
        jterrain.risk_map_from_pmf_grid(pmf, bv, (0.0, 1.0), alpha))
    values = np.linspace(0.0, 1.0, 7)
    tpmf = np.random.RandomState(3).dirichlet(np.ones(7))
    assert (tterrain.cvar_bin_for_terrain_pmf(values, tpmf, alpha)
            == jterrain.cvar_bin_for_terrain_pmf(values, tpmf, alpha))
    for eps in (0.0, 1e-6):
        assert (tterrain.cvar_value_for_terrain_pmf(values, tpmf, alpha, eps)
                == jterrain.cvar_value_for_terrain_pmf(values, tpmf, alpha,
                                                       eps))


@pytest.mark.parametrize("alpha", [1.0, 0.2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tdm_from_pmf_grid_bitwise(mode, alpha):
    pmf = _pmf_grid()
    obstacle, unknown = _masks()
    tdm_dict = dict(res=RES, xlimits=(0.0, COLS * RES),
                    ylimits=(0.0, ROWS * RES),
                    bin_values=np.linspace(0.0, 1.0, BINS),
                    bin_values_bounds=np.array([0.0, 1.0]),
                    det_dynamics_cvar_alpha=alpha)
    want = _tdm(jpkg, _cfg(jpkg, mode))
    got = _tdm(tpkg, _cfg(tpkg, mode), device="cpu")
    want.set_TDM_from_PMF_grid(pmf, tdm_dict, obstacle, unknown)
    got.set_TDM_from_PMF_grid(pmf, tdm_dict, obstacle, unknown)
    _assert_tdms_equal(got, want)
    if mode == "det_dyn":
        assert ((got.pmf_grid == 100).sum(0) == 1).all()
    if mode == "speed_map":
        assert got.risk_traction_map_device.abs().sum() > 0


def test_tdm_from_costmap_bitwise():
    rng = np.random.RandomState(4)
    cm = np.zeros((ROWS, COLS), np.uint8)
    cm[10:12, :] = 220
    cm[10:12, 12:16] = 0
    cm[:6, 20:] = 255
    cm[(rng.rand(ROWS, COLS) < 0.03) & (cm == 0)] = 180
    obstacle, unknown = _masks(5)
    costmap_dict = dict(costmap=cm, res=RES, xlimits=(0.0, COLS * RES),
                        ylimits=(0.0, ROWS * RES),
                        costmap_lethal_threshold=100)
    want = _tdm(jpkg, _cfg(jpkg, "costmap"))
    got = _tdm(tpkg, _cfg(tpkg, "costmap"), device="cpu")
    want.set_TDM_from_costmap(costmap_dict, obstacle, unknown)
    got.set_TDM_from_costmap(costmap_dict, obstacle, unknown)
    _assert_tdms_equal(got, want)
    assert int(got.unknown_map_device.sum()) >= int((cm == 255).sum())


def test_unknown_mask_from_confidence_equal():
    rng = np.random.RandomState(6)
    conf = np.clip(rng.normal(0.8, 0.3, (ROWS, COLS)), -1, 1)
    never = (rng.rand(ROWS, COLS) < 0.1).astype(np.int64)
    for thres in (0.0, 0.3, 0.6):
        for colors in (None, never):
            got = tpkg.unknown_mask_from_confidence(conf, thres, colors)
            want = jpkg.unknown_mask_from_confidence(conf, thres, colors)
            assert got.dtype == want.dtype == np.int8
            np.testing.assert_array_equal(got, want)


def test_densities_and_terrains_equal():
    """The same seeded draws give the same samples, PMFs and CVaRs."""
    def world(pkg):
        rng = np.random.RandomState(7)
        lin = pkg.GaussianMixture([0, 1.0], [0, 1.0], [0.6, 0.4], [0, 0.8],
                                  [0.15, 0.1], rng=rng)
        ang = pkg.GaussianMixture([0, 1.0], [0, 1.0], [1], [0.65], [0.1],
                                  rng=rng)
        return pkg.Terrain("Vegetation", np.zeros(3), lin, ang,
                           cvar_alpha=0.2)

    got, want = world(tpkg), world(jpkg)
    np.testing.assert_array_equal(got.lin_saved_samples,
                                  want.lin_saved_samples)
    for name in ("lin_mean", "lin_var", "lin_cvar", "lin_cvar_thres",
                 "ang_mean", "ang_cvar"):
        assert getattr(got, name) == getattr(want, name), name
    for a, b in zip(got.lin_density.get_pmf(20), want.lin_density.get_pmf(20)):
        np.testing.assert_array_equal(a, b)
    got.update_cvar_alpha(0.5)
    want.update_cvar_alpha(0.5)
    assert got.ang_cvar == want.ang_cvar


def _benchmark_pair(seed=1):
    """chip_smoke.py's port-side benchmark world and the JAX package's,
    from the same seed: ``(port world, jax world, semantic grid)``."""
    rng = np.random.RandomState(seed)
    tw = chip_smoke.benchmark_world(num_bins=20, rng=rng)
    sg = chip_smoke.semantic_grid((9, 9), 1, 0.4, rng)
    rng = np.random.RandomState(seed)
    jw = make_benchmark_world(num_bins=20, rng=rng)
    np.testing.assert_array_equal(sg, make_semantic_grid((9, 9), 1, 0.4, rng))
    return tw, jw, sg


def test_chip_smoke_benchmark_world_equals_jax():
    tw, jw, _ = _benchmark_pair()
    for key in ("id2name", "num_pmf_bins"):
        assert tw[key] == jw[key], key
    np.testing.assert_array_equal(tw["bin_values"], jw["bin_values"])
    assert tw["bin_values_bounds"] == jw["bin_values_bounds"]
    for key in ("lin_terrain2pmf", "ang_terrain2pmf"):
        got = {t.name: v for t, v in tw[key].items()}
        want = {t.name: v for t, v in jw[key].items()}
        assert set(got) == set(want)
        for name in got:
            for a, b in zip(got[name], want[name]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tdm_from_semantic_grid_bitwise(mode):
    tw, jw, sg = _benchmark_pair()
    det = None if mode == "tdm" else 0.2
    obstacle = np.zeros((9, 9), np.int8)
    obstacle[4, 2:5] = 1
    tdms = []
    for pkg, world, kw in ((tpkg, tw, dict(device="cpu")), (jpkg, jw, {})):
        tdm = _tdm(pkg, _cfg(pkg, mode), **kw)
        tdm.set_TDM_from_semantic_grid(
            sg, 1.0, world["num_pmf_bins"], world["bin_values"],
            world["bin_values_bounds"], (0, 9.0), (0, 9.0),
            world["id2name"], world["name2terrain"],
            world["ang_terrain2pmf"], det_dynamics_cvar_alpha=det,
            obstacle_map=obstacle)
        tdms.append(tdm)
    _assert_tdms_equal(*tdms)
    np.testing.assert_array_equal(tdms[0].semantic_grid, tdms[1].semantic_grid)


def _planner(pkg, mode, dynamic_cvar=False, **kw):
    pmf = _pmf_grid(8)
    obstacle, unknown = _masks(9)
    cfg = _cfg(pkg, mode)
    if dynamic_cvar:
        cfg.dynamic_cvar = True
    lin, ang = _tdm(pkg, cfg, **kw), _tdm(pkg, cfg, **kw)
    if mode == "costmap":
        cm = np.where(obstacle == 1, 200, 0).astype(np.uint8)
        cm[unknown == 1] = 255
        d = dict(costmap=cm, res=RES, xlimits=(0.0, COLS * RES),
                 ylimits=(0.0, ROWS * RES), costmap_lethal_threshold=100)
        lin.set_TDM_from_costmap(d)
        ang.set_TDM_from_costmap(d)
    else:
        d = dict(res=RES, xlimits=(0.0, COLS * RES),
                 ylimits=(0.0, ROWS * RES),
                 bin_values=np.linspace(0.0, 1.0, BINS),
                 bin_values_bounds=np.array([0.0, 1.0]),
                 det_dynamics_cvar_alpha=1.0 if mode == "tdm" else 0.3)
        lin.set_TDM_from_PMF_grid(pmf, d, obstacle, unknown)
        ang.set_TDM_from_PMF_grid(pmf[::-1].copy(), d, obstacle, unknown)
    planner = pkg.MPPIPlanner(cfg, **kw)
    planner.setup(dict(dt=0.1, x0=np.array([2.0, 2.0, 0.5]),
                       xgoal=np.array([12.0, 8.0]), goal_tolerance=0.5,
                       v_post_rollout=0.01, cvar_alpha=0.4, alpha_dyn=0.6,
                       dist_weight=1.0, lambda_weight=1.0, num_opt=2,
                       u_std=np.array([2.0, 3.0]),
                       vrange=np.array([0.0, 3.0]),
                       wrange=np.array([-np.pi, np.pi])), lin, ang)
    return planner


@pytest.mark.parametrize("mode", ["det_dyn", "speed_map", "costmap",
                                  "tdm_dynamic_cvar"])
def test_planner_staging_modes_bitwise(mode):
    dyn = mode == "tdm_dynamic_cvar"
    mode = "tdm" if dyn else mode
    jp = _planner(jpkg, mode, dyn)
    tp = _planner(tpkg, mode, dyn, device="cpu")
    jm, tm = jp._map_inputs(), tp._map_inputs()
    for name in jm._fields:
        want, got = _as_np(getattr(jm, name)), _as_np(getattr(tm, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    jt, tt = jp._build_task(), tp._build_task()
    for name in jt._fields:
        np.testing.assert_array_equal(_as_np(getattr(tt, name)),
                                      _as_np(getattr(jt, name)), err_msg=name)
    js = dataclasses.asdict(jp._static())
    ts = dataclasses.asdict(tp._static())
    for name in set(js) - {"backend"}:
        assert ts[name] == js[name], name
    if mode != "tdm":
        assert ts["num_grid_samples"] == 1 and ts["cvar_numel"] == 1


@pytest.mark.parametrize("mode", ["det_dyn", "speed_map", "costmap", "tdm"])
def test_planner_modes_solve_and_u_prev_alias(mode):
    """det modes keep the reference's quirk: after a solve u_prev aliases
    the freshly solved controls; the tdm planner leaves u_prev alone."""
    tp = _planner(tpkg, mode, device="cpu")
    u_prev0 = tp.u_prev
    x = np.array([2.0, 2.0, 0.5])
    for _ in range(2):
        u = tp.solve()
        assert u.shape == (tp.num_steps, 2) and np.isfinite(u).all()
        if mode == "tdm":
            assert tp.u_prev is u_prev0
        else:
            assert tp.u_prev is tp.u_cur
        tp.shift_and_update(x, u)
    m = 1 if mode != "tdm" else 8
    assert tp.lin_tdm.sample_grid_batch.shape[0] == m
    # On a card 'auto' routes on the support-compacted bin count: the
    # speed-map and costmap TDMs keep bin 0 and the last bin only.
    static = tp._static()
    want = "binned2" if static.num_pmf_bins <= 4 else "binned"
    assert resolve_backend(static, "cuda") == want
    if mode in ("speed_map", "costmap"):
        assert static.num_pmf_bins == 2
