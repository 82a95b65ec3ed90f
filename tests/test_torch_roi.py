"""The reachable-window (ROI) crop in the port: a cropped solve equals the
uncropped one bit for bit, and the port's crop matches the JAX package's
(``tests/test_roi.py`` for the JAX package).

A cropped solve equals the uncropped one only where each rollout's
``x - xlim0`` rounds to the same cell in the map's frame and in the
window's (``xlim0`` moved by a whole number of cells).  With the padded
origin at 0 that always holds; at any other origin a rollout can land on a
cell edge in one frame and not in the other, and its costs then differ.
These small worlds (origin at -0.5 m) have no rollout on such an edge.
The JAX package's crop has the same property.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_numba_tpu as jpkg
import mppi_numba_tpu_torch as tpkg
from mppi_numba_tpu.ops.sampling import uniform_window as j_uniform_window
from mppi_numba_tpu.solver import _crop_maps as j_crop_maps
from mppi_numba_tpu.solver import _roi_start as j_roi_start
from mppi_numba_tpu.solver import _shift_task_limits as j_shift_task_limits
from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu.solver import get_terrain_vis as j_get_vis
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import to_port
from mppi_numba_tpu_torch.ops.kernels.map_sample import sample_and_pack_crop
from mppi_numba_tpu_torch.ops.roi import crop_window_plain
from mppi_numba_tpu_torch.ops.roi import roi_start as _roi_start
from mppi_numba_tpu_torch.solver import get_terrain_solver
from mppi_numba_tpu_torch.solver import get_terrain_vis

RTOL, ATOL = 2e-4, 2e-5       # the JAX package's whole-solve tolerance


def build_planner(pkg, roi_enabled, mode="tdm", H=40, W=40, seed=3, x0=None,
                  stochastic_pmf=False, res=0.5, **kw):
    """``tests/test_roi.py``'s world for either package."""
    num_bins = 4
    bin_values = np.array([0.0, 0.5, 0.8, 1.0])
    rng = np.random.RandomState(0)
    if stochastic_pmf:
        raw = rng.randint(1, 50, size=(num_bins, H, W))
        raw[0] = 1
        pmf = np.floor(100 * raw / raw.sum(0)).astype(np.int8)
        pmf[-1] += 100 - pmf.sum(0).astype(np.int8)
    else:
        pmf = np.zeros((num_bins, H, W), dtype=np.int8)
        hot = rng.randint(1, num_bins, size=(H, W))
        for b in range(num_bins):
            pmf[b][hot == b] = 100
    flags = {"tdm": dict(use_tdm=True),
             "det": dict(use_det_dynamics=True),
             "speed": dict(use_nom_dynamics_with_speed_map=True)}[mode]
    cfg = pkg.Config(T=2.0, dt=0.1, num_grid_samples=8 if mode == "tdm" else 1,
                     num_control_rollouts=128, max_speed_padding=1.0,
                     max_map_dim=(64, 64), seed=seed, **flags)
    scale = res / 0.5
    tdm_dict = dict(res=res, xlimits=(0.0, W * res), ylimits=(0.0, H * res),
                    bin_values=bin_values,
                    bin_values_bounds=np.array([0.0, 1.0]),
                    det_dynamics_cvar_alpha=1.0 if mode == "tdm" else 0.5)
    lin, ang = pkg.TDM(cfg, **kw), pkg.TDM(cfg, **kw)
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    params = dict(dt=cfg.dt,
                  x0=(np.array([4.25, 5.25, 0.3]) * [scale, scale, 1]
                      if x0 is None else x0),
                  xgoal=np.array([17.0, 16.0]) * scale, goal_tolerance=0.5,
                  v_post_rollout=0.5, cvar_alpha=0.5, alpha_dyn=1.0,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([1.0, 1.5]),
                  vrange=np.array([0.0, 1.0]) * scale,
                  wrange=np.array([-np.pi, np.pi]))
    planner = pkg.MPPIPlanner(cfg, **kw)
    if not roi_enabled:
        planner._roi_shape = lambda hw: None
    planner.setup(params, lin, ang)
    return planner


def _port(roi_enabled, mode="tdm", **kw):
    return build_planner(tpkg, roi_enabled, mode, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["tdm", "det", "speed"])
def test_roi_crop_matches_full_map_exactly(mode):
    p_roi, p_full = _port(True, mode), _port(False, mode)
    static = p_roi._static()
    assert static.roi_shape is not None
    rH, rW = static.roi_shape
    assert rH < static.map_shape[0] and rW < static.map_shape[1]
    u_roi, u_full = p_roi.solve(), p_full.solve()
    np.testing.assert_array_equal(u_roi, u_full)
    np.testing.assert_array_equal(p_roi._last_aux.costs.numpy(),
                                  p_full._last_aux.costs.numpy())
    np.testing.assert_array_equal(p_roi.get_state_rollout(),
                                  p_full.get_state_rollout())


@pytest.mark.parametrize("res", [0.5, 0.25])
def test_roi_crop_matches_full_map_with_stochastic_pmf(res):
    p_roi = _port(True, stochastic_pmf=True, res=res)
    p_full = _port(False, stochastic_pmf=True, res=res)
    assert p_roi._static().roi_shape is not None
    for _ in range(2):
        u_roi, u_full = p_roi.solve(), p_full.solve()
        np.testing.assert_array_equal(u_roi, u_full)
        # The realized window grids equal the same window of the full maps.
        oy, ox = p_roi._last_aux.roi_offset.tolist()
        rH, rW = p_roi._static().roi_shape
        for name in ("lin_grids", "ang_grids"):
            np.testing.assert_array_equal(
                getattr(p_roi._last_aux, name).numpy(),
                getattr(p_full._last_aux, name).numpy()[
                    :, oy:oy + rH, ox:ox + rW])
        for p, u in ((p_roi, u_roi), (p_full, u_full)):
            p.shift_and_update(np.asarray(p.params["x0"]) + [0.3, 0.2, 0.0],
                               u)


def test_roi_offset_clamps_at_map_corner():
    corner = np.array([0.75, 0.75, 0.0])
    p = _port(True, x0=corner)
    u = p.solve()
    assert np.isfinite(u).all()
    off = p._last_aux.roi_offset
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), [0, 0])
    np.testing.assert_array_equal(u, _port(False, x0=corner).solve())


def test_roi_closed_loop_replans_with_moving_window():
    """The window's offset follows the robot; one cached solver serves
    every offset."""
    p = _port(True)
    static = p._static()
    x = np.asarray(p.params["x0"], dtype=np.float64)
    goal = np.asarray(p.params["xgoal"])
    d0 = np.linalg.norm(x[:2] - goal)
    offsets = []
    for _ in range(12):
        useq = p.solve()
        offsets.append(p._last_aux.roi_offset.tolist())
        v, w = useq[0]
        x = np.array([x[0] + p.dt * 0.8 * v * np.cos(x[2]),
                      x[1] + p.dt * 0.8 * v * np.sin(x[2]),
                      x[2] + p.dt * 0.8 * w])
        p.shift_and_update(x, useq, 1)
    assert np.linalg.norm(x[:2] - goal) < d0
    assert (np.asarray(offsets) >= 0).all()
    assert len({tuple(o) for o in offsets}) > 1, offsets
    assert p._static() == static
    assert get_terrain_solver(static, "cpu") is get_terrain_solver(static,
                                                                   "cpu")


def test_roi_disabled_for_models_without_displacement_bound():
    from mppi_numba_tpu_torch.models import (_REGISTRY,
                                             has_displacement_bound,
                                             register_model)

    def hover_step(x, y, th, v, w, lin_tr, ang_tr, dt):
        return x + dt * 2.0 * v, y, th

    register_model("hover-test", hover_step)
    try:
        assert not has_displacement_bound("hover-test")
        p = _port(True)
        p.cfg.model = "hover-test"
        assert p._static().roi_shape is None
        p.cfg.model = "unicycle"
        assert p._static().roi_shape is not None
    finally:
        _REGISTRY.pop("hover-test", None)


@pytest.mark.parametrize("res,xlim0", [(0.5, -1.0), (0.25, 0.0), (0.3, -1.3)])
def test_roi_start_matches_jax(res, xlim0):
    """The window's start on a grid of positions: cell edges, a float32 ulp
    either side of them, and points off the map on every side."""
    H, W, rH, rW = 40, 30, 13, 11
    f32 = np.float32
    edges = xlim0 + res * np.arange(-3, 44, dtype=np.float64)
    xs = np.concatenate([edges.astype(f32),
                         np.nextafter(edges.astype(f32), f32(-np.inf)),
                         np.nextafter(edges.astype(f32), f32(np.inf)),
                         f32([-50.0, 1e4])])
    jt = types.SimpleNamespace(xlim0=jnp.float32(xlim0),
                               ylim0=jnp.float32(xlim0 - res),
                               res=jnp.float32(res))
    tt = types.SimpleNamespace(xlim0=torch.tensor(xlim0, dtype=torch.float32),
                               ylim0=torch.tensor(xlim0 - res,
                                                  dtype=torch.float32),
                               res=torch.tensor(res, dtype=torch.float32))
    rng = np.random.RandomState(1)
    for x in xs:
        y = f32(rng.choice(xs))
        jt.x0 = jnp.asarray([x, y, 0.0], jnp.float32)
        tt.x0 = torch.tensor([x, y, 0.0], dtype=torch.float32)
        want = [int(v) for v in j_roi_start(jt, (H, W), (rH, rW))]
        got = _roi_start(tt, (H, W), (rH, rW))
        assert all(g.dtype == torch.int32 for g in got)
        assert [int(g) for g in got] == want, (x, y)


@pytest.mark.parametrize("x0", [(4.25, 5.25), (0.1, 19.9), (-3.0, 30.0),
                                (12.0, 0.25)])
def test_crop_window_matches_jax(x0):
    """``crop_window_plain`` (the plain version of the map-sampling
    kernel's crop mode) against the JAX package's ``_roi_start`` +
    ``_crop_maps`` + ``_shift_task_limits`` on the same maps and task:
    every plane, the shifted limits and the offset exact, inside the map,
    at its corners and off it; ``sample_and_pack_crop`` on CPU tensors
    runs it (no launch) and returns the same task and offset."""
    jp = build_planner(jpkg, True, "speed", stochastic_pmf=True)
    jstatic = jp._static()
    maps, task = jp._map_inputs(), jp._build_task()
    task = task._replace(x0=jnp.asarray([*x0, 0.3], jnp.float32))
    oy, ox = j_roi_start(task, jstatic.map_shape, jstatic.roi_shape)
    j_maps = j_crop_maps(maps, oy, ox, *jstatic.roi_shape)
    j_task = j_shift_task_limits(task, oy, ox)
    t_maps, t_task, _ = to_port(maps, task, np.zeros((2, 2), np.float32),
                                "cpu")
    c_maps, c_task, offset = crop_window_plain(
        t_maps, t_task, jstatic.map_shape, jstatic.roi_shape)
    before = sample_and_pack_crop.launches
    *_, s_task, s_offset = sample_and_pack_crop(
        torch.tensor([0, 7], dtype=torch.int64), t_maps, t_task, 2, "byte",
        jstatic.roi_shape)
    assert sample_and_pack_crop.launches == before  # CPU: the plain version
    assert torch.equal(s_offset, offset)
    assert offset.dtype == torch.int32
    np.testing.assert_array_equal(offset.numpy(), [int(oy), int(ox)])
    for name in c_maps._fields:
        np.testing.assert_array_equal(getattr(c_maps, name).numpy(),
                                      np.asarray(getattr(j_maps, name)))
    for name in ("xlim0", "ylim0"):
        assert (np.float32(getattr(c_task, name))
                == np.float32(getattr(j_task, name))
                == np.float32(getattr(s_task, name)))


def _jax_roi_world(mode):
    """A JAX planner's cropped static, maps and task on the stochastic
    world, the JAX solver forced onto its XLA path."""
    jp = build_planner(jpkg, True, mode, stochastic_pmf=True)
    jstatic = dataclasses.replace(jp._static(), backend="xla", num_opt=2)
    assert jstatic.roi_shape is not None
    return jstatic, jp._map_inputs(), jp._build_task()


@pytest.mark.parametrize("entry", ["solve_from_key", "solve_from_draws"])
@pytest.mark.parametrize("mode", ["tdm", "speed"])
def test_roi_solve_matches_jax(mode, entry):
    """The port's cropped solve fed JAX's draws (its map key's words, or
    its window uniforms, and its normals) against JAX's cropped solve:
    u, costs and weights within the whole-solve tolerance, the sampled
    grids and the window's offset exact."""
    jstatic, maps, task = _jax_roi_world(mode)
    K, T, M = (jstatic.num_control_rollouts, jstatic.num_steps,
               jstatic.num_grid_samples)
    key = jax.random.PRNGKey(11)
    u0 = np.zeros((T, 2), np.float32)
    j_u, j_aux = j_get_solver(jstatic)(key, maps, task, jnp.asarray(u0))

    kmap, knoise = jax.random.split(key)
    eps = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(knoise, i), (K, T, 2), dtype=jnp.float32)))
        for i in range(jstatic.num_opt)]
    fields = dataclasses.asdict(jstatic)
    fields["backend"] = "eager"
    solver = get_terrain_solver(SolverStatic(**fields), "cpu")
    t_maps, t_task, t_u0 = to_port(maps, task, u0, "cpu")
    if entry == "solve_from_key":
        map_key = torch.tensor(np.asarray(jax.random.key_data(kmap))
                               .astype(np.int64))
        u, aux = solver.solve_from_key(map_key, eps, t_maps, t_task, t_u0)
    else:
        oy, ox = j_roi_start(task, jstatic.map_shape, jstatic.roi_shape)
        uniforms = np.asarray(j_uniform_window(
            kmap, M, jstatic.map_shape, oy, ox, jstatic.roi_shape))
        u, aux = solver.solve_from_draws(torch.tensor(uniforms), eps, t_maps,
                                         t_task, t_u0)
    assert aux.roi_offset.dtype == torch.int32
    np.testing.assert_array_equal(aux.roi_offset.numpy(),
                                  np.asarray(j_aux.roi_offset))
    assert tuple(aux.lin_grids.shape[1:]) == jstatic.roi_shape
    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    np.testing.assert_array_equal(aux.ang_grids.numpy(),
                                  np.asarray(j_aux.ang_grids))
    for got, want in ((u, j_u), (aux.costs, j_aux.costs),
                      (aux.weights, j_aux.weights)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mode", ["tdm", "det"])
def test_roi_vis_matches_jax(mode):
    """The visualisation rollouts of a cropped solve: the port's vis, given
    the solve's ``roi_offset``, against JAX's on the same inputs (rtol and
    atol 1e-4, as ``tests/test_torch_vis.py``)."""
    jp = build_planner(jpkg, True, mode, stochastic_pmf=True)
    jstatic = dataclasses.replace(jp._static(), backend="xla")
    maps, task = jp._map_inputs(), jp._build_task()
    T = jstatic.num_steps
    rng = np.random.RandomState(4)
    u_cur = rng.uniform(0.0, 1.0, (T, 2)).astype(np.float32)
    u_prev = rng.uniform(0.0, 1.0, (T, 2)).astype(np.float32)
    _, j_aux = j_get_solver(jstatic)(jax.random.PRNGKey(2), maps, task,
                                     jnp.asarray(u_cur))
    assert int(np.asarray(j_aux.roi_offset).max()) > 0
    want = np.asarray(j_get_vis(jstatic)(
        maps, task, jnp.asarray(u_cur), jnp.asarray(u_prev), j_aux.noise_vis,
        j_aux.lin_grids, j_aux.ang_grids, j_aux.roi_offset))
    fields = dataclasses.asdict(jstatic)
    fields["backend"] = "eager"
    t_maps, t_task, _ = to_port(maps, task, u_cur, "cpu")
    got = get_terrain_vis(SolverStatic(**fields))(
        t_maps, t_task, torch.tensor(u_cur), torch.tensor(u_prev),
        torch.tensor(np.asarray(j_aux.noise_vis)),
        torch.tensor(np.asarray(j_aux.lin_grids)),
        torch.tensor(np.asarray(j_aux.ang_grids)),
        torch.tensor(np.asarray(j_aux.roi_offset)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
