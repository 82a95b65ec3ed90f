"""The port's visualisation rollouts vs the JAX package's: the state
rollout (``terrain_vis_states``) and the solver's vis function in tdm,
det_dyn and speed_map, on the same numpy inputs, at rtol 1e-4 / atol 1e-4 m
over T = 20 steps (float32 trig in XLA and torch differs by ulps, which
the Euler steps carry along); then the planner's ``get_state_rollout`` on
the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_numba_tpu_torch as tpkg
from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.models import bicycle_step as j_bicycle_step
from mppi_numba_tpu.models import unicycle_step as j_unicycle_step
from mppi_numba_tpu.ops.rollout import terrain_vis_states as j_vis_states
from mppi_numba_tpu.solver import get_terrain_vis as j_get_terrain_vis
from mppi_numba_tpu.types import MapInputs as JMaps
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import maps_to_port, task_to_port
from mppi_numba_tpu_torch.models import bicycle_step, unicycle_step
from mppi_numba_tpu_torch.ops.rollout import terrain_vis_states
from mppi_numba_tpu_torch.solver import get_terrain_vis

RTOL, ATOL = 1e-4, 1e-4
T, H, W, V, M = 20, 21, 30, 4, 6


def _task():
    f32 = np.float32
    return JTask(
        x0=np.array([4.0, 3.0, 0.3], f32), xgoal=np.array([18.0, 12.0], f32),
        goal_tolerance=f32(0.5), v_post_rollout=f32(0.01),
        lambda_weight=f32(1.0), u_std=np.array([1.0, 0.4], f32),
        vrange=np.array([0.0, 2.0], f32), wrange=np.array([-0.5, 0.5], f32),
        dt=f32(0.1), dist_weight=f32(1.0), obs_penalty=f32(1e4),
        unknown_penalty=f32(1e2), alpha_dyn=f32(1.0), res=f32(0.5),
        xlim0=f32(-1.0), ylim0=f32(-1.0), lin_lb=f32(0.05),
        lin_ratio=f32(0.0093), ang_lb=f32(0.1), ang_ratio=f32(0.0071))


def _draws(seed):
    """Decoded grids, masks, controls and noise rows (numpy)."""
    rng = np.random.RandomState(seed)
    i8 = np.int8
    maps = JMaps(lin_pmf=None, ang_pmf=None, lin_qbins=None, ang_qbins=None,
                 obstacle=(rng.rand(H, W) < 0.1).astype(i8),
                 unknown=(rng.rand(H, W) < 0.1).astype(i8),
                 risk=rng.randint(0, 101, (H, W)).astype(i8))
    u_cur = np.stack([rng.uniform(0.5, 2.0, T), rng.uniform(-0.5, 0.5, T)],
                     axis=-1).astype(np.float32)
    u_prev = np.stack([rng.uniform(0.5, 2.0, T), rng.uniform(-0.5, 0.5, T)],
                      axis=-1).astype(np.float32)
    return dict(maps=maps, u_cur=u_cur, u_prev=u_prev,
                noise=(rng.randn(V, T, 2) * [1.0, 0.4]).astype(np.float32),
                lin=rng.randint(0, 101, (M, H, W)).astype(i8),
                ang=rng.randint(0, 101, (M, H, W)).astype(i8))


def _jt(task):
    return JTask(*(None if x is None else jnp.asarray(x) for x in task))


@pytest.mark.parametrize("model", ["unicycle", "bicycle"])
def test_vis_states_match_jax(model):
    rng = np.random.RandomState(3)
    words = rng.randint(0, 1 << 18, (V, H, W)).astype(np.int32)
    controls = np.stack([rng.uniform(0.0, 2.0, (V, T)),
                         rng.uniform(-0.5, 0.5, (V, T))],
                        axis=-1).astype(np.float32)
    j_step, t_step = ((j_unicycle_step, unicycle_step) if model == "unicycle"
                      else (j_bicycle_step, bicycle_step))
    want = np.asarray(j_vis_states(jnp.asarray(words), _jt(_task()),
                                   jnp.asarray(controls), step_fn=j_step))
    got = terrain_vis_states(torch.tensor(words), task_to_port(_task(), "cpu"),
                             torch.tensor(controls), step_fn=t_step)
    assert got.shape == (V, T + 1, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["tdm", "det_dyn", "speed_map"])
def test_terrain_vis_matches_jax(mode):
    d = _draws(seed=11)
    m = M if mode == "tdm" else 1
    lin, ang = d["lin"][:m], d["ang"][:m]
    fields = dict(mode=mode, num_steps=T, num_control_rollouts=128,
                  num_grid_samples=m, map_shape=(H, W), num_obstacles=0,
                  cvar_numel=1, num_opt=1, num_vis_state_rollouts=V)
    j_maps = JMaps(*(None if x is None else jnp.asarray(x) for x in d["maps"]))
    want = np.asarray(j_get_terrain_vis(JStatic(**fields))(
        j_maps, _jt(_task()), jnp.asarray(d["u_cur"]),
        jnp.asarray(d["u_prev"]), jnp.asarray(d["noise"]), jnp.asarray(lin),
        jnp.asarray(ang), jnp.zeros(2, jnp.int32)))
    got = get_terrain_vis(SolverStatic(**fields))(
        maps_to_port(d["maps"], "cpu"), task_to_port(_task(), "cpu"),
        torch.tensor(d["u_cur"]), torch.tensor(d["u_prev"]),
        torch.tensor(d["noise"]), torch.tensor(lin), torch.tensor(ang))
    assert got.shape == (V, T + 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _planner(mode):
    pmf = np.zeros((4, 24, 32), np.int8)
    pmf[1], pmf[2], pmf[3] = 20, 30, 50
    cfg = tpkg.Config(T=2.0, dt=0.1, num_grid_samples=8,
                      num_control_rollouts=128, max_speed_padding=2.0,
                      num_vis_state_rollouts=V, max_map_dim=(60, 60), seed=0,
                      use_tdm=mode == "tdm",
                      use_det_dynamics=mode == "det_dyn")
    tdm_dict = dict(res=0.5, xlimits=(0.0, 16.0), ylimits=(0.0, 12.0),
                    bin_values=[0.0, 0.4, 0.7, 1.0],
                    bin_values_bounds=(0.0, 1.0),
                    det_dynamics_cvar_alpha=1.0 if mode == "tdm" else 0.3)
    lin, ang = tpkg.TDM(cfg, device="cpu"), tpkg.TDM(cfg, device="cpu")
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = tpkg.MPPIPlanner(cfg, device="cpu")
    planner.setup(dict(dt=0.1, x0=np.array([2.0, 2.0, 0.5]),
                       xgoal=np.array([12.0, 9.0]), goal_tolerance=0.5,
                       v_post_rollout=0.01, cvar_alpha=0.5,
                       lambda_weight=1.0, u_std=np.array([1.0, 1.0]),
                       vrange=np.array([0.0, 2.0]),
                       wrange=np.array([-1.5, 1.5])), lin, ang)
    return planner


@pytest.mark.parametrize("mode", ["tdm", "det_dyn"])
def test_planner_state_rollout_on_cpu(mode):
    planner = _planner(mode)
    assert planner.get_state_rollout() is None      # no solve yet
    x = np.array([2.0, 2.0, 0.5])
    for _ in range(2):
        u = planner.solve()
        x = x + 0.1 * np.array([u[0, 0] * np.cos(x[2]),
                                u[0, 0] * np.sin(x[2]), u[0, 1]])
        planner.shift_and_update(x, u)
    planner.solve()
    states = planner.get_state_rollout()
    assert isinstance(states, np.ndarray) and states.dtype == np.float32
    assert states.shape == (V, planner.num_steps + 1, 3)
    assert np.isfinite(states).all()
    np.testing.assert_array_equal(states[:, 0],
                                  np.broadcast_to(x.astype(np.float32),
                                                  (V, 3)))
    if mode == "det_dyn":
        # The reference's alias: the vis perturbs the solved controls.
        assert planner.u_prev is planner.u_cur
    else:
        # tdm rolls the one optimal sequence across V sampled maps.
        assert not np.array_equal(states[0], states[1])
