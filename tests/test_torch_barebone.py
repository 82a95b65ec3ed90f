"""The port's barebone engine (terrain-free MPPI with circle obstacles) vs
the JAX package's, on the CPU: the rollout costs (rtol 1e-4), whole
solves fed JAX's own normals (rtol 2e-4 / atol 2e-5, the JAX package's
whole-solve tolerance), the vis rollouts, the config, and the planner's
closed loop on ``examples/barebone_mppi.py``'s task."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_numba_tpu as jpkg
import mppi_numba_tpu_torch as tpkg
from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.ops.rollout import (
    barebone_rollout_costs as j_barebone_rollout_costs)
from mppi_numba_tpu.solver import get_barebone_solver as j_get_solver
from mppi_numba_tpu.solver import get_barebone_vis as j_get_vis
from mppi_numba_tpu.types import BareboneTask as JTask
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import barebone_task_to_port
from mppi_numba_tpu_torch.ops.kernels import barebone_rollout as kbare
from mppi_numba_tpu_torch.ops.rollout import barebone_rollout_costs
from mppi_numba_tpu_torch.solver import get_barebone_solver, get_barebone_vis

K, T, V = 256, 30, 5
SOLVE_RTOL, SOLVE_ATOL = 2e-4, 2e-5


def _task():
    """examples/barebone_mppi.py's task."""
    f32 = np.float32
    return JTask(
        x0=np.array([0.0, 0.0, np.pi / 4], f32), xgoal=np.array([7.0, 5.0], f32),
        goal_tolerance=f32(0.5), lambda_weight=f32(1.0),
        u_std=np.array([1.0, 1.0], f32), vrange=np.array([0.0, 2.0], f32),
        wrange=np.array([-np.pi, np.pi], f32), dt=f32(0.1),
        dist_weight=f32(10.0), obs_penalty=f32(1e6),
        obs_pos=np.array([[5.0, 4.5], [2.0, 1.0]], f32),
        obs_r=np.array([1.5, 1.0], f32))


def _jt(task):
    return JTask(*(jnp.asarray(x) for x in task))


def _static(num_opt, pkg_static):
    return pkg_static(mode="barebone", num_steps=T, num_control_rollouts=K,
                      num_grid_samples=1, map_shape=(0, 0), num_obstacles=2,
                      cvar_numel=1, num_opt=num_opt,
                      num_vis_state_rollouts=V)


@pytest.mark.parametrize("seed", [0, 1])
def test_rollout_costs_match_jax(seed):
    rng = np.random.RandomState(seed)
    u = np.stack([rng.uniform(0.5, 2.0, T), rng.uniform(-1.0, 1.0, T)],
                 axis=-1).astype(np.float32)
    noise = rng.randn(K, T, 2).astype(np.float32)
    want = np.asarray(j_barebone_rollout_costs(_jt(_task()), jnp.asarray(u),
                                               jnp.asarray(noise)))
    got = barebone_rollout_costs(barebone_task_to_port(_task(), "cpu"),
                                 torch.tensor(u), torch.tensor(noise))
    assert got.shape == (K,) and got.dtype == torch.float32
    # Some rollouts hit the obstacles (1e6 each), and some reach the goal.
    assert (want > 1e6).any() and (want < 1e6).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("n_obs", [0, 2, 5])
def test_rollout_wrapper_runs_the_plain_version_on_the_cpu(n_obs):
    """On CPU tensors the kernel's wrapper is the plain loop, bit for bit,
    and counts no launch; with 0, 2 and 5 obstacles, within rtol 1e-4 of
    JAX's rollout."""
    rng = np.random.RandomState(10 + n_obs)
    u = np.stack([rng.uniform(0.5, 2.0, T), rng.uniform(-1.0, 1.0, T)],
                 axis=-1).astype(np.float32)
    noise = rng.randn(K, T, 2).astype(np.float32)
    task = _task()._replace(
        obs_pos=rng.uniform(0.0, 6.0, (n_obs, 2)).astype(np.float32),
        obs_r=rng.uniform(0.5, 1.5, n_obs).astype(np.float32))
    t_task = barebone_task_to_port(task, "cpu")
    before = kbare.barebone_rollout_fused.launches
    got = kbare.barebone_rollout_fused(t_task, torch.tensor(u),
                                       torch.tensor(noise))
    want = barebone_rollout_costs(t_task, torch.tensor(u),
                                  torch.tensor(noise))
    assert kbare.barebone_rollout_fused.launches == before
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert kbare.check_args(t_task, torch.tensor(u),
                            torch.tensor(noise)) == (K, T, n_obs)
    j = np.asarray(j_barebone_rollout_costs(_jt(task), jnp.asarray(u),
                                            jnp.asarray(noise)))
    np.testing.assert_allclose(got.numpy(), j, rtol=1e-4)


def test_rollout_wrapper_checks_the_kernels_inputs():
    """The kernel's argument check refuses what the kernel cannot read:
    noise of another shape or dtype, controls of another horizon, a
    task field of another shape or on another device."""
    task = barebone_task_to_port(_task(), "cpu")
    u, noise = torch.zeros(T, 2), torch.zeros(K, T, 2)
    assert kbare.check_args(task, u, noise) == (K, T, 2)
    for bad in (dict(noise=torch.zeros(K, T, 3)),
                dict(noise=torch.zeros(K, T, 2, dtype=torch.float64)),
                dict(u=torch.zeros(T + 1, 2)),
                dict(task=task._replace(obs_r=torch.ones(3))),
                dict(task=task._replace(vrange=torch.zeros(3))),
                dict(task=task._replace(dt=torch.tensor(0.1,
                                                        dtype=torch.float64)))):
        args = {**dict(task=task, u=u, noise=noise), **bad}
        with pytest.raises(ValueError):
            kbare.check_args(args["task"], args["u"], args["noise"])


@pytest.mark.parametrize("num_opt", [1, 2])
def test_solve_matches_jax(num_opt):
    task = _task()        # lambda 1, as the example has it
    key = jax.random.PRNGKey(3 + num_opt)
    j_u, j_aux = j_get_solver(_static(num_opt, JStatic))(
        key, _jt(task), jnp.zeros((T, 2), jnp.float32))
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(key, i), (K, T, 2),
                                        dtype=jnp.float32))
           for i in range(num_opt)]
    u, aux = get_barebone_solver(_static(num_opt, SolverStatic), "cpu") \
        .solve_from_draws([torch.tensor(e) for e in eps],
                          barebone_task_to_port(task, "cpu"),
                          torch.zeros((T, 2)))
    for name, a, b in (("u", u, j_u), ("costs", aux.costs, j_aux.costs),
                       ("weights", aux.weights, j_aux.weights),
                       ("noise_vis", aux.noise_vis, j_aux.noise_vis)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL, err_msg=name)
    assert aux.lin_grids is None and aux.noise_vis.shape == (V, T, 2)


def test_vis_matches_jax():
    rng = np.random.RandomState(4)
    u_cur, u_prev = (rng.uniform(-1.0, 2.0, (T, 2)).astype(np.float32)
                     for _ in range(2))
    noise = rng.randn(V, T, 2).astype(np.float32)
    want = np.asarray(j_get_vis(_static(1, JStatic))(
        _jt(_task()), jnp.asarray(u_cur), jnp.asarray(u_prev),
        jnp.asarray(noise)))
    got = get_barebone_vis(_static(1, SolverStatic))(
        barebone_task_to_port(_task(), "cpu"), torch.tensor(u_cur),
        torch.tensor(u_prev), torch.tensor(noise))
    assert got.shape == (V, T + 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_config_and_task_match_jax():
    kw = dict(T=5.0, dt=0.1, num_control_rollouts=50, num_vis_state_rollouts=80,
              seed=3)
    j, t = jpkg.BareboneConfig(**kw), tpkg.BareboneConfig(**kw)
    for attr in ("seed", "T", "dt", "num_steps", "num_control_rollouts",
                 "num_vis_state_rollouts"):
        assert getattr(t, attr) == getattr(j, attr), attr
    params = _params()
    del params["obstacle_positions"], params["obstacle_radius"]
    jp = jpkg.BareboneMPPI(jpkg.BareboneConfig(**kw))
    tp = tpkg.BareboneMPPI(tpkg.BareboneConfig(**kw), device="cpu")
    for p in (jp, tp):
        p.setup(params)
    assert dataclasses.asdict(tp._static()) == dataclasses.asdict(jp._static())
    for f in JTask._fields:
        np.testing.assert_array_equal(
            getattr(tp._task_device, f).numpy(),
            np.asarray(getattr(jp._task_device, f)), err_msg=f)


def _params():
    """examples/barebone_mppi.py's params."""
    return dict(dt=0.1, x0=np.array([0, 0, np.pi / 4]), xgoal=np.array([7, 5]),
                goal_tolerance=0.5, dist_weight=10, lambda_weight=1.0,
                num_opt=1, u_std=np.array([1.0, 1.0]),
                vrange=np.array([0.0, 2.0]), wrange=np.array([-np.pi, np.pi]),
                obstacle_positions=np.array([[5, 4.5], [2, 1]]),
                obstacle_radius=np.array([1.5, 1]), obs_penalty=1e6)


def test_closed_loop_reaches_goal_on_cpu():
    """examples/barebone_mppi.py's closed loop (K = 1000, T = 5 s) reaches
    the goal without entering an obstacle."""
    cfg = tpkg.BareboneConfig(T=5.0, dt=0.1, num_control_rollouts=1000,
                              num_vis_state_rollouts=20, seed=1)
    params = _params()
    planner = tpkg.BareboneMPPI(cfg, device="cpu")
    planner.setup(params)
    assert planner.get_state_rollout() is None
    x = params["x0"].astype(float)
    for _ in range(151):
        u = planner.solve()
        assert u.shape == (50, 2) and np.isfinite(u).all()
        # The reference's alias: "previous" controls are the solved ones.
        assert planner.u_prev is planner.u_cur
        x = x + cfg.dt * np.array([np.cos(x[2]) * u[0, 0],
                                   np.sin(x[2]) * u[0, 0], u[0, 1]])
        for pos, r in zip(params["obstacle_positions"],
                          params["obstacle_radius"]):
            assert np.hypot(*(x[:2] - pos)) > r
        planner.shift_and_update(x, u)
        if np.hypot(*(x[:2] - params["xgoal"])) <= params["goal_tolerance"]:
            break
    assert np.hypot(*(x[:2] - params["xgoal"])) <= params["goal_tolerance"]
    states = planner.get_state_rollout()
    assert states.shape == (20, 51, 3) and np.isfinite(states).all()
    np.testing.assert_array_equal(
        states[:, 0], np.broadcast_to(x.astype(np.float32), (20, 3)))


def _pair_params(**change):
    """``_params()`` with ``change``, for both packages' planners."""
    return dict(_params(), **change)


def test_planner_keeps_its_buffers_across_updates():
    """``set_params`` writes into the task buffers and ``shift_and_update``
    into them and the controls buffer, which the captured solve reads on
    a card: the same objects throughout, and ``u_cur`` is that buffer
    after a shift.  Another obstacle count gives new task buffers."""
    planner = tpkg.BareboneMPPI(tpkg.BareboneConfig(
        T=2.0, dt=0.1, num_control_rollouts=128, seed=2), device="cpu")
    planner.setup(_params())
    task, u_in = tuple(planner._task_device), planner._u_in
    assert planner.u_cur is u_in
    planner.set_params(_pair_params(xgoal=np.array([6.0, 4.0]),
                                    lambda_weight=2.0))
    u = planner.solve()
    planner.shift_and_update(np.array([0.1, 0.2, 0.3]), u)
    planner.shift_and_update(np.array([0.2, 0.3, 0.4]),
                             np.ones((20, 2), np.float32))
    assert all(a is b for a, b in zip(planner._task_device, task))
    assert planner._u_in is u_in and planner.u_cur is u_in
    np.testing.assert_array_equal(planner._task_device.xgoal.numpy(),
                                  np.float32([6.0, 4.0]))
    planner.set_params(_pair_params(
        obstacle_positions=np.array([[5, 4.5], [2, 1], [1, 3]]),
        obstacle_radius=np.array([1.5, 1, 0.5])))
    assert planner._task_device.obs_pos.shape == (3, 2)
    assert planner._task_device.x0 is not task[0]


def test_planner_buffers_equal_jax_after_updates():
    """After ``set_params``, a second ``set_params`` with other values and
    three ``shift_and_update`` calls (JAX's solved sequence, the port's
    solved sequence, a host array), the task fields and ``u_cur`` equal
    the JAX planner's exactly.  Each package shifts on the device when
    handed its own solved sequence and uploads the shifted host array
    otherwise; both give the same numbers."""
    kw = dict(T=2.0, dt=0.1, num_control_rollouts=128, seed=4)
    jp = jpkg.BareboneMPPI(jpkg.BareboneConfig(**kw))
    tp = tpkg.BareboneMPPI(tpkg.BareboneConfig(**kw), device="cpu")

    def same():
        for f in JTask._fields:
            np.testing.assert_array_equal(
                getattr(tp._task_device, f).numpy(),
                np.asarray(getattr(jp._task_device, f)), err_msg=f)
        np.testing.assert_array_equal(tp.u_cur.numpy(), np.asarray(jp.u_cur))

    for p in (jp, tp):
        p.setup(_params())
    same()
    other = _pair_params(x0=np.array([0.5, -0.25, 0.1]),
                         xgoal=np.array([6.5, 4.0]), lambda_weight=3.0,
                         u_std=np.array([0.5, 0.8]), dist_weight=4.0,
                         obstacle_positions=np.array([[4, 3.5], [1, 2]]),
                         obstacle_radius=np.array([1.0, 0.5]))
    for p in (jp, tp):
        p.set_params(other)
    same()
    rng = np.random.RandomState(5)
    for step in range(3):
        j_u, t_u = jp.solve(), tp.solve()
        u = (j_u, t_u, rng.uniform(-1, 1, (20, 2)).astype(np.float32))[step]
        x = np.array([0.1 * step, 0.05, 0.2 + step])
        for p in (jp, tp):
            p.shift_and_update(x, u.copy())
        same()
