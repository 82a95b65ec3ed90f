"""The whole stochastic (tdm) solve of the port vs the JAX package, fed
JAX's own draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_flagship
from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import to_numpy, to_port
from mppi_numba_tpu_torch.solver import (get_terrain_solver, resolve_backend)

K, M, T = 128, 16, 20
RTOL, ATOL = 2e-4, 2e-5       # the JAX package's whole-solve tolerance


def _jax_draws(key, static):
    H, W = static.map_shape
    kmap, knoise = jax.random.split(key)
    uniforms = np.asarray(jax.random.uniform(kmap, (M, H * W),
                                             dtype=jnp.float32))
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(knoise, i),
                                        (K, T, 2), dtype=jnp.float32))
           for i in range(static.num_opt)]
    return uniforms, eps


def _port_static(jstatic, backend):
    fields = dataclasses.asdict(jstatic)
    fields["backend"] = backend
    return SolverStatic(**fields)


@pytest.mark.parametrize("num_opt", [1, 2])
@pytest.mark.parametrize("jax_backend,port_backend,fast_trig", [
    ("xla", "eager", False),
    ("pallas_interpret", "cuda", True),
])
def test_solve_matches_jax(num_opt, jax_backend, port_backend, fast_trig):
    """22 bins on an 11x11 map, CVaR alpha 0.2, as bench.py's flagship."""
    jstatic, maps, task = build_flagship(K=K, M=M, T=T)
    jstatic = dataclasses.replace(jstatic, num_opt=num_opt,
                                  backend=jax_backend, fast_trig=fast_trig)
    key = jax.random.PRNGKey(3 + num_opt)
    u0 = np.zeros((T, 2), np.float32)
    j_u, j_aux = j_get_solver(jstatic)(key, maps, task, jnp.asarray(u0))

    uniforms, eps = _jax_draws(key, jstatic)
    t_maps, t_task, t_u0 = to_port(maps, task, u0, "cpu")
    solver = get_terrain_solver(_port_static(jstatic, port_backend), "cpu")
    assert solver.backend == port_backend
    u, aux = solver.solve_from_draws(
        torch.tensor(uniforms), [torch.tensor(e) for e in eps], t_maps,
        t_task, t_u0)

    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    np.testing.assert_array_equal(aux.ang_grids.numpy(),
                                  np.asarray(j_aux.ang_grids))
    for got, want in ((u, j_u), (aux.costs, j_aux.costs),
                      (aux.weights, j_aux.weights),
                      (aux.noise_vis, j_aux.noise_vis)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_solve_fn_draws_from_generator():
    jstatic, maps, task = build_flagship(K=K, M=M, T=T)
    t_maps, t_task, t_u0 = to_port(maps, task, np.zeros((T, 2), np.float32),
                                   "cpu")
    solver = get_terrain_solver(_port_static(jstatic, "auto"), "cpu")
    assert solver.backend == "eager"
    u1, aux1 = solver(torch.Generator().manual_seed(4), t_maps, t_task, t_u0)
    u2, aux2 = solver(torch.Generator().manual_seed(4), t_maps, t_task, t_u0)
    assert u1.shape == (T, 2) and torch.isfinite(u1).all()
    assert aux1.costs.shape == (K,) and aux1.lin_grids.shape == (M, 11, 11)
    np.testing.assert_array_equal(u1.numpy(), u2.numpy())


def test_convert_round_trips_bitwise():
    _, maps, task = build_flagship(K=K, M=M, T=T)
    u = np.random.RandomState(1).randn(T, 2).astype(np.float32)
    back_maps, back_task, back_u = to_numpy(*to_port(maps, task, u, "cpu"))
    for name in maps._fields:
        want = np.asarray(getattr(maps, name))
        got = getattr(back_maps, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)
    for name in task._fields:
        want = getattr(task, name)
        got = getattr(back_task, name)
        if want is None:
            assert got is None, name
            continue
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(back_u, u)


def test_backend_routing_and_later_slices():
    jstatic, _, _ = build_flagship(K=K, M=M, T=T)
    auto = _port_static(jstatic, "auto")
    assert resolve_backend(auto, "cpu") == "eager"
    assert resolve_backend(auto, "cuda") == "cuda"
    assert resolve_backend(_port_static(jstatic, "cuda"), "cpu") == "cuda"
    with pytest.raises(ValueError):
        resolve_backend(_port_static(jstatic, "pallas"), "cpu")
    for change in (dict(mode="det_dyn"), dict(mode="speed_map"),
                   dict(roi_shape=(5, 5)), dict(cvar_numel=-1)):
        with pytest.raises(NotImplementedError):
            get_terrain_solver(dataclasses.replace(auto, **change), "cpu")
