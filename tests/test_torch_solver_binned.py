"""Whole det_dyn / speed_map / tdm solves of the port on each binned layout
vs the JAX package's interpret-mode binned kernels, fed JAX's own draws;
the 'auto' routing table; run-time CVaR alpha."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.solver import DYNAMIC_CVAR as J_DYNAMIC_CVAR
from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu.types import MapInputs as JMaps
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import to_port
from mppi_numba_tpu_torch.solver import (DYNAMIC_CVAR, get_terrain_solver,
                                         resolve_backend)

K, T, H, W = 128, 12, 21, 30
RTOL, ATOL = 2e-4, 2e-5       # the JAX package's whole-solve tolerance
# Port backend -> (JAX backend, PMF bins it serves).
LAYOUTS = {"binned2": ("pallas_binned2_interpret", 4),
           "binned": ("pallas_binned_interpret", 12),
           "binned8": ("pallas_binned8_interpret", 22)}


def build(mode, B, unnormalized=0, cvar_numel=None):
    """A 21x30 world as numpy NamedTuples: B-bin PMF, penalty cells, a
    risk plane; ``unnormalized`` columns sum to 60 (draws past the last
    bin); M = 8 in tdm mode and 1 in the det modes."""
    M = 8 if mode == "tdm" else 1
    rng = np.random.RandomState(3 + B)
    raw = rng.randint(1, 100, size=(B, H, W)).astype(float)
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    for i in range(unnormalized):
        pmf[:, 2 + i, 4 + 3 * i] = 0
        pmf[B - 1, 2 + i, 4 + 3 * i] = 60
    qbins = np.sort(rng.choice(101, size=B, replace=False)).astype(np.int8)
    f32 = np.float32
    maps = JMaps(lin_pmf=pmf, ang_pmf=pmf[::-1].copy(), lin_qbins=qbins,
                 ang_qbins=qbins,
                 obstacle=(rng.rand(H, W) < 0.05).astype(np.int8),
                 unknown=(rng.rand(H, W) < 0.05).astype(np.int8),
                 risk=rng.randint(20, 101, (H, W)).astype(np.int8))
    task = JTask(
        x0=np.array([4.0, 3.0, 0.3], f32),
        xgoal=np.array([W * 0.6, H * 0.6], f32), goal_tolerance=f32(0.5),
        # lambda 10: the costs are ~2e3 (terminal distance / v_post), where
        # one float32 ulp is 1.2e-4; at lambda 1 the few ulps by which
        # XLA's and torch's CPU sin/cos and reductions differ would move the
        # softmax weights past rtol on their own.
        v_post_rollout=f32(0.01), lambda_weight=f32(10.0),
        u_std=np.array([1.0, 1.5], f32), vrange=np.array([0.0, 2.0], f32),
        wrange=np.array([-3.0, 3.0], f32), dt=f32(0.1), dist_weight=f32(1.0),
        obs_penalty=f32(1e4), unknown_penalty=f32(1e2), alpha_dyn=f32(1.0),
        res=f32(1.0), xlim0=f32(0.0), ylim0=f32(0.0), lin_lb=f32(0.0),
        lin_ratio=f32(0.01), ang_lb=f32(0.0), ang_ratio=f32(0.01),
        cvar_alpha=f32(0.3))
    static = JStatic(mode=mode, num_steps=T, num_control_rollouts=K,
                     num_grid_samples=M, map_shape=(H, W), num_obstacles=0,
                     cvar_numel=(cvar_numel if cvar_numel is not None
                                 else (3 if M > 1 else 1)),
                     num_opt=1, num_vis_state_rollouts=2, num_pmf_bins=B)
    return static, maps, task


def jax_solve(static, maps, task, key):
    jm = JMaps(*(jnp.asarray(x) for x in maps))
    jt = JTask(*(jnp.asarray(x) for x in task))
    return j_get_solver(static)(key, jm, jt, jnp.zeros((T, 2), jnp.float32))


def port_solve(static, backend, maps, task, key):
    """The port's solve on the CPU with the JAX solve's own draws."""
    H_, W_ = static.map_shape
    M = static.num_grid_samples
    kmap, knoise = jax.random.split(key)
    uniforms = np.asarray(jax.random.uniform(kmap, (M, H_ * W_),
                                             dtype=jnp.float32))
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(knoise, i),
                                        (K, T, 2), dtype=jnp.float32))
           for i in range(static.num_opt)]
    fields = dataclasses.asdict(static)
    fields["backend"] = backend
    solver = get_terrain_solver(SolverStatic(**fields), "cpu")
    assert solver.backend == backend
    t_maps, t_task, t_u0 = to_port(maps, task, np.zeros((T, 2), np.float32),
                                   "cpu")
    return solver.solve_from_draws(torch.tensor(uniforms),
                                   [torch.tensor(e) for e in eps], t_maps,
                                   t_task, t_u0)


def assert_solves_match(got, want):
    (u, aux), (j_u, j_aux) = got, want
    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    np.testing.assert_array_equal(aux.ang_grids.numpy(),
                                  np.asarray(j_aux.ang_grids))
    for name, a, b in (("u", u, j_u), ("costs", aux.costs, j_aux.costs),
                       ("weights", aux.weights, j_aux.weights),
                       ("noise_vis", aux.noise_vis, j_aux.noise_vis)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("fast_trig", [False, True])
@pytest.mark.parametrize("num_opt", [1, 2])
@pytest.mark.parametrize("mode", ["tdm", "det_dyn", "speed_map"])
@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_binned_solve_matches_jax(backend, mode, num_opt, fast_trig):
    j_backend, B = LAYOUTS[backend]
    static, maps, task = build(mode, B, unnormalized=2 if mode == "tdm" else 0)
    static = dataclasses.replace(static, num_opt=num_opt, backend=j_backend,
                                 fast_trig=fast_trig)
    key = jax.random.PRNGKey(5 + num_opt)
    assert_solves_match(port_solve(static, backend, maps, task, key),
                        jax_solve(static, maps, task, key))


@pytest.mark.parametrize("mode", ["det_dyn", "speed_map"])
def test_eager_det_modes_match_jax_xla(mode):
    static, maps, task = build(mode, 12)
    static = dataclasses.replace(static, num_opt=2, backend="xla")
    key = jax.random.PRNGKey(13)
    assert_solves_match(port_solve(static, "eager", maps, task, key),
                        jax_solve(static, maps, task, key))


@pytest.mark.parametrize("port_backend,j_backend", [
    ("eager", "xla"), ("binned", "pallas_binned_interpret")])
def test_dynamic_cvar_solve_matches_jax(port_backend, j_backend):
    """Run-time alpha (DYNAMIC_CVAR): the sort-and-mask CVaR reads
    task.cvar_alpha, as the benchmark's noisy_dyn method runs it."""
    assert DYNAMIC_CVAR == J_DYNAMIC_CVAR
    static, maps, task = build("tdm", 12, cvar_numel=J_DYNAMIC_CVAR)
    static = dataclasses.replace(static, num_opt=2, backend=j_backend)
    key = jax.random.PRNGKey(19)
    assert_solves_match(port_solve(static, port_backend, maps, task, key),
                        jax_solve(static, maps, task, key))


def test_auto_routing_table():
    """'auto' on a CUDA device: the JAX package's layout order without its
    VMEM tests (tests/test_solver_backends.py's table, '_stream' dropped);
    on the CPU it is 'eager'."""
    def static(bins, shape, mode="tdm"):
        m = 1024 if mode == "tdm" else 1
        return SolverStatic(mode=mode, num_steps=100,
                            num_control_rollouts=1024, num_grid_samples=m,
                            map_shape=shape, num_obstacles=0,
                            cvar_numel=205 if m > 1 else 1, num_opt=1,
                            num_vis_state_rollouts=1, num_pmf_bins=bins)

    table = [
        (22, (11, 11), "tdm", "byte"),
        (4, (11, 11), "tdm", "byte"),
        (12, (140, 84), "tdm", "binned"),
        (4, (140, 84), "tdm", "binned2"),
        (2, (140, 84), "det_dyn", "binned2"),
        (4, (250, 250), "tdm", "binned2"),
        (5, (250, 250), "tdm", "binned"),
        (16, (250, 250), "speed_map", "binned"),
        (17, (40, 40), "tdm", "byte"),
        (22, (40, 40), "tdm", "byte"),
        (22, (140, 84), "tdm", "binned8"),
        (22, (250, 250), "tdm", "binned8"),
        (22, (250, 250), "det_dyn", "binned8"),
        (22, (250, 250), "speed_map", "binned8"),
    ]
    for bins, shape, mode, want in table:
        s = static(bins, shape, mode)
        assert resolve_backend(s, "cuda") == want, (bins, shape, mode)
        assert resolve_backend(s, "cpu") == "eager"


def test_binned_pack_refuses_too_many_bins():
    static, maps, task = build("tdm", 12)
    with pytest.raises(ValueError, match="at most 4 PMF bins"):
        port_solve(dataclasses.replace(static, num_pmf_bins=0), "binned2",
                   maps, task, jax.random.PRNGKey(0))
