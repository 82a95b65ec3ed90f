"""The bicycle model in the port's rollout kernels vs the JAX package.

The JAX package traces any registered step function into its Pallas
kernels on the exact-trig path (tests/test_pallas_kernel.py::
test_pluggable_model_traces_into_kernels); the port's CUDA kernels carry
the built-in models as a template argument, read from the step function's
``kernel_model`` tag.  Here, on the CPU: each kernel's plain version with
the bicycle against the JAX package's interpret-mode kernel (rtol 1e-5 /
atol 1e-4, that test's tolerance), whole bicycle tdm solves on each layout
against JAX's interpret-mode solves fed the same draws (rtol 2e-4 / atol
2e-5, the JAX package's whole-solve tolerance), and the tags.  The kernels
themselves are held against their plain versions on a card in
test_torch_kernels_gpu.py.

Steering stays within +-0.5 rad, a range a vehicle would use: tan(delta)
stays near delta there, far from the pole at pi/2 where an ulp of delta
would move the heading by a large step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu import models as jmodels
from mppi_numba_tpu.models import bicycle_step as j_bicycle_step
from mppi_numba_tpu.ops import packing as jpacking
from mppi_numba_tpu.ops.pallas.rollout_kernel import (
    build_bin_luts as j_build_bin_luts, build_task_vec as j_build_task_vec,
    terrain_rollout_costs_pallas, terrain_rollout_costs_pallas_binned)
from mppi_numba_tpu.ops.rollout import _clipped_controls_tk as j_clipped
from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu.types import MapInputs as JMaps
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch import models
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import task_to_port, to_port
from mppi_numba_tpu_torch.ops import packing as tpacking
from mppi_numba_tpu_torch.ops.kernels import rollout_binned, rollout_byte
from mppi_numba_tpu_torch.ops.rollout import (_clipped_controls_tk,
                                              terrain_rollout_costs)
from mppi_numba_tpu_torch.ops.sampling import decode_bins
from mppi_numba_tpu_torch.solver import get_terrain_solver

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
SOLVE_RTOL, SOLVE_ATOL = 2e-4, 2e-5
STEER = 0.5
BINS = {2: 4, 4: 16, 8: 22}
# A car's wheelbase (m): its float32 reciprocal is inexact, so a rollout
# that divided otherwise than the step function shows there.  Held to the
# exact-trig parity tolerance, 1e-4 relative on costs.
CAR_WHEELBASE = 2.7
CAR_RTOL = 1e-4


def _task(**over):
    f32 = np.float32
    fields = dict(
        x0=np.array([4.0, 3.0, 0.3], f32), xgoal=np.array([18.0, 12.0], f32),
        goal_tolerance=f32(0.5), v_post_rollout=f32(0.01),
        lambda_weight=f32(1.0), u_std=np.array([1.0, 0.3], f32),
        vrange=np.array([0.0, 2.0], f32),
        wrange=np.array([-STEER, STEER], f32), dt=f32(0.1),
        dist_weight=f32(1.0), obs_penalty=f32(1e4), unknown_penalty=f32(1e2),
        alpha_dyn=f32(1.0), res=f32(1.0), xlim0=f32(0.0), ylim0=f32(0.0),
        lin_lb=f32(0.0), lin_ratio=f32(0.01), ang_lb=f32(0.0),
        ang_ratio=f32(0.01), cvar_alpha=f32(0.3))
    fields.update(over)
    return JTask(**fields)


def _jax_task(task):
    return JTask(*(None if x is None else jnp.asarray(x) for x in task))


def _kernel_problem(cell_bits, seed, K=128, M=5, T=16, H=21, W=30):
    """Bin indices, including draws one past the last bin, the shared
    planes, quantized bin values, controls and noise (numpy)."""
    rng = np.random.RandomState(seed)
    B = BINS[cell_bits]
    return dict(
        lin_bins=rng.randint(0, B + 1, (M, H, W)).astype(np.int32),
        ang_bins=rng.randint(0, B + 1, (M, H, W)).astype(np.int32),
        qbins=np.sort(rng.choice(101, B, replace=False)).astype(np.int8),
        obs=(rng.rand(H, W) < 0.1).astype(np.int8),
        unk=(rng.rand(H, W) < 0.1).astype(np.int8),
        risk=rng.randint(1, 101, (H, W)).astype(np.int8),
        u=np.stack([rng.uniform(0.0, 1.5, T), rng.uniform(-0.3, 0.3, T)],
                   axis=-1).astype(np.float32),
        noise=rng.randn(K, T, 2).astype(np.float32), H=H, W=W, T=T)


def _grids(p):
    q = torch.tensor(p["qbins"])
    return (decode_bins(q, torch.tensor(p["lin_bins"])).numpy(),
            decode_bins(q, torch.tensor(p["ang_bins"])).numpy())


def _check_plain_byte_bicycle(speed_map, j_step, t_step, rtol, atol):
    p = _kernel_problem(8, seed=31 + speed_map)
    H, W, T = p["H"], p["W"], p["T"]
    lin, ang = _grids(p)
    risk = p["risk"] if speed_map else None
    jt = _jax_task(_task())
    j_words = jpacking.pack_map_words(
        jnp.asarray(lin), jnp.asarray(ang), jnp.asarray(p["obs"]),
        jnp.asarray(p["unk"]), None if risk is None else jnp.asarray(risk))
    v, w = j_clipped(jnp.asarray(p["u"]), jnp.asarray(p["noise"]) * jt.u_std,
                     jt.vrange, jt.wrange)
    want = np.asarray(terrain_rollout_costs_pallas(
        j_words, j_build_task_vec(jt), v, w, H=H, W=W, T=T,
        speed_map=speed_map, interpret=True, step_fn=j_step))

    pt = task_to_port(_task(), "cpu")
    words = tpacking.pack_map_words(
        torch.tensor(lin), torch.tensor(ang), torch.tensor(p["obs"]),
        torch.tensor(p["unk"]), None if risk is None else torch.tensor(risk))
    tv, tw = _clipped_controls_tk(torch.tensor(p["u"]),
                                  torch.tensor(p["noise"]) * pt.u_std,
                                  pt.vrange, pt.wrange)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w))
    got = rollout_byte.terrain_rollout_costs_byte(
        words, rollout_byte.build_task_vec(pt), tv.contiguous(),
        tw.contiguous(), H=H, W=W, T=T, speed_map=speed_map,
        step_fn=t_step)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    # The plain version is the eager rollout's bicycle, step for step.
    eager = terrain_rollout_costs(words, pt, torch.tensor(p["u"]),
                                  torch.tensor(p["noise"]) * pt.u_std,
                                  speed_map=speed_map,
                                  step_fn=t_step)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("speed_map", [False, True])
def test_plain_byte_bicycle_matches_jax_pallas_interpret(speed_map):
    _check_plain_byte_bicycle(speed_map, j_bicycle_step, models.bicycle_step,
                              KERNEL_RTOL, KERNEL_ATOL)


@pytest.mark.parametrize("speed_map", [False, True])
def test_plain_byte_bicycle_car_wheelbase_matches_jax(speed_map):
    _check_plain_byte_bicycle(
        speed_map, jmodels.make_bicycle_step(CAR_WHEELBASE),
        models.make_bicycle_step(CAR_WHEELBASE), CAR_RTOL, 0.0)


def _check_plain_binned_bicycle(cell_bits, speed_map, j_step, t_step, rtol,
                                atol):
    p = _kernel_problem(cell_bits, seed=40 + cell_bits + 10 * speed_map)
    H, W, T = p["H"], p["W"], p["T"]
    jt = _jax_task(_task())
    pt = task_to_port(_task(), "cpu")
    q = p["qbins"]
    if cell_bits == 8:
        lin, ang = _grids(p)
    else:
        lin, ang = p["lin_bins"], p["ang_bins"]
    pack = {2: "pack_bin_crumbs", 4: "pack_bin_nibbles",
            8: "pack_byte_pairs"}[cell_bits]
    v, w = j_clipped(jnp.asarray(p["u"]), jnp.asarray(p["noise"]) * jt.u_std,
                     jt.vrange, jt.wrange)
    want = np.asarray(terrain_rollout_costs_pallas_binned(
        getattr(jpacking, pack)(jnp.asarray(lin), jnp.asarray(ang)),
        jpacking.pack_mask_nibbles(jnp.asarray(p["obs"]),
                                   jnp.asarray(p["unk"])),
        None if cell_bits == 8 else j_build_bin_luts(jt, jnp.asarray(q),
                                                     jnp.asarray(q)),
        j_build_task_vec(jt), v, w,
        jpacking.pack_risk_bytes(jnp.asarray(p["risk"])) if speed_map
        else None,
        H=H, W=W, T=T, interpret=True, cell_bits=cell_bits,
        step_fn=j_step))

    tv, tw = _clipped_controls_tk(torch.tensor(p["u"]),
                                  torch.tensor(p["noise"]) * pt.u_std,
                                  pt.vrange, pt.wrange)
    got = rollout_binned.terrain_rollout_costs_binned(
        getattr(tpacking, pack)(torch.tensor(lin), torch.tensor(ang)),
        tpacking.pack_mask_nibbles(torch.tensor(p["obs"]),
                                   torch.tensor(p["unk"])),
        None if cell_bits == 8 else rollout_binned.build_bin_luts(
            pt, torch.tensor(q), torch.tensor(q)),
        rollout_byte.build_task_vec(pt), tv.contiguous(), tw.contiguous(),
        tpacking.pack_risk_bytes(torch.tensor(p["risk"])) if speed_map
        else None,
        H=H, W=W, T=T, cell_bits=cell_bits, step_fn=t_step)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("cell_bits", [2, 4, 8])
def test_plain_binned_bicycle_matches_jax_pallas_interpret(cell_bits,
                                                           speed_map):
    _check_plain_binned_bicycle(cell_bits, speed_map, j_bicycle_step,
                                models.bicycle_step, KERNEL_RTOL, KERNEL_ATOL)


@pytest.mark.parametrize("cell_bits", [2, 4, 8])
def test_plain_binned_bicycle_car_wheelbase_matches_jax(cell_bits):
    _check_plain_binned_bicycle(
        cell_bits, cell_bits == 4, jmodels.make_bicycle_step(CAR_WHEELBASE),
        models.make_bicycle_step(CAR_WHEELBASE), CAR_RTOL, 0.0)


# Port backend -> (JAX backend, PMF bins it serves).
LAYOUTS = {"byte": ("pallas_interpret", 12),
           "binned2": ("pallas_binned2_interpret", 4),
           "binned": ("pallas_binned_interpret", 12),
           "binned8": ("pallas_binned8_interpret", 22)}
K, T, H, W, M = 128, 12, 21, 30, 8


def _world(B):
    """A 21x30 tdm world with a B-bin PMF and penalty cells (numpy)."""
    rng = np.random.RandomState(60 + B)
    raw = rng.randint(1, 100, size=(B, H, W)).astype(float)
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    qbins = np.sort(rng.choice(101, size=B, replace=False)).astype(np.int8)
    maps = JMaps(lin_pmf=pmf, ang_pmf=pmf[::-1].copy(), lin_qbins=qbins,
                 ang_qbins=qbins,
                 obstacle=(rng.rand(H, W) < 0.05).astype(np.int8),
                 unknown=(rng.rand(H, W) < 0.05).astype(np.int8),
                 risk=np.zeros((H, W), np.int8))
    # lambda 10, as tests/test_torch_solver_binned.py explains: at costs
    # near 2e3 (one float32 ulp is 1.2e-4) the ulps by which XLA's and
    # torch's CPU trig and reductions differ would move the softmax
    # weights past the tolerance at lambda 1.  Penalties of 1e2 keep the
    # costs there: with 1e4 a few hits in the CVaR tail lift them to 1.2e5,
    # where one ulp (0.0078) moves u by 4e-5 even at lambda 10.
    task = _task(xgoal=np.array([W * 0.6, H * 0.6], np.float32),
                 lambda_weight=np.float32(10.0),
                 obs_penalty=np.float32(1e2))
    return maps, task


def _check_bicycle_solve(backend, num_opt, model="bicycle"):
    j_backend, B = LAYOUTS[backend]
    maps, task = _world(B)
    j_static = JStatic(mode="tdm", num_steps=T, num_control_rollouts=K,
                       num_grid_samples=M, map_shape=(H, W), num_obstacles=0,
                       cvar_numel=3, num_opt=num_opt,
                       num_vis_state_rollouts=2, num_pmf_bins=B,
                       backend=j_backend, model=model)
    key = jax.random.PRNGKey(70 + num_opt)
    j_u, j_aux = j_get_solver(j_static)(
        key, JMaps(*(jnp.asarray(x) for x in maps)), _jax_task(task),
        jnp.zeros((T, 2), jnp.float32))

    kmap, knoise = jax.random.split(key)
    uniforms = np.asarray(jax.random.uniform(kmap, (M, H * W),
                                             dtype=jnp.float32))
    eps = [np.asarray(jax.random.normal(jax.random.fold_in(knoise, i),
                                        (K, T, 2), dtype=jnp.float32))
           for i in range(num_opt)]
    fields = dataclasses.asdict(j_static)
    fields["backend"] = backend
    solver = get_terrain_solver(SolverStatic(**fields), "cpu")
    assert solver.backend == backend
    t_maps, t_task, t_u0 = to_port(maps, task, np.zeros((T, 2), np.float32),
                                   "cpu")
    u, aux = solver.solve_from_draws(torch.tensor(uniforms),
                                     [torch.tensor(e) for e in eps], t_maps,
                                     t_task, t_u0)
    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    for name, a, b in (("u", u, j_u), ("costs", aux.costs, j_aux.costs),
                       ("weights", aux.weights, j_aux.weights)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL, err_msg=name)


@pytest.mark.parametrize("num_opt", [1, 2])
@pytest.mark.parametrize("backend", sorted(LAYOUTS))
def test_bicycle_solve_matches_jax(backend, num_opt):
    _check_bicycle_solve(backend, num_opt)


@pytest.mark.parametrize("backend", ["byte", "binned"])
def test_bicycle_car_wheelbase_solve_matches_jax(backend):
    """A whole solve of a car-sized bicycle (2.7 m wheelbase), registered
    under one name in both packages, against JAX's interpret-mode solve."""
    name = "bicycle_car_test"
    jmodels.register_model(name, jmodels.make_bicycle_step(CAR_WHEELBASE),
                           displacement_bounded=True)
    models.register_model(name, models.make_bicycle_step(CAR_WHEELBASE),
                          displacement_bounded=True)
    try:
        _check_bicycle_solve(backend, 2, model=name)
    finally:
        for registry in (jmodels, models):
            registry._REGISTRY.pop(name)
            registry._UNICYCLE_DISPLACEMENT_BOUNDED.discard(name)


def test_kernel_model_tags():
    """The built-in models carry their kernel form; a custom registered
    model has none and is refused by name, pointing at the eager backend."""
    assert models.kernel_model(None) == (0, 0.0)
    assert models.kernel_model(models.unicycle_step) == (0, 0.0)
    assert models.kernel_model(models.bicycle_step) == (1, 0.5)
    assert models.kernel_model(models.make_bicycle_step(0.3)) == (
        1, float(0.3))

    def skid_step(x, y, th, v, w, lin_traction, ang_traction, dt):
        return x + dt * v, y, th + dt * w

    models.register_model("skid_test", skid_step)
    try:
        with pytest.raises(NotImplementedError, match="skid_test.*eager"):
            models.kernel_model(models.get_step_fn("skid_test"))
    finally:
        models._REGISTRY.pop("skid_test")
    # Fast trig is the unicycle's rotation; the bicycle takes exact trig.
    with pytest.raises(ValueError, match="fast_trig"):
        rollout_byte.check_fast_trig(True, models.bicycle_step)
    rollout_byte.check_fast_trig(True, models.unicycle_step)
    rollout_byte.check_fast_trig(False, models.bicycle_step)
