"""Port rollout (eager and the kernel's plain version), CVaR and update vs
the JAX package.  The kernel itself is tested on a card in
test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.ops import cvar as jcvar
from mppi_numba_tpu.ops import rollout as jrollout
from mppi_numba_tpu.ops import update as jupdate
from mppi_numba_tpu.ops.packing import pack_map_words
from mppi_numba_tpu.ops.pallas.rollout_kernel import (
    build_task_vec as j_build_task_vec, terrain_rollout_costs_pallas)
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch.convert import task_to_port
from mppi_numba_tpu_torch.ops import cvar as tcvar
from mppi_numba_tpu_torch.ops import rollout as trollout
from mppi_numba_tpu_torch.ops import update as tupdate
from mppi_numba_tpu_torch.ops.kernels import rollout_byte

RTOL, ATOL = 1e-5, 1e-4      # tests/test_pallas_kernel.py's own tolerance


def build_problem(seed=0, K=128, M=12, T=20, H=9, W=11, obstacles=True):
    """Random packed maps, task and controls, as numpy / JAX inputs."""
    rng = np.random.RandomState(seed)
    lin = rng.randint(0, 101, (M, H, W)).astype(np.int8)
    ang = rng.randint(0, 101, (M, H, W)).astype(np.int8)
    p = 0.1 if obstacles else 0.0
    obs = (rng.rand(H, W) < p).astype(np.int8)
    unk = (rng.rand(H, W) < p).astype(np.int8)
    risk = rng.randint(1, 101, (H, W)).astype(np.int8)
    f32 = np.float32
    task = JTask(
        x0=np.array([1.7, 1.3, 0.4], f32), xgoal=np.array([2.9, 2.6], f32),
        goal_tolerance=f32(0.3), v_post_rollout=f32(0.5),
        lambda_weight=f32(1.2), u_std=np.array([0.7, 1.1], f32),
        vrange=np.array([0.0, 2.0], f32), wrange=np.array([-2.5, 2.5], f32),
        dt=f32(0.1), dist_weight=f32(1.7), obs_penalty=f32(1e4),
        unknown_penalty=f32(1e2), alpha_dyn=f32(1.0), res=f32(0.5),
        xlim0=f32(0.0), ylim0=f32(0.0), lin_lb=f32(0.0), lin_ratio=f32(0.01),
        ang_lb=f32(0.0), ang_ratio=f32(0.01))
    u_cur = rng.uniform(-0.5, 1.5, (T, 2)).astype(f32)
    noise = (rng.randn(K, T, 2) * np.array([0.7, 1.1])).astype(f32)
    return task, lin, ang, obs, unk, risk, u_cur, noise


def _jax_task(task):
    return JTask(*(None if x is None else jnp.asarray(x) for x in task))


def _packed(lin, ang, obs, unk, risk, speed_map):
    return np.asarray(pack_map_words(
        jnp.asarray(lin), jnp.asarray(ang), jnp.asarray(obs),
        jnp.asarray(unk), jnp.asarray(risk) if speed_map else None))


def _port_task(task):
    return task_to_port(task, "cpu")


CASES = {
    # name: (build_problem kwargs, speed_map)
    "base": (dict(), False),
    "speed_map": (dict(), True),
    "multichunk_13x15": (dict(seed=5, M=8, T=15, H=13, W=15), False),
    "odd_m": (dict(seed=3, M=5, T=10, H=4, W=6), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_rollout_matches_jax_xla(case):
    kw, speed_map = CASES[case]
    task, lin, ang, obs, unk, risk, u_cur, noise = build_problem(**kw)
    packed = _packed(lin, ang, obs, unk, risk, speed_map)
    want = np.asarray(jrollout.terrain_rollout_costs(
        jnp.asarray(packed), _jax_task(task), jnp.asarray(u_cur),
        jnp.asarray(noise), speed_map=speed_map))
    got = trollout.terrain_rollout_costs(
        torch.tensor(packed), _port_task(task), torch.tensor(u_cur),
        torch.tensor(noise), speed_map=speed_map)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fast_trig", [False, True])
@pytest.mark.parametrize("speed_map", [False, True])
def test_plain_kernel_matches_jax_pallas_interpret(fast_trig, speed_map):
    task, lin, ang, obs, unk, risk, u_cur, noise = build_problem(seed=2)
    T = u_cur.shape[0]
    H, W = lin.shape[1:]
    packed = _packed(lin, ang, obs, unk, risk, speed_map)
    jt = _jax_task(task)
    v, w = jrollout._clipped_controls_tk(jnp.asarray(u_cur),
                                         jnp.asarray(noise), jt.vrange,
                                         jt.wrange)
    want = np.asarray(terrain_rollout_costs_pallas(
        jnp.asarray(packed), j_build_task_vec(jt), v, w, H=H, W=W, T=T,
        speed_map=speed_map, fast_trig=fast_trig, interpret=True))
    pt = _port_task(task)
    tv, tw = trollout._clipped_controls_tk(torch.tensor(u_cur),
                                           torch.tensor(noise), pt.vrange,
                                           pt.wrange)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    got = rollout_byte.terrain_rollout_costs_byte(
        torch.tensor(packed), rollout_byte.build_task_vec(pt),
        tv.contiguous(), tw.contiguous(), H=H, W=W, T=T,
        speed_map=speed_map, fast_trig=fast_trig)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_build_task_vec_equals_jax_row0():
    task = build_problem()[0]
    want = np.asarray(j_build_task_vec(_jax_task(task)))
    got = rollout_byte.build_task_vec(_port_task(task))
    assert got.shape == (rollout_byte.TASK_VEC_LEN,)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want[0, :got.shape[0]])


def test_control_coupling_matches():
    task, *_, u_cur, noise = build_problem(seed=4)
    want = np.asarray(jrollout.control_coupling(
        jnp.asarray(u_cur), jnp.asarray(noise), jnp.asarray(task.u_std),
        task.lambda_weight))
    pt = _port_task(task)
    got = trollout.control_coupling(torch.tensor(u_cur), torch.tensor(noise),
                                    pt.u_std, pt.lambda_weight)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("numel", [1, 4, 13, 16])
def test_cvar_static_matches(numel):
    costs = np.random.RandomState(5).uniform(0, 100, (64, 16)).astype(np.float32)
    want = np.asarray(jcvar.cvar_from_costs(jnp.asarray(costs), numel))
    got = tcvar.cvar_from_costs(torch.tensor(costs), numel)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("alpha", [0.05, 0.2, 0.5, 1.0])
def test_cvar_dynamic_matches(alpha):
    costs = np.random.RandomState(6).uniform(0, 100, (64, 37)).astype(np.float32)
    want = np.asarray(jcvar.cvar_from_costs_dynamic(jnp.asarray(costs),
                                                    jnp.float32(alpha)))
    got = tcvar.cvar_from_costs_dynamic(torch.tensor(costs),
                                        torch.tensor(alpha,
                                                     dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_update_useq_matches():
    rng = np.random.RandomState(7)
    K, T = 128, 20
    costs = rng.uniform(0, 30, K).astype(np.float32)
    noise = rng.randn(K, T, 2).astype(np.float32)
    u = rng.uniform(-1, 2, (T, 2)).astype(np.float32)
    lam = np.float32(1.3)
    vr = np.array([0.0, 2.0], np.float32)
    wr = np.array([-2.5, 2.5], np.float32)
    ju, jw = jupdate.update_useq(jnp.asarray(costs), jnp.asarray(noise),
                                 jnp.asarray(u), lam, jnp.asarray(vr),
                                 jnp.asarray(wr))
    tu, tw = tupdate.update_useq(torch.tensor(costs), torch.tensor(noise),
                                 torch.tensor(u), torch.tensor(lam),
                                 torch.tensor(vr), torch.tensor(wr))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-8)


def test_kernel_wrapper_on_cpu_counts_no_launch():
    task, lin, ang, obs, unk, risk, u_cur, noise = build_problem(
        seed=8, M=3, T=5, H=4, W=5)
    packed = torch.tensor(_packed(lin, ang, obs, unk, risk, False))
    pt = _port_task(task)
    v, w = trollout._clipped_controls_tk(torch.tensor(u_cur),
                                         torch.tensor(noise), pt.vrange,
                                         pt.wrange)
    before = rollout_byte.terrain_rollout_costs_byte.launches
    out = rollout_byte.terrain_rollout_costs_byte(
        packed, rollout_byte.build_task_vec(pt), v.contiguous(),
        w.contiguous(), H=4, W=5, T=5)
    assert out.shape == (128, 3)
    assert rollout_byte.terrain_rollout_costs_byte.launches == before



def test_cpu_tensors_never_build_or_load_the_kernel(monkeypatch):
    from mppi_numba_tpu_torch.ops.kernels import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was built or loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    task, lin, ang, obs, unk, risk, u_cur, noise = build_problem(
        seed=10, M=2, T=4, H=4, W=5)
    pt = _port_task(task)
    v, w = trollout._clipped_controls_tk(torch.tensor(u_cur),
                                         torch.tensor(noise), pt.vrange,
                                         pt.wrange)
    out = rollout_byte.terrain_rollout_costs_byte(
        torch.tensor(_packed(lin, ang, obs, unk, risk, False)),
        rollout_byte.build_task_vec(pt), v.contiguous(), w.contiguous(),
        H=4, W=5, T=4, fast_trig=True)
    assert out.shape == (128, 2) and torch.isfinite(out).all()


def test_kernel_library_is_keyed_by_source_and_flags():
    from mppi_numba_tpu_torch.ops.kernels import _build

    lib = _build.library_path("rollout_byte")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("rollout_byte-") and lib.suffix == ".so"
    assert (_build.CSRC / "rollout_byte.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
