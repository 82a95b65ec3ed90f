"""The port's CUDA kernel and solve on a card, against their plain PyTorch
versions.

This file imports no JAX, so it runs on a machine with a card and no JAX,
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Each test decides inside itself whether a card is present and skips where
none is, so every pytest worker collects the same tests.
"""

import numpy as np
import pytest
import torch

from mppi_numba_tpu_torch import Config, MPPIPlanner, TDM
from mppi_numba_tpu_torch.models import bicycle_step
from mppi_numba_tpu_torch.ops.kernels import rollout_byte
from mppi_numba_tpu_torch.ops.packing import pack_map_words
from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
from mppi_numba_tpu_torch.types import TerrainTask

pytestmark = pytest.mark.gpu


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _task(device):
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return TerrainTask(
        x0=f([1.7, 1.3, 0.4]), xgoal=f([5.9, 4.6]), goal_tolerance=f(0.3),
        v_post_rollout=f(0.5), lambda_weight=f(1.2), u_std=f([0.7, 1.1]),
        vrange=f([0.0, 2.0]), wrange=f([-2.5, 2.5]), dt=f(0.1),
        dist_weight=f(1.7), obs_penalty=f(1e4), unknown_penalty=f(1e2),
        alpha_dyn=f(1.0), res=f(0.5), xlim0=f(0.0), ylim0=f(0.0),
        lin_lb=f(0.0), lin_ratio=f(0.01), ang_lb=f(0.0), ang_ratio=f(0.01))


def _inputs(device, K, M, T, H, W, penalties, speed_map, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    lin = t(rng.randint(0, 101, (M, H, W)).astype(np.int8))
    ang = t(rng.randint(0, 101, (M, H, W)).astype(np.int8))
    p = 0.1 if penalties else 0.0
    obs = t((rng.rand(H, W) < p).astype(np.int8))
    unk = t((rng.rand(H, W) < p).astype(np.int8))
    risk = t(rng.randint(1, 101, (H, W)).astype(np.int8))
    words = pack_map_words(lin, ang, obs, unk, risk if speed_map else None)
    task = _task(device)
    u = t(rng.uniform(-0.5, 1.5, (T, 2)).astype(np.float32))
    noise = t(rng.randn(K, T, 2).astype(np.float32)) * task.u_std
    v, w = _clipped_controls_tk(u, noise, task.vrange, task.wrange)
    return (words, rollout_byte.build_task_vec(task), v.contiguous(),
            w.contiguous())


@pytest.mark.parametrize("fast_trig", [False, True])
@pytest.mark.parametrize("speed_map", [False, True])
def test_cuda_kernel_matches_plain_on_card(fast_trig, speed_map):
    dev = _cuda_or_skip()
    K, M, T, H, W = 200, 7, 30, 13, 15
    args = _inputs(dev, K, M, T, H, W, penalties=not fast_trig,
                   speed_map=speed_map)
    kw = dict(H=H, W=W, T=T, speed_map=speed_map, fast_trig=fast_trig)
    before = rollout_byte.terrain_rollout_costs_byte.launches
    got = rollout_byte.terrain_rollout_costs_byte(*args, **kw)
    torch.cuda.synchronize()
    assert rollout_byte.terrain_rollout_costs_byte.launches == before + 1
    want = rollout_byte.terrain_rollout_costs_byte_plain(*args, **kw)
    # chip_smoke.py's tolerances: 1e-4 exact trig, 5e-3 fast trig.
    rtol = 5e-3 if fast_trig else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=1e-4)


def test_cuda_kernel_rejects_other_models():
    dev = _cuda_or_skip()
    words = torch.zeros((2, 3, 3), dtype=torch.int32, device=dev)
    vw = torch.zeros((4, 128), device=dev)
    with pytest.raises(NotImplementedError):
        rollout_byte.terrain_rollout_costs_byte(
            words, torch.zeros(19, device=dev), vw, vw, H=3, W=3, T=4,
            step_fn=bicycle_step)


def test_cuda_kernel_rejects_bad_inputs():
    dev = _cuda_or_skip()
    words = torch.zeros((2, 3, 3), dtype=torch.int64, device=dev)
    vw = torch.zeros((4, 128), device=dev)
    with pytest.raises(ValueError):
        rollout_byte.terrain_rollout_costs_byte(
            words, torch.zeros(19, device=dev), vw, vw, H=3, W=3, T=4)


def test_planner_closed_loop_on_card():
    dev = _cuda_or_skip()
    cfg = Config(T=2.0, dt=0.1, num_grid_samples=32,
                 num_control_rollouts=256, max_map_dim=(40, 40), seed=0,
                 use_tdm=True)
    pmf = np.zeros((4, 12, 12), np.int8)
    pmf[2], pmf[3] = 30, 70
    tdm_dict = dict(res=0.5, xlimits=(0.0, 6.0), ylimits=(0.0, 6.0),
                    bin_values=[0.0, 0.3, 0.7, 1.0],
                    bin_values_bounds=(0.0, 1.0), det_dynamics_cvar_alpha=1.0)
    lin, ang = TDM(cfg), TDM(cfg)
    assert lin.device.type == "cuda"
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = MPPIPlanner(cfg)
    planner.setup(dict(dt=0.1, x0=np.array([1.0, 1.0, 0.5]),
                       xgoal=np.array([5.0, 5.0]), goal_tolerance=0.3,
                       v_post_rollout=0.01, cvar_alpha=0.25,
                       lambda_weight=1.0, u_std=np.array([1.0, 1.0]),
                       vrange=np.array([0.0, 2.0]),
                       wrange=np.array([-1.5, 1.5])), lin, ang)
    before = rollout_byte.terrain_rollout_costs_byte.launches
    x = np.array([1.0, 1.0, 0.5])
    for _ in range(3):
        u = planner.solve()
        assert u.shape == (20, 2) and np.isfinite(u).all()
        x = x + 0.1 * np.array([u[0, 0] * np.cos(x[2]),
                                u[0, 0] * np.sin(x[2]), u[0, 1]])
        planner.shift_and_update(x, u)
    assert rollout_byte.terrain_rollout_costs_byte.launches == before + 3
    assert planner.u_cur.device.type == "cuda"
