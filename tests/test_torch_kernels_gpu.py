"""The port's CUDA kernels and solves on a card, against their plain
PyTorch versions.

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
from mppi_numba_tpu_torch.models import bicycle_step, make_bicycle_step
from mppi_numba_tpu_torch.probes import gather_probe
from mppi_numba_tpu_torch.ops import packing
from mppi_numba_tpu_torch.ops.kernels import rollout_binned, rollout_byte
from mppi_numba_tpu_torch.ops.packing import pack_map_words
from mppi_numba_tpu_torch.ops.sampling import decode_bins
from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
from mppi_numba_tpu_torch.types import TerrainTask

pytestmark = pytest.mark.gpu


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _task(device, steer=2.5):
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return TerrainTask(
        x0=f([1.7, 1.3, 0.4]), xgoal=f([5.9, 4.6]), goal_tolerance=f(0.3),
        v_post_rollout=f(0.5), lambda_weight=f(1.2), u_std=f([0.7, 1.1]),
        vrange=f([0.0, 2.0]), wrange=f([-steer, steer]), dt=f(0.1),
        dist_weight=f(1.7), obs_penalty=f(1e4), unknown_penalty=f(1e2),
        alpha_dyn=f(1.0), res=f(0.5), xlim0=f(0.0), ylim0=f(0.0),
        lin_lb=f(0.0), lin_ratio=f(0.01), ang_lb=f(0.0), ang_ratio=f(0.01))


def _inputs(device, K, M, T, H, W, penalties, speed_map, seed=0, steer=2.5):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    lin = t(rng.randint(0, 101, (M, H, W)).astype(np.int8))
    ang = t(rng.randint(0, 101, (M, H, W)).astype(np.int8))
    p = 0.1 if penalties else 0.0
    obs = t((rng.rand(H, W) < p).astype(np.int8))
    unk = t((rng.rand(H, W) < p).astype(np.int8))
    risk = t(rng.randint(1, 101, (H, W)).astype(np.int8))
    words = pack_map_words(lin, ang, obs, unk, risk if speed_map else None)
    task = _task(device, steer)
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


def _custom_step(x, y, th, v, w, lin_traction, ang_traction, dt):
    """A custom registered model: a Python step function with no kernel
    form."""
    return x + dt * v * torch.cos(th), y + dt * v * torch.sin(th), th + w


# The default wheelbase, 0.5 m, and a car's, 2.7 m, whose float32
# reciprocal is inexact: a kernel that ignored its wheelbase argument
# would still match at 0.5 alone.
_STEPS = {"bicycle": bicycle_step, "bicycle_2.7": make_bicycle_step(2.7),
          "custom": _custom_step}


@pytest.mark.parametrize("model", list(_STEPS))
@pytest.mark.parametrize("layout", ["byte", 2, 4, 8])
def test_cuda_kernel_rejects_other_models(layout, model):
    """The bicycle runs inside each kernel, within 1e-4 of the plain
    version (steering within +-0.5 rad, away from tan's pole), at either
    wheelbase; a custom registered model raises, and nothing is
    launched."""
    dev = _cuda_or_skip()
    K, M, T, H, W = 200, 7, 30, 21, 30
    step_fn = _STEPS[model]
    if layout == "byte":
        args = _inputs(dev, K, M, T, H, W, penalties=True, speed_map=True,
                       steer=0.5)
        kw = dict(H=H, W=W, T=T, speed_map=True, step_fn=step_fn)
        kernel = rollout_byte.terrain_rollout_costs_byte
        plain = rollout_byte.terrain_rollout_costs_byte_plain
    else:
        args, _ = _binned_inputs(dev, layout, K, M, T, H, W, True,
                                 past_last=True, steer=0.5)
        kw = dict(H=H, W=W, T=T, cell_bits=layout, step_fn=step_fn)
        kernel = rollout_binned.terrain_rollout_costs_binned
        plain = rollout_binned.terrain_rollout_costs_binned_plain
    before = kernel.launches
    if model == "custom":
        with pytest.raises(NotImplementedError, match="eager"):
            kernel(*args, **kw)
        assert kernel.launches == before
        return
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*args, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


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


def _binned_inputs(device, cell_bits, K, M, T, H, W, speed_map, past_last,
                   seed=0, steer=2.5):
    """Binned wrapper arguments and the byte words of the same grids."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    B = {2: 4, 4: 16, 8: 22}[cell_bits]
    hi = B + 1 if past_last else B
    lin_b = t(rng.randint(0, hi, (M, H, W)).astype(np.int32))
    ang_b = t(rng.randint(0, hi, (M, H, W)).astype(np.int32))
    q = t(np.sort(rng.choice(101, B, replace=False)).astype(np.int8))
    obs = t((rng.rand(H, W) < 0.1).astype(np.int8))
    unk = t((rng.rand(H, W) < 0.1).astype(np.int8))
    risk = t(rng.randint(1, 101, (H, W)).astype(np.int8))
    task = _task(device, steer)
    u = t(rng.uniform(-0.5, 1.5, (T, 2)).astype(np.float32))
    noise = t(rng.randn(K, T, 2).astype(np.float32)) * task.u_std
    v, w = _clipped_controls_tk(u, noise, task.vrange, task.wrange)
    lin_g, ang_g = decode_bins(q, lin_b), decode_bins(q, ang_b)
    if cell_bits == 8:
        cells, lut = packing.pack_byte_pairs(lin_g, ang_g), None
    else:
        pack = (packing.pack_bin_crumbs if cell_bits == 2
                else packing.pack_bin_nibbles)
        cells = pack(lin_b, ang_b)
        lut = rollout_binned.build_bin_luts(task, q, q)
    tv = rollout_byte.build_task_vec(task)
    binned = (cells, packing.pack_mask_nibbles(obs, unk), lut, tv,
              v.contiguous(), w.contiguous(),
              packing.pack_risk_bytes(risk) if speed_map else None)
    words = pack_map_words(lin_g, ang_g, obs, unk,
                           risk if speed_map else None)
    return binned, (words, tv, v.contiguous(), w.contiguous())


@pytest.mark.parametrize("fast_trig", [False, True])
@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("cell_bits", [2, 4, 8])
def test_binned_kernel_matches_plain_on_card(cell_bits, speed_map,
                                             fast_trig):
    dev = _cuda_or_skip()
    K, M, T, H, W = 200, 7, 30, 21, 30
    args, _ = _binned_inputs(dev, cell_bits, K, M, T, H, W, speed_map,
                             past_last=True)
    kw = dict(H=H, W=W, T=T, cell_bits=cell_bits, fast_trig=fast_trig)
    before = rollout_binned.terrain_rollout_costs_binned.launches
    got = rollout_binned.terrain_rollout_costs_binned(*args, **kw)
    torch.cuda.synchronize()
    assert rollout_binned.terrain_rollout_costs_binned.launches == before + 1
    want = rollout_binned.terrain_rollout_costs_binned_plain(*args, **kw)
    # chip_smoke.py's tolerances: 1e-4 exact trig, 5e-3 fast trig.
    rtol = 5e-3 if fast_trig else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("cell_bits", [2, 4, 8])
def test_binned_kernel_equals_byte_kernel_on_card(cell_bits):
    """Columns summing to 100: the LUT entry and the byte decode are the
    same two float32 operations, so the costs agree bit for bit."""
    dev = _cuda_or_skip()
    K, M, T, H, W = 256, 5, 40, 21, 30
    binned, byte = _binned_inputs(dev, cell_bits, K, M, T, H, W, True,
                                  past_last=False, seed=cell_bits)
    got = rollout_binned.terrain_rollout_costs_binned(
        *binned, H=H, W=W, T=T, cell_bits=cell_bits, fast_trig=True)
    want = rollout_byte.terrain_rollout_costs_byte(
        *byte, H=H, W=W, T=T, speed_map=True, fast_trig=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_binned_kernel_rejects_other_models_and_bad_inputs():
    dev = _cuda_or_skip()
    args, _ = _binned_inputs(dev, 4, 128, 2, 4, 3, 5, False,
                             past_last=False)
    kw = dict(H=3, W=5, T=4, cell_bits=4)
    with pytest.raises(NotImplementedError):
        rollout_binned.terrain_rollout_costs_binned(*args, **kw,
                                                    step_fn=_custom_step)
    with pytest.raises(ValueError, match="fast_trig"):
        rollout_binned.terrain_rollout_costs_binned(
            *args, **kw, fast_trig=True, step_fn=bicycle_step)
    with pytest.raises(ValueError):
        rollout_binned.terrain_rollout_costs_binned(
            args[0].long(), *args[1:], **kw)
    with pytest.raises(ValueError):
        rollout_binned.terrain_rollout_costs_binned(*args, H=3, W=5, T=4,
                                                    cell_bits=2)


def test_planner_speed_map_on_card_runs_the_binned_kernel():
    dev = _cuda_or_skip()
    cfg = Config(T=2.0, dt=0.1, num_control_rollouts=256,
                 max_map_dim=(40, 40), seed=0,
                 use_nom_dynamics_with_speed_map=True)
    pmf = np.zeros((4, 30, 30), np.int8)
    pmf[2], pmf[3] = 30, 70
    tdm_dict = dict(res=0.5, xlimits=(0.0, 15.0), ylimits=(0.0, 15.0),
                    bin_values=[0.0, 0.3, 0.7, 1.0],
                    bin_values_bounds=(0.0, 1.0), det_dynamics_cvar_alpha=0.3)
    lin, ang = TDM(cfg), TDM(cfg)
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = MPPIPlanner(cfg)
    planner.setup(dict(dt=0.1, x0=np.array([1.0, 1.0, 0.5]),
                       xgoal=np.array([12.0, 12.0]), goal_tolerance=0.3,
                       v_post_rollout=0.01, cvar_alpha=1.0,
                       lambda_weight=1.0, u_std=np.array([1.0, 1.0]),
                       vrange=np.array([0.0, 2.0]),
                       wrange=np.array([-1.5, 1.5])), lin, ang)
    byte_before = rollout_byte.terrain_rollout_costs_byte.launches
    before = rollout_binned.terrain_rollout_costs_binned.launches
    for _ in range(3):
        u = planner.solve()
        assert u.shape == (20, 2) and np.isfinite(u).all()
        planner.shift_and_update(np.array([1.0, 1.0, 0.5]), u)
    assert planner._static().num_pmf_bins == 2
    assert rollout_binned.terrain_rollout_costs_binned.launches == before + 3
    assert rollout_byte.terrain_rollout_costs_byte.launches == byte_before


@pytest.mark.parametrize("mode", ["column", "flat"])
def test_gather_probe_kernel_matches_plain_on_card(mode):
    """The dependent gather chain equals its plain version bit for bit, in
    an L1-sized and an L2-sized table; negative inputs are refused."""
    dev = _cuda_or_skip()
    chain, plain = gather_probe.CHAINS[mode]
    for S, R in ((64, 32), (65536, 1056)):
        table, idx, mod = gather_probe.make_inputs(mode, S, R, dev, seed=S)
        before = chain.launches
        got = chain(table, idx, mod, 64)
        torch.cuda.synchronize()
        assert chain.launches == before + 1
        assert torch.equal(got, plain(table, idx, mod, 64))
    table[0, 0] = -1
    with pytest.raises(ValueError, match="nonnegative"):
        chain(table, idx, mod, 4)
