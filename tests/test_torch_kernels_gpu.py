"""The port's CUDA kernels and solves on a card, against their plain
PyTorch versions.

This file imports no JAX, so it runs on a machine with a card and no JAX,
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Each test decides inside itself whether a card is present and skips where
none is, so every pytest worker collects the same tests.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mppi_numba_tpu_torch import Config, MPPIPlanner, TDM
from mppi_numba_tpu_torch.models import (bicycle_step, make_bicycle_step,
                                         unicycle_step)
from mppi_numba_tpu_torch.probes import gather_probe
from mppi_numba_tpu_torch.ops import packing
from mppi_numba_tpu_torch.ops.kernels import (map_sample, rollout_binned,
                                              rollout_byte)
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
    assert torch.equal(got, want)


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
    """The bicycle runs inside each kernel (steering within +-0.5 rad, away
    from tan's pole): bit for bit with the plain version at 0.5 m, within
    1e-4 at 2.7 m, where PyTorch divides by the wheelbase as a multiply by
    its reciprocal; a custom registered model raises, and nothing is
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
    if model == "bicycle":
        assert torch.equal(got, want)
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
    assert torch.equal(got, want)


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
    """A 60 x 60 speed map (62 x 62 padded), cropped to its 29 x 29
    reachable window: over 512 cells, so 'auto' routes the window's 2
    support-compacted bins to 2-bit cells."""
    dev = _cuda_or_skip()
    cfg = Config(T=2.0, dt=0.1, num_control_rollouts=256,
                 max_map_dim=(80, 80), seed=0,
                 use_nom_dynamics_with_speed_map=True)
    pmf = np.zeros((4, 60, 60), np.int8)
    pmf[2], pmf[3] = 30, 70
    tdm_dict = dict(res=0.5, xlimits=(0.0, 30.0), ylimits=(0.0, 30.0),
                    bin_values=[0.0, 0.3, 0.7, 1.0],
                    bin_values_bounds=(0.0, 1.0), det_dynamics_cvar_alpha=0.3)
    lin, ang = TDM(cfg), TDM(cfg)
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = MPPIPlanner(cfg)
    planner.setup(dict(dt=0.1, x0=np.array([10.0, 10.0, 0.5]),
                       xgoal=np.array([25.0, 25.0]), goal_tolerance=0.3,
                       v_post_rollout=0.01, cvar_alpha=1.0,
                       lambda_weight=1.0, u_std=np.array([1.0, 1.0]),
                       vrange=np.array([0.0, 3.0]),
                       wrange=np.array([-1.5, 1.5])), lin, ang)
    byte_before = rollout_byte.terrain_rollout_costs_byte.launches
    before = rollout_binned.terrain_rollout_costs_binned.launches
    for _ in range(3):
        u = planner.solve()
        assert u.shape == (20, 2) and np.isfinite(u).all()
        planner.shift_and_update(np.array([10.0, 10.0, 0.5]), u)
    assert planner._static().num_pmf_bins == 2
    assert planner._static().roi_shape == (29, 29)
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


# -- edge cases, bit for bit ---------------------------------------------------

_MODELS = {"fast": (True, None), "exact": (False, None),
           "bicycle": (False, bicycle_step)}


def _edge_args(dev, layout, model, K, M, T, H=21, W=30, speed_map=False,
               seed=0):
    """Wrapper arguments and keywords of one kernel launch."""
    ft, step = _MODELS[model]
    steer = 0.5 if step is not None else 2.5
    if layout == "byte":
        args = _inputs(dev, K, M, T, H, W, penalties=True,
                       speed_map=speed_map, seed=seed, steer=steer)
        kw = dict(H=H, W=W, T=T, speed_map=speed_map, fast_trig=ft,
                  step_fn=step)
        return (args, kw, rollout_byte.terrain_rollout_costs_byte,
                rollout_byte.terrain_rollout_costs_byte_plain)
    args, _ = _binned_inputs(dev, layout, K, M, T, H, W, speed_map,
                             past_last=True, seed=seed, steer=steer)
    kw = dict(H=H, W=W, T=T, cell_bits=layout, fast_trig=ft, step_fn=step)
    return (args, kw, rollout_binned.terrain_rollout_costs_binned,
            rollout_binned.terrain_rollout_costs_binned_plain)


def _bitwise(args, kw, kernel, plain):
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("layout", ["byte", 4])
@pytest.mark.parametrize("model", list(_MODELS))
@pytest.mark.parametrize("T", [1, 33, 47, 99, 100])
def test_kernels_bitwise_across_horizons(T, model, layout):
    """Every horizon across the step loop's unroll remainder."""
    dev = _cuda_or_skip()
    _bitwise(*_edge_args(dev, layout, model, 1000, 3, T, seed=T))


@pytest.mark.parametrize("K", [1000, 1024])
@pytest.mark.parametrize("M", [1, 3, 1023])
def test_bicycle_bitwise_ragged_samples(M, K):
    """The bicycle walks two map samples a thread: an odd M leaves the last
    thread one sample, which must not be written."""
    dev = _cuda_or_skip()
    for layout in ("byte", 2):
        _bitwise(*_edge_args(dev, layout, "bicycle", K, M, 12))


def test_det_dyn_launch_at_t33():
    """det_dyn's launch: 4-bit cells, 140 x 84, M = 1, at T = 33."""
    dev = _cuda_or_skip()
    _bitwise(*_edge_args(dev, 4, "fast", 1024, 1, 33, H=140, W=84))


@pytest.mark.parametrize("layout", ["byte", 4])
def test_nan_cell_coordinate_lands_in_cell_0(layout):
    """A NaN inv_res makes every cell coordinate NaN: the kernel reads cell
    0, so its costs equal the plain version's on maps whose every cell is
    cell 0."""
    dev = _cuda_or_skip()
    args, kw, kernel, plain = _edge_args(dev, layout, "exact", 512, 3, 40,
                                         speed_map=True)
    args = list(args)
    if layout == "byte":
        uniform = [args[0][:, :1, :1].expand_as(args[0]).contiguous(),
                   *args[1:]]
        tv_at = 1
    else:
        def first(words, low, repeat):
            w0 = words[..., :1].to(torch.int64) & low
            return (w0 * repeat).expand(words.shape).to(torch.int32) \
                .contiguous()
        cells, mask, lut, tv, v, w, risk = args
        uniform = [first(cells, 0xFF, 0x01010101),
                   first(mask[None], 3, 0x55555555)[0], lut, tv, v, w,
                   first(risk[None], 0xFF, 0x01010101)[0]]
        tv_at = 3
    want = plain(*uniform, **kw)
    args[tv_at] = args[tv_at].clone()
    args[tv_at][11] = float("nan")
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["byte", 2, 8])
def test_speed_map_every_risk_byte(layout):
    """Risk bytes of all 256 values on a 16 x 16 map: the kernel's
    step-time table equals the plain version's division at each."""
    dev = _cuda_or_skip()
    args, kw, kernel, plain = _edge_args(dev, layout, "fast", 1024, 2, 100,
                                         H=16, W=16, speed_map=True)
    perm = torch.tensor(np.random.RandomState(1).permutation(256) - 128,
                        dtype=torch.int8, device=dev)
    args = list(args)
    if layout == "byte":
        # Bits 18-25 of each word hold its risk byte.
        args[0] = ((args[0] & ((1 << 18) - 1))
                   | (perm.to(torch.int32).reshape(16, 16) << 18)[None])
        assert ((args[0] >> 18) & 0xFF).unique().numel() == 256
    else:
        args[6] = perm.view(torch.int32)
    _bitwise(args, kw, kernel, plain)


def test_no_instantiation_needs_a_shared_memory_opt_in():
    """Every instantiation the wrappers reach holds at most 48 KB of shared
    memory (it asks for no dynamic shared memory) and spills nothing to
    local memory beyond sinf/cosf's 32-byte reduction buffer."""
    _cuda_or_skip()
    tilings = []
    for ft, step in ((True, None), (False, None), (False, bicycle_step)):
        for sm in (False, True):
            tilings.append(rollout_byte.kernel_tiling(
                speed_map=sm, fast_trig=ft, step_fn=step))
            tilings += [rollout_binned.kernel_tiling(
                cell_bits=cb, speed_map=sm, fast_trig=ft, step_fn=step)
                for cb in (2, 4, 8)]
    assert len(tilings) == 24
    for t in tilings:
        assert t["static_shared_bytes"] <= 48 * 1024, t
        assert t["local_bytes"] <= 32, t
        assert t["samples_per_thread"] in (1, 2) and t["block"] == 128, t


# -- map sampling (csrc/map_sample.cu) -------------------------------------------


def _map_sample_args(dev, M, H, W, window, B_lin, B_ang, alpha_dyn,
                     unnormalized=False, seed=0, m_offset=0, full_m=None):
    """Arguments of one ``sample_traction_window`` launch: PMF windows of a
    random (H, W) map at ``window = (oy, ox, rH, rW)``; with
    ``unnormalized="signed"`` columns and bin values of random int8 of any
    sign (bin values so too where B > 101)."""
    rng = np.random.RandomState(seed)
    oy, ox, rH, rW = window
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731

    def pmf(B):
        if unnormalized == "signed":
            return t(rng.randint(-128, 128, size=(B, rH, rW)).astype(np.int8))
        raw = rng.randint(0, 100, size=(B, rH, rW)).astype(float)
        raw[0] += 1.0
        p = (raw / raw.sum(0) * 100).astype(np.int8)
        p[-1] = 100 - p[:-1].sum(0)
        if unnormalized:
            p[:, 0, :3] = 0
            p[0, 0, :3] = (10, 40, 90)
        return t(p)

    def qbins(B):
        if unnormalized == "signed" or B > 101:
            return t(rng.randint(-128, 128, size=B).astype(np.int8))
        return t(np.sort(rng.choice(101, B, replace=False)).astype(np.int8))

    key = t(rng.randint(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.int64))
    args = (key, pmf(B_lin), pmf(B_ang), qbins(B_lin), qbins(B_ang),
            torch.tensor(alpha_dyn, dtype=torch.float32, device=dev), M)
    kw = dict(window=((H, W), torch.tensor(oy, dtype=torch.int32, device=dev),
                      torch.tensor(ox, dtype=torch.int32, device=dev)),
              m_offset=m_offset, full_num_samples=full_m)
    return args, kw


@pytest.mark.parametrize("case", [
    # M, H, W, (oy, ox, rH, rW), B_lin, B_ang, alpha, unnormalized, m_offset
    (16, 31, 37, (0, 0, 31, 37), 22, 22, 1.0, False, 0),
    (16, 31, 37, (5, 9, 13, 11), 12, 12, 0.2, False, 0),
    (16, 31, 37, (18, 26, 13, 11), 4, 2, 1.0, True, 0),
    (8, 31, 37, (5, 9, 13, 11), 1, 22, 0.2, True, 5),
    (1, 250, 250, (80, 120, 85, 85), 12, 12, 0.2, False, 0),
    (16, 31, 37, (0, 0, 31, 37), 22, 22, 1.0, "signed", 0),
    (16, 31, 37, (0, 0, 31, 37), 22, 12, 1.5, "signed", 0),
    (16, 31, 37, (5, 9, 13, 11), 12, 4, -0.7, "signed", 0),
    (8, 31, 37, (0, 0, 31, 37), 255, 255, 1.0, "signed", 0),
    (16, 31, 37, (0, 0, 31, 37), 255, 255, 1.0, False, 0),
    (1, 31, 37, (0, 0, 31, 37), 255, 22, 1.5, "signed", 0),
    (3, 31, 37, (5, 9, 13, 11), 12, 12, 1.0, "signed", 0),
    (4, 31, 37, (5, 9, 13, 11), 12, 12, -0.7, "signed", 0),
])
def test_map_sample_kernel_matches_plain_on_card(case):
    """Bins and grids equal the plain version's bit for bit: the whole map,
    interior and corner windows, a slice of the M axis, 1-22 and 255 bins,
    alpha 0.2 and 1, and 1.5 and -0.7 (outside the tables' 0..100: the
    loop rank), columns summing below 100 (decoded to -128) and of random
    int8 of any sign, M = 1, 3 and 4."""
    dev = _cuda_or_skip()
    M, H, W, window, bl, ba, alpha, unnorm, m_off = case
    args, kw = _map_sample_args(dev, M, H, W, window, bl, ba, alpha, unnorm,
                                m_offset=m_off,
                                full_m=M + m_off if m_off else None)
    before = map_sample.sample_traction_window.launches
    got = map_sample.sample_traction_window(*args, **kw)
    torch.cuda.synchronize()
    assert map_sample.sample_traction_window.launches == before + 1
    want = map_sample.sample_traction_window_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if unnorm is True and alpha == 1.0:
        assert (got[2] == -128).any()


def _fused_maps(args, risk_seed):
    """``MapInputs`` of a fused launch: ``_map_sample_args``' PMFs and bin
    values, and random obstacle, unknown and risk windows (int8 of any
    value, so every bit of the shared words is exercised)."""
    from mppi_numba_tpu_torch.types import MapInputs

    key, lin, ang, lq, aq = args[:5]
    rng = np.random.RandomState(risk_seed)
    plane = lambda: torch.tensor(rng.randint(  # noqa: E731
        -128, 128, tuple(lin.shape[1:])).astype(np.int8), device=lin.device)
    return MapInputs(lin, ang, lq, aq, plane(), plane(), plane())


def _flat_outputs(out):
    """``sample_and_pack_window``'s result as a flat list of tensors (and
    Nones)."""
    payload, lin, ang = out
    return [*(payload if isinstance(payload, tuple) else (payload,)), lin,
            ang]


@pytest.mark.parametrize("layout", ["byte", "binned2", "binned", "binned8"])
@pytest.mark.parametrize("case", [
    # M, H, W, (oy, ox, rH, rW), B_lin, B_ang, alpha, unnormalized, m_offset
    (16, 13, 15, (0, 0, 13, 15), 4, 4, 1.0, True, 0),
    (16, 31, 37, (5, 9, 13, 11), 12, 12, 0.2, False, 0),
    (19, 31, 37, (18, 26, 13, 11), 16, 2, 1.0, True, 0),
    (8, 31, 37, (5, 9, 13, 11), 1, 22, 0.2, True, 5),
    (33, 250, 250, (80, 120, 85, 85), 12, 12, 1.0, False, 0),
    (16, 31, 37, (0, 0, 31, 37), 22, 12, 1.5, "signed", 0),
    (16, 31, 37, (5, 9, 13, 11), 4, 16, -0.7, "signed", 0),
    (8, 31, 37, (0, 0, 31, 37), 255, 255, 1.0, "signed", 0),
    (1, 31, 37, (5, 9, 13, 11), 255, 12, 1.5, "signed", 0),
    (3, 13, 15, (0, 0, 13, 15), 16, 4, 1.0, "signed", 0),
])
def test_map_sample_fused_matches_plain_on_card(case, layout):
    """``sample_and_pack_window`` on the card equals its plain version (the
    draw, then ``packing.pack_payload``) bit for bit: payload, shared mask
    and risk words, and both grids, with and without the risk plane and
    the ang plane; ragged rows (13x15, 85x85), columns and bin values of
    any sign, 255 bins, alpha_dyn outside (0, 1], M = 1 and 3, and
    one launch a call."""
    dev = _cuda_or_skip()
    M, H, W, window, bl, ba, alpha, unnorm, m_off = case
    args, kw = _map_sample_args(dev, M, H, W, window, bl, ba, alpha, unnorm,
                                m_offset=m_off,
                                full_m=M + m_off if m_off else None)
    maps = _fused_maps(args, M + bl)
    for ang in (True, False):
        m = maps if ang else maps._replace(ang_pmf=None, ang_qbins=None)
        for risk in (False, True):
            before = map_sample.sample_and_pack_window.launches
            got = map_sample.sample_and_pack_window(
                args[0], m, args[5], M, layout, risk=risk, **kw)
            torch.cuda.synchronize()
            assert map_sample.sample_and_pack_window.launches == before + 1
            want = map_sample.sample_and_pack_window_plain(
                args[0], m, args[5], M, layout, risk=risk, **kw)
            for g, w in zip(_flat_outputs(got), _flat_outputs(want)):
                assert (g is None) == (w is None), (ang, risk)
                if g is not None:
                    assert g.dtype == w.dtype and torch.equal(g, w), (
                        ang, risk, int((g != w).sum()))


def test_map_sample_fused_rejects_bad_inputs():
    dev = _cuda_or_skip()
    args, kw = _map_sample_args(dev, 4, 20, 20, (2, 3, 9, 8), 5, 5, 1.0)
    maps = _fused_maps(args, 0)
    before = map_sample.sample_and_pack_window.launches
    with pytest.raises(ValueError, match="layout"):
        map_sample.sample_and_pack_window(args[0], maps, args[5], 4, "bins",
                                          **kw)
    with pytest.raises(ValueError, match="obstacle"):
        map_sample.sample_and_pack_window(
            args[0], maps._replace(obstacle=maps.obstacle.t()), args[5], 4,
            "byte", **kw)
    with pytest.raises(ValueError, match="B <= 255"):
        big = torch.zeros((256, 9, 8), dtype=torch.int8, device=dev)
        map_sample.sample_and_pack_window(
            args[0], maps._replace(
                lin_pmf=big, lin_qbins=torch.zeros(256, dtype=torch.int8,
                                                   device=dev)),
            args[5], 4, "binned8", **kw)
    assert map_sample.sample_and_pack_window.launches == before


def test_map_sample_known_answers_on_card():
    """``jax.random.uniform`` values (``chip_smoke.KNOWN_UNIFORMS``): the
    plain draw on the card equals them bit for bit, and the kernel's rank
    over 100 bins of 1% each is ``ceil(100 u) - 1`` at each."""
    from chip_smoke import KNOWN_UNIFORMS, KNOWN_UNIFORMS_SHAPE
    from mppi_numba_tpu_torch.ops.sampling import uniform_window

    dev = _cuda_or_skip()
    M, H, W = KNOWN_UNIFORMS_SHAPE
    pmf = torch.ones((100, H, W), dtype=torch.int8, device=dev)
    q = torch.arange(100, dtype=torch.int8, device=dev)
    for words, points in KNOWN_UNIFORMS:
        key = torch.tensor(words, dtype=torch.int64, device=dev)
        u = uniform_window(key, M, (H, W), 0, 0, (H, W)).reshape(M, H, W)
        bins = map_sample.sample_traction_window(
            key, pmf, pmf, q, q, torch.tensor(1.0, device=dev), M)[0]
        for (m, y, x), bits, rank in points:
            assert int(u[m, y, x].view(torch.int32)) == bits
            assert int(bins[m, y, x]) == rank


def test_map_sample_rejects_bad_inputs():
    dev = _cuda_or_skip()
    args, kw = _map_sample_args(dev, 4, 20, 20, (2, 3, 9, 8), 5, 5, 1.0)
    before = map_sample.sample_traction_window.launches
    with pytest.raises(ValueError, match="key"):
        map_sample.sample_traction_window(args[0].to(torch.int32), *args[1:],
                                          **kw)
    with pytest.raises(ValueError, match="qbins"):
        map_sample.sample_traction_window(*args[:3], args[3][:-1], *args[4:],
                                          **kw)
    with pytest.raises(ValueError, match="rows"):
        map_sample.sample_traction_window(*args, window=kw["window"],
                                          m_offset=1)
    with pytest.raises(ValueError, match="scalar"):
        map_sample.sample_traction_window(*args[:5], 1.0, args[6], **kw)
    with pytest.raises(ValueError, match="scalar"):
        map_sample.sample_traction_window(
            *args, window=((20, 20), 2, kw["window"][2]))
    with pytest.raises(NotImplementedError):
        map_sample.sample_traction_window(
            *args, window=((65536, 65536),) + kw["window"][1:])
    assert map_sample.sample_traction_window.launches == before


def test_map_sample_lin_only_on_card():
    """With no ang plane the kernel writes the lin plane alone, equal to the
    two-plane launch's and to the plain version's."""
    dev = _cuda_or_skip()
    args, kw = _map_sample_args(dev, 16, 31, 37, (5, 9, 13, 11), 12, 12, 0.2,
                                True)
    key, lin, _, lq, _, alpha, M = args
    before = map_sample.sample_traction_window.launches
    got = map_sample.sample_traction_window(key, lin, None, lq, None, alpha,
                                            M, **kw)
    both = map_sample.sample_traction_window(*args, **kw)
    torch.cuda.synchronize()
    assert map_sample.sample_traction_window.launches == before + 2
    assert got[1] is None and got[3] is None
    want = map_sample.sample_traction_window_plain(key, lin, None, lq, None,
                                                   alpha, M, **kw)
    for i in (0, 2):
        assert torch.equal(got[i], want[i]) and torch.equal(got[i], both[i])


def test_tdm_sample_grids_on_card():
    """``TDM.sample_grids`` on the card: one map_sample launch, equal to the
    plain version under the key the TDM's generator gives."""
    from mppi_numba_tpu_torch.ops.sampling import draw_map_key

    dev = _cuda_or_skip()
    cfg = Config(T=1.0, dt=0.1, num_grid_samples=32, max_map_dim=(64, 64),
                 seed=4, use_tdm=True)
    rng = np.random.RandomState(2)
    raw = rng.randint(1, 50, size=(6, 30, 40))
    pmf = np.floor(100 * raw / raw.sum(0)).astype(np.int8)
    tdm = TDM(cfg, device=dev)
    tdm.set_TDM_from_PMF_grid(pmf, dict(
        res=0.5, xlimits=(0.0, 20.0), ylimits=(0.0, 15.0),
        bin_values=np.linspace(0.0, 1.0, 6), bin_values_bounds=(0.0, 1.0),
        det_dynamics_cvar_alpha=1.0))
    g = torch.Generator(device=dev)
    g.set_state(tdm._generator.get_state())
    before = map_sample.sample_traction_window.launches
    grids = tdm.sample_grids(alpha_dyn=1.0)
    torch.cuda.synchronize()
    assert map_sample.sample_traction_window.launches == before + 1
    assert grids.shape == (32,) + tuple(tdm.pmf_grid_device.shape[1:])
    want = map_sample.sample_traction_window_plain(
        draw_map_key(g, dev), tdm.pmf_grid_device, None, tdm.qbin_values,
        None, torch.tensor(1.0, device=dev), 32)[2]
    assert torch.equal(grids, want)
    assert (grids == -128).any()            # columns summing below 100


# -- the reachable-window crop: map_sample's crop mode ----------------------------


def _crop_inputs(dev, H, W, B_lin, B_ang, res, lim0, seed=0):
    """A map whose PMF columns sum to 100 (and one column short of it),
    random masks and risk, and a task whose padded origin is ``lim0``."""
    from mppi_numba_tpu_torch.types import MapInputs

    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731

    def pmf(B):
        raw = rng.randint(1, 100, size=(B, H, W)).astype(float)
        p = (raw / raw.sum(0) * 100).astype(np.int8)
        p[-1] = 100 - p[:-1].sum(0)
        p[:, 1, 1] = 0
        return t(p)

    maps = MapInputs(pmf(B_lin), pmf(B_ang),
                     t(np.sort(rng.randint(-128, 128, B_lin)).astype(np.int8)),
                     t(np.sort(rng.randint(-128, 128, B_ang)).astype(np.int8)),
                     t((rng.rand(H, W) < 0.3).astype(np.int8)),
                     t((rng.rand(H, W) < 0.3).astype(np.int8)),
                     t(rng.randint(0, 101, (H, W)).astype(np.int8)))
    task = _task(dev)._replace(res=t(np.float32(res)),
                               xlim0=t(np.float32(lim0)),
                               ylim0=t(np.float32(lim0 - 0.3)))
    return maps, task


def _crop_positions(W, res, lim0):
    """x at every cell edge of a row, a float32 ulp either side, and off
    the map on both sides."""
    f32 = np.float32
    edges = (lim0 + res * np.arange(-2, W + 2)).astype(f32)
    return np.concatenate([edges, np.nextafter(edges, f32(-np.inf)),
                           np.nextafter(edges, f32(np.inf)),
                           f32([-50.0, 1e4])])


@pytest.mark.parametrize("layout", ["byte", "binned2", "binned", "binned8"])
@pytest.mark.parametrize("case", [
    # H, W, rH, rW, B_lin, B_ang, res, lim0, M
    (250, 250, 85, 85, 12, 12, 0.5, -0.5, 16),
    (250, 250, 85, 85, 4, 3, 0.5, 0.0, 3),
    (64, 48, 13, 11, 4, 2, 0.3, -1.3, 1),
    (40, 40, 40, 17, 2, 4, 0.25, 0.0, 5),
])
def test_map_sample_crop_matches_plain_on_card(case, layout):
    """The crop mode against its plain version (``crop_window_plain`` then
    ``sample_and_pack_window_plain``) on the card: payload, grids, offset
    and shifted limits bit for bit, with and without the risk plane, for
    robots at every cell edge of a row, a float32 ulp either side, and off
    the map; one launch a call."""
    dev = _cuda_or_skip()
    H, W, rH, rW, bl, ba, res, lim0, M = case
    if layout in ("binned2", "binned") and max(bl, ba) > (
            4 if layout == "binned2" else 16):
        bl = ba = 4
    maps, task = _crop_inputs(dev, H, W, bl, ba, res, lim0)
    xs = _crop_positions(W, res, lim0)
    rng = np.random.RandomState(1)
    key = torch.tensor([11, 2 ** 31 + 5], dtype=torch.int64, device=dev)
    before = map_sample.sample_and_pack_crop.launches
    calls = 0
    for x in xs[::3] if H > 100 else xs:
        t = task._replace(x0=torch.tensor(
            [x, np.float32(rng.choice(xs)), 0.3], device=dev))
        for risk in (False, True):
            got = map_sample.sample_and_pack_crop(key, maps, t, M, layout,
                                                  (rH, rW), risk=risk)
            want = map_sample.sample_and_pack_crop_plain(
                key, maps, t, M, layout, (rH, rW), risk=risk)
            calls += 1
            assert torch.equal(got[4], want[4]), (x, t.x0)
            for name in ("xlim0", "ylim0"):
                assert torch.equal(getattr(got[3], name).reshape(()),
                                   getattr(want[3], name).reshape(())), x
            for g, w in zip(_flat_outputs(got[:3]), _flat_outputs(want[:3])):
                assert (g is None) == (w is None)
                if g is not None:
                    assert g.dtype == w.dtype and torch.equal(g, w), (
                        x, risk, int((g != w).sum()))
    torch.cuda.synchronize()
    assert map_sample.sample_and_pack_crop.launches == before + calls


def test_map_sample_crop_rejects_bad_inputs():
    dev = _cuda_or_skip()
    maps, task = _crop_inputs(dev, 20, 20, 3, 3, 0.5, 0.0)
    key = torch.tensor([1, 2], dtype=torch.int64, device=dev)
    before = map_sample.sample_and_pack_crop.launches
    with pytest.raises(ValueError, match="obstacle"):
        map_sample.sample_and_pack_crop(
            key, maps._replace(obstacle=maps.obstacle[:5]), task, 2, "byte",
            (5, 5))
    with pytest.raises(ValueError, match="x0"):
        map_sample.sample_and_pack_crop(
            key, maps, task._replace(x0=task.x0.double()), 2, "byte", (5, 5))
    with pytest.raises(ValueError, match="float32 scalar"):
        map_sample.sample_and_pack_crop(
            key, maps, task._replace(res=task.res.double()), 2, "byte",
            (5, 5))
    with pytest.raises(ValueError, match="window"):
        map_sample.sample_and_pack_crop(key, maps, task, 2, "byte", (21, 5))
    assert map_sample.sample_and_pack_crop.launches == before


def _roi_planner(dev, roi, mode="tdm"):
    cfg = Config(T=2.0, dt=0.1, num_grid_samples=16,
                 num_control_rollouts=256, max_speed_padding=1.0,
                 max_map_dim=(64, 64), seed=3, use_tdm=mode == "tdm",
                 use_det_dynamics=mode == "det_dyn")
    rng = np.random.RandomState(0)
    raw = rng.randint(1, 50, size=(6, 48, 48))
    pmf = np.floor(100 * raw / raw.sum(0)).astype(np.int8)
    pmf[-1] += 100 - pmf.sum(0).astype(np.int8)
    tdm_dict = dict(res=0.5, xlimits=(0.0, 24.0), ylimits=(0.0, 24.0),
                    bin_values=np.linspace(0.0, 1.0, 6),
                    bin_values_bounds=(0.0, 1.0), det_dynamics_cvar_alpha=1.0)
    lin, ang = TDM(cfg, device=dev), TDM(cfg, device=dev)
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = MPPIPlanner(cfg, device=dev)
    if not roi:
        planner._roi_shape = lambda hw: None
    planner.setup(dict(dt=0.1, x0=np.array([6.25, 7.25, 0.3]),
                       xgoal=np.array([18.0, 17.0]), goal_tolerance=0.5,
                       v_post_rollout=0.5, cvar_alpha=0.5, lambda_weight=1.0,
                       u_std=np.array([1.0, 1.5]), vrange=np.array([0.0, 1.0]),
                       wrange=np.array([-np.pi, np.pi])), lin, ang)
    return planner


def test_planner_roi_crop_equals_full_on_card():
    """A cropped planner and an uncropped one with the same seed give the
    same controls bit for bit on the card, the cropped grids being the
    window of the uncropped ones; every uncropped solve samples and packs
    its maps through the map_sample kernel once
    (``sample_and_pack_window``), and every cropped solve through its crop
    mode once (``sample_and_pack_crop``), no other launch for the crop."""
    dev = _cuda_or_skip()
    p_roi, p_full = _roi_planner(dev, True), _roi_planner(dev, False)
    rH, rW = p_roi._static().roi_shape
    assert (rH, rW) == (13, 13) and p_full._static().roi_shape is None
    before = map_sample.sample_and_pack_window.launches
    bins_before = map_sample.sample_traction_window.launches
    crops = map_sample.sample_and_pack_crop.launches
    x = np.array([6.25, 7.25, 0.3])
    for _ in range(3):
        u_roi, u_full = p_roi.solve(), p_full.solve()
        assert np.array_equal(u_roi, u_full)
        oy, ox = p_roi._last_aux.roi_offset.tolist()
        assert torch.equal(p_roi._last_aux.lin_grids,
                           p_full._last_aux.lin_grids[:, oy:oy + rH,
                                                      ox:ox + rW])
        x = x + 0.1 * np.array([u_roi[0, 0] * np.cos(x[2]),
                                u_roi[0, 0] * np.sin(x[2]), u_roi[0, 1]])
        p_roi.shift_and_update(x, u_roi)
        p_full.shift_and_update(x, u_full)
    assert map_sample.sample_and_pack_window.launches == before + 3
    assert map_sample.sample_traction_window.launches == bins_before
    assert map_sample.sample_and_pack_crop.launches == crops + 3
    np.testing.assert_array_equal(p_roi.get_state_rollout(),
                                  p_full.get_state_rollout())


# -- CUDA graphs: the planner's solve and vis, the device simulator ---------------


def _clone_all(tup):
    return type(tup)(*(None if t is None else t.clone() for t in tup))


@pytest.mark.parametrize("roi", [True, False])
def test_planner_graph_solve_and_vis_equal_eager_on_card(roi):
    """The planner's solves, replayed from its CUDA graph, against eager
    solves of the same solver from a generator of the same seed, bit for
    bit (controls, every ``SolveAux`` field, the vis rollouts), over solve
    -> ``shift_and_update`` -> solve, then new params, then a new TDM;
    each solve one map_sample launch (the crop mode's when cropping)."""
    from mppi_numba_tpu_torch.solver import get_terrain_solver, get_terrain_vis

    dev = _cuda_or_skip()
    planner = _roi_planner(dev, roi)
    gen = torch.Generator(device=dev).manual_seed(planner.seed)
    u_e = torch.zeros((planner.num_steps, 2), device=dev)
    wrapper = (map_sample.sample_and_pack_crop if roi
               else map_sample.sample_and_pack_window)
    x = np.array([6.25, 7.25, 0.3])
    for step in range(5):
        if step == 3:
            params = dict(planner.params, xgoal=np.array([16.0, 19.0]))
            planner.set_params(params)
        if step == 4:
            other = _roi_planner(dev, roi)
            rng = np.random.RandomState(9)
            raw = rng.randint(1, 50, size=(6, 48, 48))
            pmf = np.floor(100 * raw / raw.sum(0)).astype(np.int8)
            pmf[-1] += 100 - pmf.sum(0).astype(np.int8)
            for tdm in (other.lin_tdm, other.ang_tdm):
                tdm.set_TDM_from_PMF_grid(pmf, dict(
                    res=0.5, xlimits=(0.0, 24.0), ylimits=(0.0, 24.0),
                    bin_values=np.linspace(0.0, 1.0, 6),
                    bin_values_bounds=(0.0, 1.0),
                    det_dynamics_cvar_alpha=1.0))
            planner.set_tdm(other.lin_tdm, other.ang_tdm)
        static = planner._static()
        maps = _clone_all(planner._map_inputs())
        task = _clone_all(planner._task_device)
        before = wrapper.launches
        u = planner.solve()
        assert wrapper.launches == before + 1
        want_u, want_aux = get_terrain_solver(static, dev)(gen, maps, task,
                                                           u_e)
        assert np.array_equal(u, want_u.cpu().numpy()), step
        for name in want_aux._fields:
            assert torch.equal(getattr(planner._last_aux, name),
                               getattr(want_aux, name)), (step, name)
        states = planner.get_state_rollout()
        want_states = get_terrain_vis(static)(
            maps, task, want_u, planner.u_prev, want_aux.noise_vis,
            want_aux.lin_grids, want_aux.ang_grids, want_aux.roi_offset)
        assert np.array_equal(states, want_states.cpu().numpy()), step
        x = x + 0.1 * np.array([u[0, 0] * np.cos(x[2]),
                                u[0, 0] * np.sin(x[2]), u[0, 1]])
        planner.shift_and_update(x, u)
        u_e = torch.cat([want_u[1:], want_u[-1:]])
        assert torch.equal(planner.u_cur, u_e)
    assert len(planner._solve_graphs) == 1


def test_solve_graph_outputs_are_overwritten_by_the_next_replay():
    """A ``SolveGraph``'s outputs live in its memory pool: the next call
    overwrites them, as its docstring says; a copy keeps them."""
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    dev = _cuda_or_skip()
    planner = _roi_planner(dev, False)
    solver = get_terrain_solver(planner._static(), dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    maps, task = planner._map_inputs(), planner._task_device
    u0 = torch.zeros((planner.num_steps, 2), device=dev)
    graph = solver.capture(gen, maps, task, u0)
    u1, aux1 = graph(gen, maps, task, u0)
    kept = (u1.clone(), aux1.lin_grids.clone())
    u2, aux2 = graph(gen, maps, task, u1)
    assert u2 is u1 and aux2.lin_grids is aux1.lin_grids
    assert not torch.equal(u2, kept[0])
    assert not torch.equal(aux2.lin_grids, kept[1])
    with pytest.raises(ValueError, match="captured on"):
        graph(gen, _clone_all(maps), task, u0)


@pytest.mark.parametrize("engine", ["make_device_trial", "make_episode_fn"])
def test_device_trial_graph_equals_eager_on_card(engine):
    """The device simulator's graph replays (a generator on the card)
    against its eager loop (a callable making the same draws), bit for
    bit, on a cropped world."""
    from mppi_numba_tpu_torch import device_sim
    from mppi_numba_tpu_torch.ops.sampling import draw_map_key

    dev = _cuda_or_skip()
    planner = _roi_planner(dev, True)
    static = planner._static()
    maps, task = planner._map_inputs(), planner._task_device
    gt = torch.full((48, 48), 0.9, device=dev)
    meta = torch.tensor([0.0, 0.0, 2.0], device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    g2 = torch.Generator(device=dev).manual_seed(4)

    def draws(t):
        key = draw_map_key(g2, dev)
        return key, [torch.randn((static.num_control_rollouts,
                                  static.num_steps, 2), generator=g2,
                                 device=dev) for _ in range(static.num_opt)]

    fn = getattr(device_sim, engine)(static, 25)
    before = map_sample.sample_and_pack_crop.launches
    got = fn(g, maps, task, gt, gt, meta)
    replays = map_sample.sample_and_pack_crop.launches - before
    want = fn(draws, maps, task, gt, gt, meta)
    for a, b in zip(got, want):
        assert torch.equal(a, b), (got, want)
    assert replays >= int(got.steps) > 0


# -- the scenario axis: B scenarios in one launch ---------------------------------


def _stack(parts):
    """Per-scenario arguments (tensors, NamedTuples, tuples) stacked on a
    new leading scenario axis; anything else (None, ints) is the first's."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    if hasattr(first, "_replace"):
        return type(first)(*(_stack(list(f)) for f in zip(*parts)))
    if isinstance(first, tuple):
        return tuple(_stack(list(f)) for f in zip(*parts))
    return first


def _assert_same(got, want, what):
    """Equal bit for bit, tensor by tensor through tuples (None matching
    None)."""
    if isinstance(got, tuple):
        assert isinstance(want, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _assert_same(g, w, what)
        return
    assert (got is None) == (want is None), what
    if got is not None:
        assert got.dtype == want.dtype and torch.equal(got, want), (
            what, int((got != want).sum()))


@pytest.mark.parametrize("layout", ["bins", "byte", "binned2", "binned",
                                    "binned8"])
def test_map_sample_scenarios_match_single_and_plain_on_card(layout):
    """Three scenarios (their own keys, alpha_dyn, window offsets and maps)
    in one window-mode launch equal the three single launches and the
    batched plain version, bit for bit, with and without the risk plane."""
    dev = _cuda_or_skip()
    M, H, W, win = 16, 31, 37, (5, 9, 13, 11)
    bins = 4 if layout == "binned2" else 12
    singles = [_map_sample_args(dev, M, H, W, (win[0] + s, win[1] - s,
                                               *win[2:]),
                                bins, bins, alpha, seed=s)
               for s, alpha in enumerate((1.0, 0.2, 0.6))]
    for risk in (False, True):
        outs = []
        for args, kw in singles:
            if layout == "bins":
                outs.append(map_sample.sample_traction_window(*args, **kw))
            else:
                maps = _fused_maps(args, risk_seed=7)
                outs.append(map_sample.sample_and_pack_window(
                    args[0], maps, args[5], M, layout, risk=risk, **kw))
        batch_args = _stack([a for a, _ in singles])
        kw0 = singles[0][1]
        batch_kw = dict(kw0, window=(kw0["window"][0], *(
            torch.stack([kw["window"][i] for _, kw in singles])
            for i in (1, 2))))
        before = (map_sample.sample_traction_window.launches
                  + map_sample.sample_and_pack_window.launches)
        if layout == "bins":
            args = (*batch_args[:6], M)
            got = map_sample.sample_traction_window(*args, **batch_kw)
            want = map_sample.sample_traction_window_plain(*args, **batch_kw)
        else:
            maps = _stack([_fused_maps(a, risk_seed=7) for a, _ in singles])
            got = map_sample.sample_and_pack_window(
                batch_args[0], maps, batch_args[5], M, layout, risk=risk,
                **batch_kw)
            want = map_sample.sample_and_pack_window_plain(
                batch_args[0], maps, batch_args[5], M, layout, risk=risk,
                **batch_kw)
        torch.cuda.synchronize()
        assert (map_sample.sample_traction_window.launches
                + map_sample.sample_and_pack_window.launches) == before + 1
        _assert_same(got, want, (layout, risk, "plain"))
        _assert_same(got, _stack(outs), (layout, risk, "single"))


@pytest.mark.parametrize("layout", ["byte", "binned2", "binned", "binned8"])
def test_map_sample_crop_scenarios_match_single_and_plain_on_card(layout):
    """The crop mode with three scenarios (robots in different windows, one
    off the map; their own maps, keys and alpha_dyn) in one launch equals
    three single launches and the batched plain version, bit for bit:
    payload, grids, offsets and shifted limits."""
    dev = _cuda_or_skip()
    H, W, rH, rW, M = 64, 48, 13, 11, 5
    bins = 4 if layout == "binned2" else 12
    cases = []
    for s, (x, y, alpha) in enumerate(((3.0, 4.0, 1.0), (13.7, 2.2, 0.4),
                                       (-5.0, 30.0, 0.8))):
        maps, task = _crop_inputs(dev, H, W, bins, bins, 0.3, -1.3, seed=s)
        task = task._replace(
            x0=torch.tensor([x, y, 0.3], device=dev),
            alpha_dyn=torch.tensor(alpha, dtype=torch.float32, device=dev))
        key = torch.tensor([s + 1, 2 ** 31 + 7 * s], dtype=torch.int64,
                           device=dev)
        cases.append((key, maps, task))
    key = torch.stack([c[0] for c in cases])
    maps = _stack([c[1] for c in cases])
    task = _stack([c[2] for c in cases])
    for risk in (False, True):
        singles = [map_sample.sample_and_pack_crop(k, m, t, M, layout,
                                                   (rH, rW), risk=risk)
                   for k, m, t in cases]
        before = map_sample.sample_and_pack_crop.launches
        got = map_sample.sample_and_pack_crop(key, maps, task, M, layout,
                                              (rH, rW), risk=risk)
        torch.cuda.synchronize()
        assert map_sample.sample_and_pack_crop.launches == before + 1
        want = map_sample.sample_and_pack_crop_plain(key, maps, task, M,
                                                     layout, (rH, rW),
                                                     risk=risk)
        for name, g, w, s in (
                ("payload", got[0], want[0], _stack([o[0] for o in singles])),
                ("grids", got[1:3], want[1:3],
                 _stack([o[1:3] for o in singles])),
                ("offset", got[4], want[4], _stack([o[4] for o in singles])),
                ("lims", (got[3].xlim0, got[3].ylim0),
                 (want[3].xlim0, want[3].ylim0),
                 (torch.stack([o[3].xlim0 for o in singles]),
                  torch.stack([o[3].ylim0 for o in singles])))):
            _assert_same(g, w, (layout, risk, name, "plain"))
            _assert_same(g, s, (layout, risk, name, "single"))
        assert len({tuple(o) for o in got[4].tolist()}) == 3


def _vary_task_vecs(tvs):
    """Per-scenario task vectors made to differ: x0, the goal, dt and the
    map origin move with the scenario."""
    out = []
    for b, tv in enumerate(tvs):
        tv = tv.clone()
        tv[0] += 0.25 * b
        tv[3] -= 0.5 * b
        tv[7] += 0.01 * b
        tv[12] -= 0.1 * b
        out.append(tv)
    return out


@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("model", ["fast", "exact", "bicycle"])
@pytest.mark.parametrize("layout", ["byte", 2, 4, 8])
def test_rollout_scenarios_match_single_and_plain_on_card(layout, model,
                                                          speed_map):
    """Three scenarios (their own maps, tasks and controls) in one rollout
    launch equal three single launches and the batched plain version, bit
    for bit, on the byte kernel and each binned layout."""
    dev = _cuda_or_skip()
    K, M, T, H, W = 300, 5, 40, 21, 30
    fast_trig, step_fn = _MODELS[model]
    steer = 0.5 if model == "bicycle" else 2.5
    if layout == "byte":
        parts = [_inputs(dev, K, M, T, H, W, True, speed_map, seed=s,
                         steer=steer) for s in range(3)]
        tvs = _vary_task_vecs([p[1] for p in parts])
        parts = [(p[0], tv, *p[2:]) for p, tv in zip(parts, tvs)]
        kernel = rollout_byte.terrain_rollout_costs_byte
        plain = rollout_byte.terrain_rollout_costs_byte_plain
        kw = dict(H=H, W=W, T=T, speed_map=speed_map, fast_trig=fast_trig,
                  step_fn=step_fn)
    else:
        parts = [_binned_inputs(dev, layout, K, M, T, H, W, speed_map,
                                past_last=True, seed=s, steer=steer)[0]
                 for s in range(3)]
        tvs = _vary_task_vecs([p[3] for p in parts])
        parts = [(*p[:3], tv, *p[4:]) for p, tv in zip(parts, tvs)]
        kernel = rollout_binned.terrain_rollout_costs_binned
        plain = rollout_binned.terrain_rollout_costs_binned_plain
        kw = dict(H=H, W=W, T=T, cell_bits=layout, fast_trig=fast_trig,
                  step_fn=step_fn)
    singles = torch.stack([kernel(*p, **kw) for p in parts])
    args = _stack(parts)
    before = kernel.launches
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.shape == (3, K, M)
    assert torch.equal(got, singles)
    assert torch.equal(got, plain(*args, **kw))


def test_rollout_scenarios_reject_mismatched_axes_on_card():
    dev = _cuda_or_skip()
    K, M, T, H, W = 64, 3, 10, 9, 9
    parts = [_inputs(dev, K, M, T, H, W, False, False, seed=s)
             for s in range(2)]
    words, tv, v, w = _stack(parts)
    kernel = rollout_byte.terrain_rollout_costs_byte
    before = kernel.launches
    with pytest.raises(ValueError, match="task_vec"):
        kernel(words, tv[0], v, w, H=H, W=W, T=T)
    with pytest.raises(ValueError, match="v_all"):
        kernel(words, tv, v[0], w, H=H, W=W, T=T)
    binned, _ = _binned_inputs(dev, 4, K, M, T, H, W, False, False)
    cells, mask, lut, tv1, v1, w1, _ = binned
    with pytest.raises(ValueError, match="mask"):
        rollout_binned.terrain_rollout_costs_binned(
            cells[None], mask, lut[None], tv1[None], v1[None], w1[None],
            H=H, W=W, T=T, cell_bits=4)
    assert kernel.launches == before


SKIP_SCENARIOS = 30      # a sweep chunk's episodes
SKIPPED = {"none": (), "some": (0, 3, 4, 5, 13, 21, 28, 29),
           "all": tuple(range(SKIP_SCENARIOS))}


@pytest.mark.parametrize("skipped", sorted(SKIPPED))
@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("layout", ["byte", 8])
def test_rollout_skip_mask_matches_plain_on_card(layout, speed_map, skipped):
    """B = 30 scenarios with 0, some or all of them marked in the skip
    mask (unicycle, fast trig): the launch equals the masked plain
    version bit for bit, its unmarked scenarios the unmasked launch's and
    its marked ones zeros, in one launch."""
    dev = _cuda_or_skip()
    K, M, T, H, W = 300, 5, 40, 21, 30
    if layout == "byte":
        parts = [_inputs(dev, K, M, T, H, W, True, speed_map, seed=s)
                 for s in range(SKIP_SCENARIOS)]
        tvs = _vary_task_vecs([p[1] for p in parts])
        parts = [(p[0], tv, *p[2:]) for p, tv in zip(parts, tvs)]
        kernel = rollout_byte.terrain_rollout_costs_byte
        plain = rollout_byte.terrain_rollout_costs_byte_plain
        kw = dict(H=H, W=W, T=T, speed_map=speed_map, fast_trig=True)
    else:
        parts = [_binned_inputs(dev, layout, K, M, T, H, W, speed_map,
                                past_last=True, seed=s)[0]
                 for s in range(SKIP_SCENARIOS)]
        tvs = _vary_task_vecs([p[3] for p in parts])
        parts = [(*p[:3], tv, *p[4:]) for p, tv in zip(parts, tvs)]
        kernel = rollout_binned.terrain_rollout_costs_binned
        plain = rollout_binned.terrain_rollout_costs_binned_plain
        kw = dict(H=H, W=W, T=T, cell_bits=layout, fast_trig=True)
    args = _stack(parts)
    skip = torch.zeros(SKIP_SCENARIOS, dtype=torch.bool, device=dev)
    skip[list(SKIPPED[skipped])] = True
    full = kernel(*args, **kw)
    before = kernel.launches
    got = kernel(*args, skip=skip, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.shape == full.shape
    assert torch.equal(got, plain(*args, skip=skip, **kw))
    assert torch.equal(got[~skip], full[~skip])
    assert not got[skip].any() and bool(full.all())


def test_rollout_skip_mask_rejects_bad_masks_on_card():
    dev = _cuda_or_skip()
    K, M, T, H, W = 64, 3, 10, 9, 9
    args = _stack([_inputs(dev, K, M, T, H, W, False, False, seed=s)
                   for s in range(2)])
    kernel = rollout_byte.terrain_rollout_costs_byte
    before = kernel.launches
    for bad in (torch.zeros(2, dtype=torch.uint8, device=dev),
                torch.zeros(3, dtype=torch.bool, device=dev),
                torch.zeros((2, 1), dtype=torch.bool, device=dev),
                torch.zeros(2, dtype=torch.bool)):
        with pytest.raises(ValueError, match="skip"):
            kernel(*args, H=H, W=W, T=T, skip=bad)
    binned, _ = _binned_inputs(dev, 8, K, M, T, H, W, False, False)
    with pytest.raises(ValueError, match="skip"):
        rollout_binned.terrain_rollout_costs_binned(
            *(None if a is None else a[None] for a in binned), H=H, W=W,
            T=T, cell_bits=8, skip=torch.zeros(2, dtype=torch.bool,
                                               device=dev))
    assert kernel.launches == before


def _sweep_chunk(dev, method, B, K=1024, M=1024, T=10.0):
    """The first B episodes of the reference benchmark sweep at alpha 0.6
    (``benchmark.DeviceSweep``: 9x9 grids padded to 11x11, 22 bins):
    ``(static, maps, task, gt)`` of ``method``; ``M`` past the Config's
    15,000 is set after it (the static's), as its message invites."""
    from mppi_numba_tpu_torch import benchmark

    world = benchmark.make_benchmark_world(num_bins=20,
                                           rng=np.random.RandomState(0))
    cfg = Config(T=T, dt=0.1, num_grid_samples=M, num_control_rollouts=K,
                 max_speed_padding=5.0, max_map_dim=(15, 15), seed=1,
                 use_tdm=True)
    sweep = benchmark.DeviceSweep(
        cfg, world, (9, 9), 1, 1.0,
        benchmark.default_benchmark_params(cfg, (9, 9), 1),
        [1.0, 0.7, 0.4, 0.1], 10, 3, device=dev)
    _, static, maps, task = sweep.inputs(method, 0.6)
    if method == "noisy_dyn" and static.num_grid_samples != M:
        static = dataclasses.replace(static, num_grid_samples=M)

    def first(tree):
        return type(tree)(*(None if x is None else x[:B] for x in tree))

    return static, first(maps), first(task), tuple(g[:B] for g in sweep.gt)


def test_batched_solve_equals_single_solves_on_card():
    """One batched solve of a sweep chunk (B = 30 of the 11x11 benchmark
    maps, M = K = 1024) against the 30 solves made one at a time from the
    same draws: the sampled grids bit for bit, one map_sample launch and
    one rollout launch in all, and u within rtol 2e-4 / atol 2e-5."""
    from mppi_numba_tpu_torch.solver import get_terrain_solver
    from mppi_numba_tpu_torch.types import scenario

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 30)
    solver = get_terrain_solver(static, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    B, K, T = 30, static.num_control_rollouts, static.num_steps
    keys = torch.randint(0, 2 ** 32, (B, 2), generator=g, device=dev)
    eps = [torch.randn((B, K, T, 2), generator=g, device=dev)]
    u0 = torch.zeros((B, T, 2), device=dev) + 0.3
    launches = (map_sample.sample_and_pack_window.launches,
                rollout_byte.terrain_rollout_costs_byte.launches)
    u_b, aux_b = solver.solve_from_key(keys, eps, maps, task, u0)
    assert (map_sample.sample_and_pack_window.launches,
            rollout_byte.terrain_rollout_costs_byte.launches) == (
                launches[0] + 1, launches[1] + 1)
    for b in range(B):
        u_s, aux_s = solver.solve_from_key(keys[b], [eps[0][b]],
                                           scenario(maps, b),
                                           scenario(task, b), u0[b])
        assert torch.equal(aux_b.lin_grids[b], aux_s.lin_grids), b
        torch.testing.assert_close(u_b[b], u_s, rtol=2e-4, atol=2e-5)


def test_device_trial_batch_graph_equals_eager_on_card():
    """A sweep chunk (B = 6 episodes, risk_dyn, K = 256) through the batch
    engine: its graph replays (one capture, reused by a second call on the
    same generator) against the eager loop (a callable making the same
    draws), bit for bit; one map_sample launch and one rollout launch a
    replay, whatever the batch."""
    from mppi_numba_tpu_torch import device_sim
    from mppi_numba_tpu_torch.ops.sampling import draw_map_key

    dev = _cuda_or_skip()
    static, maps, task, gt = _sweep_chunk(dev, "risk_dyn", 6, K=256)
    engine = device_sim.make_device_trial_batch(static, 60)
    g = torch.Generator(device=dev)
    g2 = torch.Generator(device=dev).manual_seed(4)

    def draws(t):
        return (draw_map_key(g2, dev, (6,)),
                [torch.randn((6, static.num_control_rollouts,
                              static.num_steps, 2), generator=g2,
                             device=dev)])

    results = []
    for _ in range(2):
        g.manual_seed(4)
        before = (map_sample.sample_and_pack_window.launches,
                  rollout_byte.terrain_rollout_costs_byte.launches)
        results.append(engine(g, maps, task, *gt))
        replays = engine.steps_run
        assert (map_sample.sample_and_pack_window.launches - before[0],
                rollout_byte.terrain_rollout_costs_byte.launches
                - before[1]) == (replays, replays)
    assert engine.captures == 1
    g2.manual_seed(4)
    want = engine(draws, maps, task, *gt)
    for got in results:
        for a, b in zip(got, want):
            assert torch.equal(a, b), (got, want)


def test_device_trial_batch_graph_reads_reached_at_each_replay_on_card(
        monkeypatch):
    """A graphed batch engine (noisy_dyn, B = 6, K = 256, M = 64) whose
    episodes reach their goals at different steps: after every replay the
    rollout's zero rows are exactly the episodes that had arrived before
    it (the kernel read ``reached`` as it stood at that replay, not as it
    stood at the capture), some replay has arrived and active episodes
    side by side, ``skipped_solves`` counts the zero rows, and the results
    equal the eager loop's, bit for bit."""
    from mppi_numba_tpu_torch import device_sim, graphs
    from mppi_numba_tpu_torch.ops.sampling import draw_map_key
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    dev = _cuda_or_skip()
    B, K, M = 6, 256, 64
    static, maps, task, gt = _sweep_chunk(dev, "noisy_dyn", B, K=K, M=M)
    # The engine's own (cached) solver: it asks for the maps' device.
    solver = get_terrain_solver(static, maps.lin_pmf.device)
    spy = torch.full((B, K, M), math.nan, device=dev)
    rollout = solver._rollout

    def spied(*args):
        out = rollout(*args)
        spy.copy_(out)
        return out

    monkeypatch.setattr(solver, "_rollout", spied)
    engine = device_sim.make_device_trial_batch(static, 150)
    seen = []
    replay = graphs.Captured.replay

    def replayed(self, *a, **kw):
        before = engine._graphed.ep.reached.clone()
        out = replay(self, *a, **kw)
        seen.append((before.cpu(), (spy == 0).flatten(1).all(1).cpu()))
        return out

    monkeypatch.setattr(graphs.Captured, "replay", replayed)
    got = engine(torch.Generator(device=dev).manual_seed(3), maps, task,
                 *gt)
    monkeypatch.setattr(graphs.Captured, "replay", replay)
    assert engine.captures == 1 and len(seen) == engine.steps_run
    for t, (arrived, zero) in enumerate(seen):
        assert torch.equal(arrived, zero), t
    assert any(a.any() and not a.all() for a, _ in seen)
    assert engine.skipped_solves == sum(int(a.sum()) for a, _ in seen) > 0
    assert engine.skipped_solves == (B * engine.steps_run
                                     - int(got.steps.sum()))
    g2 = torch.Generator(device=dev).manual_seed(3)

    def draws(t):
        return (draw_map_key(g2, dev, (B,)),
                [torch.randn((B, K, static.num_steps, 2), generator=g2,
                             device=dev)])

    want = engine(draws, maps, task, *gt)
    for a, b in zip(got, want):
        assert torch.equal(a, b), (got, want)


def test_checkpoint_round_trip_of_a_graphed_planner_on_card(tmp_path):
    """A planner whose solves replay a CUDA graph, saved after three solves
    and restored (into a fresh planner, and into itself after more
    solves), gives the next solve bit for bit."""
    from mppi_numba_tpu_torch import checkpoint

    dev = _cuda_or_skip()
    planner = _roi_planner(dev, False)
    x = np.array([6.25, 7.25, 0.3])
    for _ in range(3):
        u = planner.solve()
        x = x + 0.1 * np.array([u[0, 0], u[0, 0], u[0, 1]])
        planner.shift_and_update(x, u)
    path = tmp_path / "planner.pkl"
    checkpoint.save_planner_state(planner, path)
    want = planner.solve()
    fresh = _roi_planner(dev, False)
    fresh.solve()                        # capture its graph first
    checkpoint.load_planner_state(fresh, path)
    assert np.array_equal(fresh.solve(), want)
    planner.solve()
    checkpoint.load_planner_state(planner, path)
    assert np.array_equal(planner.solve(), want)
    assert len(planner._solve_graphs) == len(fresh._solve_graphs) == 1


def test_batched_solve_graph_equals_eager_on_card():
    """A batched solve (6 sweep episodes, noisy_dyn, M = 256) captured in
    a ``SolveGraph`` and replayed three times, each fed the last one's
    controls, against the eager batched solve from a generator of the same
    seed, bit for bit; one map_sample and one rollout launch a replay."""
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 6, K=512, M=256)
    solver = get_terrain_solver(static, dev)
    u0 = torch.zeros((6, static.num_steps, 2), device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    g2 = torch.Generator(device=dev).manual_seed(8)
    graph = solver.capture(g, maps, task, u0.clone())
    u_e = u0
    for _ in range(3):
        before = (map_sample.sample_and_pack_window.launches,
                  rollout_byte.terrain_rollout_costs_byte.launches)
        u_g, aux_g = graph(g, maps, task, graph.u0)
        assert (map_sample.sample_and_pack_window.launches - before[0],
                rollout_byte.terrain_rollout_costs_byte.launches
                - before[1]) == (1, 1)
        u_e, aux_e = solver(g2, maps, task, u_e)
        assert torch.equal(u_g, u_e)
        for name in aux_e._fields:
            assert torch.equal(getattr(aux_g, name), getattr(aux_e, name))


@pytest.mark.parametrize("layout", ["byte", "binned2", "binned", "binned8"])
def test_map_sample_crop_m_slices_match_plain_on_card(layout):
    """The crop mode's rows [a, b) of an M-row draw (``m_offset = a``, the
    sharded solve's draw) against its plain version and against the same
    rows of the kernel's whole draw, bit for bit, with and without the
    risk plane."""
    dev = _cuda_or_skip()
    bins = 4
    maps, task = _crop_inputs(dev, 250, 250, bins, bins, 0.5, 0.0)
    task = task._replace(x0=torch.tensor([61.3, 70.9, 0.3], device=dev))
    key = torch.tensor([7, 2 ** 32 - 9], dtype=torch.int64, device=dev)
    M, a, b = 64, 16, 48
    m_axis = -3 if layout == "byte" else -2
    for risk in (False, True):
        kw = dict(risk=risk, m_offset=a, full_num_samples=M)
        got = map_sample.sample_and_pack_crop(key, maps, task, b - a, layout,
                                              (85, 85), **kw)
        want = map_sample.sample_and_pack_crop_plain(
            key, maps, task, b - a, layout, (85, 85), **kw)
        whole = map_sample.sample_and_pack_crop(key, maps, task, M, layout,
                                                (85, 85), risk=risk)
        for g, w in zip(_flat_outputs(got[:3]), _flat_outputs(want[:3])):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w), (risk, int((g != w).sum()))
        g_planes = got[0] if isinstance(got[0], tuple) else (got[0],)
        w_planes = whole[0] if isinstance(whole[0], tuple) else (whole[0],)
        assert torch.equal(g_planes[0], w_planes[0].narrow(m_axis, a, b - a))
        for g, w in zip(g_planes[1:], w_planes[1:]):
            assert (g is None and w is None) or torch.equal(g, w)
        assert torch.equal(got[1], whole[1].narrow(-3, a, b - a))
        assert torch.equal(got[4], whole[4])


def _one_rank_group(tmp_path):
    """A process group of this process alone (NCCL, the default on a
    card) and its (1, 1, 1) mesh."""
    from mppi_numba_tpu_torch.parallel import multihost
    from mppi_numba_tpu_torch.parallel.mesh import make_mesh

    multihost.initialize("file://{}".format(tmp_path / "store"), 1, 0)
    return make_mesh(1, 1, num_map_shards=1)


def test_sharded_solve_one_rank_equals_single_on_card(tmp_path):
    """The sharded solve of 4 sweep episodes (noisy_dyn, K = 512, M = 256)
    on a one-rank NCCL mesh equals the single batched solve from a
    generator of the same seed bit for bit, in one map_sample launch and
    one rollout launch an iteration, its payload the single draw's."""
    import torch.distributed as dist
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver)
    from mppi_numba_tpu_torch.solver import draw_solve, get_terrain_solver

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 4, K=512, M=256)
    mesh = _one_rank_group(tmp_path)
    try:
        sharded = get_sharded_terrain_solver(static, mesh)
        u0 = torch.zeros((4, static.num_steps, 2), device=dev) + 0.2
        before = (map_sample.sample_and_pack_window.launches,
                  rollout_byte.terrain_rollout_costs_byte.launches)
        u_s, costs_s = sharded(torch.Generator(device=dev).manual_seed(3),
                               maps, task, u0)
        assert (map_sample.sample_and_pack_window.launches - before[0],
                rollout_byte.terrain_rollout_costs_byte.launches
                - before[1]) == (1, static.num_opt)
        u_1, aux = get_terrain_solver(static, dev)(
            torch.Generator(device=dev).manual_seed(3), maps, task, u0)
        assert torch.equal(u_s, u_1) and torch.equal(costs_s, aux.costs)
        keys, _ = draw_solve(torch.Generator(device=dev).manual_seed(3),
                             static, dev, (4,))
        packed, _ = sharded.sample_payload(keys, maps, task)
        want = map_sample.sample_and_pack_window(
            keys, maps, task.alpha_dyn, static.num_grid_samples, "byte")[0]
        assert torch.equal(packed, want)
    finally:
        dist.destroy_process_group()


def test_sharded_trial_batch_one_rank_equals_local_on_card(tmp_path):
    """``make_sharded_trial_batch`` on a one-rank mesh (its engine replays
    one CUDA graph a step of the whole batch's draws) against
    ``make_device_trial_batch`` on the same 4 episodes and seed: every
    metric bit for bit."""
    import torch.distributed as dist
    from mppi_numba_tpu_torch.device_sim import make_device_trial_batch
    from mppi_numba_tpu_torch.parallel.sharded import make_sharded_trial_batch

    dev = _cuda_or_skip()
    static, maps, task, gt = _sweep_chunk(dev, "noisy_dyn", 4, K=512, M=256)
    mesh = _one_rank_group(tmp_path)
    try:
        batch = make_sharded_trial_batch(static, 12, mesh)
        got = batch(torch.Generator(device=dev).manual_seed(5), maps, task,
                    *gt)
        assert batch.engine.captures == 1 and batch.engine.steps_run > 0
        want = make_device_trial_batch(static, 12)(
            torch.Generator(device=dev).manual_seed(5), maps, task, *gt)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    finally:
        dist.destroy_process_group()


def test_sharded_solve_graph_one_rank_equals_eager_and_single_on_card(
        tmp_path):
    """``ShardedTerrainSolver.capture`` on a one-rank NCCL mesh (4 sweep
    episodes, noisy_dyn, K = 512, M = 256): three replays, each fed the
    last one's controls and drawing on from the generator, bit for bit
    against the eager sharded solve and the single solve of generators of
    the same seed in the same chain (u and costs); one map_sample launch
    and one rollout launch an iteration a replay; no collective from the
    host during a replay."""
    import torch.distributed as dist
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver)
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 4, K=512, M=256)
    mesh = _one_rank_group(tmp_path)
    try:
        sharded = get_sharded_terrain_solver(static, mesh)
        single = get_terrain_solver(static, dev)
        u0 = torch.zeros((4, static.num_steps, 2), device=dev) + 0.2
        gens = [torch.Generator(device=dev).manual_seed(3)
                for _ in range(3)]
        graph = sharded.capture(gens[0], maps, task, u0.clone())
        assert graph.kernel_nodes > 0
        u_e = u_s = u0
        calls = []
        saved = dist.all_reduce
        for _ in range(3):
            before = (map_sample.sample_and_pack_window.launches,
                      rollout_byte.terrain_rollout_costs_byte.launches)
            dist.all_reduce = lambda *a, **k: calls.append(a)
            try:
                u_g, c_g = graph(gens[0], maps, task, graph.u0)
            finally:
                dist.all_reduce = saved
            assert (map_sample.sample_and_pack_window.launches - before[0],
                    rollout_byte.terrain_rollout_costs_byte.launches
                    - before[1]) == (1, static.num_opt)
            u_e, c_e = sharded(gens[1], maps, task, u_e)
            u_s, aux = single(gens[2], maps, task, u_s)
            assert torch.equal(u_g, u_e) and torch.equal(c_g, c_e)
            assert torch.equal(u_g, u_s) and torch.equal(c_g, aux.costs)
        assert not calls
    finally:
        dist.destroy_process_group()


def test_sharded_capture_refuses_gloo_on_card(tmp_path):
    """Gloo ranks on a card (collectives on the host) solve eagerly:
    ``capture`` raises and names the reason."""
    import torch.distributed as dist
    from mppi_numba_tpu_torch.parallel import multihost
    from mppi_numba_tpu_torch.parallel.mesh import make_mesh
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver)

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 2, K=256, M=64)
    multihost.initialize("file://{}".format(tmp_path / "store"), 1, 0,
                         backend="gloo")
    try:
        mesh = make_mesh(1, 1, num_map_shards=1)
        solver = get_sharded_terrain_solver(static, mesh)
        u0 = torch.zeros((2, static.num_steps, 2), device=dev)
        with pytest.raises(RuntimeError, match="only on an NCCL mesh"):
            solver.capture(torch.Generator(device=dev), maps, task, u0)
        u, _ = solver(torch.Generator(device=dev).manual_seed(1), maps, task,
                      u0)
        assert torch.isfinite(u).all()
    finally:
        dist.destroy_process_group()


def _barebone_planner(dev, seed=1):
    """``examples/barebone_mppi.py``'s planner (K = 1024, T = 50)."""
    from mppi_numba_tpu_torch import BareboneConfig, BareboneMPPI

    cfg = BareboneConfig(T=5.0, dt=0.1, num_control_rollouts=1024,
                         num_vis_state_rollouts=20, seed=seed)
    planner = BareboneMPPI(cfg, device=dev)
    planner.setup(dict(
        dt=0.1, x0=np.array([0.0, 0.0, np.pi / 4]), xgoal=np.array([7, 5]),
        goal_tolerance=0.5, dist_weight=10, lambda_weight=1.0, num_opt=1,
        u_std=np.array([1.0, 1.0]), vrange=np.array([0.0, 2.0]),
        wrange=np.array([-np.pi, np.pi]),
        obstacle_positions=np.array([[5, 4.5], [2, 1]]),
        obstacle_radius=np.array([1.5, 1]), obs_penalty=1e6))
    return planner


def test_barebone_solve_and_vis_graphs_equal_eager_on_card():
    """``BareboneSolver.capture`` replayed three times, each fed the last
    one's controls, and ``get_barebone_vis`` in a ``graphs.VisGraph``,
    against eager calls from a generator of the same seed, bit for bit
    (u, every ``SolveAux`` field, the states); the captured solve is a few
    kernels, the rollout kernel once."""
    from mppi_numba_tpu_torch.graphs import VisGraph
    from mppi_numba_tpu_torch.solver import (get_barebone_solver,
                                             get_barebone_vis)

    dev = _cuda_or_skip()
    planner = _barebone_planner(dev)
    static, task = planner._static(), planner._task_device
    solver = get_barebone_solver(static, dev)
    g, g2 = (torch.Generator(device=dev).manual_seed(6) for _ in range(2))
    graph = solver.capture(g, task, torch.zeros((50, 2), device=dev))
    # The draw, its scaling and the rollout, CVaR and update kernels: no
    # longer the plain loop's ~1,700 nodes.
    assert graph.captured_launches["barebone_rollout_fused"] == 1
    assert graph.kernel_nodes <= 10, graph.kernel_nodes
    u_e = torch.zeros((50, 2), device=dev)
    for _ in range(3):
        u_g, aux_g = graph(g, task, graph.u0)
        u_e, aux_e = solver(g2, task, u_e)
        assert torch.equal(u_g, u_e)
        for f in ("costs", "weights", "noise_vis"):
            assert torch.equal(getattr(aux_g, f), getattr(aux_e, f)), f
    vis = get_barebone_vis(static)
    vgraph = VisGraph(vis, (task,), (aux_g.noise_vis,), u_g)
    shifted = torch.cat([u_g[1:], u_g[-1:]])
    assert torch.equal(vgraph(shifted, u_g),
                       vis(task, shifted, u_e, aux_e.noise_vis))


def test_barebone_planner_graph_closed_loop_equals_eager_on_card():
    """A graphed ``BareboneMPPI`` closed loop against the eager solver and
    vis from a generator of the planner's seed, bit for bit, over solves,
    shifts, new params of the same shapes (the same graph) and a third
    obstacle (a new ``SolverStatic``: a second graph on new buffers)."""
    from mppi_numba_tpu_torch.solver import (get_barebone_solver,
                                             get_barebone_vis)

    dev = _cuda_or_skip()
    planner = _barebone_planner(dev)
    gen = torch.Generator(device=dev).manual_seed(planner.seed)
    u_e = torch.zeros((50, 2), device=dev)
    x = np.array([0.0, 0.0, np.pi / 4])
    for step in range(8):
        if step == 4:
            planner.set_params(dict(planner.params, xgoal=np.array([6, 6])))
        if step == 6:
            planner.set_params(dict(
                planner.params,
                obstacle_positions=np.array([[5, 4.5], [2, 1], [1, 4]]),
                obstacle_radius=np.array([1.5, 1, 0.5])))
        static = planner._static()
        task = type(planner._task_device)(*(
            t.clone() for t in planner._task_device))
        u = planner.solve()
        assert planner.u_prev is planner.u_cur
        want, aux = get_barebone_solver(static, dev)(gen, task, u_e)
        assert np.array_equal(u, want.cpu().numpy()), step
        x = x + 0.1 * np.array([u[0, 0] * np.cos(x[2]),
                                u[0, 0] * np.sin(x[2]), u[0, 1]])
        planner.shift_and_update(x, u)
        u_e = torch.cat([want[1:], want[-1:]])
        assert torch.equal(planner.u_cur, u_e)
        task.x0.copy_(torch.tensor(x, dtype=torch.float32))
        states = planner.get_state_rollout()
        assert np.array_equal(states, get_barebone_vis(static)(
            task, u_e, want, aux.noise_vis).cpu().numpy()), step
    assert len(planner._solve_graphs) == len(planner._vis_graphs) == 1


def _two_cards_or_skip():
    _cuda_or_skip()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _on(dev, tree):
    """Tensors (through dicts, tuples and NamedTuples; anything else
    kept) on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _on(dev, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_on(dev, t) for t in tree)) if hasattr(
            tree, "_replace") else tuple(_on(dev, t) for t in tree)
    return tree


def _same_on(got, want, dev):
    """``got`` on ``dev`` and equal to ``want`` bit for bit."""
    if isinstance(want, torch.Tensor):
        assert got.device == dev and torch.equal(got.cpu(), want.cpu())
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            _same_on(g, w, dev)
    else:
        assert got is None and want is None


def test_kernels_and_solves_on_the_second_card():
    """With the current device left at ``cuda:0``, each kernel launch and
    each solve on ``cuda:1`` tensors runs on ``cuda:1`` and equals the same
    call on ``cuda:0`` bit for bit: ``map_sample`` (bins mode, fused, crop
    mode), both rollout kernels, an eager ``TerrainSolver`` solve and a
    graph-replayed ``MPPIPlanner`` solve; a launch given tensors of both
    cards raises."""
    from mppi_numba_tpu_torch.ops.kernels.map_sample import (
        sample_and_pack_crop, sample_and_pack_window)
    from mppi_numba_tpu_torch.solver import get_terrain_solver
    from mppi_numba_tpu_torch.types import MapInputs

    d0, d1 = _two_cards_or_skip()
    torch.cuda.set_device(d0)
    args, kw = _map_sample_args(d0, 16, 31, 37, (5, 9, 13, 11), 12, 12, 0.2)
    want = map_sample.sample_traction_window(*args, **kw)
    got = map_sample.sample_traction_window(*_on(d1, args), **_on(d1, kw))
    assert torch.cuda.current_device() == 0
    _same_on(got, want, d1)

    maps, task = _crop_inputs(d0, 250, 250, 4, 4, 0.5, 0.0)
    task = task._replace(x0=torch.tensor([61.3, 70.9, 0.3], device=d0))
    key = torch.tensor([7, 2 ** 32 - 9], dtype=torch.int64, device=d0)
    for fn, fargs in ((sample_and_pack_window,
                       (key, maps, task.alpha_dyn, 64, "binned")),
                      (sample_and_pack_crop,
                       (key, maps, task, 64, "binned", (85, 85)))):
        want = fn(*fargs, risk=True)
        got = fn(*_on(d1, fargs), risk=True)
        _same_on(got, want, d1)
    with pytest.raises(ValueError, match="one device"):
        sample_and_pack_window(key.to(d1), maps, task.alpha_dyn, 64, "byte")

    args = _inputs(d0, 200, 7, 30, 13, 15, True, True)
    kw = dict(H=13, W=15, T=30, speed_map=True)
    _same_on(rollout_byte.terrain_rollout_costs_byte(*_on(d1, args), **kw),
             rollout_byte.terrain_rollout_costs_byte(*args, **kw), d1)
    with pytest.raises(ValueError, match="one device"):
        rollout_byte.terrain_rollout_costs_byte(args[0], args[1].to(d1),
                                                *args[2:], **kw)
    binned, _ = _binned_inputs(d0, 4, 200, 7, 30, 13, 15, True, False)
    kw = dict(H=13, W=15, T=30, cell_bits=4)
    _same_on(rollout_binned.terrain_rollout_costs_binned(*_on(d1, binned),
                                                         **kw),
             rollout_binned.terrain_rollout_costs_binned(*binned, **kw), d1)
    with pytest.raises(ValueError):
        rollout_binned.terrain_rollout_costs_binned(
            binned[0].to(d1), *binned[1:], **kw)
    assert torch.cuda.current_device() == 0

    planners = {d: _roi_planner(d, True) for d in (d0, d1)}
    x = np.array([6.25, 7.25, 0.3])
    for _ in range(3):
        us = {d: p.solve() for d, p in planners.items()}
        assert np.array_equal(us[d1], us[d0])
        assert planners[d1]._solve_graphs and planners[d1].u_cur.device == d1
        x = x + 0.1 * np.array([us[d0][0, 0] * np.cos(x[2]),
                                us[d0][0, 0] * np.sin(x[2]), us[d0][0, 1]])
        for p in planners.values():
            p.shift_and_update(x, us[d0])
    assert torch.cuda.current_device() == 0

    p0 = planners[d0]
    static = p0._static()
    maps0 = MapInputs(*(t.clone() for t in p0._map_inputs()))
    task0 = type(p0._task_device)(*(None if t is None else t.clone()
                                    for t in p0._task_device))
    out = {}
    for d in (d0, d1):
        u0 = torch.zeros((static.num_steps, 2), device=d)
        out[d] = get_terrain_solver(static, d)(
            torch.Generator(device=d).manual_seed(4), _on(d, maps0),
            _on(d, task0), u0)
    _same_on(out[d1], out[d0], d1)
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("window", [False, True])
def test_ops_samplers_on_card_equal_cpu(window):
    """``ops.sample_traction_bins`` / ``sample_traction_grids`` on a card
    (one launch of ``map_sample`` in its bins mode each) equal the CPU
    path bit for bit, on the whole map and on a window of rows [3, 11) of
    a 16-row draw."""
    from mppi_numba_tpu_torch.ops.sampling import (sample_traction_bins,
                                                   sample_traction_grids)

    dev = _cuda_or_skip()
    args, _ = _map_sample_args(dev, 8, 31, 37, (5, 9, 13, 11), 12, 12, 0.2)
    key, pmf, _, qbins, _, alpha, M = args
    kw = (dict(window=((31, 37), 5, 9), m_window=(16, 3)) if window
          else {})
    before = map_sample.sample_traction_window.launches
    bins = sample_traction_bins(key, pmf, alpha, M, **kw)
    grids = sample_traction_grids(key, pmf, qbins, alpha, M, **kw)
    assert map_sample.sample_traction_window.launches == before + 2
    cpu = [t.cpu() for t in (key, pmf, qbins, alpha)]
    assert torch.equal(bins.cpu(), sample_traction_bins(
        cpu[0], cpu[1], cpu[3], M, **kw))
    assert torch.equal(grids.cpu(), sample_traction_grids(*cpu, M, **kw))


def _tail_inputs(dev, B, K, M, T, seed=0):
    """The solve tail's inputs on the card: costs with ties, rows of equal
    crash penalties and one NaN row, noise, controls and per-scenario
    task values (``B`` None: no scenario axis)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lead = () if B is None else (B,)
    n = 1 if B is None else B
    costs = torch.rand(lead + (K, M), generator=g, device=dev) * 100
    costs[..., 1, :] = torch.round(costs[..., 1, :] / 10) * 10
    costs[..., 2, :] = 1e5
    costs[..., 3, : (M + 1) // 2] = 1e5 + 7.5
    costs[..., 4, M // 2] = float("nan")
    noise = torch.randn(lead + (K, T, 2), generator=g, device=dev)
    u = torch.rand(lead + (T, 2), generator=g, device=dev) * 3 - 1
    u_std = torch.rand((n, 2), generator=g, device=dev) + 0.5
    lam = torch.rand((n,), generator=g, device=dev) * 2 + 0.5
    alpha = torch.rand((n,), generator=g, device=dev) * 0.95 + 0.05
    rng = torch.tensor([[0.0, 2.0], [-2.5, 2.5]], device=dev)
    vr, wr = rng[0].expand((n, 2)).clone(), rng[1].expand((n, 2)).clone()
    if B is None:
        u_std, lam, alpha, vr, wr = u_std[0], lam[0], alpha[0], vr[0], wr[0]
    return costs, noise, u, u_std, lam, alpha, vr, wr


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("B,K,M,T", [
    (None, 1000, 1, 50), (None, 1024, 1024, 100), (30, 1024, 1024, 100),
    (None, 2048, 512, 80), (None, 1024, 64, 60), (None, 10240, 16, 100),
    (30, 1000, 5, 40), (None, 1024, 410, 100), (None, 64, 2048, 7),
    (3, 37, 4096, 3)])
def test_cvar_costs_kernel_matches_plain_on_card(B, K, M, T, dynamic):
    """The CVaR plus coupling kernel against its plain version, bit for
    bit (NaN rows included), static count and run-time alpha (and the
    static count's alpha), in registers (M <= 1024) and in shared memory
    (M 2048 and 4096)."""
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    dev = _cuda_or_skip()
    costs, noise, u, u_std, lam, alpha, _, _ = _tail_inputs(dev, B, K, M, T)
    kw = dict(alpha=alpha) if dynamic else dict(numel=max(1, (M * 2) // 10))
    before = kc.cvar_costs.launches
    got = kc.cvar_costs(costs, noise, u, u_std, lam, **kw)
    torch.cuda.synchronize()
    assert kc.cvar_costs.launches == before + 1
    want = kc.cvar_costs_plain(costs, noise, u, u_std, lam, **kw)
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    if not dynamic:
        # The same count from alpha: its own order (windows over M).
        numel = kw["numel"]
        alpha_n = torch.full_like(alpha, (numel - 0.5) / M)
        same = kc.cvar_costs(costs, noise, u, u_std, lam, alpha=alpha_n)
        assert torch.equal(_bits(same), _bits(kc.cvar_costs_plain(
            costs, noise, u, u_std, lam, alpha=alpha_n)))


def test_cvar_costs_kernel_rejects_bad_inputs_on_card():
    """A CPU tensor among CUDA ones, two counts or none: raised before any
    launch."""
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    dev = _cuda_or_skip()
    costs, noise, u, u_std, lam, alpha, _, _ = _tail_inputs(dev, None, 8,
                                                            16, 5)
    before = kc.cvar_costs.launches
    with pytest.raises(ValueError):
        kc.cvar_costs(costs, noise.cpu(), u, u_std, lam, numel=3)
    with pytest.raises(ValueError):
        kc.cvar_costs(costs, noise, u, u_std, lam, numel=3, alpha=alpha)
    with pytest.raises(ValueError):
        kc.cvar_costs(costs, noise, u, u_std, lam)
    assert kc.cvar_costs.launches == before


@pytest.mark.parametrize("B,K,T", [
    (None, 1000, 50), (None, 1024, 100), (30, 1024, 100), (None, 2048, 80),
    (None, 10240, 100), (30, 1000, 40), (None, 20000, 10), (3, 17, 3)])
def test_update_useq_kernel_matches_plain_on_card(B, K, T):
    """The update kernel against its plain version, bit for bit: u and
    the weights, from the CVaR kernel's costs, and with a NaN cost."""
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    dev = _cuda_or_skip()
    costs, noise, u, u_std, lam, alpha, vr, wr = _tail_inputs(dev, B, K, 5,
                                                              T, seed=1)
    costs_k = kc.cvar_costs(costs[..., 5:, :], noise[..., 5:, :, :], u,
                            u_std, lam, alpha=alpha)
    noise = noise[..., 5:, :, :].contiguous()
    for c in (costs_k, costs_k.clone().index_fill_(-1, torch.tensor(
            [3], device=dev), float("nan"))):
        before = ku.update_useq_fused.launches
        got = ku.update_useq_fused(c, noise, u, lam, vr, wr)
        torch.cuda.synchronize()
        assert ku.update_useq_fused.launches == before + 1
        want = ku.update_useq_plain(c, noise, u, lam, vr, wr)
        for g_, w_ in zip(got, want):
            assert g_.shape == w_.shape
            assert torch.equal(_bits(g_), _bits(w_))


@pytest.mark.parametrize("dynamic", [False, True])
def test_solve_graph_with_the_tail_kernels_equals_eager_on_card(dynamic):
    """A sweep chunk's batched solve (B = 30, K = M = 1024), static count
    or run-time alpha, captured in a CUDA graph and replayed, against
    eager solves from a generator of the same seed, bit for bit; each
    replay launches the CVaR and update kernels once an iteration."""
    import dataclasses

    from mppi_numba_tpu_torch.solver import DYNAMIC_CVAR, TerrainSolver

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 30)
    if not dynamic:
        static = dataclasses.replace(static, cvar_numel=205)
    else:
        assert static.cvar_numel == DYNAMIC_CVAR
    solver = TerrainSolver(static, dev)
    u0 = torch.zeros((30, static.num_steps, 2), device=dev) + 0.2
    gens = [torch.Generator(device=dev).manual_seed(2) for _ in range(2)]
    graph = solver.capture(gens[0], maps, task, u0.clone())
    assert graph.captured_launches["cvar_costs"] == static.num_opt
    assert graph.captured_launches["update_useq_fused"] == static.num_opt
    u_e = u0
    for _ in range(2):
        u_g, aux_g = graph(gens[0], maps, task, graph.u0)
        u_e, aux_e = solver(gens[1], maps, task, u_e)
        assert torch.equal(u_g, u_e)
        assert torch.equal(aux_g.costs, aux_e.costs)
        assert torch.equal(aux_g.weights, aux_e.weights)


def _edge_costs(dev, kind, B, K, M, seed=0):
    """Rows that stress the CVaR's select and sort: ``equal`` (every cost
    of a row the same, one value a row), ``ties`` (most costs the crash
    penalty 1e5 and the rest spread around it, so the count's threshold
    lands among equal costs), ``specials`` (NaN, +-inf, +0.0 beside -0.0
    among ordinary costs), ``one_bin`` (costs in [256, 288): every key's
    top 12 bits alike, one bin of the wide kernel's first histogram)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    costs = torch.rand((B, K, M), generator=g, device=dev) * 300
    if kind == "one_bin":
        costs = costs * (31.9 / 300.0) + 256.0
    elif kind == "equal":
        costs = costs[..., :1].expand(B, K, M).contiguous()
    elif kind == "ties":
        pick = torch.rand((B, K, M), generator=g, device=dev)
        costs = torch.where(pick < 0.7, torch.full_like(costs, 1e5),
                            torch.where(pick < 0.85, costs + 1e5, costs))
    else:
        pick = torch.randint(0, 8, (B, K, M), generator=g, device=dev)
        for code, value in ((0, float("nan")), (1, float("inf")),
                            (2, -float("inf")), (3, 0.0), (4, -0.0)):
            costs = torch.where(pick == code,
                                torch.full_like(costs, value), costs)
    return costs


# Every CVaR instantiation (threads a row, keys a thread of the padded
# row), as (an M of that padded row, the team): the warp teams and the
# 128-thread teams at each padded row up to 1,024 (from 256 they select
# first), the 512- and 1,024-thread blocks past it.
CVAR_EDGE_TEAMS = [(7, 32), (50, 32), (100, 32), (100, 128), (200, 32),
                   (200, 128), (300, 32), (300, 128), (1024, 32),
                   (1024, 128), (2000, 512), (3000, 512), (5000, 512),
                   (9000, 1024)]


def cvar_edge_rows(M, tpr, sms):
    """``(B, K)`` for which ``threads_per_row`` gives a row of M the team
    ``tpr`` on a card of ``sms`` SMs: 3 x 37 rows (128 threads a row from
    a padded row of 128, else what M dictates), or for a warp team on rows
    of 128 to 1,024 keys, 3 x K rows with K odd, just past the half of the
    card that 128-thread teams fill.  Neither is a multiple of the four
    rows a warp-team block takes."""
    from mppi_numba_tpu_torch.ops.tree import padded_length

    if tpr == 32 and 128 <= padded_length(M) <= 1024:
        return 3, (8 * sms // 3 + 1) | 1
    return 3, 37


@pytest.mark.parametrize("kind", ["equal", "ties", "specials"])
@pytest.mark.parametrize("M,tpr", CVAR_EDGE_TEAMS)
def test_cvar_costs_select_then_sort_edges_on_card(kind, M, tpr):
    """The CVaR at each instantiation, through the team the launcher
    picks for the rows' shapes, against its plain version, bit for bit, on
    rows of equal costs, of ties at the threshold and of NaN / +-inf /
    +-0.0, at counts 1 and M (static), past M (alpha 1.3) and <= 0 (alpha
    0 and -0.5) and the planner's 0.2: from a padded row of 256 the short
    counts select first and the long ones sort whole."""
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    dev = _cuda_or_skip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, K = cvar_edge_rows(M, tpr, sms)
    assert kc.threads_per_row(B, K, M, sms) == tpr
    T = 9
    costs = _edge_costs(dev, kind, B, K, M)
    _, noise, u, u_std, lam, _, _, _ = _tail_inputs(dev, B, K, M, T)
    counts = [dict(numel=1), dict(numel=M), dict(numel=M + 5)] + [
        dict(alpha=torch.full((B,), a, device=dev))
        for a in (1.3, 0.0, -0.5, 0.2)]
    before = kc.cvar_costs.launches
    for kw in counts:
        want = kc.cvar_costs_plain(costs, noise, u, u_std, lam, **kw)
        got = kc.cvar_costs(costs, noise, u, u_std, lam, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), kw
    assert kc.cvar_costs.launches == before + len(counts)


# The windowed sum's cases (XLA's CPU order, windows of 32 terms): counts
# 1, 33 (a window and one term), 205 (the flagship's 7 windows) and alpha
# 1 (static: the row as stored; run-time: sorted) at M = 1,024, 16,384
# (the last a team sorts: three levels) and 70,000 (the wide kernel's
# windows across its rounds), and the sweep's B = 30.
CVAR_WINDOW_SHAPES = [(None, 64, 1024, 20), (30, 64, 1024, 20),
                      (None, 16, 16384, 20), (2, 5, 70000, 9)]


@pytest.mark.parametrize("B,K,M,T", CVAR_WINDOW_SHAPES)
def test_cvar_windows_on_card(B, K, M, T):
    """The CVaR kernels' windowed sums against the plain version, bit for
    bit: static counts 1, 33, 205, ceil(0.2 M), 16,385 where M is wider
    (a round and one term) and M (alpha 1, unsorted), and the run-time
    alpha of each (alpha 1: the sorted row), on costs spread over eight
    decades (the order shows in the last bits)."""
    import math

    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    dev = _cuda_or_skip()
    costs, noise, u, u_std, lam, _, _, _ = _tail_inputs(dev, B, K, M, T,
                                                        seed=M + 1)
    g = torch.Generator(device=dev).manual_seed(M)
    costs = costs * 10.0 ** (torch.rand(costs.shape, generator=g,
                                        device=dev) * 8 - 3)
    n = 1 if B is None else B
    counts = sorted({c for c in (1, 33, 205, math.ceil(0.2 * M), 16385, M)
                     if c <= M})
    for numel in counts:
        a = 1.0 if numel == M else (numel - 0.5) / M
        alpha = torch.full((n,) if B else (), a, device=dev)
        assert int(torch.ceil(M * alpha).max()) == numel
        for kw in (dict(numel=numel), dict(alpha=alpha)):
            want = kc.cvar_costs_plain(costs, noise, u, u_std, lam, **kw)
            got = kc.cvar_costs(costs, noise, u, u_std, lam, **kw)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want)), (numel, list(kw))


# The barebone rollout kernel's shapes: K of one rollout, a block's 256
# and one either side, the example's 1,000, the lifted 40,000 and the
# Config's 1e6; horizons of 1, 7, 50, 100 and 257 steps (whole and partial
# tiles of 8); 1 and 2 obstacles (held in registers), none, 5 and 9 (the
# generic instantiation, read from global memory).
BAREBONE_KS = (1, 255, 256, 257, 1000, 40000, 1000000)


def _barebone_case(dev, K, T, N, seed=0):
    """The example's task with N obstacles past the goal, controls and
    noise that reach the goal, hit obstacles and clip."""
    from mppi_numba_tpu_torch.types import BareboneTask

    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    obs = torch.rand((N, 2), generator=g, device=dev) * 2.5 + torch.tensor(
        [2.5, 2.0], device=dev)
    task = BareboneTask(
        x0=f([0.0, 0.0, math.pi / 4]), xgoal=f([2.0, 1.5]),
        goal_tolerance=f(0.5), lambda_weight=f(1.0), u_std=f([1.0, 1.0]),
        vrange=f([0.0, 2.0]), wrange=f([-math.pi, math.pi]), dt=f(0.1),
        dist_weight=f(10.0), obs_penalty=f(1e6), obs_pos=obs,
        obs_r=torch.rand((N,), generator=g, device=dev) * 0.5 + 0.5)
    u = torch.stack([torch.rand((T,), generator=g, device=dev) * 2 + 0.5,
                     torch.rand((T,), generator=g, device=dev) - 0.5], -1)
    noise = torch.randn((K, T, 2), generator=g, device=dev) * 1.5
    return task, u, noise


@pytest.mark.parametrize("N", [0, 1, 2, 5, 9])
@pytest.mark.parametrize("T", [1, 7, 50, 100, 257])
@pytest.mark.parametrize("K", BAREBONE_KS)
def test_barebone_rollout_kernel_matches_plain_on_card(K, T, N):
    """The barebone rollout kernel against the plain loop
    (``ops/rollout.py::barebone_rollout_costs``) on the same CUDA tensors,
    bit for bit, one launch counted."""
    from mppi_numba_tpu_torch.ops.kernels import barebone_rollout as kb
    from mppi_numba_tpu_torch.ops.rollout import barebone_rollout_costs

    dev = _cuda_or_skip()
    task, u, noise = _barebone_case(dev, K, T, N, seed=K + T + N)
    before = kb.barebone_rollout_fused.launches
    got = kb.barebone_rollout_fused(task, u, noise)
    torch.cuda.synchronize()
    assert kb.barebone_rollout_fused.launches == before + 1
    want = barebone_rollout_costs(task, u, noise)
    assert got.shape == (K,)
    assert torch.equal(_bits(got), _bits(want))
    if K >= 1000 and T >= 50 and N:
        # Some rollouts hit an obstacle and some reach the goal.
        assert bool((want >= 1e6).any()) and bool((want < 1e6).any())


def test_barebone_rollout_kernel_rejects_bad_inputs_on_card():
    """A CPU tensor among CUDA ones, or noise of another shape: raised
    before any launch."""
    from mppi_numba_tpu_torch.ops.kernels import barebone_rollout as kb

    dev = _cuda_or_skip()
    task, u, noise = _barebone_case(dev, 8, 5, 2)
    before = kb.barebone_rollout_fused.launches
    with pytest.raises(ValueError):
        kb.barebone_rollout_fused(task, u.cpu(), noise)
    with pytest.raises(ValueError):
        kb.barebone_rollout_fused(task._replace(dt=task.dt.cpu()), u, noise)
    with pytest.raises(ValueError):
        kb.barebone_rollout_fused(task, u, noise[..., :1].contiguous())
    assert kb.barebone_rollout_fused.launches == before


# Every update instantiation (positions a thread, blocks a cluster) on an
# H100's 132 SMs, as the (B, K, T) that gets it from ``launch_shape``: K =
# 1, Ks that are no power of two, 15,000 and 20,000 (64 positions a
# thread), Ts that are no multiple of the four steps a block sums.
UPDATE_EDGE_SHAPES = [
    (None, 1, 5), (3, 50, 130), (None, 50, 7), (3, 100, 150), (2, 100, 99),
    (3, 333, 9), (2, 1000, 7), (3, 3000, 130), (2, 3000, 101),
    (None, 3000, 99), (None, 3000, 9), (2, 5000, 130), (None, 5000, 101),
    (None, 5000, 10), (None, 15000, 101), (None, 15000, 10),
    (None, 20000, 5)]


@pytest.mark.parametrize("B,K,T", UPDATE_EDGE_SHAPES)
def test_update_useq_every_launch_shape_on_card(B, K, T):
    """The update kernel in the launch shape ``launch_shape`` gives
    (B, K, T), against its plain version, bit for bit, with and without a
    NaN cost."""
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    dev = _cuda_or_skip()
    costs, noise, u, _, lam, _, vr, wr = _tail_inputs(dev, B, max(K, 8), 1,
                                                      T, seed=3)
    costs = costs[..., :K, 0].contiguous()
    noise = noise[..., :K, :, :].contiguous()
    before = ku.update_useq_fused.launches
    for c in (costs, costs.clone().index_fill_(-1, torch.tensor(
            [K // 2], device=dev), float("nan"))):
        want = ku.update_useq_plain(c, noise, u, lam, vr, wr)
        got = ku.update_useq_fused(c, noise, u, lam, vr, wr)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(_bits(g_), _bits(w_))
    assert ku.update_useq_fused.launches == before + 2


@pytest.mark.parametrize("dynamic", [False, True])
def test_solve_past_the_old_cvar_cap_graph_equals_eager_on_card(dynamic):
    """A solve at ``Config(num_grid_samples=8192)``, past the CVaR kernel's
    former cap of M = 4096, static count or run-time alpha: captured in a
    CUDA graph and replayed, against eager solves from a generator of the
    same seed, bit for bit; each replay launches the CVaR and update
    kernels once an iteration."""
    import dataclasses

    from mppi_numba_tpu_torch.solver import TerrainSolver

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 2, M=8192)
    assert static.num_grid_samples == 8192
    if not dynamic:
        static = dataclasses.replace(static, cvar_numel=1639)
    solver = TerrainSolver(static, dev)
    u0 = torch.zeros((2, static.num_steps, 2), device=dev) + 0.2
    gens = [torch.Generator(device=dev).manual_seed(4) for _ in range(2)]
    graph = solver.capture(gens[0], maps, task, u0.clone())
    assert graph.captured_launches["cvar_costs"] == static.num_opt
    assert graph.captured_launches["update_useq_fused"] == static.num_opt
    u_e = u0
    for _ in range(2):
        u_g, aux_g = graph(gens[0], maps, task, graph.u0)
        u_e, aux_e = solver(gens[1], maps, task, u_e)
        assert torch.equal(u_g, u_e)
        assert torch.equal(aux_g.costs, aux_e.costs)
        assert torch.equal(aux_g.weights, aux_e.weights)
        assert bool(torch.isfinite(u_g).all())


# The shapes past the tail kernels' former caps: T past the 4,096 steps a
# team stages (the coupling its own launch) at every team size, M past the
# 16,384 keys a team sorts (the wide kernel), and at 16,384 itself; then
# three scenarios (each its own alpha) at T = 4,097, 8,193 and 20,000 (the
# coupling kernel's one to four groups a thread) and M = 16 (a warp team),
# 1,024 and 20,000 (the wide kernel after the coupling).
LIFTED_CVAR = [(None, 64, 16, 4097), (None, 37, 16, 20000),
               (3, 37, 300, 4100), (None, 37, 2000, 5000),
               (None, 16, 10000, 4097), (2, 9, 16384, 20),
               (None, 8, 32768, 20), (2, 7, 70000, 20),
               (None, 8, 20000, 4097)] + [
                   (3, 37, M, T) for M in (16, 1024, 20000)
                   for T in (4097, 8193, 20000)]


@pytest.mark.parametrize("B,K,M,T", LIFTED_CVAR)
def test_cvar_costs_past_the_former_caps_on_card(B, K, M, T):
    """The CVaR plus coupling at shapes the kernel refused before, against
    its plain version, bit for bit, at numel ceil(0.2 M), 1 and M and at
    alphas 0.2 and 1 (ties, crashes and a NaN among the costs), three
    scenarios also at alphas 0.2, 0.6 and 1 (one each), and at each
    static count's alpha; past 4,096 steps each call launches the coupling
    kernel once before the CVaR's."""
    import math

    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    dev = _cuda_or_skip()
    costs, noise, u, u_std, lam, _, _, _ = _tail_inputs(dev, B, K, M, T,
                                                        seed=M + T)
    n = 1 if B is None else B
    wide = M > kc.SORTED_M
    counted = kc.cvar_costs_wide if wide else kc.cvar_costs
    before = (counted.launches, kc.coupling_sums.launches)
    calls = 0
    per_scenario = ([dict(alpha=torch.tensor([0.2, 0.6, 1.0][:n],
                                             device=dev))]
                    if B is not None else [])
    for kw in ([dict(numel=v) for v in (math.ceil(0.2 * M), 1, M)]
               + [dict(alpha=torch.full((n,) if B else (), a, device=dev))
                  for a in (0.2, 1.0)] + per_scenario):
        want = kc.cvar_costs_plain(costs, noise, u, u_std, lam, **kw)
        got = kc.cvar_costs(costs, noise, u, u_std, lam, **kw)
        calls += 1
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), kw
        if "numel" in kw:
            alpha = torch.full((n,) if B else (), (kw["numel"] - 0.5) / M,
                               device=dev)
            same = kc.cvar_costs(costs, noise, u, u_std, lam, alpha=alpha)
            calls += 1
            assert torch.equal(_bits(same), _bits(kc.cvar_costs_plain(
                costs, noise, u, u_std, lam, alpha=alpha))), kw
    coupled = calls if T > kc.STAGED_T else 0
    assert (counted.launches, kc.coupling_sums.launches) == (
        before[0] + calls, before[1] + coupled)


@pytest.mark.parametrize("B,K,T", [(None, 1, 4097), (None, 37, 8193),
                                   (3, 1024, 20000), (2, 5, 40000),
                                   (None, 3, 100)])
def test_coupling_sums_on_card(B, K, T):
    """The coupling kernel on its own against its plain version (the
    halving tree of noise * u / sigma^2), bit for bit: one row (a block's
    second row idle), an odd K, the flagship's K at 20,000 steps, 40,000
    steps (super-groups past the register stack) and a short horizon."""
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(T)
    lead = () if B is None else (B,)
    noise = torch.randn(lead + (K, T, 2), generator=g, device=dev)
    u = torch.rand(lead + (T, 2), generator=g, device=dev) * 3 - 1
    u_std = torch.rand(lead + (2,), generator=g, device=dev) + 0.5
    before = kc.coupling_sums.launches
    got = kc.coupling_sums(noise, u, u_std)
    want = kc.coupling_sums_plain(noise, u, u_std)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    assert kc.coupling_sums.launches == before + 1


@pytest.mark.parametrize("kind", ["equal", "ties", "specials", "one_bin"])
def test_cvar_wide_kernel_edges_on_card(kind):
    """The wide kernel on rows of equal costs, of ties at the threshold,
    of NaN / +-inf / +-0.0 and of costs whose keys share their top 12 bits
    (one bin of the first histogram), at counts 1, 16,384 (one round),
    16,385 and M (rounds that end among equal keys), past M and <= 0, and
    at alphas 0.2 and 1, one a scenario; at M = 40,000 and just past
    16,384, with the coupling summed in the block (T = 9) and launched
    before it (T = 4,097)."""
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    dev = _cuda_or_skip()
    B, K = 2, 5
    for M, T in ((40000, 9), (16385, 9), (40000, 4097)):
        costs = _edge_costs(dev, kind, B, K, M)
        _, noise, u, u_std, lam, _, _, _ = _tail_inputs(dev, B, K, 8, T)
        counts = [dict(numel=v)
                  for v in (1, 16384, 16385, 33000, M, M + 5) if v <= M + 5]
        counts += [dict(alpha=torch.full((B,), a, device=dev))
                   for a in (1.3, 0.0, -0.5)]
        counts += [dict(alpha=torch.tensor([0.2, 1.0], device=dev))]
        for kw in counts:
            want = kc.cvar_costs_plain(costs, noise, u, u_std, lam, **kw)
            got = kc.cvar_costs(costs, noise, u, u_std, lam, **kw)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want)), (M, T, kw)


@pytest.mark.parametrize("B,K,T", [(None, 32769, 9), (None, 40000, 50),
                                   (3, 40000, 7), (None, 100000, 50),
                                   (None, 1000000, 50), (2, 65536, 130)])
def test_update_useq_past_the_former_cap_on_card(B, K, T):
    """The update at K past 32,768 (the wide path's three launches) against
    its plain version, bit for bit, with and without a NaN cost."""
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    dev = _cuda_or_skip()
    costs, noise, u, _, lam, _, vr, wr = _tail_inputs(dev, B, K, 1, T,
                                                      seed=K)
    costs = costs[..., 0].contiguous()
    before = (ku.update_useq_fused.launches, ku.update_useq_wide.launches)
    for c in (costs, costs.clone().index_fill_(-1, torch.tensor(
            [K // 3], device=dev), float("nan"))):
        want = ku.update_useq_plain(c, noise, u, lam, vr, wr)
        got = ku.update_useq_fused(c, noise, u, lam, vr, wr)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert g_.shape == w_.shape
            assert torch.equal(_bits(g_), _bits(w_))
    assert (ku.update_useq_fused.launches,
            ku.update_useq_wide.launches) == (before[0], before[1] + 2)


# The wide update's edges: K just past 32,768, the lifted 40,000, just
# past a power of two, the Config's 1e6, and just past 2^20 and 2^21
# (update_wide_eta's streamed groups of 16 positions a thread); one
# scenario and three; T of one step, three, 50 and 4,097 (33 chunks of
# columns), but not K from 1e6 at T = 4,097 (33 GB of noise or more, three
# times that for the plain version).
WIDE_EDGES = [(K, B, T)
              for K in (32769, 40000, 65537, 1000000, 1048577, 2097153)
              for B in (1, 3) for T in (1, 3, 50, 4097)
              if not (K >= 1000000 and T == 4097)]


@pytest.mark.parametrize("K,B,T", WIDE_EDGES)
def test_update_useq_wide_edges_on_card(K, B, T):
    """The wide update (three launches, one count) against its plain
    version, bit for bit: u and the weights (the NaN cost is
    ``test_update_useq_past_the_former_cap_on_card``'s)."""
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    dev = _cuda_or_skip()
    costs, noise, u, _, lam, _, vr, wr = _tail_inputs(
        dev, None if B == 1 else B, K, 1, T, seed=K + B + T)
    costs = costs[..., 0].contiguous()
    costs[..., 4] = 7.0   # no NaN row here: the weights stay finite
    before = ku.update_useq_wide.launches
    got = ku.update_useq_wide(costs, noise, u, lam, vr, wr)
    torch.cuda.synchronize()
    assert ku.update_useq_wide.launches == before + 1
    want = ku.update_useq_plain(costs, noise, u, lam, vr, wr)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert torch.equal(_bits(g_), _bits(w_))


def _scenarios_expanded(t, B):
    """``t`` with a leading axis of B scenarios (a copy a scenario)."""
    return t.expand((B,) + tuple(t.shape)).contiguous()


def test_launches_past_65535_scenarios_equal_per_chunk_launches_on_card():
    """65,539 scenarios (K = 32, M = 1, 11 x 11; every scenario its own
    key) in one call of each scenario-axis wrapper: the map sampler (byte
    and 8-bit-cell payloads), both rollout kernels and the update launch
    twice (65,535 and 4 scenarios), each result bit for bit the calls on
    those two slices, and the last scenarios bit for bit their plain
    versions."""
    from mppi_numba_tpu_torch.types import MapInputs
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    dev = _cuda_or_skip()
    B, K, M, T, H, W = 65539, 32, 1, 5, 11, 11
    args, _ = _map_sample_args(dev, M, H, W, (0, 0, H, W), 12, 12, 1.0)
    one = _fused_maps(args, risk_seed=3)
    maps = MapInputs(*(_scenarios_expanded(t, B) for t in one))
    g = torch.Generator(device=dev).manual_seed(9)
    key = torch.randint(0, 2 ** 31, (B, 2), generator=g, device=dev)
    alpha = torch.ones(B, device=dev)
    parts = (slice(0, 65535), slice(65535, B))

    def cut(tree, p):
        return type(tree)(*(None if t is None else t[p] for t in tree))

    fused = map_sample.sample_and_pack_window
    payloads = {}
    for layout in ("byte", "binned8"):
        before = fused.launches
        whole = fused(key, maps, alpha, M, layout)
        assert fused.launches == before + 2
        for p in parts:
            _assert_same(_stack_free(whole, p),
                         fused(key[p], cut(maps, p), alpha[p], M, layout),
                         (layout, p))
        payloads[layout] = whole[0]
    task_vec = _scenarios_expanded(rollout_byte.build_task_vec(_task(dev)),
                                   B)
    v = torch.rand((B, T, K), generator=g, device=dev) * 2
    w = torch.rand((B, T, K), generator=g, device=dev) * 2 - 1
    words = payloads["byte"]
    kernel = rollout_byte.terrain_rollout_costs_byte
    before = kernel.launches
    costs = kernel(words, task_vec, v, w, H=H, W=W, T=T)
    assert kernel.launches == before + 2
    for p in parts:
        assert torch.equal(_bits(costs[p]), _bits(kernel(
            words[p], task_vec[p], v[p], w[p], H=H, W=W, T=T)))
    assert torch.equal(_bits(costs[-3:]), _bits(
        rollout_byte.terrain_rollout_costs_byte_plain(
            words[-3:], task_vec[-3:], v[-3:], w[-3:], H=H, W=W, T=T)))
    cells, mask, _ = payloads["binned8"]
    binned = rollout_binned.terrain_rollout_costs_binned
    before = binned.launches
    bcosts = binned(cells, mask, None, task_vec, v, w, H=H, W=W, T=T,
                    cell_bits=8)
    assert binned.launches == before + 2
    for p in parts:
        assert torch.equal(_bits(bcosts[p]), _bits(binned(
            cells[p], mask[p], None, task_vec[p], v[p], w[p], H=H, W=W,
            T=T, cell_bits=8)))
    assert torch.equal(_bits(bcosts[-3:]), _bits(
        rollout_binned.terrain_rollout_costs_binned_plain(
            cells[-3:], mask[-3:], None, task_vec[-3:], v[-3:], w[-3:],
            H=H, W=W, T=T, cell_bits=8)))
    noise = torch.randn((B, K, T, 2), generator=g, device=dev)
    u = torch.rand((B, T, 2), generator=g, device=dev)
    lam = torch.ones(B, device=dev)
    vr = _scenarios_expanded(torch.tensor([0.0, 2.0], device=dev), B)
    wr = _scenarios_expanded(torch.tensor([-2.5, 2.5], device=dev), B)
    c = costs[..., 0].contiguous()
    before = ku.update_useq_fused.launches
    got = ku.update_useq_fused(c, noise, u, lam, vr, wr)
    assert ku.update_useq_fused.launches == before + 2
    for p in parts:
        part = ku.update_useq_fused(c[p], noise[p], u[p], lam[p], vr[p],
                                    wr[p])
        for a, b in zip(got, part):
            assert torch.equal(_bits(a[p]), _bits(b))
    want = ku.update_useq_plain(c[-3:], noise[-3:], u[-3:], lam[-3:],
                                vr[-3:], wr[-3:])
    for a, b in zip(got, want):
        assert torch.equal(_bits(a[-3:]), _bits(b))


def _stack_free(out, p):
    """A sampler's result (tensors, tuples of them, Nones) cut to the
    scenarios ``p``."""
    if isinstance(out, tuple):
        return tuple(_stack_free(o, p) for o in out)
    return None if out is None else out[p]


@pytest.mark.parametrize("M", [65541, 70000])
def test_rollouts_past_65535_map_samples_on_card(M):
    """Both rollout kernels at M past 65,535 (runs of 65,535 samples a
    launch, copied into the costs' columns) against their plain versions,
    bit for bit, and the byte kernel against the binned one."""
    dev = _cuda_or_skip()
    K, T, H, W = 32, 7, 3, 4
    words, task_vec, v, w = _inputs(dev, K, M, T, H, W, True, False)[:4]
    kernel = rollout_byte.terrain_rollout_costs_byte
    before = kernel.launches
    got = kernel(words, task_vec, v, w, H=H, W=W, T=T)
    assert kernel.launches == before + 2
    want = rollout_byte.terrain_rollout_costs_byte_plain(
        words, task_vec, v, w, H=H, W=W, T=T)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("M,T", [(1024, 409.7), (20000, 10.0),
                                 (70000, 10.0)])
def test_lifted_terrain_solves_graph_equals_eager_on_card(M, T):
    """Terrain solves past the former caps (4,097 steps; 20,000 and
    70,000 map samples, set after the Config as its message invites), two
    scenarios at the run-time alpha: captured in a CUDA graph and
    replayed, against eager solves from a generator of the same seed, bit
    for bit, each replay launching the CVaR kernel (the wide one past
    16,384 samples) and the update once an iteration."""
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc
    from mppi_numba_tpu_torch.solver import TerrainSolver

    dev = _cuda_or_skip()
    static, maps, task, _ = _sweep_chunk(dev, "noisy_dyn", 2, M=M, T=T)
    assert (static.num_grid_samples, static.num_steps) == (
        M, int(T / 0.1 + 1e-6))
    solver = TerrainSolver(static, dev)
    u0 = torch.zeros((2, static.num_steps, 2), device=dev) + 0.2
    gens = [torch.Generator(device=dev).manual_seed(4) for _ in range(2)]
    graph = solver.capture(gens[0], maps, task, u0.clone())
    cvar = "cvar_costs_wide" if M > kc.SORTED_M else "cvar_costs"
    assert graph.captured_launches[cvar] == static.num_opt
    assert graph.captured_launches["update_useq_fused"] == static.num_opt
    u_e = u0
    for _ in range(2):
        u_g, aux_g = graph(gens[0], maps, task, graph.u0)
        u_e, aux_e = solver(gens[1], maps, task, u_e)
        assert torch.equal(u_g, u_e)
        assert torch.equal(aux_g.costs, aux_e.costs)
        assert torch.equal(aux_g.weights, aux_e.weights)
        assert bool(torch.isfinite(u_g).all())


@pytest.mark.parametrize("K", [100000, 1000000])
def test_lifted_barebone_solves_graph_equals_eager_on_card(K):
    """The barebone engine at K = 100,000 and 1,000,000 (its Config's
    ceiling): ``BareboneSolver.capture`` replayed twice against eager
    solves from a generator of the same seed, bit for bit, each replay
    launching the wide update."""
    from mppi_numba_tpu_torch import BareboneConfig, BareboneMPPI
    from mppi_numba_tpu_torch.solver import get_barebone_solver

    dev = _cuda_or_skip()
    planner = _barebone_planner(dev)
    cfg = BareboneConfig(T=5.0, dt=0.1, num_control_rollouts=K, seed=1)
    assert cfg.num_control_rollouts == K
    big = BareboneMPPI(cfg, device=dev)
    big.setup(planner.params)
    static, task = big._static(), big._task_device
    solver = get_barebone_solver(static, dev)
    g, g2 = (torch.Generator(device=dev).manual_seed(6) for _ in range(2))
    graph = solver.capture(g, task, torch.zeros((50, 2), device=dev))
    assert graph.captured_launches["update_useq_wide"] == static.num_opt
    u_e = torch.zeros((50, 2), device=dev)
    for _ in range(2):
        u_g, aux_g = graph(g, task, graph.u0)
        u_e, aux_e = solver(g2, task, u_e)
        assert torch.equal(u_g, u_e)
        assert torch.equal(aux_g.weights, aux_e.weights)
        assert bool(torch.isfinite(u_g).all())


# -- the visualisation rollouts (csrc/vis_rollout.cu) -------------------------------

# Kernels a vis graph replays at most: the vis kernel (the torch loop
# replayed 3,716 at T = 100 and 557 at the barebone planner's T = 50).
VIS_MAX_NODES = 3
# The full map, the cropped window and its start (oy, ox) of the vis cases.
VIS_MAP, VIS_ROI, VIS_OFFSET = (21, 30), (13, 15), (4, 9)


def _vis_case(dev, mode, V, T, crop, past_last, seed=0, M=None):
    """``terrain_vis_fused``'s positional arguments on ``dev``: int8 grids
    (the window's when cropping; -128 among them with ``past_last``, the
    costmap's all 100), controls, noise rows, the offset and the task."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    M = (V + 2 if mode == "tdm" else 1) if M is None else M
    hw = VIS_ROI if crop else VIS_MAP
    if mode == "costmap":
        lin = np.full((M,) + hw, 100, np.int8)
        ang = lin.copy()
    else:
        lin = rng.randint(0, 101, (M,) + hw).astype(np.int8)
        ang = rng.randint(0, 101, (M,) + hw).astype(np.int8)
    if past_last:
        lin[rng.rand(*lin.shape) < 0.3] = -128
        ang[rng.rand(*ang.shape) < 0.3] = -128
    u_cur = np.stack([rng.uniform(0.5, 2.0, T), rng.uniform(-0.5, 0.5, T)],
                     axis=-1).astype(np.float32)
    u_prev = np.stack([rng.uniform(0.5, 2.0, T), rng.uniform(-0.5, 0.5, T)],
                      axis=-1).astype(np.float32)
    noise = (rng.randn(V, T, 2) * [1.0, 0.6]).astype(np.float32)
    task = _task(dev, steer=0.5)
    if crop:
        task = task._replace(x0=t(np.array([6.1, 3.4, 0.4], np.float32)))
    return (t(lin), t(ang), t(u_cur), t(u_prev), t(noise),
            t(np.array(VIS_OFFSET if crop else (0, 0), np.int32)), task)


def _vis_kw(mode, V, crop, model):
    return dict(V=V, det=mode != "tdm", crop=crop,
                step_fn=dict(_STEPS, unicycle=unicycle_step)[model])


def _vis_held(got, want, model):
    """Bit for bit for every model, the 2.7 m bicycle too: the kernel
    multiplies by the wheelbase's float32 reciprocal, as PyTorch divides
    by a Python scalar on CUDA."""
    assert got.shape == want.shape and got.dtype == want.dtype, model
    assert torch.equal(got, want), model


@pytest.mark.parametrize("past_last", [False, True])
@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("model", ["unicycle", "bicycle", "bicycle_2.7"])
@pytest.mark.parametrize("mode", ["tdm", "det_dyn", "speed_map", "costmap"])
def test_terrain_vis_kernel_matches_plain_on_card(mode, model, crop,
                                                  past_last):
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.ops.rollout import terrain_vis_fused_plain

    dev = _cuda_or_skip()
    V, T = 20, 100
    args = _vis_case(dev, mode, V, T, crop, past_last, seed=3)
    kw = _vis_kw(mode, V, crop, model)
    before = vis_rollout.terrain_vis_fused.launches
    got = vis_rollout.terrain_vis_fused(*args, **kw)
    torch.cuda.synchronize()
    assert vis_rollout.terrain_vis_fused.launches == before + 1
    want = terrain_vis_fused_plain(*args, **kw)
    assert got.shape == (V, T + 1, 3)
    _vis_held(got, want, model)


@pytest.mark.parametrize("T", [1, 7, 100])
@pytest.mark.parametrize("V", [1, 31, 32, 33, 100, 4225])
@pytest.mark.parametrize("mode", ["tdm", "det_dyn"])
def test_terrain_vis_kernel_edges_on_card(mode, V, T):
    """V of one rollout, a warp's width and one either side, many blocks,
    and past the rollouts an H100 holds at once (a block a rollout:
    ``vis_rollout.vis_route``); one step; tdm with more grids than
    rollouts."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.ops.rollout import terrain_vis_fused_plain

    dev = _cuda_or_skip()
    args = _vis_case(dev, mode, V, T, False, True, seed=V + T)
    kw = _vis_kw(mode, V, False, "unicycle")
    got = vis_rollout.terrain_vis_fused(*args, **kw)
    torch.cuda.synchronize()
    want = terrain_vis_fused_plain(*args, **kw)
    assert got.shape == (V, T + 1, 3)
    assert torch.equal(got, want)


# The route cases (grid, T, V): 11 x 11 planes at every byte offset, odd
# T, T = 4,097 (five chunks of the control ring); 250 x 250 (dynamic shared
# memory past 48 KB); 340 x 340, whose grid does not fit beside the ring
# (the global route by its shape); 250 x 250 past the 132 blocks an H100
# holds at once with the grid shared (the global route by its waves); and
# V past the rollouts the card holds at once.
VIS_ROUTE_CASES = (((11, 11), 1, 20), ((11, 11), 7, 20), ((11, 11), 101, 20),
                   ((11, 11), 4097, 5), ((250, 250), 101, 20),
                   ((250, 250), 4097, 3), ((340, 340), 101, 20),
                   ((250, 250), 100, 133), ((140, 84), 100, 4225))


def _vis_route_case(dev, mode, hw, V, T, seed):
    """``terrain_vis_fused``'s arguments on an ``hw`` grid whose planes lie
    at an odd byte offset (a view one byte into its memory), the robot
    mid-map."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    M = V + 2 if mode == "tdm" else 1
    grids = []
    for _ in range(2):
        g = rng.randint(0, 101, M * hw[0] * hw[1] + 1).astype(np.int8)
        g[rng.rand(*g.shape) < 0.3] = -128
        grids.append(t(g)[1:].view((M,) + hw))
    u_cur, u_prev = (t(np.stack([rng.uniform(0.5, 2.0, T),
                                 rng.uniform(-0.5, 0.5, T)], -1)
                       .astype(np.float32)) for _ in range(2))
    noise = t((rng.randn(V, T, 2) * [1.0, 0.6]).astype(np.float32))
    task = _task(dev, steer=0.5)._replace(x0=t(np.array(
        [0.45 * hw[1] * 0.5, 0.55 * hw[0] * 0.5, 0.3], np.float32)))
    return (*grids, u_cur, u_prev, noise, t(np.zeros(2, np.int32)), task)


@pytest.mark.parametrize("route", ["by_shape", "global", "shared"])
@pytest.mark.parametrize("model", ["unicycle", "bicycle", "bicycle_2.7"])
@pytest.mark.parametrize("mode", ["tdm", "det_dyn"])
@pytest.mark.parametrize("case", VIS_ROUTE_CASES,
                         ids=["{}x{}_T{}_V{}".format(*hw, T, V)
                              for hw, T, V in VIS_ROUTE_CASES])
def test_terrain_vis_routes_match_plain_on_card(case, mode, model, route):
    """Each route of the terrain vis kernel against the plain version: the
    route ``route_on_card`` takes from the shape, and each route named
    (the wrapper's ``route``), each launch counted under its route; a
    shared grid that does not fit is refused before any launch."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.ops.rollout import terrain_vis_fused_plain

    dev = _cuda_or_skip()
    hw, T, V = case
    args = _vis_route_case(dev, mode, hw, V, T, seed=T + V)
    assert args[0].data_ptr() % 4 != 0
    kw = _vis_kw(mode, V, False, model)
    det, bike = mode != "tdm", model != "unicycle"
    by_shape = vis_rollout.route_on_card(V, T, *hw, det, bike,
                                         dev.index or 0).route
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if hw == (340, 340) or (hw == (250, 250) and V > sms):
        assert by_shape == "global"
    elif V <= sms:
        assert by_shape == "shared"
    before = dict(vis_rollout.terrain_vis_fused.route_launches)
    if route == "shared" and hw == (340, 340):
        with pytest.raises(ValueError, match="does not fit"):
            vis_rollout.terrain_vis_fused(*args, **kw, route=route)
        assert vis_rollout.terrain_vis_fused.route_launches == before
        return
    got = vis_rollout.terrain_vis_fused(
        *args, **kw, route=None if route == "by_shape" else route)
    torch.cuda.synchronize()
    after = vis_rollout.terrain_vis_fused.route_launches
    want_route = by_shape if route == "by_shape" else route
    assert {k: after[k] - before[k] for k in after} == {
        r: int(r == want_route) for r in after}
    want = terrain_vis_fused_plain(*args, **kw)
    assert got.shape == (V, T + 1, 3)
    _vis_held(got, want, model)


def test_fast_sincos_matches_sincosf_on_card():
    """The terrain chain's branch-free sine and cosine equal ``sincosf``'s
    bits on every float32 below 105,615 in magnitude and every NaN."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout

    dev = _cuda_or_skip()
    bad, checked = vis_rollout.check_fast_sincos(dev.index or 0)
    assert bad == 0
    assert checked == 2 * (0x47ce4780 - 0) + 2 * (2 ** 23 - 1)


@pytest.mark.parametrize("th0", [1.2e5, -3.5e5, 2.0e7])
@pytest.mark.parametrize("model", ["unicycle", "bicycle", "bicycle_2.7"])
@pytest.mark.parametrize("mode", ["tdm", "det_dyn"])
def test_terrain_vis_far_heading_matches_plain_on_card(mode, model, th0):
    """Headings past the fast sine's range: the chunk is stepped again with
    ``sincosf``, bit for bit with the plain version."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.ops.rollout import terrain_vis_fused_plain

    dev = _cuda_or_skip()
    V, T = 6, 40
    args = _vis_route_case(dev, mode, (11, 11), V, T, seed=5)
    task = args[6]._replace(x0=torch.tensor([2.5, 3.0, th0], device=dev))
    args = args[:6] + (task,)
    kw = _vis_kw(mode, V, False, model)
    got = vis_rollout.terrain_vis_fused(*args, **kw)
    torch.cuda.synchronize()
    _vis_held(got, terrain_vis_fused_plain(*args, **kw), model)


def test_vis_kernel_attributes_on_card():
    """Each vis kernel's registers, stack and shared memory: no stack (no
    spill), no static shared memory, and the terrain kernels may take the
    card's whole opt-in dynamic shared memory."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout

    dev = _cuda_or_skip()
    attrs = vis_rollout.kernel_attributes(dev.index or 0)
    optin = vis_rollout._prepared(dev.index or 0)
    assert list(attrs) == list(vis_rollout.KERNEL_NAMES)
    for name, a in attrs.items():
        assert a["static_smem_bytes"] == 0, (name, a)
        assert 0 < a["registers"] <= 255, (name, a)
        if name.startswith("terrain"):
            assert a["max_dynamic_smem_bytes"] == optin, (name, a)


def _barebone_vis_case(dev, V, T, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    planner_task = _barebone_planner(dev)._task_device
    u_cur, u_prev = (t(rng.uniform(-1.0, 2.5, (T, 2)).astype(np.float32))
                     for _ in range(2))
    noise = t(rng.randn(V, T, 2).astype(np.float32))
    return planner_task, u_cur, u_prev, noise


@pytest.mark.parametrize("T", [1, 7, 33, 50, 100, 4097])
@pytest.mark.parametrize("V", [1, 20, 31, 32, 33, 4225])
def test_barebone_vis_kernel_matches_plain_on_card(V, T):
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.ops.rollout import barebone_vis_fused_plain

    dev = _cuda_or_skip()
    args = _barebone_vis_case(dev, V, T, seed=V * T)
    before = vis_rollout.barebone_vis_fused.launches
    got = vis_rollout.barebone_vis_fused(*args)
    torch.cuda.synchronize()
    assert vis_rollout.barebone_vis_fused.launches == before + 1
    assert got.shape == (V, T + 1, 3)
    assert torch.equal(got, barebone_vis_fused_plain(*args))


def test_vis_kernels_refuse_what_they_do_not_take_on_card():
    """A custom model raises (pointing at the eager backend) and wrong
    dtypes, shapes and devices raise ValueError, nothing launched; a
    NaN noise entry passes through the barebone vis's clamps as through
    torch.clamp (the terrain plain loop cannot index a NaN state's
    cell)."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.ops.rollout import barebone_vis_fused_plain

    dev = _cuda_or_skip()
    args = _vis_case(dev, "det_dyn", 4, 10, False, False)
    kw = _vis_kw("det_dyn", 4, False, "custom")
    before = vis_rollout.terrain_vis_fused.launches
    with pytest.raises(NotImplementedError, match="eager"):
        vis_rollout.terrain_vis_fused(*args, **kw)
    kw["step_fn"] = unicycle_step
    bad = [(args[0].to(torch.int32),) + args[1:],
           args[:2] + (args[2][:5],) + args[3:],
           args[:4] + (args[4].cpu(),) + args[5:],
           args[:6] + (args[6]._replace(dt=args[6].dt.double()),)]
    for b in bad:
        with pytest.raises(ValueError):
            vis_rollout.terrain_vis_fused(*b, **kw)
    with pytest.raises(ValueError, match="roi_offset"):
        vis_rollout.terrain_vis_fused(*args[:5], None, args[6],
                                      **dict(kw, crop=True))
    assert vis_rollout.terrain_vis_fused.launches == before
    task, u_cur, u_prev, noise = _barebone_vis_case(dev, 4, 10)
    noise[1, 3, 0] = float("nan")
    noise[2, 5, 1] = float("nan")
    got = vis_rollout.barebone_vis_fused(task, u_cur, u_prev, noise)
    want = barebone_vis_fused_plain(task, u_cur, u_prev, noise)
    assert bool(got.isnan().any())
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("mode", ["tdm", "det_dyn"])
def test_planner_vis_graph_is_one_kernel_on_card(mode):
    """``get_state_rollout()`` replays a vis graph of at most
    ``VIS_MAX_NODES`` kernels that launches the vis kernel once, bit for
    bit with the eager kernel call and its plain version; the barebone
    planner's too.  ``backend="eager"`` keeps the plain loop on the card,
    bit for bit with it."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.solver import get_barebone_vis, get_terrain_vis

    dev = _cuda_or_skip()
    planner = _roi_planner(dev, True, mode)
    assert planner._static().roi_shape is not None
    planner.solve()
    before = vis_rollout.terrain_vis_fused.launches
    states = planner.get_state_rollout()
    assert vis_rollout.terrain_vis_fused.launches == before + 1
    (graph,) = planner._vis_graphs.values()
    assert graph._call.kernel_nodes <= VIS_MAX_NODES
    assert graph._call.captured_launches == {"terrain_vis_fused": 1}
    static, aux = planner._last_static, planner._last_aux
    head = (planner._map_inputs(), planner._task_device)
    tail = (aux.noise_vis, aux.lin_grids, aux.ang_grids, aux.roi_offset)
    for backend in ("auto", "eager"):
        vis = get_terrain_vis(dataclasses.replace(static, backend=backend))
        eager = vis(*head, planner.u_cur, planner.u_prev, *tail)
        assert np.array_equal(states, eager.cpu().numpy()), backend

    bb = _barebone_planner(dev)
    bb.solve()
    before = vis_rollout.barebone_vis_fused.launches
    states = bb.get_state_rollout()
    assert vis_rollout.barebone_vis_fused.launches == before + 1
    (graph,) = bb._vis_graphs.values()
    assert graph._call.kernel_nodes <= VIS_MAX_NODES
    for backend in ("auto", "eager"):
        vis = get_barebone_vis(dataclasses.replace(bb._last_static,
                                                   backend=backend))
        eager = vis(bb._task_device, bb.u_cur, bb.u_prev,
                    bb._last_aux.noise_vis)
        assert np.array_equal(states, eager.cpu().numpy()), backend
