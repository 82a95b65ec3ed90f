"""The plain reference against the program's plain versions at a tiny
size on the CPU: the same maps, the same draws, the same solve and the
same episode step.  The reference itself imports nothing of the program;
only these tests do."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import mppi as ref
from perfbench.tests.test_perfbench_yardstick import CFG

from mppi_numba_tpu_torch.config import Config, SolverStatic
from mppi_numba_tpu_torch.ops.kernels.rollout_byte import (
    build_task_vec, terrain_rollout_costs_byte_plain)
from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
from mppi_numba_tpu_torch.ops.sampling import uniform01_at_counters
from mppi_numba_tpu_torch.solver import DYNAMIC_CVAR, TerrainSolver
from mppi_numba_tpu_torch.terrain import TDM
from mppi_numba_tpu_torch.types import MapInputs, TerrainTask

REF = Path(__file__).resolve().parents[1] / "reference"
PARAMS = dict(goal_tolerance=0.5, v_post_rollout=0.01, lambda_weight=1.0,
              u_std=[2.0, 3.0], vrange=[0.0, 3.0],
              wrange=[-np.pi, np.pi], alpha_dyn=1.0, cvar_alpha=0.4)
SMALL = dict(CFG, planner=dict(T=1.0, dt=0.1, num_control_rollouts=100,
                               num_grid_samples=6, max_map_dim=[40, 40],
                               max_speed_padding=5.0,
                               num_vis_state_rollouts=1),
             params=PARAMS)


def test_reference_imports_nothing_of_the_program():
    for path in REF.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("__future__", "math", "typing",
                                           "numpy", "torch"), (path, n)


def test_uniforms_match_the_programs_threefry():
    key = torch.tensor([2 ** 32 - 5, 123456789], dtype=torch.int64)
    idx = torch.arange(0, 5000, 7, dtype=torch.int64)
    got = ref.uniforms(key[0], key[1], idx)
    assert torch.equal(got, uniform01_at_counters(key, idx))


def _tdms(mode, det_alpha, grid, world):
    pw = inputs.program_world(world)
    kw = {"tdm": dict(use_tdm=True), "det_dyn": dict(use_det_dynamics=True),
          "speed_map": dict(use_nom_dynamics_with_speed_map=True)}[mode]
    conf = Config(T=1.0, dt=0.1, max_map_dim=(40, 40), **kw)
    lims = ((0, grid.shape[1]), (0, grid.shape[0]))
    out = []
    for plane in ("lin", "ang"):
        t = TDM(conf, device="cpu")
        t.set_TDM_from_semantic_grid(
            grid, 1.0, pw["num_pmf_bins"], pw["bin_values"],
            pw["bin_values_bounds"], *lims, pw["id2name"],
            pw["name2terrain"], pw[plane + "_terrain2pmf"],
            det_dynamics_cvar_alpha=det_alpha)
        out.append(t)
    return out


@pytest.mark.parametrize("mode, alpha", [("tdm", None), ("det_dyn", 0.4),
                                         ("det_dyn", 1.0),
                                         ("speed_map", 0.6)])
def test_planes_match_the_programs_tdm(mode, alpha):
    world, grid, _ = inputs.one_map(dict(SMALL, grid=dict(
        shape=[12, 9], mud_margin=1, res=1.0, grass_density=0.5)), 7, 0)
    lin, ang = _tdms(mode, alpha, grid, world)
    P = ref.planes(world, grid, mode, alpha, 1)
    assert np.array_equal(P.lin, lin.pmf_grid_device.numpy())
    assert np.array_equal(P.ang, ang.pmf_grid_device.numpy())
    assert np.array_equal(P.lin_q, lin.qbin_values.numpy())
    assert np.array_equal(P.risk, lin.risk_traction_map_device.numpy())
    tk = ref.task(dict(SMALL, grid=dict(shape=[12, 9], res=1.0)), world,
                  np.zeros((1, 3)), np.zeros((1, 2)), 1.0, 1.0, "cpu")
    assert float(tk.xlim0[0]) == lin.padded_xlimits[0]
    assert float(tk.ylim0[0]) == lin.padded_ylimits[0]


def _program_task(tk, s=0):
    f = {k: getattr(tk, k)[s] for k in tk._fields}
    return TerrainTask(
        x0=f["x0"], xgoal=f["goal"], goal_tolerance=f["tol"],
        v_post_rollout=f["v_post"], lambda_weight=f["lam"],
        u_std=f["u_std"], vrange=f["vrange"], wrange=f["wrange"],
        dt=f["dt"], dist_weight=torch.tensor(1.0),
        obs_penalty=torch.tensor(1e5), unknown_penalty=torch.tensor(1e2),
        alpha_dyn=f["alpha_dyn"], res=f["res"], xlim0=f["xlim0"],
        ylim0=f["ylim0"], lin_lb=f["lin_lb"], lin_ratio=f["lin_ratio"],
        ang_lb=f["ang_lb"], ang_ratio=f["ang_ratio"],
        cvar_alpha=f["cvar_alpha"])


@pytest.mark.parametrize("mode, roi, dynamic", [
    ("tdm", None, True), ("tdm", (9, 9), False), ("det_dyn", None, False),
    ("speed_map", (9, 9), False)])
def test_solve_matches_the_programs_solve(mode, roi, dynamic):
    """The reference's solve against ``TerrainSolver.solve_from_key`` on
    the same key and normals (the eager path: exact sines)."""
    cfg = dict(SMALL, grid=dict(shape=[20, 22], mud_margin=1, res=1.0,
                                grass_density=0.4))
    world, grid, _ = inputs.one_map(cfg, 11, 0)
    alpha = 0.6
    det = alpha if mode != "tdm" else None
    lin, ang = _tdms(mode, det, grid, world)
    M = 6 if mode == "tdm" else 1
    T, K = 10, 100
    gen = torch.Generator().manual_seed(5)
    key = torch.randint(0, 2 ** 32, (2,), generator=gen, dtype=torch.int64)
    eps = torch.randn((K, T, 2), generator=gen)
    u = torch.randn((T, 2), generator=gen) * 0.5
    x0 = np.array([[6.3, 9.2, 0.7]], np.float32)
    goal = np.array([[14.0, 12.5]], np.float32)
    cvar_alpha = 0.4 if mode == "tdm" else 1.0
    alpha_dyn = 1.0 if mode == "tdm" else alpha
    tk = ref.task(cfg, world, x0, goal, alpha_dyn, cvar_alpha, "cpu")
    P = ref.planes(world, grid, mode, det, ref.pad_cells(cfg))
    numel = None if dynamic else ref.cvar_count(M, cvar_alpha)
    r = ref.solve(torch.tensor(P.lin)[None], torch.tensor(P.ang)[None],
                  torch.tensor(P.lin_q), torch.tensor(P.ang_q),
                  torch.tensor(P.risk)[None], tk, u[None], key[None],
                  eps[None], M=M, roi=roi, fast_trig=False,
                  speed_map=mode == "speed_map", numel=numel)
    H, W = lin.pmf_grid_device.shape[1:]
    static = SolverStatic(
        mode=mode, num_steps=T, num_control_rollouts=K, num_grid_samples=M,
        map_shape=(H, W), num_obstacles=0,
        cvar_numel=DYNAMIC_CVAR if dynamic else numel, num_opt=1,
        num_vis_state_rollouts=1, backend="eager", roi_shape=roi,
        num_pmf_bins=22)
    maps = MapInputs(lin.pmf_grid_device, ang.pmf_grid_device,
                     lin.qbin_values, ang.qbin_values,
                     lin.obstacle_map_device, lin.unknown_map_device,
                     lin.risk_traction_map_device)
    u_new, aux = TerrainSolver(static, "cpu").solve_from_key(
        key, [eps], maps, _program_task(tk), u)
    assert torch.equal(aux.lin_grids, r["lin"][0])
    assert torch.equal(aux.ang_grids, r["ang"][0])
    assert torch.equal(aux.roi_offset.long(), r["offset"][0])
    torch.testing.assert_close(aux.costs, r["costs"][0], rtol=1e-5,
                               atol=1e-4)
    # The reference sums in PyTorch's order, not the program's: an ulp of
    # a cost moves a control by up to some 1e-4 through the softmax
    # (mppi_numba_tpu_torch/ops/tree.py).
    torch.testing.assert_close(u_new, r["u"][0], rtol=0, atol=2e-4)


def test_fast_trig_rollout_matches_the_kernels_plain_version():
    cfg = dict(SMALL, grid=dict(shape=[14, 14], mud_margin=1, res=1.0,
                                grass_density=0.4))
    world, grid, _ = inputs.one_map(cfg, 3, 0)
    P = ref.planes(world, grid, "tdm", None, 1)
    gen = torch.Generator().manual_seed(9)
    M, K, T = 5, 100, 10
    vals = torch.randint(0, 101, (1, M, 16, 16), generator=gen,
                         dtype=torch.int8)
    x0 = np.array([[7.1, 6.4, -0.3]], np.float32)
    tk = ref.task(cfg, world, x0, np.array([[12.0, 3.0]], np.float32), 1.0,
                  1.0, "cpu")
    u = torch.randn((T, 2), generator=gen)
    noise = torch.randn((K, T, 2), generator=gen) * torch.tensor([2., 3.])
    v_all, w_all = _clipped_controls_tk(u, noise, tk.vrange[0],
                                        tk.wrange[0])
    got = ref.rollout_costs(vals, vals.flip(1), None, tk, v_all[None],
                            w_all[None], True, False, torch.float32)
    words = (vals[0].to(torch.int32) & 0xFF) | (
        (vals.flip(1)[0].to(torch.int32) & 0xFF) << 8)
    want = terrain_rollout_costs_byte_plain(
        words, build_task_vec(_program_task(tk)), v_all, w_all, H=16, W=16,
        T=T, fast_trig=True)
    assert torch.equal(got[0], want)
    assert P.lin.shape == (22, 16, 16)


def test_episode_step_matches_the_programs_step():
    from mppi_numba_tpu_torch.device_sim import _Episodes, _make_step_core

    gen = torch.Generator().manual_seed(4)
    S, T = 3, 8
    x0 = torch.tensor([[3.2, 4.1, 0.3], [1.0, 7.7, -2.0], [8.6, 8.4, 1.0]])
    ep = _Episodes(x0, T)
    ep.reached[2] = True
    ep.u.copy_(torch.randn((S, T, 2), generator=gen))
    u_new = torch.randn((S, T, 2), generator=gen)
    gt = (torch.rand((S, 9, 9), generator=gen),
          torch.rand((S, 9, 9), generator=gen),
          torch.tensor([[0.0, 0.0, 1.0]] * S))
    cfg = dict(SMALL, grid=dict(shape=[9, 9], mud_margin=1, res=1.0))
    world = inputs.make_world(CFG["world"], 1)
    tk = ref.task(cfg, world, x0.numpy(), np.full((S, 2), 8.0, np.float32),
                  1.0, 1.0, "cpu")
    before = {n: t.clone() for n, t in zip(
        ("x", "u", "reached", "steps", "cum_obj", "cum_dist", "dist"),
        ep.tensors())}
    core = _make_step_core(lambda m, t, u: (u_new, None))
    ep.step(core, None, _program_task_batch(tk), gt)
    after = ref.episode_step(before, u_new, gt[0], gt[1], 1.0, tk,
                             torch.float32)
    for n, t in zip(("x", "u", "reached", "steps", "cum_obj", "cum_dist"),
                    ep.tensors()):
        torch.testing.assert_close(t, after[n], rtol=1e-6, atol=1e-6)


def _program_task_batch(tk):
    one = _program_task(tk)
    return one._replace(xgoal=tk.goal, goal_tolerance=tk.tol, dt=tk.dt)
