"""The port's TDM and planner vs the JAX package's: staging bit for bit,
the receding-horizon shift, and a short closed loop on the CPU."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_numba_tpu as jpkg
import mppi_numba_tpu.mppi as jmppi
import mppi_numba_tpu_torch as tpkg
import mppi_numba_tpu_torch.mppi as tmppi
from mppi_numba_tpu_torch.solver import DYNAMIC_CVAR

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from external_pmf_planning import synth_pmf_grid  # noqa: E402

NUM_BINS, ROWS, COLS, RES = 12, 30, 40, 0.5


def _grid(unnormalized):
    pmf, bin_values = synth_pmf_grid(NUM_BINS, ROWS, COLS)
    if unnormalized:
        pmf = pmf.copy()
        pmf[:, 3, 5] = 0
        pmf[NUM_BINS - 2, 3, 5] = 60          # column sums to 60
    return pmf, bin_values


def _params():
    return dict(dt=0.1, x0=np.array([2.0, 2.0, np.pi / 4]),
                xgoal=np.array([18.0, 13.0]), goal_tolerance=0.5,
                v_post_rollout=0.01, cvar_alpha=0.3, alpha_dyn=0.7,
                dist_weight=1.0, lambda_weight=1.0, num_opt=2,
                u_std=np.array([2.0, 3.0]), vrange=np.array([0.0, 3.0]),
                wrange=np.array([-np.pi, np.pi]))


def _make(pkg, unnormalized, **planner_kw):
    pmf, bin_values = _grid(unnormalized)
    cfg = pkg.Config(T=2.0, dt=0.1, num_grid_samples=16,
                     num_control_rollouts=128, max_speed_padding=4.0,
                     num_vis_state_rollouts=4, max_map_dim=(80, 100), seed=0,
                     use_tdm=True)
    tdm_dict = dict(res=RES, xlimits=(0.0, COLS * RES),
                    ylimits=(0.0, ROWS * RES), bin_values=bin_values,
                    bin_values_bounds=np.array([0.0, 1.0]),
                    det_dynamics_cvar_alpha=1.0)
    lin, ang = (pkg.TDM(cfg, **planner_kw), pkg.TDM(cfg, **planner_kw))
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = pkg.MPPIPlanner(cfg, **planner_kw)
    planner.setup(_params(), lin, ang)
    return planner


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("unnormalized", [False, True])
def test_planner_staging_bitwise(unnormalized):
    jp = _make(jpkg, unnormalized)
    tp = _make(tpkg, unnormalized, device="cpu")

    jm, tm = jp._map_inputs(), tp._map_inputs()
    for name in jm._fields:
        want, got = _as_np(getattr(jm, name)), _as_np(getattr(tm, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)

    jt, tt = jp._build_task(), tp._build_task()
    for name in jt._fields:
        want, got = _as_np(getattr(jt, name)), _as_np(getattr(tt, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)

    js = dataclasses.asdict(jp._static())
    ts = dataclasses.asdict(tp._static())
    assert set(js) == set(ts)
    for name in set(js) - {"backend"}:
        assert ts[name] == js[name], name
    # The reachable window of this world: 29x29 cells of the 32x42 map.
    assert tp._static().roi_shape == (29, 29)


@pytest.mark.parametrize("matches_last_solve", [False, True])
def test_shift_and_update_matches(matches_last_solve):
    u = np.random.RandomState(2).randn(20, 2).astype(np.float32)
    last = u.copy() if matches_last_solve else None
    want = jmppi.shifted_useq(jnp.asarray(u), last, u, 3)
    got = tmppi.shifted_useq(torch.tensor(u), last, u, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jp = _make(jpkg, False)
    tp = _make(tpkg, False, device="cpu")
    new_x0 = np.array([2.5, 2.25, 0.3])
    for p in (jp, tp):
        if matches_last_solve:
            p.u_cur = (jnp.asarray(u) if p is jp else torch.tensor(u))
            p._last_useq_np = u.copy()
        p.shift_and_update(new_x0, u, num_shifts=2)
    np.testing.assert_array_equal(_as_np(tp.u_cur), _as_np(jp.u_cur))
    np.testing.assert_array_equal(_as_np(tp._task_device.x0),
                                  _as_np(jp._task_device.x0))
    np.testing.assert_array_equal(tp.params["x0"], jp.params["x0"])


def test_closed_loop_on_cpu():
    tp = _make(tpkg, False, device="cpu")
    x = np.array([2.0, 2.0, np.pi / 4])
    for _ in range(3):
        u = tp.solve()
        assert u.shape == (tp.num_steps, 2) and u.dtype == np.float32
        assert np.isfinite(u).all()
        v, w = u[0]
        x = x + 0.1 * np.array([v * np.cos(x[2]), v * np.sin(x[2]), w])
        tp.shift_and_update(x, u, num_shifts=1)
    # The TDMs expose the batch the solve used: the reachable window's.
    assert tp.lin_tdm.sample_grid_batch.shape == (16, 29, 29)


def test_planner_later_slices_raise():
    tp = _make(tpkg, False, device="cpu")
    tp.solve()
    # Visualisation rollouts are ported: the optimal sequence across the
    # first V sampled maps, from the task's x0.
    states = tp.get_state_rollout()
    assert states.shape == (tp.num_vis_state_rollouts, tp.num_steps + 1, 3)
    np.testing.assert_array_equal(
        states[:, 0], np.broadcast_to(tp.params["x0"].astype(np.float32),
                                      (tp.num_vis_state_rollouts, 3)))
    # The det_dyn TDM is ported: a one-hot per cell.
    cfg = tpkg.Config(T=2.0, dt=0.1, use_det_dynamics=True)
    det = tpkg.TDM(cfg, device="cpu")
    det.set_TDM_from_PMF_grid(
        *_grid(False)[:1], dict(res=RES, xlimits=(0, 20), ylimits=(0, 15),
                                bin_values=np.linspace(0, 1, NUM_BINS),
                                bin_values_bounds=(0.0, 1.0),
                                det_dynamics_cvar_alpha=1.0))
    assert det.pmf_grid_initialized
    assert ((det.pmf_grid == 100).sum(0) == 1).all()
    # So is run-time CVaR alpha: one solver serves every alpha.
    tp.cfg.dynamic_cvar = True
    assert tp._static().cvar_numel == DYNAMIC_CVAR
    u = tp.solve()
    assert u.shape == (tp.num_steps, 2) and np.isfinite(u).all()


def test_quantize_pmf_int8_equal():
    pmf = np.random.RandomState(3).dirichlet(np.ones(22), size=5)
    for row in pmf:
        np.testing.assert_array_equal(tpkg.quantize_pmf_int8(row),
                                      jpkg.quantize_pmf_int8(row))
