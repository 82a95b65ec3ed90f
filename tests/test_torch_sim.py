"""The port's closed-loop simulation and ground-truth helpers vs the JAX
package's: ``simulate_step``, ``TractionGrid``, the ground-truth draws
(``sample_realization_from_pmf_grid``, ``TDM.sample_grids_true_dist``) and
``trial`` with a fixed stub planner, all equal; then the TDM's own map
draws and the planner's control shift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_numba_tpu as jpkg
import mppi_numba_tpu.sim as jsim
import mppi_numba_tpu.terrain as jterrain
import mppi_numba_tpu_torch as tpkg
import mppi_numba_tpu_torch.sim as tsim
import mppi_numba_tpu_torch.terrain as tterrain
from mppi_numba_tpu_torch.ops.kernels.map_sample import (
    sample_traction_window_plain)
from mppi_numba_tpu_torch.ops.sampling import draw_map_key


def test_simulate_step_equal():
    rng = np.random.RandomState(0)
    for _ in range(50):
        x = rng.randn(3) * [5.0, 5.0, 3.0]
        u = rng.randn(2)
        lt, at = rng.rand(2)
        np.testing.assert_array_equal(tsim.simulate_step(x, u, lt, at, 0.1),
                                      jsim.simulate_step(x, u, lt, at, 0.1))


@pytest.mark.parametrize("use_int8", [False, True])
def test_traction_grid_get_equal(use_int8):
    rng = np.random.RandomState(1)
    lin, ang = rng.rand(9, 13), rng.rand(9, 13)
    kw = dict(res=0.5, use_int8=use_int8, xlimits=(-1.0, 5.5),
              ylimits=(2.0, 6.5))
    tg, jg = (tterrain.TractionGrid(lin, ang, **kw),
              jterrain.TractionGrid(lin, ang, **kw))
    pts = np.concatenate([rng.uniform(-3.0, 8.0, (200, 2)),
                          [[-1.0, 2.0], [5.5, 6.5], [5.49, 6.49],
                           [-1.01, 3.0]]])
    for x, y in pts:
        assert tg.get(x, y) == jg.get(x, y), (x, y)
    for a, b in zip(tg.get_grids(), jg.get_grids()):
        np.testing.assert_array_equal(a, b)
    default = tterrain.TractionGrid(lin, ang)
    assert default.xlimits == (0, 13) and default.ylimits == (0, 9)


def _pmf(rng, B, H, W):
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    raw[0] += 1.0
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    return pmf


def test_sample_realization_from_pmf_grid_equal():
    """The same RandomState draws the same realization in both packages;
    a PMF that does not sum to 100 is refused in both."""
    pmf = _pmf(np.random.RandomState(2), 12, 11, 17)
    ang = pmf[::-1].copy()
    bins = np.linspace(0.0, 1.0, 12)
    kw = dict(res=0.5, xlimits=(0.0, 8.5), ylimits=(0.0, 5.5))
    got = tterrain.sample_realization_from_pmf_grid(
        pmf, ang, bins, np.random.RandomState(9), **kw)
    want = jterrain.sample_realization_from_pmf_grid(
        pmf, ang, bins, np.random.RandomState(9), **kw)
    assert isinstance(got, tterrain.TractionGrid)
    for a, b in zip(got.get_grids(), want.get_grids()):
        np.testing.assert_array_equal(a, b)
    assert (got.xlimits, got.ylimits, got.res) == (want.xlimits,
                                                   want.ylimits, want.res)
    bad = pmf.copy()
    bad[0, 3, 4] += 1
    with pytest.raises(ValueError, match="sums"):
        tterrain.sample_realization_from_pmf_grid(
            bad, ang, bins, np.random.RandomState(9))


def _semantic_tdm(pkg, **kw):
    """A two-terrain semantic world whose densities draw from a seeded
    RandomState of their own."""
    rng = np.random.RandomState(5)
    dens = [pkg.GaussianMixture([0, 1], [0, 1], w, m, s, rng=rng)
            for w, m, s in (([0.6, 0.4], [0.0, 0.8], [0.15, 0.1]),
                            ([1.0], [0.65], [0.1]))]
    terrains = [pkg.Terrain(name, np.zeros(3), d, d, num_saved_samples=200)
                for name, d in zip(("Vegetation", "Dirt"), dens)]
    t2p = {t: d.get_pmf(10) for t, d in zip(terrains, dens)}
    sg = (np.random.RandomState(6).rand(8, 9) < 0.4).astype(np.int8)
    cfg = pkg.Config(T=1.0, dt=0.1, num_grid_samples=4,
                     num_control_rollouts=100, max_speed_padding=1.0,
                     max_map_dim=(30, 30), use_tdm=True)
    tdm = pkg.TDM(cfg, **kw)
    bin_values = t2p[terrains[0]][0]
    tdm.set_TDM_from_semantic_grid(
        sg, 0.5, len(bin_values), bin_values,
        (np.min(bin_values), np.max(bin_values)), (0, 4.5), (0, 4.0),
        {0: "Dirt", 1: "Vegetation"},
        {t.name: t for t in terrains}, t2p)
    return tdm


def test_sample_grids_true_dist_equal():
    got = _semantic_tdm(tpkg, device="cpu").sample_grids_true_dist()
    want = _semantic_tdm(jpkg).sample_grids_true_dist()
    for a, b in zip(got.get_grids(), want.get_grids()):
        np.testing.assert_array_equal(a, b)
    assert (got.res, got.xlimits, got.ylimits) == (want.res, want.xlimits,
                                                   want.ylimits)


def test_int8_grid_to_float32_equal():
    grid = np.random.RandomState(3).randint(0, 101, (4, 6)).astype(np.int8)
    got = _semantic_tdm(tpkg, device="cpu").int8_grid_to_float32(grid)
    want = _semantic_tdm(jpkg).int8_grid_to_float32(grid)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


class _StubPlanner:
    """A fixed planner: a control sequence that depends only on the state
    it was last given, so both packages' trials see the same controls."""

    def __init__(self, x0, goal, T=10):
        self.x = np.asarray(x0, dtype=float)
        self.goal = np.asarray(goal, dtype=float)
        self.T = T
        self.calls = []

    def solve(self):
        d = self.goal - self.x[:2]
        heading = np.arctan2(d[1], d[0])
        w = np.clip(heading - self.x[2], -1.0, 1.0)
        v = min(1.5, float(np.hypot(*d)))
        return np.tile(np.array([v, w], np.float32), (self.T, 1))

    def shift_and_update(self, new_x0, u_cur, num_shifts=1):
        self.calls.append((np.asarray(new_x0).copy(), num_shifts))
        self.x = np.asarray(new_x0, dtype=float)


@pytest.mark.parametrize("max_steps", [5, 80])
def test_trial_equal_with_stub_planner(max_steps):
    """A timeout (5 steps) and a reached goal (80): the same metrics and
    history in both packages."""
    lin = np.full((20, 20), 0.9)
    ang = np.full((20, 20), 0.8)
    lin[5:8, :] = 0.4
    params = dict(x0=np.array([1.0, 1.0, 0.0]), xgoal=np.array([6.0, 7.0]),
                  goal_tolerance=0.5, v_post_rollout=0.5)
    out = []
    for sim, terrain in ((tsim, tterrain), (jsim, jterrain)):
        planner = _StubPlanner(params["x0"], params["xgoal"])
        grid = terrain.TractionGrid(lin, ang, res=0.5)
        seen = []
        out.append((sim.trial(planner, grid, 0.1, max_steps, params,
                              return_history=True,
                              on_step=lambda t, xh: seen.append(
                                  (t, xh.shape))), planner.calls, seen))
    (got, calls_t, seen_t), (want, calls_j, seen_j) = out
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["success"] == (max_steps == 80)
    assert len(calls_t) == len(calls_j) and seen_t == seen_j
    for (a, n), (b, m) in zip(calls_t, calls_j):
        np.testing.assert_array_equal(a, b)
        assert n == m == 1


def test_tdm_sample_grids_draws_from_its_generator():
    """``TDM.sample_grids``: the map draw of a key from the TDM's own
    generator (seeded from ``cfg.seed``), one map in the det modes."""
    pmf = _pmf(np.random.RandomState(4), 6, 9, 12)
    tdm_dict = dict(res=0.5, xlimits=(0.0, 6.0), ylimits=(0.0, 4.5),
                    bin_values=np.linspace(0.0, 1.0, 6),
                    bin_values_bounds=(0.0, 1.0), det_dynamics_cvar_alpha=0.5)
    for flags, batch in ((dict(use_tdm=True), 5),
                         (dict(use_det_dynamics=True), 1)):
        cfg = tpkg.Config(T=1.0, dt=0.1, num_grid_samples=5, seed=7,
                          max_map_dim=(30, 30), **flags)
        tdm = tpkg.TDM(cfg, device="cpu")
        tdm.set_TDM_from_PMF_grid(pmf, tdm_dict)
        grids = tdm.sample_grids(alpha_dyn=0.5)
        H, W = tdm.get_padded_grid_xy_dim()
        assert grids.dtype == torch.int8 and grids.shape == (batch, H, W)
        assert tdm.sample_grid_batch is grids
        g = torch.Generator().manual_seed(7)
        key = draw_map_key(g, torch.device("cpu"))
        pmf_d, q = tdm.pmf_grid_device, tdm.qbin_values
        want = sample_traction_window_plain(
            key, pmf_d, pmf_d, q, q, torch.tensor(0.5), batch)[2]
        np.testing.assert_array_equal(grids.numpy(), want.numpy())
        # The next batch takes the generator's next key.
        second = tdm.sample_grids(alpha_dyn=0.5)
        want2 = sample_traction_window_plain(
            draw_map_key(g, torch.device("cpu")), pmf_d, pmf_d, q, q,
            torch.tensor(0.5), batch)[2]
        np.testing.assert_array_equal(second.numpy(), want2.numpy())
        assert set(np.unique(grids.numpy())) <= set(q.numpy().tolist())


def test_tdm_sample_grids_matches_jax_for_the_same_key():
    """With the TDM's key set to a JAX key's words, its batch is the JAX
    TDM's batch for that key, bit for bit."""
    pmf = _pmf(np.random.RandomState(8), 7, 10, 11)
    tdm_dict = dict(res=0.5, xlimits=(0.0, 5.5), ylimits=(0.0, 5.0),
                    bin_values=np.linspace(0.0, 1.0, 7),
                    bin_values_bounds=(0.0, 1.0), det_dynamics_cvar_alpha=1.0)
    cfg_kw = dict(T=1.0, dt=0.1, num_grid_samples=6, seed=2,
                  max_map_dim=(30, 30), use_tdm=True)
    jt = jpkg.TDM(jpkg.Config(**cfg_kw))
    jt.set_TDM_from_PMF_grid(pmf, tdm_dict)
    _, sub = jax.random.split(jt._rng_key)
    want = np.asarray(jt.sample_grids(alpha_dyn=0.7))
    tt = tpkg.TDM(tpkg.Config(**cfg_kw), device="cpu")
    tt.set_TDM_from_PMF_grid(pmf, tdm_dict)
    key = torch.tensor(np.asarray(jax.random.key_data(sub)).astype(np.int64))
    got = sample_traction_window_plain(
        key, tt.pmf_grid_device, tt.pmf_grid_device, tt.qbin_values,
        tt.qbin_values, torch.tensor(0.7, dtype=torch.float32),
        tt.batch_size)[2]
    np.testing.assert_array_equal(got.numpy(), want)


def test_shift_optimal_control_sequence_equal():
    u = np.random.RandomState(2).randn(20, 2).astype(np.float32)
    cfg_kw = dict(T=2.0, dt=0.1, use_tdm=True)
    jp = jpkg.MPPIPlanner(jpkg.Config(**cfg_kw))
    tp = tpkg.MPPIPlanner(tpkg.Config(**cfg_kw), device="cpu")
    for p in (jp, tp):
        p.shift_optimal_control_sequence(u, num_shifts=3)
    assert tp.u_cur.dtype == torch.float32
    np.testing.assert_array_equal(tp.u_cur.numpy(), np.asarray(jp.u_cur))
    np.testing.assert_array_equal(
        tp.u_cur.numpy(), np.concatenate([u[3:], u[-3:]]))


def test_trial_runs_the_port_planner_on_a_pmf_realization():
    """``sim.trial`` drives the port's planner (on the CPU here) over a
    ground truth drawn from its own PMF, with the crop on: the metrics are
    finite and the robot nears the goal."""
    pmf = _pmf(np.random.RandomState(10), 6, 36, 36)
    pmf[:, :, :] = 0
    pmf[4], pmf[5] = 30, 70
    bins = np.array([0.0, 0.2, 0.4, 0.6, 0.8, 1.0])
    res = 0.5
    tdm_dict = dict(res=res, xlimits=(0.0, 36 * res), ylimits=(0.0, 36 * res),
                    bin_values=bins, bin_values_bounds=(0.0, 1.0),
                    det_dynamics_cvar_alpha=1.0)
    cfg = tpkg.Config(T=1.5, dt=0.1, num_grid_samples=8,
                      num_control_rollouts=128, max_speed_padding=1.0,
                      max_map_dim=(40, 40), seed=0, use_tdm=True)
    lin, ang = (tpkg.TDM(cfg, device="cpu"), tpkg.TDM(cfg, device="cpu"))
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    params = dict(dt=0.1, x0=np.array([3.0, 3.0, 0.7]),
                  xgoal=np.array([9.0, 8.0]), goal_tolerance=0.5,
                  v_post_rollout=0.01, cvar_alpha=0.5, alpha_dyn=1.0,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([1.0, 1.0]), vrange=np.array([0.0, 1.5]),
                  wrange=np.array([-1.5, 1.5]))
    planner = tpkg.MPPIPlanner(cfg, device="cpu")
    planner.setup(params, lin, ang)
    assert planner._static().roi_shape is not None
    truth = tterrain.sample_realization_from_pmf_grid(
        pmf, pmf, bins, np.random.RandomState(0), res=res,
        xlimits=tdm_dict["xlimits"], ylimits=tdm_dict["ylimits"])
    out = tsim.trial(planner, truth, 0.1, 8, params, return_history=True)
    assert out["xhist"].shape == (9, 3) and np.isfinite(out["xhist"]).all()
    assert np.isfinite(out["cum_obj"])
    d0 = np.hypot(*(params["xgoal"] - params["x0"][:2]))
    assert np.hypot(*(params["xgoal"] - out["xhist"][-1, :2])) < d0
