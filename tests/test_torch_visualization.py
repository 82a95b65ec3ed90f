"""The port's plotting modules (``visualization``, ``benchmark_vis``) on
the Agg backend, against the JAX package's on the same worlds, and its
angle helpers (``utils.angles``) against JAX's bit for bit."""

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mppi_numba_tpu as jpkg  # noqa: E402
import mppi_numba_tpu_torch as tpkg  # noqa: E402
from mppi_numba_tpu import benchmark_vis as jvis_b  # noqa: E402
from mppi_numba_tpu import visualization as jvis  # noqa: E402
from mppi_numba_tpu.utils import angles as jangles  # noqa: E402
from mppi_numba_tpu_torch import benchmark_vis as tvis_b  # noqa: E402
from mppi_numba_tpu_torch import visualization as tvis  # noqa: E402
from mppi_numba_tpu_torch.utils import angles as tangles  # noqa: E402


def _tdms(mode="tdm"):
    """The same semantic world as a JAX TDM and a port TDM (the benchmark
    world's terrains, a 6x5 grid, padded)."""
    out = []
    for pkg, extra in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        rng = np.random.RandomState(0)
        world = pkg.make_benchmark_world(num_bins=10, rng=rng)
        sg = rng.randint(0, 2, size=(6, 5))
        cfg = pkg.Config(T=2.0, dt=0.1, num_grid_samples=16,
                         num_control_rollouts=128, max_speed_padding=2.0,
                         max_map_dim=(30, 30), seed=0,
                         use_tdm=mode == "tdm",
                         use_det_dynamics=mode == "det")
        tdm = pkg.TDM(cfg, **extra)
        tdm.set_TDM_from_semantic_grid(
            sg, 1.0, world["num_pmf_bins"], world["bin_values"],
            world["bin_values_bounds"], (0.0, 5.0), (0.0, 6.0),
            world["id2name"], world["name2terrain"],
            world["lin_terrain2pmf"],
            det_dynamics_cvar_alpha=None if mode == "tdm" else 0.4)
        out.append(tdm)
    return out


@pytest.mark.parametrize("mode", ["tdm", "det"])
def test_tdm_visualizer_draw_matches_jax(mode):
    jtdm, ttdm = _tdms(mode)
    vis = tvis.TDMVisualizer(ttdm)
    fig, ax = vis.draw(figsize=(4, 4))
    jv = jvis.TDMVisualizer(jtdm)
    assert vis.semantic_grid.shape == ttdm.get_padded_grid_xy_dim()
    assert (vis.semantic_grid[0, :] == -1).all()      # the padding ring
    np.testing.assert_array_equal(vis.semantic_grid, jv.semantic_grid)
    assert vis.id2name == jv.id2name
    np.testing.assert_array_equal(vis.xlimits, jv.xlimits)
    np.testing.assert_array_equal(vis.ylimits, jv.ylimits)
    np.testing.assert_array_equal(
        vis.calc_auto_figsize(vis.xlimits, vis.ylimits),
        jv.calc_auto_figsize(jv.xlimits, jv.ylimits))
    assert len(ax.collections) == 2           # the grid lines, the cells
    assert tvis.TDM_Visualizer is tvis.TDMVisualizer
    plt.close(fig)


def test_tdm_visualizer_without_semantic_grid():
    """A PMF-grid TDM has no semantic grid: ``draw`` needs one given."""
    cfg = tpkg.Config(T=1.0, dt=0.1, num_grid_samples=4,
                      num_control_rollouts=100, use_tdm=True)
    tdm = tpkg.TDM(cfg, device="cpu")
    pmf = np.zeros((3, 4, 4), np.int8)
    pmf[2] = 100
    tdm.set_TDM_from_PMF_grid(pmf, dict(
        res=1.0, xlimits=(0.0, 4.0), ylimits=(0.0, 4.0),
        bin_values=[0.0, 0.5, 1.0], bin_values_bounds=(0.0, 1.0),
        det_dynamics_cvar_alpha=1.0))
    vis = tvis.TDMVisualizer(tdm)
    assert vis.draw() is None
    fig, _ = vis.draw(figsize=(3, 3), semantic_grid=np.zeros((4, 4), int),
                      id2rgb_map={0: (1, 0, 0)})
    plt.close(fig)


def test_density_plots():
    gm = tpkg.GaussianMixture([0, 1.0], [0, 1.0], [1.0], [0.5], [0.1],
                              num_samples=1e3)
    t = tpkg.Terrain("t", (0, 1, 0), gm, gm)
    fig, ax = plt.subplots()
    tvis.vis_density(ax, gm, t, show_cvar=True, title="t")
    fig2, ax2 = plt.subplots()
    tvis.vis_density_as_pmf(ax2, gm, t, num_bins=10, title="t")
    values, pmf = gm.get_pmf(num_bins=10)
    np.testing.assert_allclose(ax2.containers[0].markerline.get_ydata(), pmf)
    plt.close(fig)
    plt.close(fig2)


def test_render_episode_gif(tmp_path):
    """The reference-styled episode animation: one frame per capture, and
    the legend's +-1e6 dummy markers never autoscale the axes."""
    from PIL import Image

    rng = np.random.RandomState(0)
    frames = []
    for t in range(1, 4):
        xhist = np.cumsum(rng.rand(t + 1, 3), axis=0)
        rollouts = np.cumsum(rng.rand(5, 6, 3), axis=1)
        frames.append((xhist, rollouts))
    fig, ax = plt.subplots(figsize=(3, 3))
    ax.set_xlim(0, 10)
    ax.set_ylim(0, 10)
    out = tvis.render_episode_gif(fig, ax, frames, np.array([1.0, 1.0, 0.0]),
                                  np.array([8.0, 8.0]), 0.5, 0.1,
                                  str(tmp_path / "ep.gif"), caption="env")
    im = Image.open(out)
    n = 0
    try:
        while True:
            im.seek(n)
            n += 1
    except EOFError:
        pass
    assert n == len(frames)
    assert ax.get_xlim() == (0.0, 10.0)


def _results_frame():
    rng = np.random.RandomState(0)
    rows = []
    for method in ("noisy_dyn", "risk_dyn", "baseline"):
        for alpha in (0.5, 1.0):
            for density in (0.4, 1.0):
                for _ in range(5):
                    ok = bool(rng.rand() < 0.8)
                    rows.append(dict(method=method, alpha=alpha, success=ok,
                                     time_to_goal=(rng.rand() * 10 if ok
                                                   else np.nan),
                                     grass_density=density))
    return pd.DataFrame(rows)


def test_benchmark_vis_matches_jax():
    """The paper figure renders, and its numbers (success rates and the
    time-to-goal groups by alpha) equal the JAX package's."""
    df = _results_frame()
    alphas = [0.5, 1.0]
    fig, axes = tvis_b.plot_joint_success_and_time(
        df, alphas, method_list=["noisy_dyn", "risk_dyn", "baseline"])
    assert len(axes) == 2
    plt.close(fig)
    for method in ("noisy_dyn", "risk_dyn", "baseline"):
        for density in (None, 0.4):
            assert tvis_b.success_rate_by_alpha(df, method, alphas, density) \
                == jvis_b.success_rate_by_alpha(df, method, alphas, density)
            for got, want in zip(
                    tvis_b.collect_metric_by_alpha(df, "time_to_goal", method,
                                                   alphas, density),
                    jvis_b.collect_metric_by_alpha(df, "time_to_goal", method,
                                                   alphas, density)):
                np.testing.assert_array_equal(got, want)
    ax = tvis_b.make_boxplot(
        {m: tvis_b.collect_metric_by_alpha(df, "time_to_goal", m, alphas)
         for m in ("noisy_dyn", "risk_dyn")}, ["0.5", "1.0"],
        ["noisy_dyn", "risk_dyn"], tvis_b.METHOD2RGB)
    plt.close(ax.figure)
    assert tvis_b.METHOD2LABEL == jvis_b.METHOD2LABEL


ANGLES = np.concatenate([
    np.linspace(-20.0, 20.0, 4001), [0.0, np.pi, -np.pi, 2 * np.pi,
                                     -2 * np.pi, 3 * np.pi, 1e4, -1e4]])


def test_angles_match_jax_bitwise():
    for th in (0.3, -4.0, np.pi, 7.5, -np.pi, 0.0):
        assert tangles.normalize_angle(th) == jangles.normalize_angle(th)
    np.testing.assert_array_equal(tangles.normalize_angle_np(ANGLES),
                                  jangles.normalize_angle_np(ANGLES))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float32)):
        x = ANGLES.astype(np.float32)
        got = tangles.normalize_angle_torch(torch.tensor(x, dtype=dtype))
        want = jangles.normalize_angle_jnp(jnp.asarray(x, jdtype))
        if dtype == torch.float32:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = tangles.normalize_angle_torch(torch.tensor(ANGLES))
    assert bool(((out > -np.pi) & (out <= np.pi)).all())
    from mppi_numba_tpu_torch import utils
    assert utils.normalize_angle is tangles.normalize_angle
