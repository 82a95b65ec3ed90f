"""The port's fused map draw and pack (``map_sample.sample_and_pack_window``)
vs the JAX package, on the CPU.

With JAX's map key words injected, the port's sample-and-pack equals JAX's
``sample_traction_bins`` + ``decode_bins`` + the JAX solver's pack
(``mppi_numba_tpu/solver.py::make_rollout_backend``) bit for bit, in every
layout, with and without the risk plane, at an offset window, at an
``m_offset``, and with columns summing below 100 (ranks of B, decoded to
-128, and with 4 and 16 bins spilling into the ang field).  The kernel's
rank rule, an inverse-CDF table over ``sampled`` = 0..100 built per cell by
counting, is modelled here in numpy and held against the port's and JAX's
rank on int8 columns of any sign.  Whole solves through ``solve_from_key``
on each layout against JAX's interpret-mode solves close the slice.  The
kernel itself is held against these plain versions on a card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.ops import sampling as jsampling
from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu.solver import make_rollout_backend as j_make_backend
from mppi_numba_tpu.types import MapInputs as JMaps
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import to_port
from mppi_numba_tpu_torch.ops import sampling as tsampling
from mppi_numba_tpu_torch.ops.kernels import map_sample
from mppi_numba_tpu_torch.solver import get_terrain_solver
from mppi_numba_tpu_torch.types import MapInputs

# Port layout -> (JAX backend, PMF bins it serves): 4 and 16 bins put a
# rank of B (a draw past a column summing below 100) into the top bit of
# the 2- and 4-bit lin field, where it spills into the ang field.
LAYOUTS = {"byte": ("pallas", 12), "binned2": ("pallas_binned2", 4),
           "binned": ("pallas_binned", 16), "binned8": ("pallas_binned8", 22)}
H, W = 17, 19
KEY = jax.random.split(jax.random.PRNGKey(2024))[1]
RTOL, ATOL = 2e-4, 2e-5       # the JAX package's whole-solve tolerance


def _port_key(key):
    return torch.tensor(np.asarray(jax.random.key_data(key)).astype(np.int64))


def _pmf(rng, B, unnormalized):
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    raw[0] += 1.0
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    if unnormalized:                       # inside every window below
        pmf[:, 6, 5:11] = 0
        pmf[0, 6, 5:11] = (0, 10, 30, 50, 70, 90)
    return pmf


def _maps(B, unnormalized, seed):
    """A (H, W) world as numpy ``MapInputs``: lin and ang PMFs, their bin
    values, obstacle and unknown indicators and a risk plane."""
    rng = np.random.RandomState(seed)
    return JMaps(lin_pmf=_pmf(rng, B, unnormalized),
                 ang_pmf=_pmf(rng, B, unnormalized),
                 lin_qbins=np.sort(rng.choice(101, B, replace=False))
                 .astype(np.int8),
                 ang_qbins=np.sort(rng.choice(101, B, replace=False))
                 .astype(np.int8),
                 obstacle=(rng.rand(H, W) < 0.2).astype(np.int8),
                 unknown=(rng.rand(H, W) < 0.2).astype(np.int8),
                 risk=rng.randint(0, 101, (H, W)).astype(np.int8))


def _task():
    f32 = np.float32
    return JTask(
        x0=np.array([4.0, 3.0, 0.3], f32), xgoal=np.array([12.0, 9.0], f32),
        goal_tolerance=f32(0.5), v_post_rollout=f32(0.01),
        lambda_weight=f32(10.0), u_std=np.array([1.0, 1.5], f32),
        vrange=np.array([0.0, 2.0], f32), wrange=np.array([-3.0, 3.0], f32),
        dt=f32(0.1), dist_weight=f32(1.0), obs_penalty=f32(1e2),
        unknown_penalty=f32(1e2), alpha_dyn=f32(1.0), res=f32(1.0),
        xlim0=f32(0.0), ylim0=f32(0.0), lin_lb=f32(0.0), lin_ratio=f32(0.01),
        ang_lb=f32(0.0), ang_ratio=f32(0.01), cvar_alpha=f32(0.3))


def _jax_sample_and_pack(layout, maps, alpha, M, window, m_window,
                         speed_map, crop):
    """JAX's draw, decode and its solver's pack of the ``crop`` window."""
    rH, rW = maps.obstacle[crop[1:]].shape
    bins = [jsampling.sample_traction_bins(
        KEY, jnp.asarray(pmf[crop]), jnp.float32(alpha), M, window=window,
        m_window=m_window) for pmf in (maps.lin_pmf, maps.ang_pmf)]
    grids = [jsampling.decode_bins(jnp.asarray(q), b)
             for q, b in zip((maps.lin_qbins, maps.ang_qbins), bins)]
    j_backend, B = LAYOUTS[layout]
    static = JStatic(mode="speed_map" if speed_map else "tdm", num_steps=4,
                     num_control_rollouts=8, num_grid_samples=M,
                     map_shape=(rH, rW), num_obstacles=0, cvar_numel=1,
                     num_opt=1, num_vis_state_rollouts=1, num_pmf_bins=B,
                     backend=j_backend)
    _, pack, _ = j_make_backend(static)
    jmaps = JMaps(*(jnp.asarray(a[crop[1:]] if a.ndim == 2 else
                                a[crop] if a.ndim == 3 else a)
                    for a in maps))
    jtask = JTask(*(jnp.asarray(x) for x in _task()))
    payload = pack(*bins, *grids, jmaps, jtask)
    if layout != "byte":              # (cells, mask, lut, risk): no LUT
        payload = (payload[0], payload[1], payload[3])
    return payload, grids, bins


def _assert_payload_equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_payload_equal(g, w)
        return
    if want is None:
        assert got is None
        return
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["full", "window_m_offset", "unnormalized"])
@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sample_and_pack_matches_jax(layout, speed_map, case):
    B = LAYOUTS[layout][1]
    maps = _maps(B, case == "unnormalized", seed=B + 7 * speed_map)
    M, full_m = 6, 9
    windowed = case == "window_m_offset"
    oy, ox, rH, rW = (3, 2, 11, 13) if windowed else (0, 0, H, W)
    m_offset = 3 if windowed else 0
    alpha = 0.2 if windowed else 1.0
    crop = (slice(None), slice(oy, oy + rH), slice(ox, ox + rW))
    want, grids, bins = _jax_sample_and_pack(
        layout, maps, alpha, M,
        ((H, W), jnp.int32(oy), jnp.int32(ox)) if windowed else None,
        (full_m, m_offset) if windowed else None, speed_map, crop)

    t_maps = MapInputs(*(torch.tensor(np.ascontiguousarray(
        a[crop[1:]] if a.ndim == 2 else a[crop] if a.ndim == 3 else a))
        for a in maps))
    before = map_sample.sample_and_pack_window.launches
    payload, lin_grids, ang_grids = map_sample.sample_and_pack_window(
        _port_key(KEY), t_maps, torch.tensor(alpha, dtype=torch.float32), M,
        layout,
        window=(((H, W), torch.tensor(oy, dtype=torch.int32),
                 torch.tensor(ox, dtype=torch.int32)) if windowed else None),
        risk=speed_map, m_offset=m_offset,
        full_num_samples=full_m if windowed else None)
    assert map_sample.sample_and_pack_window.launches == before   # CPU: plain
    for got, w in ((lin_grids, grids[0]), (ang_grids, grids[1])):
        assert got.dtype == torch.int8 and got.shape == (M, rH, rW)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    _assert_payload_equal(payload, want)
    if case == "unnormalized":
        assert (lin_grids == -128).any()            # past the last bin
        assert (np.asarray(bins[0]) == B).any()     # rank B: the spill
    if speed_map and layout != "byte":
        assert payload[2] is not None


# Robot positions (x, y) on the 17x19 map at res 0.5 (8.5 x 9.5 m from
# the padded origin) for the crop mode: near each edge, off a corner, at
# the centre, and on a cell edge.
CROP_AT = {"west": (0.2, 4.0), "east": (9.4, 4.3), "south": (4.1, 0.1),
           "north": (4.6, 8.4), "off_corner": (-3.0, 11.0),
           "centre": (4.75, 4.25), "cell_edge": (5.0, 3.5)}


@pytest.mark.parametrize("where", sorted(CROP_AT))
@pytest.mark.parametrize("origin", [0.0, -0.5])
@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_crop_mode_plain_matches_crop_then_sample_and_pack(layout, speed_map,
                                                           origin, where):
    """``sample_and_pack_crop`` on CPU tensors (the kernel's crop mode's
    plain version) equals ``roi.crop_window_plain`` followed by
    ``sample_and_pack_window_plain`` at the window, bit for bit: payload,
    grids, offset and shifted limits; and its payload and grids are JAX's
    draw and pack of JAX's window (``_roi_start``)."""
    from mppi_numba_tpu.solver import _roi_start as j_roi_start
    from mppi_numba_tpu_torch.ops.roi import crop_window_plain

    B = LAYOUTS[layout][1]
    maps = _maps(B, False, seed=100 + B)
    M, (rH, rW) = 5, (9, 7)
    f32 = np.float32
    jtask = _task()._replace(
        x0=np.array([*CROP_AT[where], 0.2], f32), res=f32(0.5),
        xlim0=f32(origin), ylim0=f32(origin))
    t_maps, t_task, _ = to_port(maps, jtask, None, "cpu")
    key = _port_key(KEY)
    before = map_sample.sample_and_pack_crop.launches
    payload, lin_grids, ang_grids, c_task, offset = (
        map_sample.sample_and_pack_crop(key, t_maps, t_task, M, layout,
                                        (rH, rW), risk=speed_map))
    assert map_sample.sample_and_pack_crop.launches == before   # CPU: plain
    w_maps, w_task, w_offset = crop_window_plain(t_maps, t_task, (H, W),
                                                 (rH, rW))
    w_payload, w_lin, w_ang = map_sample.sample_and_pack_window_plain(
        key, w_maps, t_task.alpha_dyn, M, layout,
        window=((H, W), w_offset[0], w_offset[1]), risk=speed_map)
    assert offset.dtype == torch.int32 and torch.equal(offset, w_offset)
    for name in ("xlim0", "ylim0"):
        assert torch.equal(getattr(c_task, name), getattr(w_task, name))
    assert torch.equal(lin_grids, w_lin) and torch.equal(ang_grids, w_ang)
    _assert_payload_equal(payload, tuple(w_payload) if layout != "byte"
                          else w_payload)

    oy, ox = (int(v) for v in j_roi_start(jtask, (H, W), (rH, rW)))
    assert offset.tolist() == [oy, ox]
    crop = (slice(None), slice(oy, oy + rH), slice(ox, ox + rW))
    want, grids, _ = _jax_sample_and_pack(
        layout, maps, 1.0, M, ((H, W), jnp.int32(oy), jnp.int32(ox)), None,
        speed_map, crop)
    np.testing.assert_array_equal(lin_grids.numpy(), np.asarray(grids[0]))
    np.testing.assert_array_equal(ang_grids.numpy(), np.asarray(grids[1]))
    _assert_payload_equal(payload, want)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sample_and_pack_without_ang_plane(layout):
    """With no ang plane the payload's ang fields are 0: JAX's pack of the
    lin draw beside zero ang bins and grids."""
    B = LAYOUTS[layout][1]
    maps = _maps(B, True, seed=50 + B)
    M = 5
    crop = (slice(None), slice(0, H), slice(0, W))
    want_bins = jsampling.sample_traction_bins(
        KEY, jnp.asarray(maps.lin_pmf), jnp.float32(1.0), M)
    want_grids = jsampling.decode_bins(jnp.asarray(maps.lin_qbins), want_bins)
    zeros = jnp.zeros_like(want_bins)
    static = JStatic(mode="tdm", num_steps=4, num_control_rollouts=8,
                     num_grid_samples=M, map_shape=(H, W), num_obstacles=0,
                     cvar_numel=1, num_opt=1, num_vis_state_rollouts=1,
                     num_pmf_bins=B, backend=LAYOUTS[layout][0])
    _, pack, _ = j_make_backend(static)
    want = pack(want_bins, zeros, want_grids, zeros.astype(jnp.int8),
                JMaps(*(jnp.asarray(a[crop[1:]] if a.ndim == 2 else a)
                        for a in maps)),
                JTask(*(jnp.asarray(x) for x in _task())))
    if layout != "byte":
        want = (want[0], want[1], want[3])
    t_maps = MapInputs(*(torch.tensor(a) for a in maps))._replace(
        ang_pmf=None, ang_qbins=None)
    payload, lin_grids, ang_grids = map_sample.sample_and_pack_window(
        _port_key(KEY), t_maps, torch.tensor(1.0), M, layout)
    assert ang_grids is None
    np.testing.assert_array_equal(lin_grids.numpy(), np.asarray(want_grids))
    _assert_payload_equal(payload, want)


def _table_model(pmf):
    """The kernel's inverse-CDF table, in numpy: per cell, count each
    ``cum_b + 1`` (clamped below at 0) into a histogram over s = 0..100
    and take its prefix sum: ``rank[s] = #{b : cum_b < s}``.
    Returns int ``(101, cells)``."""
    B = pmf.shape[0]
    cum = np.cumsum(pmf.reshape(B, -1).astype(np.int32), axis=0)
    hist = np.zeros((101, cum.shape[1]), np.int64)
    for b in range(B):
        v = np.maximum(cum[b] + 1, 0)
        cols = np.nonzero(v <= 100)[0]
        np.add.at(hist, (v[cols], cols), 1)
    return np.cumsum(hist, axis=0)


@pytest.mark.parametrize("B", [1, 2, 4, 16, 22, 32])
def test_rank_table_rule_equals_traction_bins(B):
    """For every s in 0..100, on random int8 columns of any sign (and
    normalized ones, and columns summing below 100), the table rule gives
    the rank the port's ``traction_bins_from_uniforms`` and JAX's count
    ``sum_b(cum_b < s)`` give."""
    rng = np.random.RandomState(B)
    cells = 60
    pmf = rng.randint(-128, 128, size=(B, 1, cells)).astype(np.int8)
    raw = rng.randint(0, 100, size=(B, 1, 20)).astype(float) + 1.0
    normal = (raw / raw.sum(0) * 100).astype(np.int8)
    normal[-1] = 100 - normal[:-1].sum(0)
    pmf[:, :, :20] = normal
    pmf[:, :, 20:30] = 0
    pmf[0, :, 20:30] = np.arange(0, 100, 10)
    s = np.arange(101)
    # u whose ceil(100 u) in float32 is s: (s - 0.5) / 100, and 0 at s = 0.
    u = np.where(s > 0, (s - 0.5) / 100, 0.0).astype(np.float32)
    sampled = np.ceil(u * np.float32(100.0)).astype(np.int32)
    np.testing.assert_array_equal(sampled, s)
    got = tsampling.traction_bins_from_uniforms(
        torch.tensor(np.repeat(u[:, None], cells, axis=1)), torch.tensor(pmf),
        torch.tensor(1.0, dtype=torch.float32)).numpy().reshape(101, cells)
    cum = np.cumsum(pmf.reshape(B, cells).astype(np.int32), axis=0)
    count = (cum[None] < s[:, None, None]).sum(axis=1)
    table = _table_model(pmf)
    np.testing.assert_array_equal(table, count)
    np.testing.assert_array_equal(got, count)
    assert table.max() <= B


@pytest.mark.parametrize("alpha_dyn", [1.0, 0.2])
def test_traction_bins_any_int8_column_match_jax(alpha_dyn):
    """Columns with negative entries (a cumulative that falls) rank as
    JAX's count does, bit for bit."""
    rng = np.random.RandomState(9)
    pmf = rng.randint(-128, 128, size=(12, 7, 9)).astype(np.int8)
    M = 16
    want = np.asarray(jsampling.sample_traction_bins(
        KEY, jnp.asarray(pmf), jnp.float32(alpha_dyn), M))
    u = np.asarray(jax.random.uniform(KEY, (M, 7 * 9), dtype=jnp.float32))
    got = tsampling.traction_bins_from_uniforms(
        torch.tensor(u), torch.tensor(pmf),
        torch.tensor(alpha_dyn, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["tdm", "speed_map"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_solve_from_key_matches_jax(layout, mode):
    """The whole solve through the fused entry: the port's
    ``solve_from_key`` fed JAX's map key words and normals, against JAX's
    interpret-mode solve: the grids exact, u, costs and weights within the
    whole-solve tolerance."""
    j_backend, B = LAYOUTS[layout]
    maps = _maps(B, mode == "tdm", seed=70 + B)
    task = _task()
    M = 6 if mode == "tdm" else 1
    K, T = 64, 8
    static = JStatic(mode=mode, num_steps=T, num_control_rollouts=K,
                     num_grid_samples=M, map_shape=(H, W), num_obstacles=0,
                     cvar_numel=2 if M > 1 else 1, num_opt=2,
                     num_vis_state_rollouts=2, num_pmf_bins=B,
                     backend=j_backend + "_interpret")
    key = jax.random.PRNGKey(40 + B)
    u0 = np.zeros((T, 2), np.float32)
    j_u, j_aux = j_get_solver(static)(
        key, JMaps(*(jnp.asarray(x) for x in maps)),
        JTask(*(jnp.asarray(x) for x in task)), jnp.asarray(u0))

    kmap, knoise = jax.random.split(key)
    eps = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(knoise, i), (K, T, 2), dtype=jnp.float32)))
        for i in range(static.num_opt)]
    fields = dataclasses.asdict(static)
    fields["backend"] = layout
    solver = get_terrain_solver(SolverStatic(**fields), "cpu")
    assert solver.backend == layout
    t_maps, t_task, t_u0 = to_port(maps, task, u0, "cpu")
    u, aux = solver.solve_from_key(_port_key(kmap), eps, t_maps, t_task, t_u0)
    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    np.testing.assert_array_equal(aux.ang_grids.numpy(),
                                  np.asarray(j_aux.ang_grids))
    for name, got, want in (("u", u, j_u), ("costs", aux.costs, j_aux.costs),
                            ("weights", aux.weights, j_aux.weights)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
