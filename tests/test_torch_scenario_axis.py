"""The scenario axis: B scenarios (a batch of episodes) in one call of the
map draw, the rollouts and the whole solve, on the CPU.

Each batched plain version equals its B single-scenario calls bit for bit
(the kernels are held to the same on a card, ``tests/test_torch_kernels_gpu
.py``), the batched map draw equals JAX's draw under ``jax.vmap``, and the
batched solve (``TerrainSolver.solve_from_key`` with a leading axis) equals
``jax.vmap`` of the JAX package's solve within the whole-solve tolerance,
JAX's keys and noise injected (lambda 10, as the CPU solve tests use).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.ops import sampling as jsampling
from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu.types import MapInputs as JMaps
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import to_port
from mppi_numba_tpu_torch.ops import packing
from mppi_numba_tpu_torch.ops.cvar import (cvar_from_costs,
                                           cvar_from_costs_dynamic)
from mppi_numba_tpu_torch.ops.kernels import (map_sample, rollout_binned,
                                              rollout_byte)
from mppi_numba_tpu_torch.ops.rollout import (_clipped_controls_tk,
                                              control_coupling)
from mppi_numba_tpu_torch.ops.sampling import decode_bins
from mppi_numba_tpu_torch.ops.update import update_useq
from mppi_numba_tpu_torch.solver import get_terrain_solver
from mppi_numba_tpu_torch.types import scenario

B = 3                          # scenarios
H, W = 13, 15
K, M, T = 64, 8, 12
RTOL, ATOL = 2e-4, 2e-5        # the JAX package's whole-solve tolerance
LAYOUTS = ("byte", "binned2", "binned", "binned8")



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The closed loops here step small tensors, where torch's intra-op
    threads cost more than they save on a busy host: one thread for each
    test, the setting put back after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _stack(parts):
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    if hasattr(first, "_replace"):
        return type(first)(*(_stack(list(f)) for f in zip(*parts)))
    if isinstance(first, tuple):
        return tuple(_stack(list(f)) for f in zip(*parts))
    return first


def _same(got, want):
    """Equal bit for bit through tuples (None matching None)."""
    if isinstance(got, tuple):
        assert isinstance(want, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == want.dtype and torch.equal(got, want)


def _world(seed, bins, unnormalized=False):
    """Numpy ``MapInputs`` and ``TerrainTask`` of one scenario."""
    rng = np.random.RandomState(seed)

    def pmf():
        raw = rng.randint(1, 100, size=(bins, H, W)).astype(float)
        p = (raw / raw.sum(0) * 100).astype(np.int8)
        p[-1] = 100 - p[:-1].sum(0)
        if unnormalized:
            p[:, 2, 3:7] = 0
            p[0, 2, 3:7] = (10, 30, 50, 70)
        return p

    maps = JMaps(pmf(), pmf(),
                 np.sort(rng.choice(101, bins, replace=False)).astype(np.int8),
                 np.sort(rng.choice(101, bins, replace=False)).astype(np.int8),
                 (rng.rand(H, W) < 0.15).astype(np.int8),
                 (rng.rand(H, W) < 0.15).astype(np.int8),
                 rng.randint(0, 101, (H, W)).astype(np.int8))
    f32 = np.float32
    task = JTask(
        x0=np.array([3.0 + seed, 2.5 + 0.5 * seed, 0.4], f32),
        xgoal=np.array([11.0 - seed, 10.0], f32), goal_tolerance=f32(0.5),
        v_post_rollout=f32(0.05), lambda_weight=f32(10.0),
        u_std=np.array([1.0 + 0.2 * seed, 1.5], f32),
        vrange=np.array([0.0, 2.0], f32), wrange=np.array([-3.0, 3.0], f32),
        dt=f32(0.1), dist_weight=f32(1.0), obs_penalty=f32(1e2),
        unknown_penalty=f32(1e2), alpha_dyn=f32((1.0, 0.3, 0.7)[seed % 3]),
        res=f32(1.0), xlim0=f32(0.0), ylim0=f32(-0.5 * seed),
        lin_lb=f32(0.0), lin_ratio=f32(0.01), ang_lb=f32(0.05 * seed),
        ang_ratio=f32(0.01), cvar_alpha=f32((0.5, 0.25, 1.0)[seed % 3]))
    return maps, task


def _keys(seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), B)
    return ks, torch.tensor(np.asarray(jax.random.key_data(ks))
                            .astype(np.int64))


def _batched_worlds(bins, unnormalized=False):
    worlds = [_world(s, bins, unnormalized) for s in range(B)]
    jmaps = jax.tree.map(lambda *xs: np.stack(xs), *(w[0] for w in worlds))
    jtask = jax.tree.map(lambda *xs: np.stack(xs), *(w[1] for w in worlds))
    tmaps, ttask, _ = to_port(jmaps, jtask, None, "cpu")
    return worlds, jmaps, jtask, tmaps, ttask


@pytest.mark.parametrize("risk", [False, True])
@pytest.mark.parametrize("layout", ("bins",) + LAYOUTS)
def test_map_sample_scenarios_equal_singles_and_jax_vmap(layout, risk):
    """The batched plain draw (window mode, each scenario its own key,
    alpha_dyn, window offset and maps; columns summing below 100) equals
    the B single calls bit for bit, and its bins JAX's draw under
    ``jax.vmap``."""
    bins = 4 if layout == "binned2" else 12
    worlds, jmaps, jtask, tmaps, ttask = _batched_worlds(bins, True)
    jkeys, keys = _keys(11)
    rH, rW, full = 9, 10, (H + 4, W + 3)
    oy = torch.tensor([0, 2, 4], dtype=torch.int32)
    ox = torch.tensor([3, 0, 1], dtype=torch.int32)
    crop = [type(tmaps)(*(t[b] if t.dim() == 2 else
                          t[b][..., int(oy[b]):int(oy[b]) + rH,
                               int(ox[b]):int(ox[b]) + rW]
                          for t in tmaps)) for b in range(B)]
    maps = _stack(crop)
    alpha = ttask.alpha_dyn
    if layout == "bins":
        got = map_sample.sample_traction_window(
            keys, maps.lin_pmf, maps.ang_pmf, maps.lin_qbins,
            maps.ang_qbins, alpha, M, window=(full, oy, ox))
        singles = [map_sample.sample_traction_window(
            keys[b], crop[b].lin_pmf, crop[b].ang_pmf, crop[b].lin_qbins,
            crop[b].ang_qbins, alpha[b], M, window=(full, oy[b], ox[b]))
            for b in range(B)]

        def jdraw(key, pmf, a, y, x):
            return jsampling.sample_traction_bins(key, pmf, a, M,
                                                  window=(full, y, x))

        want_bins = jax.vmap(jdraw)(jkeys, jnp.asarray(maps.lin_pmf.numpy()),
                                    jnp.asarray(alpha.numpy()),
                                    jnp.asarray(oy.numpy()),
                                    jnp.asarray(ox.numpy()))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_bins))
    else:
        got = map_sample.sample_and_pack_window(
            keys, maps, alpha, M, layout, window=(full, oy, ox), risk=risk)
        singles = [map_sample.sample_and_pack_window(
            keys[b], crop[b], alpha[b], M, layout,
            window=(full, oy[b], ox[b]), risk=risk) for b in range(B)]
    _same(got, _stack(singles))


@pytest.mark.parametrize("risk", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_map_sample_crop_scenarios_equal_singles(layout, risk):
    """The batched plain crop mode (each scenario its own robot, limits,
    key and maps) equals the B single calls bit for bit: payload, grids,
    the shifted limits and the offsets."""
    bins = 4 if layout == "binned2" else 12
    worlds, jmaps, jtask, tmaps, ttask = _batched_worlds(bins)
    ttask = ttask._replace(x0=torch.tensor([[1.0, 1.0, 0.0], [7.3, 6.2, 0.1],
                                            [14.0, 12.5, 0.2]]))
    _, keys = _keys(12)
    got = map_sample.sample_and_pack_crop(keys, tmaps, ttask, M, layout,
                                          (5, 7), risk=risk)
    singles = [map_sample.sample_and_pack_crop(
        keys[b], scenario(tmaps, b), scenario(ttask, b), M, layout, (5, 7),
        risk=risk) for b in range(B)]
    want = _stack(singles)
    _same(got[:3], want[:3])
    _same((got[3].xlim0, got[3].ylim0, got[4]),
          (want[3].xlim0, want[3].ylim0, want[4]))
    assert len({tuple(o) for o in got[4].tolist()}) == B


def _rollout_parts(layout, seed, speed_map):
    """One scenario's rollout arguments in ``layout``."""
    maps, task = _world(seed, 4 if layout == "binned2" else 12)
    t_maps, t_task, _ = to_port(maps, task, None, "cpu")
    g = torch.Generator().manual_seed(seed)
    lin_b, ang_b = (torch.randint(0, maps.lin_pmf.shape[0], (M, H, W),
                                  generator=g, dtype=torch.int32)
                    for _ in range(2))
    lin_g = decode_bins(t_maps.lin_qbins, lin_b)
    ang_g = decode_bins(t_maps.ang_qbins, ang_b)
    payload = packing.pack_payload(layout, lin_b, ang_b, lin_g, ang_g,
                                   t_maps, risk=speed_map)
    u = torch.rand((T, 2), generator=g) * 2 - 0.5
    noise = torch.randn((K, T, 2), generator=g) * t_task.u_std
    v, w = _clipped_controls_tk(u, noise, t_task.vrange, t_task.wrange)
    tv = rollout_byte.build_task_vec(t_task)
    if layout == "byte":
        return (payload, tv, v.contiguous(), w.contiguous())
    cells, mask, riskw = payload
    lut = (None if layout == "binned8" else
           rollout_binned.build_bin_luts(t_task, t_maps.lin_qbins,
                                         t_maps.ang_qbins))
    return (cells, mask, lut, tv, v.contiguous(), w.contiguous(), riskw)


@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("fast_trig", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_rollout_plain_scenarios_equal_singles(layout, fast_trig, speed_map):
    parts = [_rollout_parts(layout, s, speed_map) for s in range(B)]
    if layout == "byte":
        fn = rollout_byte.terrain_rollout_costs_byte
        kw = dict(H=H, W=W, T=T, speed_map=speed_map, fast_trig=fast_trig)
    else:
        fn = rollout_binned.terrain_rollout_costs_binned
        kw = dict(H=H, W=W, T=T, fast_trig=fast_trig,
                  cell_bits={"binned2": 2, "binned": 4,
                                         "binned8": 8}[layout])
    got = fn(*_stack(parts), **kw)
    assert got.shape == (B, K, M)
    assert torch.equal(got, torch.stack([fn(*p, **kw) for p in parts]))


SKIP_MASKS = {"none": (False, False, False), "one": (False, True, False),
              "all": (True, True, True)}


def _rollout_fn(layout, fast_trig, speed_map):
    if layout == "byte":
        return (rollout_byte.terrain_rollout_costs_byte,
                dict(H=H, W=W, T=T, speed_map=speed_map, fast_trig=fast_trig))
    return (rollout_binned.terrain_rollout_costs_binned,
            dict(H=H, W=W, T=T, fast_trig=fast_trig,
                 cell_bits={"binned2": 2, "binned": 4, "binned8": 8}[layout]))


@pytest.mark.parametrize("mask", sorted(SKIP_MASKS))
@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_rollout_plain_skip_mask_zeroes_only_its_scenarios(layout, speed_map,
                                                           mask):
    """The plain versions with a skip mask: the unmarked scenarios' costs
    are the unmasked call's bit for bit, the marked ones' zeros; a single
    scenario takes a 0-d mask."""
    parts = [_rollout_parts(layout, s, speed_map) for s in range(B)]
    fn, kw = _rollout_fn(layout, True, speed_map)
    args = _stack(parts)
    skip = torch.tensor(SKIP_MASKS[mask])
    full = fn(*args, **kw)
    got = fn(*args, skip=skip, **kw)
    assert torch.equal(got[~skip], full[~skip])
    assert not got[skip].any() and bool(full.all())
    for b in range(B):
        assert torch.equal(fn(*parts[b], skip=skip[b], **kw), got[b])


@pytest.mark.parametrize("mask", sorted(SKIP_MASKS))
def test_eager_rollout_skip_mask_zeroes_only_its_scenarios(mask):
    """``ops/rollout.py::terrain_rollout_costs`` (the eager backend, one
    scenario a call) with the skip mask, through the solver's rollout:
    the unmarked scenarios' costs bit for bit, the marked ones' zeros."""
    from mppi_numba_tpu_torch.solver import make_rollout_backend

    static = SolverStatic(mode="tdm", backend="eager", num_steps=T,
                          num_control_rollouts=K, num_grid_samples=M,
                          map_shape=(H, W), num_obstacles=0, num_opt=1,
                          num_vis_state_rollouts=1, cvar_numel=M // 2)
    _, _, _, rollout = make_rollout_backend(static, "cpu")
    _, _, _, tmaps, ttask = _batched_worlds(12)
    g = torch.Generator().manual_seed(9)
    words = torch.stack([packing.pack_map_words(
        *(torch.randint(0, 101, (M, H, W), generator=g, dtype=torch.int8)
          for _ in range(2)), tmaps.obstacle[b], tmaps.unknown[b], None)
        for b in range(B)])
    u = torch.rand((B, T, 2), generator=g) * 2 - 0.5
    noise = torch.randn((B, K, T, 2), generator=g)
    skip = torch.tensor(SKIP_MASKS[mask])
    full = rollout(words, ttask, u, noise)
    got = rollout(words, ttask, u, noise, skip)
    assert torch.equal(got[~skip], full[~skip])
    assert not got[skip].any() and bool(full.all())


def test_task_vectors_luts_and_reductions_are_per_scenario():
    """The batched task vector and LUTs are the single ones stacked, bit
    for bit; the CVaR, the coupling and the update reduce each scenario
    over its own axes, as their single calls do."""
    _, _, _, tmaps, ttask = _batched_worlds(12)
    tv = rollout_byte.build_task_vec(ttask)
    lut = rollout_binned.build_bin_luts(ttask, tmaps.lin_qbins,
                                        tmaps.ang_qbins)
    assert tv.shape == (B, 19) and lut.shape == (B, 2, 16)
    for b in range(B):
        tb_ = scenario(ttask, b)
        assert torch.equal(tv[b], rollout_byte.build_task_vec(tb_))
        assert torch.equal(lut[b], rollout_binned.build_bin_luts(
            tb_, tmaps.lin_qbins[b], tmaps.ang_qbins[b]))
    g = torch.Generator().manual_seed(0)
    costs = torch.rand((B, K, M), generator=g) * 100
    noise = torch.randn((B, K, T, 2), generator=g)
    u = torch.rand((B, T, 2), generator=g)
    dyn = cvar_from_costs_dynamic(costs, ttask.cvar_alpha)
    stat = cvar_from_costs(costs, 3)
    coup = control_coupling(u, noise, ttask.u_std, ttask.lambda_weight)
    un, wn = update_useq(dyn + coup, noise, u, ttask.lambda_weight,
                         ttask.vrange, ttask.wrange)
    for b in range(B):
        t1 = scenario(ttask, b)
        d1 = cvar_from_costs_dynamic(costs[b], t1.cvar_alpha)
        c1 = control_coupling(u[b], noise[b], t1.u_std, t1.lambda_weight)
        u1, w1 = update_useq(d1 + c1, noise[b], u[b], t1.lambda_weight,
                             t1.vrange, t1.wrange)
        torch.testing.assert_close(dyn[b], d1, rtol=0, atol=0)
        torch.testing.assert_close(stat[b], cvar_from_costs(costs[b], 3),
                                   rtol=0, atol=0)
        torch.testing.assert_close(coup[b], c1, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(un[b], u1, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(wn[b], w1, rtol=1e-5, atol=1e-7)


_MODES = {
    # name: (mode, cvar_numel, roi_shape)
    "tdm_dynamic_cvar": ("tdm", -1, None),
    "tdm_static_cvar": ("tdm", M // 2, None),
    "tdm_cropped": ("tdm", -1, (7, 9)),
    "det_dyn": ("det_dyn", 1, None),
    "speed_map": ("speed_map", 1, None),
}


@pytest.mark.parametrize("name", sorted(_MODES))
def test_batched_solve_matches_jax_vmap(name):
    """``solve_from_key`` over B scenarios (their own maps, tasks, cvar and
    alpha_dyn, controls, JAX's keys and noise) against ``jax.vmap`` of the
    JAX package's solve: u within the whole-solve tolerance, the sampled
    grids exact, the window offsets exact when cropping; and against the
    port's B single solves."""
    mode, cvar_numel, roi = _MODES[name]
    Ms = M if mode == "tdm" else 1
    kw = dict(mode=mode, num_steps=T, num_control_rollouts=K,
              num_grid_samples=Ms, map_shape=(H, W), num_obstacles=0,
              cvar_numel=cvar_numel, num_opt=2, num_vis_state_rollouts=2,
              roi_shape=roi, num_pmf_bins=12)
    jstatic = JStatic(backend="xla", **kw)
    tstatic = SolverStatic(backend="eager", **kw)
    worlds, jmaps, jtask, tmaps, ttask = _batched_worlds(12)
    if mode != "tdm":
        jtask = jtask._replace(alpha_dyn=np.ones(B, np.float32))
        ttask = ttask._replace(alpha_dyn=torch.ones(B))
    jkeys, _ = _keys(21 + len(name))
    u0 = (np.random.RandomState(3).rand(B, T, 2) - 0.3).astype(np.float32)
    j_u, j_aux = jax.vmap(j_get_solver(jstatic))(
        jkeys, jax.tree.map(jnp.asarray, jmaps),
        jax.tree.map(jnp.asarray, jtask), jnp.asarray(u0))

    def draws(key):
        kmap, knoise = jax.random.split(key)
        return (jax.random.key_data(kmap),
                jnp.stack([jax.random.normal(jax.random.fold_in(knoise, i),
                                             (K, T, 2), dtype=jnp.float32)
                           for i in range(2)]))

    mk, eps = jax.vmap(draws)(jkeys)
    map_keys = torch.tensor(np.asarray(mk).astype(np.int64))
    eps = [torch.tensor(np.asarray(eps[:, i])) for i in range(2)]
    solver = get_terrain_solver(tstatic, "cpu")
    u, aux = solver.solve_from_key(map_keys, eps, tmaps, ttask,
                                   torch.tensor(u0))
    assert u.shape == (B, T, 2)
    np.testing.assert_allclose(u.numpy(), np.asarray(j_u), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    np.testing.assert_array_equal(aux.ang_grids.numpy(),
                                  np.asarray(j_aux.ang_grids))
    if roi:
        np.testing.assert_array_equal(aux.roi_offset.numpy(),
                                      np.asarray(j_aux.roi_offset))
        assert len({tuple(o) for o in aux.roi_offset.tolist()}) > 1
    for b in range(B):
        u1, aux1 = solver.solve_from_key(map_keys[b], [e[b] for e in eps],
                                         scenario(tmaps, b),
                                         scenario(ttask, b),
                                         torch.tensor(u0[b]))
        torch.testing.assert_close(u[b], u1, rtol=RTOL, atol=ATOL)
        assert torch.equal(aux.lin_grids[b], aux1.lin_grids)
        assert torch.equal(aux.roi_offset[b], aux1.roi_offset)
        assert aux.noise_vis[b].shape == aux1.noise_vis.shape


def test_batched_solve_kernel_layout_matches_jax_pallas_vmap():
    """The layouts' plain kernel versions under the scenario axis (the
    byte layout, fast trig, dynamic CVaR) against JAX's Pallas kernel in
    interpret mode under ``jax.vmap``, the TPU kernel's batch axis."""
    kw = dict(mode="tdm", num_steps=T, num_control_rollouts=K,
              num_grid_samples=M, map_shape=(H, W), num_obstacles=0,
              cvar_numel=-1, num_opt=1, num_vis_state_rollouts=1,
              num_pmf_bins=12, fast_trig=True)
    jstatic = JStatic(backend="pallas_interpret", **kw)
    tstatic = SolverStatic(backend="byte", **kw)
    _, jmaps, jtask, tmaps, ttask = _batched_worlds(12)
    jkeys, _ = _keys(5)
    u0 = np.zeros((B, T, 2), np.float32)
    j_u, _ = jax.vmap(j_get_solver(jstatic))(
        jkeys, jax.tree.map(jnp.asarray, jmaps),
        jax.tree.map(jnp.asarray, jtask), jnp.asarray(u0))

    def draws(key):
        kmap, knoise = jax.random.split(key)
        return (jax.random.key_data(kmap),
                jax.random.normal(jax.random.fold_in(knoise, 0), (K, T, 2),
                                  dtype=jnp.float32))

    mk, eps = jax.vmap(draws)(jkeys)
    u, _ = get_terrain_solver(tstatic, "cpu").solve_from_key(
        torch.tensor(np.asarray(mk).astype(np.int64)),
        [torch.tensor(np.asarray(eps))], tmaps, ttask, torch.tensor(u0))
    np.testing.assert_allclose(u.numpy(), np.asarray(j_u), rtol=RTOL,
                               atol=ATOL)
