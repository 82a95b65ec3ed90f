"""The port's device simulator (``mppi_numba_tpu_torch.device_sim``) against
the JAX package's on the CPU, fed JAX's own draws.

JAX's episode step runs ``key, sub = split(key)`` and solves with ``sub``;
its solve splits ``sub`` into the map key and the noise key
(``tests/test_torch_solver.py::_jax_draws``).  The port's trial takes a
callable ``step -> (map_key, eps_list)`` that hands it the same draws.
Small size: K = 64, M = 16, T = 10, an 11x11 map, max_steps 8, lambda 10
(as the CPU solve tests, so that float32 ulps do not grow through the
softmax).
"""


import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu import device_sim as jsim
from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.types import MapInputs as JMaps
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch import device_sim as tsim
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import to_port

K, M, T, H, W = 64, 16, 10, 11, 11
MAX_STEPS = 8
RTOL, ATOL = 2e-4, 2e-5
# Goals: reached within MAX_STEPS (the early exit and the masked steps
# after it), and too far to reach (the timeout penalty).
GOALS = {"reached": (2.7, 2.5), "timeout": (9.0, 9.5)}


def _world(goal, seed=0):
    rng = np.random.RandomState(seed)
    B = 6
    raw = rng.randint(1, 100, size=(B, H, W)).astype(float)
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    qbins = np.linspace(40, 100, B).astype(np.int8)
    obstacle = np.zeros((H, W), np.int8)
    obstacle[7, 2:5] = 1
    maps = JMaps(pmf, pmf, qbins, qbins, obstacle, np.zeros((H, W), np.int8),
                 np.zeros((H, W), np.int8))
    f32 = np.float32
    task = JTask(
        x0=np.array([2.0, 2.0, 0.8], f32), xgoal=np.array(goal, f32),
        goal_tolerance=f32(0.5), v_post_rollout=f32(0.01),
        lambda_weight=f32(10.0), u_std=np.array([1.5, 2.0], f32),
        vrange=np.array([0.0, 2.0], f32),
        wrange=np.array([-3.14, 3.14], f32), dt=f32(0.1),
        dist_weight=f32(1.0), obs_penalty=f32(1e5), unknown_penalty=f32(1e2),
        alpha_dyn=f32(1.0), res=f32(1.0), xlim0=f32(0.0), ylim0=f32(0.0),
        lin_lb=f32(0.0), lin_ratio=f32(0.01), ang_lb=f32(0.0),
        ang_ratio=f32(0.01), cvar_alpha=f32(0.5))
    gt_lin = (1.1 + 0.3 * rng.rand(H - 2, W - 2)).astype(f32)
    gt_ang = (0.6 + 0.3 * rng.rand(H - 2, W - 2)).astype(f32)
    gt_meta = np.array([0.0, 0.0, 1.0], f32)
    return maps, task, gt_lin, gt_ang, gt_meta


def _statics():
    kw = dict(mode="tdm", num_steps=T, num_control_rollouts=K,
              num_grid_samples=M, map_shape=(H, W), num_obstacles=0,
              cvar_numel=M // 2, num_opt=2, num_vis_state_rollouts=1)
    return JStatic(backend="xla", **kw), SolverStatic(backend="eager", **kw)


def _jax_draws(key):
    """``step -> (map_key, eps_list)``: the draws JAX's episode makes at
    each step from ``key``."""
    subs = []
    for _ in range(MAX_STEPS):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draws(t):
        kmap, knoise = jax.random.split(subs[t])
        map_key = torch.tensor(np.asarray(jax.random.key_data(kmap))
                               .astype(np.int64))
        eps = [torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(knoise, i), (K, T, 2), dtype=jnp.float32)))
            for i in range(2)]
        return map_key, eps

    return draws


def _port_inputs(world):
    maps, task, gt_lin, gt_ang, gt_meta = world
    t_maps, t_task, _ = to_port(maps, task, None, "cpu")
    return (t_maps, t_task, torch.tensor(gt_lin), torch.tensor(gt_ang),
            torch.tensor(gt_meta))


def _assert_same(got, want):
    assert int(got.steps) == int(want.steps)
    assert bool(got.success) == bool(want.success)
    for name in ("dist_to_goal", "cum_dist_to_goal", "cum_obj"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("goal", sorted(GOALS))
@pytest.mark.parametrize("engine", ["make_device_trial", "make_episode_fn"])
def test_trial_matches_jax(engine, goal):
    """One episode, JAX's draws injected: steps and success exact, the
    distances and the objective within the whole-solve tolerance."""
    jstatic, tstatic = _statics()
    world = _world(GOALS[goal])
    key = jax.random.PRNGKey(5)
    j_fn = getattr(jsim, engine)(jstatic, MAX_STEPS)
    if engine == "make_episode_fn":
        j_fn = jax.jit(j_fn)
    want = j_fn(key, *world)
    got = getattr(tsim, engine)(tstatic, MAX_STEPS)(_jax_draws(key),
                                                    *_port_inputs(world))
    _assert_same(got, want)
    assert bool(want.success) == (goal == "reached")
    if goal == "reached":
        assert int(want.steps) < MAX_STEPS


def _jax_batch_draws(keys):
    """``step -> (map_keys (B, 2), eps_list [(B, K, T, 2)])``: each
    scenario's JAX draws (``_jax_draws``) stacked on the scenario axis."""
    each = [_jax_draws(k) for k in keys]

    def draws(t):
        parts = [d(t) for d in each]
        return (torch.stack([p[0] for p in parts]),
                [torch.stack([p[1][i] for p in parts]) for i in range(2)])

    return draws


def _batch_inputs(worlds):
    ports = [_port_inputs(w) for w in worlds]
    maps = type(ports[0][0])(*(torch.stack(f) for f in zip(
        *(p[0] for p in ports))))
    task = type(ports[0][1])(*(torch.stack(f) for f in zip(
        *(p[1] for p in ports))))
    return ports, (maps, task, *(torch.stack([p[i] for p in ports])
                                 for i in (2, 3, 4)))


def test_batch_matches_jax_and_single():
    """Two scenarios (one reaches its goal, one times out) stepped together
    by the batch engine (one batched solve a step) against JAX's vmapped
    batch, and each against the port's single trial, as
    ``tests/test_device_sim.py`` holds JAX's."""
    jstatic, tstatic = _statics()
    worlds = [_world(GOALS["reached"], 0), _world(GOALS["timeout"], 1)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *worlds)
    want = jsim.make_device_trial_batch(jstatic, MAX_STEPS)(
        jnp.stack(keys), *stacked)
    ports, batch_in = _batch_inputs(worlds)
    engine = tsim.make_device_trial_batch(tstatic, MAX_STEPS)
    got = engine(_jax_batch_draws(keys), *batch_in)
    assert got.steps.shape == (2,) and got.success.dtype == torch.bool
    assert engine.steps_run == MAX_STEPS      # one episode never arrives
    single = tsim.make_device_trial(tstatic, MAX_STEPS)
    for i in range(2):
        _assert_same(type(got)(*(f[i] for f in got)),
                     type(want)(*(f[i] for f in want)))
        one = single(_jax_draws(keys[i]), *ports[i])
        assert int(one.steps) == int(got.steps[i])
        assert bool(one.success) == bool(got.success[i])
        np.testing.assert_allclose(float(one.cum_obj), float(got.cum_obj[i]),
                                   rtol=1e-5)
    assert [bool(s) for s in got.success] == [True, False]


def test_batch_stops_once_every_episode_has_arrived():
    """A batch whose episodes all reach their goals stops stepping then
    (the steps after are masked, so nothing changes), with JAX's masked
    results; a single episode is a batch of one, bit for bit."""
    jstatic, tstatic = _statics()
    worlds = [_world(GOALS["reached"], 0), _world(GOALS["reached"], 2)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(9)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *worlds)
    want = jsim.make_device_trial_batch(jstatic, MAX_STEPS)(
        jnp.stack(keys), *stacked)
    ports, batch_in = _batch_inputs(worlds)
    engine = tsim.make_device_trial_batch(tstatic, MAX_STEPS)
    got = engine(_jax_batch_draws(keys), *batch_in)
    assert bool(got.success.all())
    assert engine.steps_run == int(got.steps.max()) < MAX_STEPS
    for i in range(2):
        _assert_same(type(got)(*(f[i] for f in got)),
                     type(want)(*(f[i] for f in want)))
        alone = tsim.make_device_trial_batch(tstatic, MAX_STEPS)(
            _jax_batch_draws([keys[i]]),
            *(type(x)(*(f[i:i + 1] for f in x)) if hasattr(x, "_replace")
              else x[i:i + 1] for x in batch_in))
        for a, b in zip(alone, got):
            assert torch.equal(a[0], b[i])


class _MaskSpy:
    """A solver that records the skip mask each solve is handed (as it
    stands at the call) and, with ``drop``, solves without it."""

    def __init__(self, solver, drop):
        self.solver, self.drop, self.masks = solver, drop, []

    def __call__(self, generator, maps, task, u0, skip=None):
        self.masks.append(skip.clone())
        return self.solver(generator, maps, task, u0,
                           skip=None if self.drop else skip)


@pytest.mark.parametrize("backend", ["eager", "byte", "binned8"])
def test_batch_skip_mask_changes_no_result(backend, monkeypatch):
    """Three episodes (two reach their goals at different steps, one times
    out), a generator's draws: with the finished episodes' rollouts
    skipped and with every rollout run, every ``TrialResult`` field is bit
    for bit the same and the generator ends in the same state; each solve
    is handed ``reached`` as it stood before the step, and
    ``skipped_solves`` is ``B * steps_run - sum(steps)``, the masks' sum."""
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    tstatic = dataclasses.replace(_statics()[1], backend=backend)
    worlds = [_world(GOALS["reached"], 0), _world(GOALS["timeout"], 1),
              _world(GOALS["reached"], 2)]
    _, batch_in = _batch_inputs(worlds)
    runs = []
    for drop in (False, True):
        spy = _MaskSpy(get_terrain_solver(tstatic, "cpu"), drop)
        monkeypatch.setattr(tsim, "get_terrain_solver",
                            lambda static, dev, spy=spy: spy)
        engine = tsim.make_device_trial_batch(tstatic, MAX_STEPS)
        g = torch.Generator().manual_seed(3)
        runs.append((engine(g, *batch_in), g.get_state(), engine, spy))
    (got, state, engine, spy), (want, want_state, _, _) = runs
    for a, b in zip(got, want):
        assert torch.equal(a, b), (got, want)
    assert torch.equal(state, want_state)
    assert engine.steps_run == MAX_STEPS == len(spy.masks)
    assert [int(s) < MAX_STEPS for s in got.steps] == [True, False, True]
    assert not spy.masks[0].any()
    for t, mask in enumerate(spy.masks):
        assert torch.equal(mask, got.steps <= t), t
    assert (engine.skipped_solves == 3 * MAX_STEPS - int(got.steps.sum())
            == sum(int(m.sum()) for m in spy.masks) > 0)


def test_episode_fn_equals_its_batch_row():
    """``make_episode_fn`` (every step run, none exits early) gives each
    episode of a batch its row of the batch's result, bit for bit, JAX's
    draws injected, with the finished episode's rollouts skipped in
    both."""
    _, tstatic = _statics()
    worlds = [_world(GOALS["reached"], 0), _world(GOALS["timeout"], 1)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    ports, batch_in = _batch_inputs(worlds)
    batch = tsim.make_device_trial_batch(tstatic, MAX_STEPS)(
        _jax_batch_draws(keys), *batch_in)
    for i in range(2):
        one = tsim.make_episode_fn(tstatic, MAX_STEPS)
        got = one(_jax_draws(keys[i]), *ports[i])
        for a, b in zip(got, batch):
            assert torch.equal(a, b[i]), (i, got, batch)
        assert one.engine.skipped_solves == MAX_STEPS - int(got.steps)
    assert int(batch.steps[0]) < MAX_STEPS


def test_batch_step_follows_jax_step_along_its_trajectory():
    """The batched step (solve, ground-truth step, shift) against JAX's
    ``_make_step_core`` along JAX's own closed-loop trajectory, 40 steps
    of two scenarios, each step fed JAX's state, controls and draws:
    states, shifted controls and goal distances within the whole-solve
    tolerance at every step.  (Left to run free, the two closed loops part
    ways: float32 ordering differences grow about 10x every two steps.)"""
    from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    jstatic, tstatic = _statics()
    steps = 40
    worlds = [_world(GOALS["timeout"], 0), _world((9.5, 3.0), 1)]
    stacked = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *worlds)
    j_step = jax.jit(jax.vmap(jsim._make_step_core(j_get_solver(jstatic))))
    _, (maps, task, gl, ga, gm) = _batch_inputs(worlds)
    solver = get_terrain_solver(tstatic, "cpu")
    keys = jnp.stack([jax.random.PRNGKey(11), jax.random.PRNGKey(12)])
    x = stacked[1].x0
    u = jnp.zeros((2, T, 2), jnp.float32)
    for t in range(steps):
        pair = jax.vmap(jax.random.split)(keys)
        subs = pair[:, 1]
        draws = [_jax_draws_of(s) for s in subs]
        map_keys = torch.stack([d[0] for d in draws])
        eps = [torch.stack([d[1][i] for d in draws]) for i in range(2)]
        step = tsim._make_step_core(
            lambda m, tk, uu: solver.solve_from_key(map_keys, eps, m, tk, uu))
        got = step(torch.tensor(np.asarray(x)), torch.tensor(np.asarray(u)),
                   maps, task, gl, ga, gm)
        x, u, keys, dist = j_step(x, u, keys, stacked[0], stacked[1],
                                  *stacked[2:])
        for g, w in zip(got, (x, u, dist)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=str(t))


def _jax_draws_of(sub):
    """The map key and the noise a JAX solve draws from its key ``sub``."""
    kmap, knoise = jax.random.split(sub)
    return (torch.tensor(np.asarray(jax.random.key_data(kmap))
                         .astype(np.int64)),
            [torch.tensor(np.asarray(jax.random.normal(
                jax.random.fold_in(knoise, i), (K, T, 2),
                dtype=jnp.float32))) for i in range(2)])


def test_generator_draws_match_the_solvers_own():
    """With a generator, each step draws as ``TerrainSolver.__call__``
    does: the same episode as the callable replaying those draws."""
    _, tstatic = _statics()
    inputs = _port_inputs(_world(GOALS["timeout"]))
    from mppi_numba_tpu_torch.ops.sampling import draw_map_key

    g = torch.Generator().manual_seed(3)
    gen_result = tsim.make_episode_fn(tstatic, 3)(g, *inputs)
    g2 = torch.Generator().manual_seed(3)

    def draws(t):
        key = draw_map_key(g2, torch.device("cpu"))
        return key, [torch.randn((K, T, 2), generator=g2) for _ in range(2)]

    call_result = tsim.make_episode_fn(tstatic, 3)(draws, *inputs)
    for a, b in zip(gen_result, call_result):
        assert torch.equal(a, b)
    assert int(gen_result.steps) == 3
