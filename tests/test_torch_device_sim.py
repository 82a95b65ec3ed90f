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


def test_batch_matches_jax_and_single():
    """Two scenarios (one reaches its goal, one times out) through the
    batch engine against JAX's vmapped batch, and each against the port's
    single trial, as ``tests/test_device_sim.py`` holds JAX's."""
    jstatic, tstatic = _statics()
    worlds = [_world(GOALS["reached"], 0), _world(GOALS["timeout"], 1)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *worlds)
    want = jsim.make_device_trial_batch(jstatic, MAX_STEPS)(
        jnp.stack(keys), *stacked)
    ports = [_port_inputs(w) for w in worlds]
    batch_in = [type(ports[0][0])(*(torch.stack(f) for f in zip(
        *(p[0] for p in ports))))]
    batch_in.append(type(ports[0][1])(*(torch.stack(f) for f in zip(
        *(p[1] for p in ports)))))
    batch_in += [torch.stack([p[i] for p in ports]) for i in (2, 3, 4)]
    got = tsim.make_device_trial_batch(tstatic, MAX_STEPS)(
        [_jax_draws(k) for k in keys], *batch_in)
    assert got.steps.shape == (2,) and got.success.dtype == torch.bool
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
