"""The port's sharded solve (``mppi_numba_tpu_torch.parallel``) on eight
gloo ranks on the CPU, against the port's single solve and the JAX
package's, at ``tests/test_sharding.py``'s sizes: K = 64, M = 8, T = 10,
5 bins on 8x8 maps, two optimisation iterations.

One spawned group of eight ranks runs every case (``torch_parallel_ranks
.run_group``); each case is asserted in its own test.  The draws are
JAX's (its map keys and normals) injected into both solves, so the
sharded solve rolls out the single solve's rollouts and differs only in
the order of its sums across ranks.  Tolerances as the JAX package's
sharding tests: u rtol 2e-4 / atol 2e-5, costs rtol 2e-4 / atol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.config import SolverStatic as JStatic
from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu.types import MapInputs as JMaps
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.device_sim import make_device_trial_batch
from mppi_numba_tpu_torch.ops.kernels.map_sample import sample_and_pack_window
from mppi_numba_tpu_torch.solver import DYNAMIC_CVAR, TerrainSolver

from tests import torch_parallel_ranks as ranks

WORLD = 8
U_TOL = dict(rtol=2e-4, atol=2e-5)
COST_TOL = dict(rtol=2e-4, atol=2e-3)
K_MESHES = [(1, 8, 1), (2, 4, 1), (4, 2, 1), (8, 1, 1)]
KM_MESHES = [(1, 2, 4), (1, 4, 2), (2, 2, 2), (1, 1, 8)]


def _cases():
    """name -> (mesh, build_case kwargs, static changes, task changes)."""
    cases = {}
    for mesh in K_MESHES:
        cases["k{}".format(mesh)] = (mesh, dict(cvar_numel=3), {}, {})
    for mesh in KM_MESHES:
        for numel in (3, 8):
            cases["km{}_cvar{}".format(mesh, numel)] = (
                mesh, dict(cvar_numel=numel), {}, {})
    cases["dynamic(1, 2, 4)"] = ((1, 2, 4), {}, dict(cvar_numel=DYNAMIC_CVAR),
                                 dict(cvar_alpha=0.4))
    cases["roi(2, 2, 2)"] = ((2, 2, 2), dict(H=20, W=20, cvar_numel=3),
                             dict(roi_shape=(9, 9)), {})
    # Lambda 10, as the port's other CPU solve tests against JAX: at
    # lambda 1 the bicycle's float32 cost ulps between the two packages
    # (not between the sharded and the single solve) grow through the
    # softmax to 1.3e-4 in u.
    cases["bicycle_dynamic(1, 8, 1)"] = (
        (1, 8, 1), dict(lam=10.0),
        dict(model="bicycle", cvar_numel=DYNAMIC_CVAR), dict(cvar_alpha=0.5))
    return cases


CASES = _cases()


def _jax_draws(static, S):
    """JAX's keys of ``build_case`` and the solve's draws from them: the
    map keys ``(S, 2)`` and ``num_opt`` normals ``(S, K, T, 2)``."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(S))
    K, T = static["num_control_rollouts"], static["num_steps"]

    def draws(key):
        kmap, knoise = jax.random.split(key)
        return (jax.random.key_data(kmap),
                jnp.stack([jax.random.normal(jax.random.fold_in(knoise, i),
                                             (K, T, 2), dtype=jnp.float32)
                           for i in range(static["num_opt"])]))

    mk, eps = jax.vmap(draws)(keys)
    return (keys, np.asarray(mk).astype(np.int64),
            [np.asarray(eps[:, i]) for i in range(static["num_opt"])])


def _case(name):
    mesh, build, static_changes, task_changes = CASES[name]
    S = mesh[0] * 2
    static, maps, task, u0 = ranks.build_case(S, **build)
    static.update(static_changes)
    for k, v in task_changes.items():
        task[k] = np.full_like(task[k], v)
    keys, map_keys, eps = _jax_draws(static, S)
    return dict(kind="solve", mesh=mesh, static=static, maps=maps, task=task,
                u0=u0, map_keys=map_keys, eps=eps, jax_keys=np.asarray(keys))


def _trial_job():
    """Eight episodes of ``tests/test_sharding.py``'s trial batch on 7x7
    maps, each with its own start and goal."""
    B = 8
    static, maps, task, _ = ranks.build_case(B, M=8, T=8, H=7, W=7)
    # Goals from 0.5 m to 2.5 m ahead: the near ones are reached within
    # the steps (the masked steps after), the far ones time out.
    task["x0"][:, :2] = 1.5
    task["xgoal"][:] = 1.5 + np.linspace(0.35, 1.8, B, dtype=np.float32)[
        :, None]
    task["v_post_rollout"][:] = 0.01
    rng = np.random.RandomState(0)
    gt = rng.uniform(0.4, 1.0, (B, 5, 5)).astype(np.float32)
    meta = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (B, 1))
    return dict(kind="trial", mesh=(2, 4, 1), static=static, maps=maps,
                task=task, gt=(gt, gt.copy(), meta), max_steps=10, seed=0)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case, run once on eight ranks: ``(jobs, [results by rank])``."""
    jobs = {name: _case(name) for name in CASES}
    jobs["trial"] = _trial_job()
    sent = {name: {k: v for k, v in job.items() if k != "jax_keys"}
            for name, job in jobs.items()}
    out = ranks.run_group(WORLD, sent, tmp_path_factory.mktemp("group"))
    return jobs, out


def _port_single(job):
    static = SolverStatic(**job["static"])
    maps, task, u0 = ranks.port_inputs(job["maps"], job["task"], job["u0"])
    u, aux = TerrainSolver(static, "cpu").solve_from_key(
        torch.as_tensor(job["map_keys"]),
        [torch.as_tensor(e) for e in job["eps"]], maps, task, u0)
    return u.numpy(), aux.costs.numpy()


def _jax_single(job):
    static = JStatic(**dict(job["static"], backend="xla"))
    solve = j_get_solver(static)
    us, costs = [], []
    for s in range(job["u0"].shape[0]):
        maps = JMaps(**{k: jnp.asarray(v[s]) for k, v in job["maps"].items()})
        task = JTask(**{k: jnp.asarray(v[s]) for k, v in job["task"].items()})
        u, aux = solve(job["jax_keys"][s], maps, task,
                       jnp.asarray(job["u0"][s]))
        us.append(np.asarray(u))
        costs.append(np.asarray(aux.costs))
    return np.stack(us), np.stack(costs)


def _check_against(group, name, ref):
    jobs, out = group
    job = jobs[name]
    want_u, want_costs = (_port_single if ref == "port" else _jax_single)(job)
    for r, res in enumerate(out):
        got = res[name]
        rows, ks = got["rows"], got["ks"]
        np.testing.assert_allclose(got["u"], want_u[rows], err_msg=str(r),
                                   **U_TOL)
        np.testing.assert_allclose(got["costs"], want_costs[rows, ks],
                                   err_msg=str(r), **COST_TOL)
        np.testing.assert_allclose(got["u_all"], want_u, err_msg=str(r),
                                   **U_TOL)


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("mesh", K_MESHES, ids=str)
def test_k_sharded_solve(group, mesh, ref):
    _check_against(group, "k{}".format(mesh), ref)


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("numel", [3, 8])     # two-phase top-k / all-reduce
@pytest.mark.parametrize("mesh", KM_MESHES, ids=str)
def test_map_sharded_solve(group, mesh, numel, ref):
    _check_against(group, "km{}_cvar{}".format(mesh, numel), ref)


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("name", ["dynamic(1, 2, 4)", "roi(2, 2, 2)",
                                  "bicycle_dynamic(1, 8, 1)"])
def test_sharded_solve_modes(group, name, ref):
    """Run-time alpha over a sharded M axis; the reachable-window crop
    (its window clamped at the map's corner) under k and m sharding; the
    bicycle with a run-time alpha."""
    _check_against(group, name, ref)


def _expected_calls(job, rank):
    """The collectives the port's design makes in one solve on ``rank``:
    ``{(name, group ranks): count}``."""
    s_, k_, m_ = job["mesh"]
    static = job["static"]
    M = static["num_grid_samples"]
    n_m = m_ if M % m_ == 0 else 1
    s, rest = divmod(rank, k_ * m_)
    k, m = divmod(rest, m_)
    k_group = tuple((s * k_ + kk) * m_ + m for kk in range(k_))
    m_group = tuple((s * k_ + k) * m_ + mm for mm in range(m_))
    it = static["num_opt"]
    want = {}
    if k_ > 1:
        # One k rank runs the update kernel: no collective over k.
        want[("all_reduce", k_group)] = 3 * it
        if (M // n_m) % k_ == 0:
            want[("all_gather_into_tensor", k_group)] = 1
    if n_m > 1:
        # The candidates, or at alpha 1 each rank's sums (added in rank
        # order, as JAX's psum adds them on the CPU).
        want[("all_gather_into_tensor", m_group)] = it
    return want


@pytest.mark.parametrize("name", ["k(1, 8, 1)", "k(8, 1, 1)",
                                  "km(1, 4, 2)_cvar3", "km(2, 2, 2)_cvar8",
                                  "dynamic(1, 2, 4)"])
def test_collective_counts(group, name):
    """Per solve, with k sharded: three all-reduces an iteration over k,
    one payload gather over k when the k ranks split the draw (one k rank
    updates with the kernel and makes neither); with m sharded, one
    gather an iteration over m (the candidates, or at alpha 1 the ranks'
    sums); nothing else."""
    jobs, out = group
    for r, res in enumerate(out):
        got = {}
        for fn, _, ranks_ in res[name]["calls"]:
            got[(fn, ranks_)] = got.get((fn, ranks_), 0) + 1
        assert got == _expected_calls(jobs[name], r), (r, got)
        ops = [op for fn, op, _ in res[name]["calls"] if fn == "all_reduce"]
        k_split = jobs[name]["mesh"][1] > 1
        assert sum("MIN" in op for op in ops) == (
            jobs[name]["static"]["num_opt"] if k_split else 0), ops


@pytest.mark.parametrize("name", ["k(1, 8, 1)", "km(1, 4, 2)_cvar3",
                                  "km(2, 2, 2)_cvar3", "roi(2, 2, 2)"])
def test_gathered_payload_is_the_unsharded_draw(group, name):
    """Each rank's payload after the gather over k: bit for bit the rows
    of its m shard of the unsharded draw and pack (one launch of all M
    rows), the crop's window included."""
    from mppi_numba_tpu_torch.ops.kernels.map_sample import (
        sample_and_pack_crop)

    jobs, out = group
    job = jobs[name]
    static = job["static"]
    maps, task = ranks.port_inputs(job["maps"], job["task"])
    keys = torch.as_tensor(job["map_keys"])
    M = static["num_grid_samples"]
    if static.get("roi_shape"):
        want = sample_and_pack_crop(keys, maps, task, M, "byte",
                                    static["roi_shape"])[0]
    else:
        want = sample_and_pack_window(keys, maps, task.alpha_dyn, M, "byte")[0]
    for r, res in enumerate(out):
        got = res[name]
        assert np.array_equal(got["payload"],
                              want[got["rows"], got["ms"]].numpy()), r


def test_sharded_solver_is_cached(group):
    _, out = group
    assert all(res[name]["cached"] for res in out for name in CASES)


@pytest.mark.parametrize("field", ["steps", "success", "cum_obj"])
def test_sharded_trial_batch_matches_local(group, field):
    """Eight episodes over a (2, 4) mesh, every rank returning the whole
    batch, against ``make_device_trial_batch`` from the same generator
    seed: steps and success exact, cum_obj within rtol 1e-4."""
    jobs, out = group
    job = jobs["trial"]
    maps, task = ranks.port_inputs(job["maps"], job["task"])
    local = make_device_trial_batch(SolverStatic(**job["static"]),
                                    job["max_steps"])(
        torch.Generator().manual_seed(job["seed"]), maps, task,
        *(torch.as_tensor(g) for g in job["gt"]))
    want = getattr(local, field).numpy()
    if field == "success":      # goals reached and goals timed out
        assert 0 < want.sum() < len(want), want
    for r, res in enumerate(out):
        got = res["trial"][field]
        assert got.dtype == want.dtype, r
        if field == "cum_obj":
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=str(r))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(r))
