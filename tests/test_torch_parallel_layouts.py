"""The port's sharded solve on four gloo ranks on the CPU (the reachable
window, the binned payload layouts), on one rank (bit for bit with the
single solve), the distributed reductions of ``ops/update.py`` and
``ops/cvar.py`` against their single-device versions and JAX's, and the
map draw's M slices in crop mode.

Sizes and tolerances as ``tests/test_torch_parallel_solve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mppi_numba_tpu.ops import cvar as jcvar
from mppi_numba_tpu_torch.ops.cvar import (cvar_from_costs,
                                           cvar_from_costs_dynamic)
from mppi_numba_tpu_torch.ops.kernels.cvar_costs import cvar_costs_plain
from mppi_numba_tpu_torch.ops.kernels.map_sample import (
    sample_and_pack_crop, sample_and_pack_window)
from mppi_numba_tpu_torch.ops.kernels.update_useq import update_useq_plain
from mppi_numba_tpu_torch.ops.update import update_useq
from mppi_numba_tpu_torch.solver import DYNAMIC_CVAR

from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel_solve import (U_TOL, _check_against,
                                             _jax_draws, _port_single)

OPS_MESHES = [(1, 2, 2), (1, 1, 4), (1, 4, 1)]
OPS_NUMELS = (3, 8, 16)       # M = 16: keep < M_local, keep = M_local, alpha 1
# The flagship's M = 1,024 on the meshes that split m: 33 and 205 worst
# costs and alpha 1, each past XLA's 32-term window.
WIDE_OPS_MESHES = [(1, 2, 2), (1, 1, 4)]
WIDE_OPS_NUMELS = (33, 205, 1024)
LAYOUTS = ("byte", "binned2", "binned", "binned8")


def _cases():
    """name -> (world, mesh, build_case kwargs, static changes, task
    changes)."""
    roi = (dict(H=20, W=20, cvar_numel=3), dict(roi_shape=(9, 9)), {})
    return {
        "roi(1, 4, 1)": (4, (1, 4, 1)) + roi,
        "roi(1, 2, 2)": (4, (1, 2, 2)) + roi,
        # >16 bins: 8-bit cells; <=4 bins: 2-bit cells.
        "binned8(1, 4, 1)": (4, (1, 4, 1), dict(B=22, cvar_numel=3),
                             dict(num_pmf_bins=22, backend="binned8"), {}),
        "binned2(1, 4, 1)": (4, (1, 4, 1), dict(B=4, cvar_numel=3),
                             dict(num_pmf_bins=4, backend="binned2"), {}),
        "one_rank_cvar3": (1, (1, 1, 1), dict(cvar_numel=3), {}, {}),
        "one_rank_dynamic": (1, (1, 1, 1), {},
                             dict(cvar_numel=DYNAMIC_CVAR),
                             dict(cvar_alpha=0.4)),
        "one_rank_roi": (1, (1, 1, 1)) + roi,
    }


CASES = _cases()


def _case(name):
    _, mesh, build, static_changes, task_changes = CASES[name]
    S = 2
    static, maps, task, u0 = ranks.build_case(S, **build)
    static.update(static_changes)
    for k, v in task_changes.items():
        task[k] = np.full_like(task[k], v)
    keys, map_keys, eps = _jax_draws(static, S)
    return dict(kind="solve", mesh=mesh, static=static, maps=maps, task=task,
                u0=u0, map_keys=map_keys, eps=eps, jax_keys=np.asarray(keys))


def _ops_job(mesh, M=16, numels=OPS_NUMELS, alphas=(0.3, 0.55)):
    """The distributed reductions' inputs; past M = 16 the costs spread
    over three decades, so that the order of their sums shows."""
    rng = np.random.RandomState(7)
    S, K, T = 2, 8, 10
    f32 = np.float32
    costs_km = rng.rand(S, K, M) * 100
    if M > 16:
        costs_km = costs_km * 10.0 ** rng.uniform(0, 3, (S, K, M))
    return dict(
        kind="ops", mesh=mesh, numels=numels,
        costs_km=costs_km.astype(f32),
        costs=(rng.rand(S, K) * 50).astype(f32),
        noise=rng.randn(S, K, T, 2).astype(f32),
        u=rng.rand(S, T, 2).astype(f32),
        task=dict(lambda_weight=np.array([1.0, 10.0], f32),
                  vrange=np.tile(np.array([0.0, 2.0], f32), (S, 1)),
                  wrange=np.tile(np.array([-3.0, 3.0], f32), (S, 1)),
                  u_std=np.array([[2.0, 3.0], [0.5, 1.5]], f32),
                  cvar_alpha=np.array(alphas, f32)))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The four-rank and the one-rank cases, each group spawned once:
    ``{world: (jobs, [results by rank])}``."""
    out = {}
    for world in (4, 1):
        jobs = {name: _case(name) for name, c in CASES.items()
                if c[0] == world}
        if world == 4:
            jobs.update({"ops{}".format(m): _ops_job(m) for m in OPS_MESHES})
            jobs.update({"ops_wide{}".format(m): _ops_job(
                m, 1024, WIDE_OPS_NUMELS, (205 / 1024, 33 / 1024))
                for m in WIDE_OPS_MESHES})
        sent = {name: {k: v for k, v in job.items() if k != "jax_keys"}
                for name, job in jobs.items()}
        out[world] = (jobs, ranks.run_group(
            world, sent, tmp_path_factory.mktemp("world{}".format(world))))
    return out


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("name", ["roi(1, 4, 1)", "roi(1, 2, 2)",
                                  "binned8(1, 4, 1)", "binned2(1, 4, 1)"])
def test_four_rank_solve(groups, name, ref):
    """The crop's window and m offsets under k and (k, m) sharding, and
    the 8- and 2-bit cell layouts' gathered payload, against the single
    solves."""
    _check_against(groups[4], name, ref)


@pytest.mark.parametrize("name", ["binned8(1, 4, 1)", "binned2(1, 4, 1)"])
def test_gathered_cells_are_the_unsharded_draw(groups, name):
    """The gathered cell words bit for bit the unsharded launch's; the
    shared mask words computed on every rank, not gathered, equal too."""
    jobs, out = groups[4]
    job = jobs[name]
    maps, task = ranks.port_inputs(job["maps"], job["task"])
    want = sample_and_pack_window(torch.as_tensor(job["map_keys"]), maps,
                                  task.alpha_dyn, 8, job["static"]["backend"])[0]
    for r, res in enumerate(out):
        cells, mask, risk = res[name]["payload"]
        assert np.array_equal(cells, want[0].numpy()), r
        assert np.array_equal(mask, want[1].numpy()), r
        assert risk is None and want[2] is None


@pytest.mark.parametrize("name", ["one_rank_cvar3", "one_rank_dynamic",
                                  "one_rank_roi"])
def test_one_rank_equals_single_solve_bitwise(groups, name):
    """A (1, 1, 1) mesh: the sharded solve is the single solve, bit for
    bit (every collective over one rank), and within tolerance of JAX's."""
    jobs, (res,) = groups[1]
    want_u, want_costs = _port_single(jobs[name])
    assert np.array_equal(res[name]["u"], want_u)
    assert np.array_equal(res[name]["costs"], want_costs)
    _check_against(groups[1], name, "jax")


def _ops(groups, mesh):
    jobs, out = groups[4]
    return jobs["ops{}".format(mesh)], out


@pytest.mark.parametrize("numel", OPS_NUMELS)
@pytest.mark.parametrize("mesh", OPS_MESHES, ids=str)
def test_distributed_cvar(groups, mesh, numel):
    """The two-phase top-k over the m group equals the single-device CVaR
    bit for bit (the global worst come out sorted as ``torch.topk`` sorts
    them); alpha 1's all-reduced sums within float32 order.  Both against
    JAX's ``cvar_from_costs`` on the same costs."""
    job, out = _ops(groups, mesh)
    costs = torch.as_tensor(job["costs_km"])
    want = cvar_from_costs(costs, numel).numpy()
    want_jax = np.asarray(jcvar.cvar_from_costs(jnp.asarray(job["costs_km"]),
                                                numel))
    for r, res in enumerate(out):
        got = res["ops{}".format(mesh)]["cvar"][numel]
        ks = res["ops{}".format(mesh)]["ks"]
        if numel < costs.shape[-1]:
            assert np.array_equal(got, want[:, ks]), r
        np.testing.assert_allclose(got, want[:, ks], rtol=1e-6, err_msg=str(r))
        np.testing.assert_allclose(got, want_jax[:, ks], rtol=1e-6,
                                   err_msg=str(r))


@pytest.mark.parametrize("mesh", OPS_MESHES, ids=str)
def test_distributed_dynamic_cvar(groups, mesh):
    """Run-time alpha: the gathered cost slices reduce as one device's, bit
    for bit, and within float32 of JAX's ``cvar_from_costs_dynamic``."""
    job, out = _ops(groups, mesh)
    alpha = job["task"]["cvar_alpha"]
    want = cvar_from_costs_dynamic(torch.as_tensor(job["costs_km"]),
                                   torch.as_tensor(alpha)).numpy()
    want_jax = np.stack([np.asarray(jcvar.cvar_from_costs_dynamic(
        jnp.asarray(job["costs_km"][s]), alpha[s])) for s in range(2)])
    for r, res in enumerate(out):
        got = res["ops{}".format(mesh)]
        assert np.array_equal(got["dynamic"], want[:, got["ks"]]), r
        np.testing.assert_allclose(got["dynamic"], want_jax[:, got["ks"]],
                                   rtol=1e-6, err_msg=str(r))


def _jax_distributed_cvar(costs_km, numel, n_m):
    """JAX's ``cvar_from_costs_distributed`` with the M axis split over
    ``n_m`` CPU devices (``shard_map``), jitted: what each rank returns."""
    M = costs_km.shape[-1]
    mesh = Mesh(np.array(jax.devices()[:n_m]), ("m",))
    fn = shard_map(
        lambda c: jcvar.cvar_from_costs_distributed(c, numel, M, "m"),
        mesh=mesh, in_specs=P(None, None, "m"), out_specs=P(),
        check_vma=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(costs_km)))


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("numel", WIDE_OPS_NUMELS)
@pytest.mark.parametrize("mesh", WIDE_OPS_MESHES, ids=str)
def test_distributed_cvar_equals_jax_bitwise(groups, mesh, numel):
    """At the flagship's M = 1,024 split over the m ranks: the two-phase
    top-k of 33 and 205 worst costs and alpha 1's gathered sums each equal
    JAX's ``cvar_from_costs_distributed`` over the same split bit for bit;
    the pool's (a static count) equal the single-device CVaR too, and
    the run-time alpha's gathered rows JAX's ``cvar_from_costs_dynamic``
    (205 and 33 of 1,024, one a scenario)."""
    jobs, out = groups[4]
    job = jobs["ops_wide{}".format(mesh)]
    costs = job["costs_km"]
    want = _jax_distributed_cvar(costs, numel, mesh[2])
    single = np.asarray(jcvar.cvar_from_costs(jnp.asarray(costs), numel))
    alpha = job["task"]["cvar_alpha"]
    dynamic = np.stack([np.asarray(jax.jit(jcvar.cvar_from_costs_dynamic)(
        jnp.asarray(costs[s]), alpha[s])) for s in range(2)])
    for r, res in enumerate(out):
        got = res["ops_wide{}".format(mesh)]
        ks = got["ks"]
        assert np.array_equal(_bits(got["cvar"][numel]),
                              _bits(want[:, ks])), r
        if numel < costs.shape[-1]:
            assert np.array_equal(_bits(want), _bits(single))
        assert np.array_equal(_bits(got["dynamic"]),
                              _bits(dynamic[:, ks])), r


@pytest.mark.parametrize("mesh", OPS_MESHES, ids=str)
def test_update_over_k_group(groups, mesh):
    """``update_useq(..., group=k)`` on each rank's K rows: the controls of
    the whole update on every rank, its weights this rank's rows."""
    job, out = _ops(groups, mesh)
    t = {k: torch.as_tensor(v) for k, v in job["task"].items()}
    u, w = update_useq(torch.as_tensor(job["costs"]),
                       torch.as_tensor(job["noise"]), torch.as_tensor(job["u"]),
                       t["lambda_weight"], t["vrange"], t["wrange"])
    for r, res in enumerate(out):
        got = res["ops{}".format(mesh)]
        np.testing.assert_allclose(got["u"], u.numpy(), err_msg=str(r),
                                   **U_TOL)
        np.testing.assert_allclose(got["w"], w[:, got["ks"]].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=str(r))


@pytest.mark.parametrize("mesh", OPS_MESHES, ids=str)
def test_m_split_solve_tail_is_the_single_one_bitwise(groups, mesh):
    """The solve's CVaR plus coupling (``cvar_costs``) on the m group's
    gathered pool, static counts below M and a run-time alpha, equals it
    on the whole M axis bit for bit: the pool sorts as the single row."""
    job, out = _ops(groups, mesh)
    t = {k: torch.as_tensor(v) for k, v in job["task"].items()}
    args = (torch.as_tensor(job["costs_km"]), torch.as_tensor(job["noise"]),
            torch.as_tensor(job["u"]), t["u_std"], t["lambda_weight"])
    for r, res in enumerate(out):
        got = res["ops{}".format(mesh)]
        ks = got["ks"]
        for numel, tail in got["tail"].items():
            want = cvar_costs_plain(*args, numel=numel).numpy()
            assert np.array_equal(tail, want[:, ks]), (r, numel)
        want = cvar_costs_plain(*args, alpha=t["cvar_alpha"]).numpy()
        assert np.array_equal(got["tail_dynamic"], want[:, ks]), r


@pytest.mark.parametrize("mesh", [m for m in OPS_MESHES if m[1] == 1],
                         ids=str)
def test_k_split_update_at_one_rank_is_the_kernels_plain_version(groups,
                                                                 mesh):
    """The k-split update's torch ops around the collectives, on a k group
    of one rank: bit for bit the plain version of the update kernel (the
    same tree sums)."""
    job, out = _ops(groups, mesh)
    t = {k: torch.as_tensor(v) for k, v in job["task"].items()}
    u, w = update_useq_plain(torch.as_tensor(job["costs"]),
                             torch.as_tensor(job["noise"]),
                             torch.as_tensor(job["u"]), t["lambda_weight"],
                             t["vrange"], t["wrange"])
    for r, res in enumerate(out):
        got = res["ops{}".format(mesh)]
        assert np.array_equal(got["u"], u.numpy()), r
        assert np.array_equal(got["w"], w.numpy()), r


def _crop_world(bins, seed=0):
    rng = np.random.RandomState(seed)
    S, H, W = 2, 20, 22
    static, maps, task, _ = ranks.build_case(S, B=bins, H=H, W=W, seed=seed)
    maps["obstacle"] = (rng.rand(S, H, W) < 0.15).astype(np.int8)
    maps["unknown"] = (rng.rand(S, H, W) < 0.15).astype(np.int8)
    maps["risk"] = rng.randint(0, 101, (S, H, W)).astype(np.int8)
    task["x0"] = np.array([[3.2, 17.9, 0.1], [15.5, 9.1, 0.2]], np.float32)
    task["alpha_dyn"] = np.array([1.0, 0.6], np.float32)
    return ranks.port_inputs(maps, task)


def _planes(payload):
    return payload if isinstance(payload, tuple) else (payload, None, None)


@pytest.mark.parametrize("risk", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_crop_draw_m_slices(layout, risk):
    """Rows [a, b) of an M-row crop draw equal a crop draw of b - a rows
    at ``m_offset = a`` of the same M, bit for bit: the per-sample planes,
    the grids, the shared words, the window and the shifted limits; for
    one scenario and for two in one call."""
    maps, task = _crop_world(4 if layout == "binned2" else 12)
    keys = torch.tensor([[11, 12], [13, 2 ** 32 - 5]], dtype=torch.int64)
    M, (a, b) = 8, (3, 7)
    for scenario in (0, None):
        if scenario is None:
            args = (keys, maps, task)
        else:
            args = (keys[scenario],
                    type(maps)(*(t[scenario] for t in maps)),
                    type(task)(*(None if t is None else t[scenario]
                                 for t in task)))
        full = sample_and_pack_crop(*args, M, layout, (9, 11), risk=risk)
        part = sample_and_pack_crop(*args, b - a, layout, (9, 11), risk=risk,
                                    m_offset=a, full_num_samples=M)
        cells, mask, riskw = _planes(full[0])
        p_cells, p_mask, p_riskw = _planes(part[0])
        m_axis = -3 if layout == "byte" else -2
        assert torch.equal(cells.narrow(m_axis, a, b - a), p_cells)
        assert (mask is None and p_mask is None) or torch.equal(mask, p_mask)
        assert (riskw is None) == (p_riskw is None)
        if riskw is not None:
            assert torch.equal(riskw, p_riskw)
        for got, want in ((part[1], full[1]), (part[2], full[2])):
            assert torch.equal(got, want.narrow(-3, a, b - a))
        assert torch.equal(part[4], full[4])
        assert torch.equal(part[3].xlim0, full[3].xlim0)
        assert torch.equal(part[3].ylim0, full[3].ylim0)
    assert not torch.equal(part[1], full[1].narrow(-3, 0, b - a))
