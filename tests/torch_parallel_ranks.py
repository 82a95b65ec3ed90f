"""The ranks of the port's parallel tests: gloo process groups on the CPU,
spawned from a test module, importing neither JAX nor the JAX package.

A test module builds a list of jobs (numpy inputs, JAX's draws injected
where it compares with JAX), and ``run_group`` spawns ``world`` ranks that
run every job in order and write their results; the module then asserts
each case in a test of its own.  One group a (test file, world size)
keeps the spawn and the process group's set-up to once a file.

Every rank pins torch to one thread (eight ranks of eight threads on eight
cores starve each other) and joins through a file store in the test's
temporary directory (fixed ports collide between xdist workers).
"""

from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

F32 = np.float32
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather",
               "broadcast", "reduce_scatter_tensor", "reduce_scatter",
               "all_to_all_single", "all_to_all", "reduce", "gather",
               "scatter", "send", "recv", "barrier")


def build_case(S, K=64, M=8, T=10, B=5, H=8, W=8, seed=0, mode="tdm",
               cvar_numel=None, lam=1.0):
    """``tests/test_sharding.py::build_case`` in numpy: ``(static fields,
    maps, task, u0)``, the maps and the task as dicts of ``(S, ...)``
    arrays in the field order of ``MapInputs`` / ``TerrainTask``."""
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 100, size=(S, B, H, W)).astype(float)
    pmf = (raw / raw.sum(1, keepdims=True) * 100).astype(np.int8)
    pmf[:, -1] = 100 - pmf[:, :-1].sum(1)
    qbins = np.linspace(0, 100, B).astype(np.int8)
    zeros = np.zeros((S, H, W), np.int8)
    maps = dict(lin_pmf=pmf, ang_pmf=pmf.copy(),
                lin_qbins=np.broadcast_to(qbins, (S, B)).copy(),
                ang_qbins=np.broadcast_to(qbins, (S, B)).copy(),
                obstacle=zeros, unknown=zeros.copy(), risk=zeros.copy())

    def batch(x):
        x = np.asarray(x, F32)
        return np.broadcast_to(x, (S,) + x.shape).copy()

    task = dict(
        x0=batch([2.0, 2.0, 0.3]), xgoal=batch([6.0, 6.0]),
        goal_tolerance=batch(0.4), v_post_rollout=batch(0.3),
        lambda_weight=batch(lam), u_std=batch([1.0, 1.5]),
        vrange=batch([0.0, 2.0]), wrange=batch([-3.0, 3.0]),
        dt=batch(0.1), dist_weight=batch(1.5), obs_penalty=batch(1e4),
        unknown_penalty=batch(1e2), alpha_dyn=batch(1.0), res=batch(1.0),
        xlim0=batch(0.0), ylim0=batch(0.0), lin_lb=batch(0.0),
        lin_ratio=batch(0.01), ang_lb=batch(0.0), ang_ratio=batch(0.01),
        cvar_alpha=batch(1.0))
    static = dict(mode=mode, num_steps=T, num_control_rollouts=K,
                  num_grid_samples=M, map_shape=(H, W), num_obstacles=0,
                  cvar_numel=M if cvar_numel is None else cvar_numel,
                  num_opt=2, num_vis_state_rollouts=1, backend="eager")
    return static, maps, task, np.zeros((S, T, 2), F32)


def port_inputs(maps, task, u0=None, rows=slice(None)):
    """The port's ``MapInputs`` / ``TerrainTask`` (and u0) of the dicts
    ``build_case`` gives, scenarios ``rows``, on the CPU."""
    from mppi_numba_tpu_torch.types import MapInputs, TerrainTask

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x[rows]))

    out = (MapInputs(**{k: t(v) for k, v in maps.items()}),
           TerrainTask(**{k: t(v) for k, v in task.items()}))
    return out if u0 is None else out + (t(u0),)


@contextlib.contextmanager
def counted_collectives(calls):
    """Append ``(name, op, group ranks)`` to ``calls`` for every
    ``torch.distributed`` collective made inside the block."""
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            group = kwargs.get("group")
            ranks = tuple(dist.get_process_group_ranks(group)
                          if group is not None
                          else range(dist.get_world_size()))
            op = kwargs.get("op")
            calls.append((name, None if op is None else str(op), ranks))
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _meshes():
    """Meshes by shape, made once a group (``new_group`` is collective)."""
    from mppi_numba_tpu_torch.parallel.mesh import make_mesh

    made = {}

    def get(shape):
        if shape not in made:
            s, k, m = shape
            made[shape] = make_mesh(s, k, devices="cpu", num_map_shards=m)
        return made[shape]

    return get


def _numpy(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_numpy(f) for f in x)
    return x.cpu().numpy()


def _solve_job(job, mesh_of):
    from mppi_numba_tpu_torch.config import SolverStatic
    from mppi_numba_tpu_torch.parallel.sharded import (
        gather_scenarios, get_sharded_terrain_solver)

    mesh = mesh_of(job["mesh"])
    static = SolverStatic(**job["static"])
    solver = get_sharded_terrain_solver(static, mesh)
    S = job["u0"].shape[0]
    s_local = S // job["mesh"][0]
    rows = slice(solver.my_s * s_local, (solver.my_s + 1) * s_local)
    maps, task, u0 = port_inputs(job["maps"], job["task"], job["u0"], rows)
    map_keys = torch.as_tensor(job["map_keys"])
    eps = [torch.as_tensor(e) for e in job["eps"]]
    calls = []
    with counted_collectives(calls):
        u, costs = solver.solve_from_key(map_keys, eps, maps, task, u0)
    packed, _ = solver.sample_payload(map_keys, maps, task)
    return dict(u=_numpy(u), costs=_numpy(costs), rows=rows,
                ks=slice(solver.k0, solver.k0 + solver.k_local),
                ms=solver.m_slice, payload=_numpy(packed), calls=calls,
                u_all=_numpy(gather_scenarios(mesh, u)),
                cached=get_sharded_terrain_solver(static, mesh) is solver)


def _ops_job(job, mesh_of):
    """``update_useq`` over the k group and the distributed CVaRs over the
    m group, each rank on its (K, M) block of the same costs."""
    from mppi_numba_tpu_torch.ops.cvar import (
        cvar_from_costs_distributed, cvar_from_costs_dynamic_distributed,
        cvar_pool)
    from mppi_numba_tpu_torch.ops.kernels.cvar_costs import cvar_costs
    from mppi_numba_tpu_torch.ops.update import update_useq
    from mppi_numba_tpu_torch.parallel.collectives import all_gather_cat
    from mppi_numba_tpu_torch.parallel.mesh import (MAP_AXIS, ROLLOUT_AXIS)

    mesh = mesh_of(job["mesh"])
    _, n_k, n_m = job["mesh"]
    costs_km = torch.as_tensor(job["costs_km"])
    S, K, M = costs_km.shape
    k, m = mesh.get_local_rank(ROLLOUT_AXIS), mesh.get_local_rank(MAP_AXIS)
    ks = slice(k * K // n_k, (k + 1) * K // n_k)
    ms = slice(m * M // n_m, (m + 1) * M // n_m)
    k_group, m_group = mesh.get_group(ROLLOUT_AXIS), mesh.get_group(MAP_AXIS)
    block = costs_km[:, ks, ms]
    t = {name: torch.as_tensor(v) for name, v in job["task"].items()}
    out = dict(ks=ks, ms=ms, cvar={})
    for numel in job["numels"]:
        out["cvar"][numel] = _numpy(cvar_from_costs_distributed(
            block, numel, M, m_group))
    out["dynamic"] = _numpy(cvar_from_costs_dynamic_distributed(
        block, t["cvar_alpha"], m_group))
    noise = torch.as_tensor(job["noise"])[:, ks]
    # The solve's CVaR plus coupling (cvar_costs, its plain version on CPU
    # tensors) on the m group's pool: the candidates of a static count,
    # the whole rows of a run-time alpha.
    coupling = (noise, torch.as_tensor(job["u"]), t["u_std"],
                t["lambda_weight"])
    out["tail"] = {numel: _numpy(cvar_costs(
        cvar_pool(block, numel, m_group), *coupling, numel=numel))
        for numel in job["numels"] if numel < M}
    out["tail_dynamic"] = _numpy(cvar_costs(
        all_gather_cat(block, -1, m_group), *coupling,
        alpha=t["cvar_alpha"]))
    u, w = update_useq(torch.as_tensor(job["costs"])[:, ks], noise,
                       torch.as_tensor(job["u"]), t["lambda_weight"],
                       t["vrange"], t["wrange"], group=k_group)
    out.update(u=_numpy(u), w=_numpy(w))
    return out


def _trial_job(job, mesh_of):
    from mppi_numba_tpu_torch.config import SolverStatic
    from mppi_numba_tpu_torch.parallel.sharded import make_sharded_trial_batch

    mesh = mesh_of(job["mesh"])
    maps, task = port_inputs(job["maps"], job["task"])
    batch = make_sharded_trial_batch(SolverStatic(**job["static"]),
                                     job["max_steps"], mesh)
    res = batch(torch.Generator().manual_seed(job["seed"]), maps, task,
                *(torch.as_tensor(g) for g in job["gt"]))
    return {name: _numpy(f) for name, f in res._asdict().items()}


def _static_job(job, mesh_of):
    """``assert_uniform_static`` on statics that rank 1 changes, and
    ``host_local_scenarios`` on scenario counts that rank 1 changes: what
    each rank raised (None where it did not)."""
    from mppi_numba_tpu_torch.config import SolverStatic
    from mppi_numba_tpu_torch.parallel import multihost

    mesh = mesh_of(job["mesh"])
    rank = dist.get_rank()
    static = SolverStatic(**job["static"])
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except (RuntimeError, ValueError) as e:
            out[name] = "{}: {}".format(type(e).__name__, e)

    from mppi_numba_tpu_torch.parallel.mesh import balanced_mesh, make_mesh

    out["balanced"] = tuple(balanced_mesh(devices="cpu").shape)
    out["global"] = tuple(multihost.global_mesh(devices="cpu").shape)
    attempt("same", lambda: multihost.assert_uniform_static(static, mesh))
    attempt("uncovered", lambda: make_mesh(2, 2, devices="cpu"))
    attempt("indivisible", lambda: make_mesh(3, devices="cpu"))
    changed = SolverStatic(**dict(job["static"], num_control_rollouts=(
        job["static"]["num_control_rollouts"] * (2 if rank == 1 else 1))))
    attempt("differ", lambda: multihost.assert_uniform_static(changed, mesh))
    local = (np.zeros((2 + (rank == 1), 3), F32),)
    attempt("counts", lambda: multihost.host_local_scenarios(mesh, local))
    (leaves,), offset = multihost.host_local_scenarios(
        mesh, (np.full((2, 3), rank, F32),))
    out["offset"] = offset
    out["leaf"] = _numpy(leaves)
    return out


def _capture_job(job, mesh_of):
    """``ShardedTerrainSolver.capture`` on this gloo CPU mesh (it must
    refuse, naming why), and the capture's agreement on input shapes with
    rank 1's ``u0`` one step short: what each rank raised."""
    from mppi_numba_tpu_torch.config import SolverStatic
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver)

    mesh = mesh_of(job["mesh"])
    solver = get_sharded_terrain_solver(SolverStatic(**job["static"]), mesh)
    maps, task, u0 = port_inputs(job["maps"], job["task"], job["u0"])
    out = {}
    try:
        solver.capture(torch.Generator().manual_seed(0), maps, task, u0)
        out["capture"] = None
    except RuntimeError as e:
        out["capture"] = str(e)
    if dist.get_rank() == 1:
        u0 = u0[:, 1:]
    try:
        solver._agree_on_inputs(maps, task, u0)
        out["agree"] = None
    except ValueError as e:
        out["agree"] = str(e)
    return out


def _scaling_job(job, mesh_of):
    """``drivers.scaling_bench`` on this process group (``job["argv"]``):
    its records and what it printed."""
    import io

    from mppi_numba_tpu_torch.drivers import scaling_bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        records = scaling_bench.run(scaling_bench.parse_args(job["argv"]))
    return dict(records=records, stdout=out.getvalue())


JOBS = {"solve": _solve_job, "ops": _ops_job, "trial": _trial_job,
        "static": _static_job, "scaling": _scaling_job,
        "capture": _capture_job}


def _rank(rank, world, store, jobs_path, out_dir):
    from mppi_numba_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize("file://" + store, world, rank, backend="gloo")
    try:
        with open(jobs_path, "rb") as f:
            jobs = pickle.load(f)
        mesh_of = _meshes()
        results = {name: JOBS[job["kind"]](job, mesh_of)
                   for name, job in jobs.items()}
        with open(os.path.join(out_dir, "rank{}.pkl".format(rank)),
                  "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_group(world, jobs, tmp_dir):
    """Spawn ``world`` gloo ranks that run ``jobs`` (``{name: job}``, each
    ``job["kind"]`` a key of ``JOBS``) in order; returns ``[{name: result}
    for each rank]``.  A rank that fails raises here."""
    import torch.multiprocessing as mp

    tmp_dir = str(tmp_dir)
    jobs_path = os.path.join(tmp_dir, "jobs.pkl")
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    mp.spawn(_rank, args=(world, os.path.join(tmp_dir, "store"), jobs_path,
                          tmp_dir), nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, "rank{}.pkl".format(rank)),
                  "rb") as f:
            out.append(pickle.load(f))
    return out
