"""Bring-up of the process group: one process a device, on one host or
many; the JAX package's ``mppi_numba_tpu/parallel/multihost.py``.

* ``initialize(...)``: one call a process, ``dist.init_process_group``
  with ``torchrun``'s environment read where no argument is given, NCCL on
  a card (gloo when asked: the CPU, or several ranks sharing one card) and
  a finite timeout, so that a hung rank fails the run instead of holding
  it;
* ``global_mesh(...)``: the ``(scenario, k, m)`` mesh over every rank,
  scenarios across hosts and rollouts across a host's ranks by default;
* ``assert_uniform_static(...)``: every rank's ``SolverStatic``
  fingerprint gathered, and a raise on every rank where one differs,
  before a mismatched solve can hang in a collective or return garbage;
* ``host_local_scenarios(...)``: a rank's own scenarios on its device,
  with their offset in the batch.

``python -m mppi_numba_tpu_torch.parallel.multihost --demo [--mesh-axis k]
[--cpu]`` spawns two ranks (gloo), runs the sharded solve and holds each
scenario against the single solver; under ``torchrun`` without ``--demo``
every rank runs the same check on the process group it is given.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_gather_cat
from .mesh import (MAP_AXIS, ROLLOUT_AXIS, SCENARIO_AXIS, make_mesh,
                   rank_device)

# A collective that waits longer than this raises on every rank.
TIMEOUT = datetime.timedelta(seconds=120)
DEMO_PROCS = 2


def _env(name, value):
    if value is not None:
        return value
    if name not in os.environ:
        raise RuntimeError("multihost.initialize: pass the argument or set "
                           "{} (torchrun sets it)".format(name))
    return os.environ[name]


def initialize(init_method=None, world_size=None, rank=None, backend=None):
    """Join the process group.

    Arguments not given are read from ``torchrun``'s environment:
    ``WORLD_SIZE``, ``RANK`` and ``tcp://MASTER_ADDR:MASTER_PORT``.
    ``backend``: None is NCCL, which needs a card (raises on a host without
    one); pass ``"gloo"`` for CPU ranks or for several ranks sharing one
    card (NCCL takes one rank a card).  An NCCL rank's card is
    ``cuda:(LOCAL_RANK % device_count)``, bound here.
    """
    world_size = int(_env("WORLD_SIZE", world_size))
    rank = int(_env("RANK", rank))
    if init_method is None:
        init_method = "tcp://{}:{}".format(_env("MASTER_ADDR", None),
                                           _env("MASTER_PORT", None))
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass backend='gloo' to run "
                               "on the CPU")
        backend = "nccl"
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT, **kwargs)


def global_mesh(num_scenario_shards=None, num_rollout_shards=None,
                num_map_shards=None, devices=None):
    """A mesh over every rank of the process group.

    Defaults: one scenario shard a host (``WORLD_SIZE / LOCAL_WORLD_SIZE``;
    every rank its own host where ``LOCAL_WORLD_SIZE`` is unset) and the
    rollout axis over a host's ranks, so the per-iteration collectives stay
    within a host.  ``devices`` as for ``mesh.make_mesh``.
    """
    n = dist.get_world_size()
    if num_scenario_shards is None:
        num_scenario_shards = n // int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if num_rollout_shards is None and num_map_shards is None:
        num_rollout_shards = n // num_scenario_shards
    return make_mesh(num_scenario_shards, num_rollout_shards, devices,
                     num_map_shards)


def _static_fingerprint(static) -> np.ndarray:
    """Four uint32 words of the SHA-256 of the ``SolverStatic``'s repr (a
    dataclass: its fields in order)."""
    digest = hashlib.sha256(repr(static).encode()).digest()[:16]
    return np.frombuffer(digest, dtype=np.uint32).copy()


def assert_uniform_static(static, mesh):
    """Raise on EVERY rank if any rank's ``static`` differs from rank 0's.

    Collective: the fingerprints are all-gathered over the process group.
    """
    mine = torch.tensor(_static_fingerprint(static).astype(np.int64),
                        device=rank_device(mesh))
    every = all_gather_cat(mine[None], 0, None).cpu()
    bad = [r for r in range(every.shape[0])
           if not torch.equal(every[r], every[0])]
    if bad:
        raise RuntimeError(
            "SolverStatic mismatch across ranks (rank(s) {} differ from rank "
            "0); every rank must build the same static signature. Local "
            "static: {!r}".format(bad, static))


def _tree_map(fn, x):
    if x is None:
        return None
    if hasattr(x, "_replace"):
        return type(x)(*(_tree_map(fn, f) for f in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, f) for f in x)
    return fn(x)


def host_local_scenarios(mesh, local_leaves):
    """This rank's scenarios on its device, and their offset in the batch.

    ``local_leaves``: tensors or numpy arrays, or NamedTuples and tuples of
    them (``MapInputs``, ``TerrainTask``), each with the leading axis
    ``S_local`` of this rank's scenario shard (the ranks of one shard hold
    the same scenarios).  Collective: checks that every rank holds the same
    number of scenarios, and raises on every rank where one does not.
    Returns ``(leaves on the rank's device, offset)`` where ``offset`` is
    the shard's first scenario, ``my_scenario_shard * S_local``.
    """
    dev = rank_device(mesh)
    counts = set()

    def move(x):
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x).to(dev)
        counts.add(t.shape[0] if t.dim() else None)
        return t

    leaves = _tree_map(move, local_leaves)
    if len(counts) != 1 or None in counts:
        raise ValueError("every leaf needs the same leading scenario axis; "
                         "got leading sizes {}".format(sorted(
                             counts, key=str)))
    count = counts.pop()
    every = all_gather_cat(torch.tensor([count], device=dev), 0, None).cpu()
    if not bool((every == count).all()):
        raise RuntimeError("ranks hold different numbers of scenarios: "
                           "{}".format(every.tolist()))
    return leaves, mesh.get_local_rank(SCENARIO_AXIS) * count


# -- the demo ------------------------------------------------------------------


def _demo_problem(S, K, M=8, T=10, H=13, W=15, B=8, seed=0):
    """``(static, maps, task, u0)`` of S scenarios, numpy leaves: the JAX
    demo's problem (``__graft_entry__._make_problem``), each scenario its
    own start."""
    from ..config import SolverStatic
    from ..types import MapInputs, TerrainTask

    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    qbins = np.linspace(0, 100, B).astype(np.int8)

    def batched(x):
        x = np.asarray(x)
        return np.broadcast_to(x, (S,) + x.shape).copy()

    f32 = np.float32
    maps = MapInputs(
        lin_pmf=batched(pmf), ang_pmf=batched(pmf), lin_qbins=batched(qbins),
        ang_qbins=batched(qbins),
        obstacle=batched((rng.rand(H, W) < 0.05).astype(np.int8)),
        unknown=batched(np.zeros((H, W), np.int8)),
        risk=batched(np.zeros((H, W), np.int8)))
    x0 = np.stack([np.array([2.0 + 0.5 * s, 2.0, 0.3], f32)
                   for s in range(S)])
    task = TerrainTask(
        x0=x0, xgoal=batched(np.array([7.0, 7.0], f32)),
        goal_tolerance=batched(f32(0.5)), v_post_rollout=batched(f32(0.01)),
        lambda_weight=batched(f32(1.0)),
        u_std=batched(np.array([2.0, 3.0], f32)),
        vrange=batched(np.array([0.0, 3.0], f32)),
        wrange=batched(np.array([-3.14, 3.14], f32)),
        dt=batched(f32(0.1)), dist_weight=batched(f32(1.0)),
        obs_penalty=batched(f32(1e5)), unknown_penalty=batched(f32(1e2)),
        alpha_dyn=batched(f32(1.0)), res=batched(f32(1.0)),
        xlim0=batched(f32(-1.0)), ylim0=batched(f32(-1.0)),
        lin_lb=batched(f32(0.0)), lin_ratio=batched(f32(0.01)),
        ang_lb=batched(f32(0.0)), ang_ratio=batched(f32(0.01)))
    static = SolverStatic(mode="tdm", num_steps=T, num_control_rollouts=K,
                          num_grid_samples=M, map_shape=(H, W),
                          num_obstacles=0, cvar_numel=3, num_opt=2,
                          num_vis_state_rollouts=1, backend="eager")
    return static, maps, task, np.zeros((S, T, 2), f32)


def run_worker(mesh_axis="scenario", devices=None):
    """One rank of the demo's check, on the process group as it stands:
    the sharded solve of this rank's scenarios against the single solver
    of the whole batch, from generators of one seed.  Returns the number
    of scenarios checked."""
    from ..solver import TerrainSolver
    from .sharded import get_sharded_terrain_solver

    if mesh_axis == "k":
        # The rollout axis across processes: every per-iteration
        # collective and the map gather cross between them.
        mesh = global_mesh(num_scenario_shards=1, devices=devices)
    else:
        mesh = global_mesh(devices=devices)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_s = sizes[SCENARIO_AXIS]
    S = max(n_s, 2)
    static, maps, task, u0 = _demo_problem(S, 32 * sizes[ROLLOUT_AXIS])
    assert_uniform_static(static, mesh)
    s_local = S // n_s
    lo = mesh.get_local_rank(SCENARIO_AXIS) * s_local
    (l_maps, l_task, l_u0), offset = host_local_scenarios(
        mesh, _tree_map(lambda x: x[lo:lo + s_local], (maps, task, u0)))
    dev = rank_device(mesh)
    solver = get_sharded_terrain_solver(static, mesh)
    u, _ = solver(torch.Generator(device=dev).manual_seed(0), l_maps, l_task,
                  l_u0)

    full = _tree_map(lambda x: torch.as_tensor(x).to(dev), (maps, task, u0))
    u_ref, _ = TerrainSolver(static, dev)(
        torch.Generator(device=dev).manual_seed(0), *full)
    np.testing.assert_allclose(u.cpu().numpy(),
                               u_ref[offset:offset + s_local].cpu().numpy(),
                               rtol=2e-4, atol=2e-5)
    print("[rank {}/{}] mesh {}: sharded solve matches the single solve on "
          "{} local scenarios: OK".format(dist.get_rank(),
                                          dist.get_world_size(),
                                          dict(sizes), s_local), flush=True)
    return s_local


def _demo_rank(rank, world, init_method, mesh_axis, devices):
    torch.set_num_threads(1)
    initialize(init_method, world, rank, backend="gloo")
    try:
        run_worker(mesh_axis, devices)
    finally:
        dist.destroy_process_group()


def demo(num_procs=DEMO_PROCS, mesh_axis="scenario", devices=None):
    """Spawn ``num_procs`` gloo ranks on this host (a file store in a
    temporary directory) and run ``run_worker`` on each; raises if any
    rank fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_demo_rank,
                 args=(num_procs, "file://" + os.path.join(tmp, "store"),
                       mesh_axis, devices),
                 nprocs=num_procs, join=True)
    print("multihost demo: all {} processes OK (mesh axis across "
          "processes: {})".format(num_procs, mesh_axis), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo", action="store_true",
                    help="spawn {} gloo ranks on this host and check the "
                         "sharded solve".format(DEMO_PROCS))
    ap.add_argument("--mesh-axis", choices=("scenario", "k"),
                    default="scenario",
                    help="the mesh axis across processes: 'scenario' (no "
                         "traffic within a solve) or 'k' (every collective "
                         "of a solve crosses between them)")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (default: the card)")
    args = ap.parse_args(argv)
    devices = "cpu" if args.cpu else None
    if args.demo:
        demo(DEMO_PROCS, args.mesh_axis, devices)
        return
    initialize(backend="gloo" if args.cpu else None)
    try:
        run_worker(args.mesh_axis, devices)
    finally:
        dist.destroy_process_group()


__all__ = ["initialize", "global_mesh", "assert_uniform_static",
           "host_local_scenarios", "SCENARIO_AXIS", "ROLLOUT_AXIS",
           "MAP_AXIS"]

if __name__ == "__main__":
    main()
