"""The port's multi-process bring-up (``mppi_numba_tpu_torch.parallel
.multihost``) on the CPU: the static fingerprint, the fail-fast checks on
two gloo ranks, and the two-process demo entry point (the counterpart of
``scripts/multihost_launch.py --demo``)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.parallel import multihost

from tests import torch_parallel_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _static():
    return SolverStatic(mode="tdm", num_steps=10, num_control_rollouts=64,
                        num_grid_samples=8, map_shape=(7, 7),
                        num_obstacles=0, cvar_numel=3, num_opt=1,
                        num_vis_state_rollouts=1)


def test_static_fingerprint_detects_mismatch():
    a = _static()
    fp = multihost._static_fingerprint(a)
    assert fp.dtype == np.uint32 and fp.shape == (4,)
    assert np.array_equal(fp, multihost._static_fingerprint(
        SolverStatic(**dataclasses.asdict(a))))
    for change in (dict(num_control_rollouts=128), dict(backend="byte"),
                   dict(roi_shape=(5, 5))):
        assert not np.array_equal(fp, multihost._static_fingerprint(
            dataclasses.replace(a, **change))), change


def test_initialize_reads_the_environment_and_needs_a_card(monkeypatch):
    """Without arguments or ``torchrun``'s environment it says what is
    missing; NCCL, the default, raises on a host without a card (no quiet
    CPU run).  Neither joins a process group."""
    import torch
    import torch.distributed as dist

    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        multihost.initialize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("file:///nonexistent", 1, 0)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    static, maps, task, u0 = ranks.build_case(2)
    jobs = {"static": dict(kind="static", mesh=(1, 2, 1), static=static),
            "capture": dict(kind="capture", mesh=(1, 2, 1), static=static,
                            maps=maps, task=task, u0=u0)}
    return ranks.run_group(2, jobs, tmp_path_factory.mktemp("two"))


def test_assert_uniform_static_raises_on_every_rank(two_ranks):
    for res in two_ranks:
        assert res["static"]["same"] is None
        assert "SolverStatic mismatch" in res["static"]["differ"]
        assert "rank(s) [1]" in res["static"]["differ"]


def test_host_local_scenarios_checks_counts_and_places(two_ranks):
    """Unequal scenario counts raise on every rank; equal ones come back
    on the rank's device with the scenario shard's offset (a (1, 2) mesh:
    one scenario shard, offset 0 on both ranks)."""
    for r, res in enumerate(two_ranks):
        assert "different numbers of scenarios" in res["static"]["counts"]
        assert res["static"]["offset"] == 0
        assert np.array_equal(res["static"]["leaf"], np.full((2, 3), r))


def test_make_mesh_refuses_meshes_that_miss_ranks(two_ranks):
    for res in two_ranks:
        assert "does not cover" in res["static"]["uncovered"]
        assert "not divisible" in res["static"]["indivisible"]


def test_default_meshes(two_ranks):
    """``balanced_mesh`` on 2 ranks: one scenario shard, two rollout
    shards; ``global_mesh`` without ``LOCAL_WORLD_SIZE``: every rank its
    own host, so one scenario shard a rank."""
    for res in two_ranks:
        assert res["static"]["balanced"] == (1, 2, 1)
        assert res["static"]["global"] == (2, 1, 1)


def test_capture_refuses_gloo_and_checks_shapes_on_every_rank(two_ranks):
    """``ShardedTerrainSolver.capture`` on a gloo CPU mesh raises on every
    rank, naming NCCL and the backend, with no fallback; the capture's
    shape agreement raises on both ranks when one rank's ``u0`` is off."""
    for res in two_ranks:
        msg = res["capture"]["capture"]
        assert msg is not None and "only on an NCCL mesh" in msg
        assert "gloo" in msg and "cpu" in msg
        assert "one S_local on every rank" in res["capture"]["agree"]


def test_sharded_solver_cache_follows_the_process_group(tmp_path):
    """A mesh of the same shape on a later process group (after
    ``destroy_process_group``) compares equal to the first; the cached
    sharded solver must not hand back the first one's dead groups."""
    import torch
    import torch.distributed as dist

    from mppi_numba_tpu_torch.parallel.mesh import ROLLOUT_AXIS, make_mesh
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver)

    static, maps, task, u0 = ranks.build_case(1)
    static = SolverStatic(**static)
    maps, task, u0 = ranks.port_inputs(maps, task, u0)
    solvers = []
    for i in range(2):
        multihost.initialize("file://{}".format(tmp_path / "s{}".format(i)),
                             1, 0, backend="gloo")
        try:
            mesh = make_mesh(1, 1, devices="cpu")
            solver = get_sharded_terrain_solver(static, mesh)
            assert get_sharded_terrain_solver(static, mesh) is solver
            assert solver.k_group is mesh.get_group(ROLLOUT_AXIS)
            u, _ = solver(torch.Generator().manual_seed(0), maps, task, u0)
            assert torch.isfinite(u).all()
            solvers.append(solver)
        finally:
            dist.destroy_process_group()
    assert solvers[0] is not solvers[1]


@pytest.mark.parametrize("mesh_axis", ["scenario", "k"])
def test_two_process_demo(mesh_axis):
    """``python -m mppi_numba_tpu_torch.parallel.multihost --demo --cpu``:
    two spawned gloo ranks, the sharded solve held against the single
    solve on each; ``--mesh-axis k`` puts one solve's rollouts across the
    processes, so every collective of the solve crosses between them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "mppi_numba_tpu_torch.parallel.multihost",
         "--demo", "--cpu", "--mesh-axis", mesh_axis],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all 2 processes OK" in proc.stdout
    assert proc.stdout.count("sharded solve matches the single solve") == 2
