"""The port's profiling helpers on the CPU: ``chained_solve_time`` times a
real chain of solves, ``chained_kernel_time`` a chain of calls, and
``trace`` writes a trace file."""

import json

import numpy as np
import torch

from bench import build_flagship
from mppi_numba_tpu_torch import profiling
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.convert import to_port
from mppi_numba_tpu_torch.solver import get_terrain_solver

K, M, T = 32, 4, 5


def _solver_and_inputs():
    jstatic, maps, task = build_flagship(K=K, M=M, T=T)
    fields = {f: getattr(jstatic, f) for f in jstatic.__dataclass_fields__}
    fields["backend"] = "eager"
    t_maps, t_task, u0 = to_port(maps, task, np.zeros((T, 2), np.float32),
                                 "cpu")
    return get_terrain_solver(SolverStatic(**fields), "cpu"), t_maps, t_task, u0


def test_chained_solve_time_is_finite_and_positive():
    solver, maps, task, u0 = _solver_and_inputs()
    calls = []

    def solve_fn(generator, m, t, u):
        calls.append(u)
        return solver(generator, m, t, u)

    s = profiling.chained_solve_time(solve_fn, maps, task, u0, num_iters=3)
    assert np.isfinite(s) and s > 0
    # A warm chain from u0, then a chain from zeros; each solve is fed the
    # last one's controls.
    assert len(calls) == 6 and calls[0] is u0
    assert torch.equal(calls[3], torch.zeros_like(u0))
    per, enqueue = profiling.chained_solve_time(
        solver, maps, task, u0, num_iters=2, with_enqueue=True)
    assert per > 0 and enqueue > 0


def test_chained_kernel_time_is_finite_and_positive():
    ms = profiling.chained_kernel_time(lambda v: v * v + 1.0,
                                       torch.ones(64), num_iters=4, reps=2)
    assert np.isfinite(ms) and ms > 0


def test_trace_writes_a_file(tmp_path):
    solver, maps, task, u0 = _solver_and_inputs()
    with profiling.trace(tmp_path / "trace") as log_dir:
        solver(torch.Generator().manual_seed(0), maps, task, u0)
    path = log_dir / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_fetch_rtt_on_the_cpu():
    assert profiling.measure_fetch_rtt(n=3, device="cpu") >= 0
