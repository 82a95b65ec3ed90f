"""What the examples share: their arguments (``--device``, ``--small``,
``--out-dir``), the closed loop of the scripts that step the robot
themselves, host-clock solve timing, figures only where matplotlib
imports, and the JSON lines they print after the card line."""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np

from ..drivers import _common as dc

# Figures go here unless ``--out-dir`` names another directory; never into
# the repository's ``examples/``, whose media are the JAX scripts'.
OUT_DIR = os.path.join("build", "examples_torch")
# ``--small``: the drivers' sizes (K the least a ``Config`` keeps, M kept
# at 1 where the solve rolls one map), and a closed loop of a few steps.
SMALL_K = dc.SMALL_CONFIG_K
SMALL_M, SMALL_T, SMALL_STEPS = dc.SMALL_M, dc.SMALL_T, dc.SMALL_STEPS


def parser(doc):
    """The example's argument parser: ``--device``, ``--small`` and
    ``--out-dir``; the module adds its own."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    dc.add_device_arg(ap)
    ap.add_argument("--small", action="store_true",
                    help="K = {}, M = {} (1 where the solve rolls one map), "
                         "T = {} steps and {} closed-loop steps: a quick run, "
                         "e.g. with --device cpu".format(
                             SMALL_K, SMALL_M, SMALL_T, SMALL_STEPS))
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="directory for figures (default: %(default)s)")
    return ap


def sizes(small, K, M, T, dt, steps):
    """``(K, M, T in seconds, closed-loop steps)``: the example's own, or
    ``--small``'s."""
    if not small:
        return K, M, T, steps
    return SMALL_K, SMALL_M if M > 1 else 1, SMALL_T * dt, SMALL_STEPS


class TimedPlanner:
    """A planner whose ``solve()`` calls are timed on the host clock.  A
    solve hands back host controls, so each time ends with the device's
    work (a graph replay on a card, eager on the CPU)."""

    def __init__(self, planner):
        self.planner, self.solve_ms = planner, []

    def __getattr__(self, name):
        return getattr(self.planner, name)

    def solve(self):
        t0 = time.perf_counter()
        u = self.planner.solve()
        self.solve_ms.append(1e3 * (time.perf_counter() - t0))
        return u


def closed_loop(planner, step, x0, xgoal, tol, dt, max_steps, on_step=None,
                stop_at_goal=True):
    """The scripts' own loop: solve, ``on_step(t, states)`` (the states so
    far), ``x = step(x, u)``, shift and update, and stop within ``tol`` of
    the goal (``stop_at_goal``).  Returns ``(states (n+1, 3), controls
    (n, 2), outcome)``, the outcome in ``sim.trial``'s keys and its
    convention (time to goal ``(t + 1) * dt``), with the steps run."""
    states = [np.asarray(x0, dtype=float).copy()]
    controls = []
    reached = None
    for t in range(max_steps):
        useq = planner.solve()
        if on_step is not None:
            on_step(t, states)
        x = step(states[-1], useq[0])
        states.append(x)
        controls.append(useq[0])
        planner.shift_and_update(x, useq, num_shifts=1)
        dist = float(np.linalg.norm(x[:2] - xgoal)) - tol
        if reached is None and dist <= 0:
            reached = t
            if stop_at_goal:
                break
    ok = reached is not None
    return np.array(states), np.array(controls), dict(
        success=ok, time_to_goal=(reached + 1) * dt if ok else None,
        dist_to_goal=None if ok else dist, steps=len(states) - 1)


def jsonable(value):
    """``value`` with numpy scalars and arrays made plain and every
    non-finite float made None (strict JSON has no NaN)."""
    if isinstance(value, dict):
        return {k: jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, np.ndarray)):
        return [jsonable(v) for v in value]
    if isinstance(value, (np.bool_, bool)):
        return bool(value)
    if isinstance(value, (np.integer, int)):
        return int(value)
    if isinstance(value, (np.floating, float)):
        return float(value) if math.isfinite(value) else None
    return value


def clock(device):
    """How ``TimedPlanner`` times on ``device``."""
    return ("host clock, CUDA-graph replays" if device.type == "cuda"
            else "host clock, eager (cpu)")


def solve_times(solve_ms, device):
    """The first solve (it captures the graphs on a card) apart from the
    median of the rest, ms, and the clock."""
    rest = solve_ms[1:] or solve_ms
    return dict(first=solve_ms[0], median=float(np.median(rest)),
                solves=len(solve_ms), clock=clock(device))


def graphs(planner):
    """The planner's CUDA graphs: solve and vis graphs held, and a solve
    graph's kernels and wrapper launches a replay (None on the CPU)."""
    solve = list(planner._solve_graphs.values())
    return dict(solve_graphs=len(solve), vis_graphs=len(planner._vis_graphs),
                kernel_nodes=solve[0].kernel_nodes if solve else None,
                captured_launches=(solve[0].captured_launches if solve
                                   else None))


def describe(example, mode, planner, **extra):
    """The line that says what runs: the solver's shape and its layout
    (``solver.resolve_backend``)."""
    from ..solver import resolve_backend

    s = planner._static()
    dc.emit(jsonable(dict(
        example=example, mode=mode,
        backend=resolve_backend(s, planner.device),
        solver_mode=s.mode, K=s.num_control_rollouts, M=s.num_grid_samples,
        T=s.num_steps, map=list(s.map_shape), roi=s.roi_shape,
        num_pmf_bins=s.num_pmf_bins, **extra)))


def final(states, truth=None):
    """Where a closed loop ended: the last state, and the realized
    tractions there (a robot that stalls on a cell of near-zero traction
    misses its goal)."""
    x = states[-1]
    out = dict(final_state=x)
    if truth is not None:
        out["final_traction"] = truth.get(x[0], x[1])
    return out


def report(example, mode, planner, timed, outcome, before, device,
           **extra):
    """The outcome line: the outcome, solve times, the kernel launches
    since ``before`` (``drivers._common.launch_counts()``) and the
    graphs."""
    dc.emit(jsonable(dict(
        example=example, mode=mode, outcome=outcome,
        solve_ms=solve_times(timed.solve_ms, device),
        launches=dc.launched_since(before), **graphs(planner), **extra)))


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    does not import."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def out_path(out_dir, name):
    """``out_dir/name``, the directory made."""
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, name)
