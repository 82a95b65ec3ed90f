"""Profiling and timing utilities: the JAX package's ``profiling.py`` for
PyTorch.

* ``span``: names a stretch of the port's host work for
  ``torch.profiler``.  While a profiler records (``trace`` below, or any
  ``torch.profiler.profile``), ``span(name)`` is a
  ``torch.profiler.record_function``: a ``user_annotation`` record in the
  same trace as the kernels, on the same clock, whose parent is the span
  around it on the same thread; a span's count is the number of its
  records.  Each then costs tens of microseconds of host time, and a CUDA
  graph's launch reads several times longer under CUDA activity, so a
  profiled stretch runs slower than an unprofiled one.  While none
  records, a span is one shared do-nothing context (a flag read and a
  ``with``: under a microsecond).  The planner
  (``mppi.solve``, ``mppi.solve.prepare``, ``mppi.solve.fetch``,
  ``mppi.update``, ``mppi.update.upload``, ``mppi.set_params``), the graphs
  (``graphs.replay``, ``graphs.capture``) and the device simulator
  (``device_sim.load``, ``device_sim.poll``, ``device_sim.result``) name
  their steps this way.  An operator reads them by wrapping a loop in
  ``trace()`` and opening its ``trace.json`` (Perfetto, or
  ``chrome://tracing``), or by reading ``key_averages()`` of their own
  ``torch.profiler.profile``.
* ``trace``: ``torch.profiler`` around a block, writing a Chrome trace
  file (per-kernel device time where a card is present; the spans above
  beside the kernels).
* ``chained_solve_time`` and ``chained_kernel_time``: per-call latency
  from chains of calls, each fed the last one's output, so that nothing
  overlaps and the host need not wait inside the chain: timed with CUDA
  events on a card, with ``time.perf_counter`` on the CPU.
* ``device_liveness_probe`` and ``measure_fetch_rtt``: is the card
  answering, and what does one round trip to it cost.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# Where ``trace`` writes by default: the repository's build directory.
DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[1] / "build" / "trace"


# What ``span`` returns while no profiler records: one context, shared.
_OFF = contextlib.nullcontext()


def span(name):
    """A context naming a stretch of host work ``name`` in a profiler's
    trace: ``torch.profiler.record_function(name)`` while a profiler
    records (``torch.autograd.profiler._is_profiler_enabled``, which
    ``torch.profiler.profile`` sets while it runs), else a shared context
    that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir=DEFAULT_TRACE_DIR):
    """Profile a block with ``torch.profiler`` (the CPU, and the card's
    kernels where one is present) and write its Chrome trace to
    ``log_dir/trace.json``.  Yields ``log_dir``.  The port's ``span``
    records of the block are in the trace, as ``user_annotation`` events
    beside the kernels: wrap a control loop in it to see where its host
    time goes."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _time_chain(run, device):
    """``(seconds, enqueue seconds)`` of ``run()``: on a card the device's
    time between CUDA events around it and the host's time to enqueue it;
    on the CPU both the host's time."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        run()
        total = time.perf_counter() - t0
        return total, total
    with torch.cuda.device(device):     # events on the device's stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        t0 = time.perf_counter()
        run()
        enqueue = time.perf_counter() - t0
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3, enqueue


def chained_solve_time(solve_fn, maps, task, u0, num_iters=30,
                       generator=None, fetch_rtt_s=0.0, with_enqueue=False):
    """Per-solve latency of a receding-horizon chain, in seconds.

    ``solve_fn(generator, maps, task, u) -> (u_new, aux)`` (a
    ``TerrainSolver``, or a ``SolveGraph`` with the generator it was
    captured with) runs ``num_iters`` times, solve i + 1 fed solve i's
    controls, from zeros, after one warm chain from ``u0``; the total over
    ``num_iters``.  On a card the device's time between CUDA events (no
    host sync inside the chain), on the CPU the host's.  ``fetch_rtt_s``
    is subtracted from the total.  With ``with_enqueue``: ``(seconds,
    host enqueue seconds)`` per solve.
    """
    if generator is None:
        generator = torch.Generator(device=u0.device).manual_seed(0)

    def chain(u):
        for _ in range(num_iters):
            u, _ = solve_fn(generator, maps, task, u)
        return u

    chain(u0)
    _sync(u0.device)
    total, enqueue = _time_chain(lambda: chain(torch.zeros_like(u0)),
                                 u0.device)
    per_solve = (total - fetch_rtt_s) / num_iters
    return (per_solve, enqueue / num_iters) if with_enqueue else per_solve


def chained_kernel_time(kernel_fn, v0, num_iters=20, reps=3,
                        fetch_rtt_s=0.0):
    """Per-call latency of one kernel in milliseconds, best of ``reps``.

    ``kernel_fn(v) -> costs`` runs ``num_iters`` times, each input
    depending on the last output (``v + min(costs) * 1e-30``), so the
    calls run one after another; timed as ``chained_solve_time`` times,
    ``fetch_rtt_s`` subtracted from each rep's total.
    """
    def chain(v):
        for _ in range(num_iters):
            v = v + torch.min(kernel_fn(v)) * 1e-30
        return v

    chain(v0)
    _sync(v0.device)
    best = np.inf
    for rep in range(reps):
        total, _ = _time_chain(lambda: chain(v0 + 1e-6 * rep), v0.device)
        best = min(best, (total - fetch_rtt_s) / num_iters)
    return 1000.0 * best


def device_liveness_probe(deadline_s=75.0):
    """Whether the card answers a trivial computation within a deadline.

    Runs ``torch.ones(8, 8, device="cuda").sum().item()`` in a
    subprocess (killed at the deadline, so a hung card leaves no process
    behind).  Returns ``(alive: bool, detail: str)``.
    """
    code = ("import torch; "
            "print(torch.ones(8, 8, device='cuda').sum().item())")
    try:
        r = subprocess.run([sys.executable, "-c", code], timeout=deadline_s,
                           capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return False, "liveness probe timed out after {:.0f} s".format(
            deadline_s)
    if r.returncode != 0:
        tail = (r.stderr or "").strip().splitlines()
        return False, "liveness probe exited rc={}: {}".format(
            r.returncode, tail[-1] if tail else "no stderr")
    return True, "ok"


def measure_fetch_rtt(n=5, device="cuda"):
    """The host's round trip to ``device``, in seconds: the median time of
    a small op whose result is copied back to the host."""
    x = torch.zeros((8,), dtype=torch.float32, device=device)
    (x * 1.0).cpu()
    ts = []
    for i in range(n):
        t0 = time.perf_counter()
        (x + float(i)).cpu()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
