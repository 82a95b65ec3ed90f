"""What the readers of the program's own spans share.

The program names its host steps with ``mppi_numba_tpu_torch.profiling.
span`` (``mppi.solve.prepare``, ``graphs.replay``, ``device_sim.poll``,
...), which records only while a profiler runs: inside the profiled
slice they are ``user_annotation`` records beside the harness's own
spans, in ``Slice.host``.  A program without a span leaves no record,
and its reading is None.
"""

from __future__ import annotations


def mean_record_ms(ctx, name):
    """Mean milliseconds of the slice's host records named ``name``, or
    None where the slice holds none."""
    if ctx.slice is None:
        return None
    durs = [dur for n, _, dur in ctx.slice.host if n == name]
    return 1e-3 * sum(durs) / len(durs) if durs else None
