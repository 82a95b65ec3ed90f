"""Mean host milliseconds of ``MPPIPlanner.solve()`` in the closed loop:
the span around each call outside the profiled slice (task upload,
graph replay, copy of the controls to the host)."""

from perfbench.readings import mean_ms


def read(ctx):
    return mean_ms(ctx, "planner.solve")
