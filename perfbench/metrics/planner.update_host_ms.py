"""Mean host milliseconds of ``MPPIPlanner.shift_and_update()`` in the
closed loop (an episode's first step: ``set_params`` and the controls'
reset): the span around each call outside the profiled slice."""

from perfbench.readings import mean_ms


def read(ctx):
    return mean_ms(ctx, "planner.update")
