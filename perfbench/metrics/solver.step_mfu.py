"""The whole solve's least time over the profiled slice's length, in per
cent: the step's share of the card's peak, idle time included."""

from perfbench import yardstick
from perfbench.readings import step_mfu


def read(ctx):
    return step_mfu(ctx, yardstick.solve_least_s)
