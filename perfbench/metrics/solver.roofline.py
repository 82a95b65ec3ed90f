"""The whole solve's least time (the map draw's, the rollout's and the
tail's operations at their rates, or its bytes) over the device time of
the slice's kernels, in per cent (``yardstick.solve_least_s``)."""

from perfbench import yardstick
from perfbench.readings import share


def read(ctx):
    return share(ctx, yardstick.solve_least_s)
