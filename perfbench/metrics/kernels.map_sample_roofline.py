"""The map draw's least time over its kernel's device time in the slice,
in per cent (``yardstick.map_sample_least_s``; ``map_sample_kernel``)."""

from perfbench import yardstick
from perfbench.readings import MAP_SAMPLE_KERNELS, share


def read(ctx):
    return share(ctx, yardstick.map_sample_call_least_s, MAP_SAMPLE_KERNELS)
