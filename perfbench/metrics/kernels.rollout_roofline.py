"""The rollout's least time over its kernels' device time in the slice,
in per cent (``yardstick.rollout_call_least_s``; the byte and binned
rollout kernels by name)."""

from perfbench import yardstick
from perfbench.readings import ROLLOUT_KERNELS, share


def read(ctx):
    return share(ctx, yardstick.rollout_call_least_s, ROLLOUT_KERNELS)
