"""Kernel records in the profiled slice a graph replay (a count): what
one batched episode step launches on the device, torch's own kernels
included."""

from perfbench.readings import kernels_per_call


def read(ctx):
    return kernels_per_call(ctx)
