"""Per cent of the profiled slice in which no device operation ran."""

from perfbench.readings import idle_share


def read(ctx):
    return idle_share(ctx)
