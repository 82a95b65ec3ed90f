"""Mean milliseconds of ``solve()``'s copy of the controls to the host
(``mppi.solve.fetch``: the wait for the device's solve, then the copy),
over the profiled slice's solves."""

from perfbench.program_spans import mean_record_ms


def read(ctx):
    return mean_record_ms(ctx, "mppi.solve.fetch")
