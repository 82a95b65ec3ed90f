"""Mean milliseconds of the planner's preparation inside ``solve()``
(``mppi.solve.prepare``: the solve conditions, the ``SolverStatic``, the
map inputs, the solver and the graph lookup, before the replay), over the
profiled slice's solves."""

from perfbench.program_spans import mean_record_ms


def read(ctx):
    return mean_record_ms(ctx, "mppi.solve.prepare")
