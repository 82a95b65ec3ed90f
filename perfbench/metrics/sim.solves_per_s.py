"""Scenario solves a second in the batch cells: each call's episodes
times the steps it ran (``steps_run``), over the calls' host seconds,
the profiled calls left out."""


def read(ctx):
    calls = [(n, s) for n, s, profiled in ctx.batch_calls if not profiled]
    secs = sum(s for _, s in calls)
    return sum(n for n, _ in calls) / secs if secs else None
