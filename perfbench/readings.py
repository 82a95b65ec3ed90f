"""What the per-layer readers share: sums over the profiled slice.

A reader (``metrics/<name>.py``) gets one context: ``spans`` (host
spans), ``slice`` (the profiled ``trace.Slice``, or None),
``slice_work`` (``[(scenario solves, shape)]`` run inside the slice),
``slice_calls`` (solve calls or graph replays inside the slice) and
``batch_calls`` (``[(scenario solves, seconds, profiled)]`` a batch
call).  A reading that finds nothing to read is None.
"""

from __future__ import annotations

ROLLOUT_KERNELS = ("rollout_byte_kernel", "rollout_binned_kernel")
MAP_SAMPLE_KERNELS = ("map_sample_kernel",)


def kernel_seconds(ctx, names=None):
    """Device seconds of the slice's kernels (those whose name holds one
    of ``names``), or None where the trace holds none."""
    if ctx.slice is None:
        return None
    durs = [d for n, _, d in ctx.slice.kernel_ops
            if names is None or any(k in n for k in names)]
    return sum(durs) * 1e-6 if durs else None


def least_seconds(ctx, least):
    """The slice's work at its least: ``least(shape)`` a scenario solve."""
    return sum(n * least(shape) for n, shape in ctx.slice_work)


def share(ctx, least, names=None):
    """Least time over the kernels' device time, in percent."""
    busy = kernel_seconds(ctx, names)
    if not busy or not ctx.slice_work:
        return None
    return 100.0 * least_seconds(ctx, least) / busy


def mean_ms(ctx, span):
    """Mean host milliseconds of the calls of ``span`` outside the
    profiled slice."""
    d = ctx.spans.outside_slice(span)
    return 1e3 * sum(d) / len(d) if d else None


def kernels_per_call(ctx):
    """Kernel records of the slice over its solve calls or replays."""
    if ctx.slice is None or not ctx.slice.kernel_ops or not ctx.slice_calls:
        return None
    return len(ctx.slice.kernel_ops) / ctx.slice_calls


def idle_share(ctx):
    """Per cent of the slice in which no device operation ran."""
    if ctx.slice is None or not ctx.slice.window_s():
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s() / ctx.slice.window_s())


def step_mfu(ctx, least):
    """The slice's work at its least over the slice's length, in percent."""
    if ctx.slice is None or not ctx.slice.window_s() or not ctx.slice_work:
        return None
    return 100.0 * least_seconds(ctx, least) / ctx.slice.window_s()
