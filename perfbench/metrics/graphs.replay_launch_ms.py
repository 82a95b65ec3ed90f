"""Mean milliseconds of a CUDA graph's launch on the host
(``graphs.replay``: ``CUDAGraph.replay()`` alone, without the launch
counts after it), over the profiled slice's replays."""

from perfbench.program_spans import mean_record_ms


def read(ctx):
    return mean_record_ms(ctx, "graphs.replay")
