"""Mean milliseconds of the device simulator's read of ``reached`` on the
host (``device_sim.poll``: the wait for the queued steps, once every
``CHUNK_STEPS`` replays), over the profiled slice's polls."""

from perfbench.program_spans import mean_record_ms


def read(ctx):
    return mean_record_ms(ctx, "device_sim.poll")
