"""The card's name and power limit, and device timing with CUDA events
(over eager launches, or over launches captured in a CUDA graph): what
every timed figure of the port is printed beside and measured with."""

from __future__ import annotations

import subprocess

import torch


def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0].strip()


def time_cuda(fn, reps, warmup):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after
    ``warmup`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cuda_graph(fn, reps, warmup, generator=None):
    """Mean device time of ``fn`` in ms over ``reps`` calls captured in one
    CUDA graph and replayed (CUDA events around the replay), after
    ``warmup`` eager calls: the launches' own time, without the host's
    time to make each launch, which exceeds a short kernel's.
    ``generator``: the ``torch.Generator`` that ``fn`` draws from, if
    any (``graphs.Captured``)."""
    from .graphs import Captured

    for _ in range(warmup):
        fn()
    graph = Captured(lambda: [fn() for _ in range(reps)], generator)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
