"""Host spans and a bounded slice of the device's trace.

``Spans`` times each call the harness makes into the program on the host
clock; inside a profiled slice the same calls are also named for
``torch.profiler`` (``record_function``), so that the device's idle gaps
can be put down to what the host was doing.

``Slice`` profiles the calls between ``start()`` and ``stop()`` with
``torch.profiler`` (CPU and CUDA activities), writes the Chrome trace to
a temporary file under ``TMPDIR``, reads back every device operation
(kernels, copies, sets) and every named host span, and deletes the file.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

SLICE = "perfbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock spans by name: ``durations[name]`` lists each call's
    seconds as ``(seconds, in_slice)``."""

    def __init__(self):
        self.durations = defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name):
        if self.profiling:
            import torch

            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                yield
                self.durations[name].append((time.perf_counter() - t0, True))
        else:
            t0 = time.perf_counter()
            yield
            self.durations[name].append((time.perf_counter() - t0, False))

    def outside_slice(self, name):
        """The seconds of the calls of ``name`` made outside the profiled
        slice."""
        return [d for d, inside in self.durations[name] if not inside]


class Slice:
    """One profiled slice: ``device`` lists ``(name, start_us, dur_us)``
    of each device operation (``kernel_ops`` of each kernel), ``host`` the
    named host spans, ``window`` ``(start_us, dur_us)`` of the slice
    itself."""

    def __init__(self, spans):
        self.spans = spans
        self.device = []
        self.kernel_ops = []
        self.host = []
        self.window = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + ([ProfilerActivity.CUDA] if cuda else []))
        self._prof.start()
        self._rf = torch.profiler.record_function(SLICE)
        self._rf.__enter__()
        self.spans.profiling = True
        self.host_s = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self.host_s
        self.spans.profiling = False
        self._rf.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        del self._prof
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            rec = (ev.get("name", ""), float(ev["ts"]), float(ev["dur"]))
            if cat in DEVICE_CATS:
                self.device.append(rec)
                if cat == "kernel":
                    self.kernel_ops.append(rec)
            elif cat == "user_annotation":
                if rec[0] == SLICE:
                    self.window = rec[1:]
                else:
                    self.host.append(rec)

    # -- readings ------------------------------------------------------------

    def busy_intervals(self):
        """The union of the device operations' intervals inside the
        window, sorted: ``[(start_us, end_us)]``."""
        if self.window is None:
            return []
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        out = []
        for _, ts, dur in sorted(self.device, key=lambda d: d[1]):
            a, b = max(ts, w0), min(ts + dur, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def window_s(self):
        return None if self.window is None else self.window[1] * 1e-6

    def top_ops(self, n=10):
        """The device operations that took most time, by short name:
        ``[[name, seconds], ...]``."""
        tot = defaultdict(float)
        for name, _, dur in self.device:
            tot[short_name(name)] += dur * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The device's idle time inside the window summed by the host
        span it fell in (the innermost named span around each gap's
        middle, else the harness's own code): ``[[name, seconds], ...]``,
        the largest first."""
        if self.window is None:
            return []
        busy = self.busy_intervals()
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        tot = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            inside = [h for h in host[max(0, i - 16):i]
                      if mid <= h[1] + h[2]]
            name = min(inside, key=lambda h: h[2])[0] if inside else "harness"
            tot[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


def short_name(name):
    """A kernel's name without its return type, namespace, template
    arguments and parameters."""
    s = name
    if s.startswith("void "):
        s = s[5:]
    for stop in ("<", "("):
        if stop in s:
            s = s[:s.index(stop)]
    return s.split("::")[-1] or name[:64]
