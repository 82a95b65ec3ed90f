"""The general generator: what every kind of traffic shares.  A traffic
mix is a data file of parameters (``perfbench/traffic/<mix>.json``) whose
``"driver"`` names the code that runs the program under it,
``perfbench/drivers/<driver>.py``, on a configuration
(``perfbench/configs/<config>.json``).  A driver module has

* ``drive(run) -> Result``: set-up, the window, and what the program
  produced for the check;
* ``numbers(run, result, control=False) -> {name: value}``: the check's
  numbers, from the plain reference, after the window.

The drivers here: ``closed_loop`` (one robot through the planner's host
path) and ``batch`` (chunks of episodes as one device batch).  A new kind
of traffic is a new file; a new mix of an existing kind is a data file.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any

import numpy as np

import importlib
import re

from .reference import mppi as ref
from .trace import Slice

# The protocol's methods: the solver mode each plans in (the configuration
# states it; ``benchmark.METHOD_MODES``), and the program's ``Config`` flag
# of each mode.
METHOD_MODES = {"noisy_dyn": "tdm", "risk_dyn": "det_dyn",
                "nom_dyn_risk_cost": "speed_map"}
MODE_FLAGS = {"tdm": "use_tdm", "det_dyn": "use_det_dynamics",
              "speed_map": "use_nom_dynamics_with_speed_map"}


def driver(name):
    """The module ``perfbench/drivers/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError("a driver's name is letters, digits and _: "
                         "{!r}".format(name))
    return importlib.import_module("perfbench.drivers." + name)


@dataclasses.dataclass
class Result:
    e2e: dict
    attempted: int
    failed: int
    setup_s: float
    memory_peak_bytes: int
    check: Any                 # what the driver's numbers() compares
    slice: Any = None          # the profiled trace.Slice
    slice_work: list = dataclasses.field(default_factory=list)
    slice_calls: int = 0
    batch_calls: list = dataclasses.field(default_factory=list)
    info: dict = dataclasses.field(default_factory=dict)


def program_config(Config, cfg, seed, **kw):
    """The program's ``Config`` of a configuration's ``planner`` sizes."""
    pc = cfg["planner"]
    return Config(T=pc["T"], dt=pc["dt"],
                  num_grid_samples=pc["num_grid_samples"],
                  num_control_rollouts=pc["num_control_rollouts"],
                  max_speed_padding=pc["max_speed_padding"],
                  num_vis_state_rollouts=pc["num_vis_state_rollouts"],
                  max_map_dim=tuple(pc["max_map_dim"]), seed=seed, **kw)


def task_params(cfg):
    """The planner's params dict of a configuration (start and goal set
    by the caller)."""
    p = cfg["params"]
    out = dict(p, dt=cfg["planner"]["dt"])
    for k in ("u_std", "vrange", "wrange", "x0", "xgoal"):
        if k in out:
            out[k] = np.asarray(out[k], float)
    return out


def solve_shape(cfg, M, roi, alpha, mode):
    """The yardstick's shape of one scenario solve."""
    pc = cfg["planner"]
    T = int(pc["T"] / pc["dt"] + 1e-6)
    nb = cfg["world"]["num_bins"] + 2
    return dict(K=pc["num_control_rollouts"], M=M, T=T, rH=roi[0],
                rW=roi[1], bins=2 * nb, numel=ref.cvar_count(M, alpha),
                fast_trig=ref.fast_trig(cfg, True),
                speed_map=mode == "speed_map")


class Tracer:
    """Starts the profiled slice at the first call past ``at`` of the
    window and ends it at the first call boundary past ``seconds`` of
    slice."""

    def __init__(self, run, window_s):
        self.on = bool(run.trace)
        self.spans = run.spans
        self.begin = run.mix["trace_at"] * window_s
        self.length = run.mix["trace_seconds"]
        self.slice = None
        self.t0 = None
        self.done = False
        if self.on:
            # The profiler's first start initialises CUPTI, which takes
            # seconds: done here, in set-up, not inside the window.
            warm = Slice(self.spans)
            warm.start()
            warm.stop()

    def before(self, elapsed):
        """Called before each call; returns whether it is profiled."""
        if not self.on or self.done:
            return False
        if self.slice is None and elapsed >= self.begin:
            self.slice = Slice(self.spans)
            self.slice.start()
            self.t0 = time.perf_counter()
        return self.slice is not None

    def after(self):
        if (self.slice is not None and not self.done
                and time.perf_counter() - self.t0 >= self.length):
            self.slice.stop()
            self.done = True

    def close(self):
        if self.slice is not None and not self.done:
            self.slice.stop()
            self.done = True

    def info(self):
        """What the slice holds, for the run's notes."""
        sl = self.slice
        if sl is None:
            return {}
        return dict(slice_kernels=len(sl.kernel_ops),
                    slice_host_spans=len(sl.host),
                    slice_window_s=sl.window_s(), slice_host_s=sl.host_s)


def settle():
    """The end of set-up: what set-up made is collected once and frozen
    out of the garbage collector's later passes, which would otherwise
    walk every object of torch and the inputs inside the window."""
    gc.collect()
    gc.freeze()
