"""Standalone barebone MPPI: unicycle, no terrain, analytic circle obstacles.

Same lifecycle, params keys and defaults as ``mppi_numba_tpu.barebone``:
information-theoretic MPPI with nominal unicycle dynamics, squared-distance
costs and circular obstacles on one device: on a card the rollouts in a
kernel of their own (``ops/kernels/barebone_rollout.py``; the JAX package
compiles them from a ``lax.scan``), then the solve's CVaR and update
kernels; on the CPU their plain versions.  Randomness comes from a
``torch.Generator`` on the planner's device, seeded from ``cfg.seed``.

The planner keeps its solve's inputs in buffers that it updates in place,
as ``MPPIPlanner`` does: the task (``set_params`` and ``shift_and_update``
write into it) and the shifted nominal controls.  On a card ``solve()``
replays the solve from a CUDA graph captured on those buffers (one per
``SolverStatic``; a change of the obstacle count is a new one, on new task
buffers) and ``get_state_rollout()`` replays the visualisation rollouts
from another; on the CPU both run eagerly.  A replay equals the eager call
bit for bit.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .config import SolverStatic, rec_min_control_rollouts
from .graphs import VisGraph
from .mppi import shifted_useq
from .ops.costs import BAREBONE_DEFAULT_DIST_WEIGHT, BAREBONE_DEFAULT_OBS_COST
from .solver import get_barebone_solver, get_barebone_vis
from .terrain import resolve_device
from .types import BareboneTask

# The barebone engine recommends a much higher rollout ceiling than the
# terrain engine.
rec_max_control_rollouts = int(1e6)


class BareboneConfig:
    """Barebone configuration: horizon, step, rollout counts and seed."""

    def __init__(self, T=10.0, dt=0.1, num_control_rollouts=1024,
                 num_vis_state_rollouts=20, seed=1):
        self.seed = seed
        self.T = T
        self.dt = dt
        self.num_steps = int(T / dt + 1e-6)   # see Config: float-safe truncation

        assert T > 0
        assert dt > 0
        assert T > dt
        assert self.num_steps > 0

        self.num_control_rollouts = int(num_control_rollouts)
        if self.num_control_rollouts > rec_max_control_rollouts:
            self.num_control_rollouts = rec_max_control_rollouts
            print("MPPI Config: Clip num_control_rollouts to recommended max "
                  "of {}.".format(rec_max_control_rollouts))
        elif self.num_control_rollouts < rec_min_control_rollouts:
            self.num_control_rollouts = rec_min_control_rollouts
            print("MPPI Config: Clip num_control_rollouts to recommended min "
                  "of {}.".format(rec_min_control_rollouts))

        self.num_vis_state_rollouts = max(
            1, min(int(num_vis_state_rollouts), self.num_control_rollouts))


class BareboneMPPI:
    """Barebone planner: ``setup(params) -> solve() -> shift_and_update``,
    the terrain planner's lifecycle without TDMs, on a CUDA device unless
    ``device`` names another."""

    def __init__(self, cfg: BareboneConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.T = cfg.T
        self.dt = cfg.dt
        self.num_steps = cfg.num_steps
        self.num_control_rollouts = cfg.num_control_rollouts
        self.num_vis_state_rollouts = cfg.num_vis_state_rollouts
        self.seed = cfg.seed
        self.device_var_initialized = True
        self.reset()

    def reset(self):
        self.u_seq0 = np.zeros((self.num_steps, 2), dtype=np.float32)
        self.params = None
        self.params_set = False
        # u_cur is the last solve's output, or the buffer that
        # shift_and_update writes the shifted sequence into (the captured
        # solve's input).
        self._u_in = torch.tensor(self.u_seq0, device=self.device)
        self.u_cur = self._u_in
        self.u_prev = torch.tensor(self.u_seq0, device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        self._last_aux = None
        self._task_device = None
        self._last_useq_np = None
        # On a card: SolverStatic -> SolveGraph, and -> VisGraph.
        self._solve_graphs = {}
        self._vis_graphs = {}

    def setup(self, params):
        self.set_params(params)

    def set_params(self, params):
        self.params = copy.deepcopy(params)
        self.params_set = True
        # Staged once per params change, into the planner's task buffers;
        # per-replan updates touch only x0 (see shift_and_update).  Another
        # obstacle count gives buffers of other shapes, and drops the
        # graphs captured on the old ones.
        task = self._task()
        old = self._task_device
        if old is None or any(a.shape != b.shape for a, b in zip(task, old)):
            self._task_device = task
            self._solve_graphs.clear()
            self._vis_graphs.clear()
        else:
            for dst, src in zip(old, task):
                dst.copy_(src)

    def check_solve_conditions(self):
        if not self.params_set:
            print("MPPI parameters are not set. Cannot solve")
            return False
        return True

    def _static(self):
        n_obs = (len(self.params["obstacle_positions"])
                 if "obstacle_positions" in self.params else 1)
        return SolverStatic(
            mode="barebone",
            num_steps=self.num_steps,
            num_control_rollouts=self.num_control_rollouts,
            num_grid_samples=1,
            map_shape=(0, 0),
            num_obstacles=n_obs,
            cvar_numel=1,
            num_opt=int(self.params.get("num_opt", 1)),
            num_vis_state_rollouts=self.num_vis_state_rollouts,
        )

    def _task(self):
        p = self.params
        f32 = np.float32
        if "obstacle_positions" in p:
            obs_pos = np.asarray(p["obstacle_positions"], dtype=f32)
            obs_r = np.asarray(p["obstacle_radius"], dtype=f32)
        else:
            # A far-away dummy obstacle, as the reference has it.
            obs_pos = np.array([[1e5, 1e5]], dtype=f32)
            obs_r = np.array([0.0], dtype=f32)

        def t(value):
            return torch.tensor(np.asarray(value, dtype=f32),
                                device=self.device)

        return BareboneTask(
            x0=t(p["x0"]), xgoal=t(p["xgoal"]),
            goal_tolerance=t(p["goal_tolerance"]),
            lambda_weight=t(p["lambda_weight"]), u_std=t(p["u_std"]),
            vrange=t(p["vrange"]), wrange=t(p["wrange"]), dt=t(p["dt"]),
            dist_weight=t(p.get("dist_weight", BAREBONE_DEFAULT_DIST_WEIGHT)),
            obs_penalty=t(p.get("obs_penalty", BAREBONE_DEFAULT_OBS_COST)),
            obs_pos=t(obs_pos), obs_r=t(obs_r))

    def solve(self):
        """Optimize and return the control sequence ``(num_steps, 2)`` as
        host float32.

        On a card the solve is replayed from a CUDA graph (captured at the
        first solve of each ``SolverStatic``); its outputs then live in the
        graph's memory, and the next solve overwrites them
        (``get_state_rollout()`` reads them before it)."""
        if not self.check_solve_conditions():
            print("MPPI solve condition not met. Cannot solve. Return")
            return
        static = self._static()
        task = self._task_device
        solver = get_barebone_solver(static, self.device)
        if self.device.type == "cuda":
            graph = self._solve_graphs.get(static)
            if graph is None:
                graph = self._solve_graphs[static] = solver.capture(
                    self._generator, task, self._u_in)
            solver = graph
        u_new, aux = solver(self._generator, task, self.u_cur)
        self.u_cur = u_new
        # The reference's quirk, kept as the JAX package keeps it: the
        # "previous" controls alias the freshly updated ones.
        self.u_prev = u_new
        self._last_aux = aux
        self._last_static = static
        self._last_useq_np = u_new.cpu().numpy()
        # A copy, so that caller edits cannot defeat shift_and_update's
        # is-this-the-solved-sequence comparison.
        return self._last_useq_np.copy()

    def shift_and_update(self, new_x0, u_cur, num_shifts=1):
        """Receding-horizon update, into the planner's buffers: the new x0
        into the task's, and the shifted controls (shifted on the device
        when ``u_cur`` is the sequence the last solve returned, else the
        shifted host array uploaded) into the solve's input."""
        new_x0 = np.asarray(new_x0).copy()
        self.params["x0"] = new_x0
        self._task_device.x0.copy_(torch.from_numpy(
            new_x0.astype(np.float32)))
        u_np = np.asarray(u_cur, dtype=np.float32)
        self._u_in.copy_(shifted_useq(self.u_cur, self._last_useq_np, u_np,
                                      num_shifts))
        self.u_cur = self._u_in
        self._last_useq_np = None   # a second shift must re-upload

    def get_state_rollout(self):
        """Visualisation rollouts of the last solve: host float32
        ``(num_vis, T+1, 3)``; on a card replayed from a CUDA graph (one
        for each ``SolverStatic``): one launch of the vis kernel
        (``ops/kernels/vis_rollout.py``)."""
        assert self.params_set, "MPPI parameters are not set"
        if self._last_aux is None:
            print("No solve has produced rollout data yet. Cannot visualize.")
            return None
        static = self._last_static
        head, tail = (self._task_device,), (self._last_aux.noise_vis,)
        vis = get_barebone_vis(static)
        if self.device.type != "cuda":
            return vis(*head, self.u_cur, self.u_prev, *tail).cpu().numpy()
        graph = self._vis_graphs.get(static)
        if graph is None or not graph.reads(head, tail):
            graph = self._vis_graphs[static] = VisGraph(vis, head, tail,
                                                        self.u_cur)
        return graph(self.u_cur, self.u_prev).cpu().numpy()
