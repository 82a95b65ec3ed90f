"""Standalone barebone MPPI: unicycle, no terrain, analytic circle obstacles.

Same lifecycle, params keys and defaults as ``mppi_numba_tpu.barebone``:
information-theoretic MPPI with nominal unicycle dynamics, squared-distance
costs and circular obstacles, as plain PyTorch ops on one device (the JAX
package has no kernel for it either).  Randomness comes from a
``torch.Generator`` on the planner's device, seeded from ``cfg.seed``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .config import SolverStatic, rec_min_control_rollouts
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
        self.u_cur = torch.tensor(self.u_seq0, device=self.device)
        self.u_prev = torch.tensor(self.u_seq0, device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        self._last_aux = None
        self._task_device = None
        self._last_useq_np = None

    def setup(self, params):
        self.set_params(params)

    def set_params(self, params):
        self.params = copy.deepcopy(params)
        self.params_set = True
        # Staged once per params change; per-replan updates touch only x0
        # (see shift_and_update).
        self._task_device = self._task()

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
        host float32."""
        if not self.check_solve_conditions():
            print("MPPI solve condition not met. Cannot solve. Return")
            return
        static = self._static()
        solver = get_barebone_solver(static, self.device)
        u_new, aux = solver(self._generator, self._task_device, self.u_cur)
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
        new_x0 = np.asarray(new_x0).copy()
        self.params["x0"] = new_x0
        self._task_device = self._task_device._replace(
            x0=torch.tensor(new_x0.astype(np.float32), device=self.device))
        u_np = np.asarray(u_cur, dtype=np.float32)
        self.u_cur = shifted_useq(self.u_cur, self._last_useq_np, u_np,
                                  num_shifts)
        self._last_useq_np = None   # a second shift must re-upload

    def get_state_rollout(self):
        """Visualisation rollouts of the last solve: host float32
        ``(num_vis, T+1, 3)``."""
        assert self.params_set, "MPPI parameters are not set"
        if self._last_aux is None:
            print("No solve has produced rollout data yet. Cannot visualize.")
            return None
        states = get_barebone_vis(self._last_static)(
            self._task_device, self.u_cur, self.u_prev,
            self._last_aux.noise_vis)
        return states.cpu().numpy()
