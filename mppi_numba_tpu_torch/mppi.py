"""Stateful MPPI planner over the functional core, on one device.

Same lifecycle as ``mppi_numba_tpu.mppi.MPPIPlanner``: ``reset /
setup(params, lin_tdm, ang_tdm) / solve / get_state_rollout /
shift_and_update``, the same params-dict keys, the same solve-condition
guards and the same reachable-window crop.  Randomness comes from a
``torch.Generator`` on the planner's device, seeded from ``cfg.seed``:
each solve draws its map key and its noise from it.

The planner keeps its solve's inputs in buffers that it updates in place:
the map planes (copied in when the TDMs hand over new ones), the task
(``set_params`` and ``shift_and_update`` write into it) and the shifted
nominal controls (``shift_and_update`` writes them there).  On a card
``solve()`` replays the solve from a CUDA graph captured on those buffers
(one per ``SolverStatic``, after one eager warm-up call), and
``get_state_rollout()`` replays the visualisation rollouts from another;
on the CPU both run eagerly.  A replayed solve equals the eager one bit for
bit.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .config import Config, SolverStatic
from .graphs import Captured, same_tensors
from .models import has_displacement_bound
from .ops.costs import (DEFAULT_DIST_WEIGHT, DEFAULT_OBS_COST,
                        DEFAULT_UNKNOWN_COST)
from .solver import DYNAMIC_CVAR, get_terrain_solver, get_terrain_vis
from .terrain import resolve_device
from .types import MapInputs, TerrainTask


class MPPIPlanner:
    """Planner that runs MPPI with PyTorch, on a CUDA device by default.

    Typical workflow:
      1. Initialize with a ``Config`` (and a device).
      2. ``reset()``
      3. ``setup(mppi_params, linear_tdm, angular_tdm)``
      4. ``solve()`` -> optimized control sequence ``(num_steps, 2)``
      5. ``shift_and_update(next_state, useq, num_shifts=1)``
      6. Repeat from 2 if traction maps change.
    """

    def __init__(self, cfg: Config, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.T = cfg.T
        self.dt = cfg.dt
        self.num_steps = cfg.num_steps
        self.num_grid_samples = cfg.num_grid_samples
        self.num_control_rollouts = cfg.num_control_rollouts
        self.num_vis_state_rollouts = cfg.num_vis_state_rollouts
        self.seed = cfg.seed
        self.use_tdm = cfg.use_tdm
        self.use_det_dynamics = cfg.use_det_dynamics
        self.use_nom_dynamics_with_speed_map = cfg.use_nom_dynamics_with_speed_map
        self.use_costmap = cfg.use_costmap
        self.det_dyn = cfg.det_dyn

        self.device_var_initialized = True
        self.reset()

    def reset(self):
        self.u_seq0 = np.zeros((self.num_steps, 2), dtype=np.float32)
        self.params = None
        self.params_set = False
        self.lin_tdm = None
        self.ang_tdm = None
        self.tdm_set = False

        # u_cur is the last solve's output, or the buffer that
        # shift_and_update writes the shifted sequence into (the captured
        # solve's input).  The "previous" controls start as zeros of their
        # own: the buffer changes in place.
        self._u_in = torch.tensor(self.u_seq0, device=self.device)
        self.u_cur = self._u_in
        self.u_prev = torch.zeros_like(self._u_in)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        self._last_aux = None
        self._task_flat = None
        self._task_device = None
        self._maps_buf = None
        self._maps_src = None
        self._last_useq_np = None
        self._compacted_planes = None
        self._compacted_token = None
        # On a card: SolverStatic -> SolveGraph, and -> _VisGraph.
        self._solve_graphs = {}
        self._vis_graphs = {}

    # -- setup ---------------------------------------------------------------

    def setup(self, params, lin_tdm, ang_tdm):
        self.set_tdm(lin_tdm, ang_tdm)
        self.set_params(params)

    def is_within_bound(self, v, vbounds):
        return v >= vbounds[0] and v <= vbounds[1]

    def set_params(self, params):
        if not self.is_within_bound(params['x0'][0], self.lin_tdm.xlimits):
            print("ERROR: When setting mppi params, x0[0] is not within xlimits!")
            assert False
        if not self.is_within_bound(params['x0'][1], self.lin_tdm.ylimits):
            print("ERROR: When setting mppi params, x0[1] is not within ylimits!")
            assert False
        self.params = copy.deepcopy(params)
        self.params_set = True
        # Stage the task once per params change, into the planner's task
        # buffer; per-replan updates touch only its x0 (see
        # shift_and_update).
        flat = self._build_task_flat()
        if self._task_flat is None:
            self._task_flat = flat
            self._task_device = _unpack_task(flat)
        else:
            self._task_flat.copy_(flat)

    def set_tdm(self, lin_tdm, ang_tdm):
        self.lin_tdm = lin_tdm
        self.ang_tdm = ang_tdm
        self.tdm_set = True
        self._compacted_planes = None

    def check_solve_conditions(self):
        if not self.params_set:
            print("MPPI parameters are not set. Cannot solve")
            return False
        if not self.tdm_set:
            print("MPPI has not received TDMs. Cannot solve")
            return False
        if not self.device_var_initialized:
            print("Device variables not initialized. Cannot solve.")
            return False
        if not self.lin_tdm.pmf_grid_initialized:
            print("Linear TDM's PMF not initialized. Cannot solve.")
            return False
        if not self.ang_tdm.pmf_grid_initialized:
            print("Angular TDM's PMF not initialized. Cannot solve.")
            return False
        if not self.is_within_bound(self.params["x0"][0], self.lin_tdm.padded_xlimits):
            print("Robot initial condition not within padded xlimits.")
            return False
        if not self.is_within_bound(self.params["x0"][1], self.lin_tdm.padded_ylimits):
            print("Robot initial condition not within padded ylimits.")
            return False
        return True

    # -- solve -----------------------------------------------------------------

    def _mode(self):
        if self.use_det_dynamics:
            return "det_dyn"
        if self.use_nom_dynamics_with_speed_map or self.use_costmap:
            # Costmap mode shares the speed-map solve: nominal dynamics, a
            # risk byte of 100 (full speed) and the lethal/no-info masks
            # carrying the penalties (see TDM.set_TDM_from_costmap).
            return "speed_map"
        return "tdm"

    def _static(self):
        mode = self._mode()
        M = 1 if mode != "tdm" else self.num_grid_samples
        H, W = self.lin_tdm.get_padded_grid_xy_dim()
        if mode != "tdm":
            cvar_numel = 1
        elif getattr(self.cfg, "dynamic_cvar", False):
            # Alpha is read from the task at run time: one cached solver
            # serves every cvar_alpha.
            cvar_numel = DYNAMIC_CVAR
        else:
            alpha = float(self.params.get("cvar_alpha", 1.0))
            cvar_numel = int(math.ceil(M * alpha))
        # Fast rotation updates are accurate when per-step heading
        # increments stay small; mirror the reference's fastmath trig under
        # that guard.
        ang_ub = float(self.ang_tdm.bin_values_bounds[1])
        max_dth = (float(self.params["dt"])
                   * float(np.max(np.abs(self.params["wrange"]))) * ang_ub)
        return SolverStatic(
            roi_shape=self._roi_shape((H, W)),
            # The support-compacted bin count (see _compact_planes): what
            # 'auto' routes the layout on.
            num_pmf_bins=int(self._compact_planes()[4]),
            mode=mode,
            num_steps=self.num_steps,
            num_control_rollouts=self.num_control_rollouts,
            num_grid_samples=M,
            map_shape=(H, W),
            num_obstacles=0,
            cvar_numel=cvar_numel,
            num_opt=int(self.params.get("num_opt", 1)),
            num_vis_state_rollouts=self.num_vis_state_rollouts,
            fast_trig=(max_dth <= 0.6
                       and getattr(self.cfg, 'model', 'unicycle')
                       == 'unicycle'),
            model=getattr(self.cfg, "model", "unicycle"),
            # Optional override (set ``cfg.backend`` after construction):
            # 'eager', 'byte', 'binned2', 'binned' or 'binned8'.
            backend=getattr(self.cfg, "backend", "auto"),
        )

    def _roi_shape(self, padded_hw):
        """The reachable window's static size, or None when cropping buys
        nothing.

        A rollout moves at most ``max|vrange| * traction_ub * num_steps *
        dt`` metres from x0 (a step's displacement is ``dt * lin_traction *
        v``), so a window of that radius plus a margin, re-centred on x0
        every solve, holds every cell a rollout can reach: sampling, packing
        and the rollout's reads shrink from the padded map to it.  Cropped
        when the window is under 3/4 of the map, as in the JAX package.  A
        model without that displacement bound is never cropped.  The cropped
        solve draws the same maps as the uncropped one; its costs are the
        same where every rollout's ``x - xlim0`` rounds to the same cell in
        the map's frame and the window's, which holds with the padded
        origin at 0 and may fail for a rollout on a cell edge elsewhere.
        """
        if not has_displacement_bound(getattr(self.cfg, "model", "unicycle")):
            return None
        H, W = padded_hw
        p = self.params
        vmax = float(np.max(np.abs(p["vrange"])))
        tr_ub = max(1.0, float(self.lin_tdm.bin_values_bounds[1]))
        reach_m = vmax * tr_ub * self.num_steps * float(p["dt"])
        cells = int(math.ceil(reach_m / float(self.lin_tdm.res))) + 2
        r = 2 * cells + 1
        rH, rW = min(H, r), min(W, r)
        if rH * rW * 4 >= H * W * 3:
            return None
        return (rH, rW)

    def _compact_planes(self):
        """PMF bin planes with globally-zero-mass rows dropped, memoized.

        A bin whose int8 mass is zero in every cell can never be selected
        by the sampling rank ``sum(cum < sampled)``, so dropping it leaves
        the sampled traction values unchanged.  Row 0 is always kept, and
        so is the last row when some column sums below 100 (a draw past
        the end of such a column then lands one past the same retained
        rows).  Returns ``(lin_pmf, lin_q, ang_pmf, ang_q, num_bins)``.
        """
        lin, ang = self.lin_tdm, self.ang_tdm
        token = (id(lin), getattr(lin, "_content_version", None),
                 id(ang), getattr(ang, "_content_version", None))
        if (self._compacted_planes is not None
                and self._compacted_token == token):
            return self._compacted_planes
        self._compacted_token = token
        declared = int(max(lin.num_pmf_bins, ang.num_pmf_bins))
        if not getattr(self.cfg, "compact_pmf_support", True):
            self._compacted_planes = (lin.pmf_grid_device, lin.qbin_values,
                                      ang.pmf_grid_device, ang.qbin_values,
                                      declared)
            return self._compacted_planes

        def compact(tdm):
            pmf = tdm.padded_pmf_host
            qbins = tdm.qbin_values_host
            used = (pmf != 0).any(axis=(1, 2))
            used[0] = True
            if int(pmf.astype(np.int32).sum(axis=0).min()) < 100:
                used[-1] = True
            if used.all():
                return tdm.pmf_grid_device, tdm.qbin_values, len(used)
            return (torch.tensor(np.ascontiguousarray(pmf[used]),
                                 device=self.device),
                    torch.tensor(qbins[used], device=self.device),
                    int(used.sum()))

        lin_pmf, lin_q, n_lin = compact(lin)
        ang_pmf, ang_q, n_ang = compact(ang)
        self._compacted_planes = (lin_pmf, lin_q, ang_pmf, ang_q,
                                  max(n_lin, n_ang))
        return self._compacted_planes

    def _map_inputs(self):
        """The solve's map planes, in the planner's buffers: the TDMs'
        (support-compacted) planes, copied in whenever the TDMs hand over
        new tensors (a new shape allocates new buffers, and drops the
        graphs captured on the old ones)."""
        lin = self.lin_tdm
        lin_pmf, lin_q, ang_pmf, ang_q, _ = self._compact_planes()
        src = MapInputs(
            lin_pmf=lin_pmf,
            ang_pmf=ang_pmf,
            lin_qbins=lin_q,
            ang_qbins=ang_q,
            obstacle=lin.obstacle_map_device,
            unknown=lin.unknown_map_device,
            risk=lin.risk_traction_map_device,
        )
        if same_tensors(src, self._maps_src):
            return self._maps_buf
        buf = self._maps_buf
        if buf is None or any(a.shape != b.shape or a.dtype != b.dtype
                              for a, b in zip(src, buf)):
            self._maps_buf = MapInputs(*(t.clone() for t in src))
            self._solve_graphs.clear()
            self._vis_graphs.clear()
        else:
            for dst, t in zip(buf, src):
                dst.copy_(t)
        self._maps_src = src
        return self._maps_buf

    def _build_task(self):
        """The TerrainTask: views of one float32 upload."""
        return _unpack_task(self._build_task_flat())

    def _build_task_flat(self):
        """The task's fields packed in one float32 tensor on the device."""
        p = self.params
        lin, ang = self.lin_tdm, self.ang_tdm
        f32 = np.float32
        lin_lb, lin_ub = lin.bin_values_bounds
        ang_lb, ang_ub = ang.bin_values_bounds
        if self._mode() == "tdm":
            alpha_dyn = f32(p.get("alpha_dyn", 1.0))
        else:
            alpha_dyn = f32(1.0)
        flat = np.concatenate([
            np.asarray(p["x0"], dtype=f32).ravel(),                 # 0:3
            np.asarray(p["xgoal"], dtype=f32).ravel(),              # 3:5
            np.asarray(p["u_std"], dtype=f32).ravel(),              # 5:7
            np.asarray(p["vrange"], dtype=f32).ravel(),             # 7:9
            np.asarray(p["wrange"], dtype=f32).ravel(),             # 9:11
            np.asarray([
                p["goal_tolerance"], p["v_post_rollout"],
                p["lambda_weight"], p["dt"],
                p.get("dist_weight", DEFAULT_DIST_WEIGHT),
                p.get("obs_penalty", DEFAULT_OBS_COST),
                p.get("unknown_penalty", DEFAULT_UNKNOWN_COST),
                alpha_dyn, lin.res,
                lin.padded_xlimits[0], lin.padded_ylimits[0],
                lin_lb, 0.01 * (lin_ub - lin_lb),
                ang_lb, 0.01 * (ang_ub - ang_lb),
                p.get("cvar_alpha", 1.0),
            ], dtype=f32),                                           # 11:27
        ])
        return torch.tensor(flat, device=self.device)

    def solve(self):
        """Optimize and return the control sequence ``(num_steps, 2)`` as
        host float32.

        On a card the solve is replayed from a CUDA graph (captured at the
        first solve of each ``SolverStatic``).  Its ``SolveAux``, and the
        TDMs' ``sample_grid_batch``, then live in the graph's memory: the
        next solve overwrites them (``get_state_rollout()`` reads them
        before it)."""
        if not self.check_solve_conditions():
            print("MPPI solve condition not met. Cannot solve. Return")
            return

        static = self._static()
        maps, task = self._map_inputs(), self._task_device
        solver = get_terrain_solver(static, self.device)
        if self.device.type == "cuda":
            graph = self._solve_graphs.get(static)
            if graph is None:
                graph = solver.capture(self._generator, maps, task,
                                       self._u_in)
                self._solve_graphs[static] = graph
            solver = graph
        u_new, aux = solver(self._generator, maps, task, self.u_cur)
        self.u_cur = u_new
        self._last_aux = aux
        self._last_static = static
        # The TDMs expose the batch the solve actually used.
        self.lin_tdm.sample_grid_batch = aux.lin_grids
        self.ang_tdm.sample_grid_batch = aux.ang_grids

        if self.det_dyn:
            # The reference's quirk, kept as the JAX package keeps it: the
            # "previous" controls alias the freshly updated ones.
            self.u_prev = u_new

        self._last_useq_np = u_new.cpu().numpy()
        # Hand the caller a copy, so that caller edits cannot defeat
        # shift_and_update's is-this-the-solved-sequence comparison.
        return self._last_useq_np.copy()

    # -- receding horizon -------------------------------------------------------

    def shift_and_update(self, new_x0, u_cur, num_shifts=1):
        """Receding-horizon update: one small upload (the new x0); the
        control shift runs on the device when ``u_cur`` is the sequence the
        last solve returned, else the shifted host array is uploaded."""
        new_x0 = np.asarray(new_x0).copy()
        self.params["x0"] = new_x0
        self._task_device.x0.copy_(torch.from_numpy(
            new_x0.astype(np.float32)))
        u_np = np.asarray(u_cur, dtype=np.float32)
        self._u_in.copy_(shifted_useq(self.u_cur, self._last_useq_np, u_np,
                                      num_shifts))
        self.u_cur = self._u_in
        self._last_useq_np = None

    def shift_optimal_control_sequence(self, u_cur, num_shifts=1):
        """Set the nominal controls to the host array ``u_cur`` shifted by
        ``num_shifts`` steps (its last entries kept), uploaded."""
        u_cur_shifted = np.asarray(u_cur).copy()
        u_cur_shifted[:-num_shifts] = u_cur_shifted[num_shifts:]
        self._u_in.copy_(torch.from_numpy(u_cur_shifted.astype(np.float32)))
        self.u_cur = self._u_in

    # -- visualization ------------------------------------------------------------

    def get_state_rollout(self):
        """State sequences under the current optimal control.

        tdm: the optimal sequence rolled across the first
        ``num_vis_state_rollouts`` sampled map pairs.  Det modes: the
        optimal sequence plus noise-perturbed previous sequences on map
        sample 0.  Returns host float32 ``(num_vis, T+1, 3)``.

        On a card the rollouts are replayed from a CUDA graph captured on
        the planner's buffers and the last solve's outputs (one for each
        ``SolverStatic``).
        """
        assert self.params_set, "MPPI parameters are not set"
        assert self.tdm_set, "MPPI has not received TDMs"
        if self._last_aux is None:
            print("No solve has produced rollout data yet. Cannot visualize.")
            return None
        aux = self._last_aux
        static = self._last_static
        inputs = (self._map_inputs(), self._task_device, aux.noise_vis,
                  aux.lin_grids, aux.ang_grids, aux.roi_offset)
        if self.device.type != "cuda":
            states = get_terrain_vis(static)(*inputs[:2], self.u_cur,
                                             self.u_prev, *inputs[2:])
            return states.cpu().numpy()
        graph = self._vis_graphs.get(static)
        if graph is None or not graph.reads(inputs):
            graph = self._vis_graphs[static] = _VisGraph(static, inputs,
                                                         self.u_cur)
        return graph(self.u_cur, self.u_prev).cpu().numpy()


class _VisGraph:
    """A planner's visualisation rollouts captured in a CUDA graph, on its
    map and task buffers and one solve graph's outputs (``inputs``: maps,
    task, noise_vis, lin_grids, ang_grids, roi_offset), with the two
    control sequences copied into its own buffers at each call."""

    def __init__(self, static, inputs, u_like):
        self.inputs = inputs
        self._u = (torch.empty_like(u_like), torch.empty_like(u_like))
        vis = get_terrain_vis(static)
        maps, task, *rest = inputs
        self._call = Captured(lambda: vis(maps, task, *self._u, *rest),
                              device=u_like.device)

    def reads(self, inputs):
        return all(same_tensors(a, b) for a, b in zip(inputs, self.inputs))

    def __call__(self, u_cur, u_prev):
        """The (V, T+1, 3) states, in the graph's memory."""
        self._u[0].copy_(u_cur)
        self._u[1].copy_(u_prev)
        return self._call.replay()


def _unpack_task(flat):
    """Slice one packed float32 upload into a TerrainTask of views."""
    return TerrainTask(
        x0=flat[0:3], xgoal=flat[3:5], u_std=flat[5:7], vrange=flat[7:9],
        wrange=flat[9:11], goal_tolerance=flat[11], v_post_rollout=flat[12],
        lambda_weight=flat[13], dt=flat[14], dist_weight=flat[15],
        obs_penalty=flat[16], unknown_penalty=flat[17], alpha_dyn=flat[18],
        res=flat[19], xlim0=flat[20], ylim0=flat[21], lin_lb=flat[22],
        lin_ratio=flat[23], ang_lb=flat[24], ang_ratio=flat[25],
        cvar_alpha=flat[26])


def _shift_useq(u_cur, num_shifts):
    """Device-side receding-horizon shift: ``u[:-n] = u[n:]`` with the last
    ``n`` entries left unchanged."""
    return torch.cat([u_cur[num_shifts:], u_cur[-num_shifts:]], dim=0)


def shifted_useq(u_cur_device, last_useq_np, u_np, num_shifts):
    """Shift on the device (no upload) when ``u_np`` equals the last solve's
    output, else shift the passed host array and upload it."""
    if (last_useq_np is not None and u_np.shape == last_useq_np.shape
            and np.array_equal(u_np, last_useq_np)):
        return _shift_useq(u_cur_device, num_shifts)
    u_shifted = u_np.copy()
    u_shifted[:-num_shifts] = u_shifted[num_shifts:]
    return torch.tensor(u_shifted.astype(np.float32),
                        device=u_cur_device.device)



# The reference's class name, as the JAX package keeps it.
MPPI_Numba = MPPIPlanner
