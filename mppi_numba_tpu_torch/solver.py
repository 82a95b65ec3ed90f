"""Functional solver core: one terrain solve (tdm, det_dyn or speed_map),
the visualisation rollouts, and the barebone (terrain-free) solve.

One solve runs, on the device that holds the inputs: sample the lin/ang
PMF bins from one counter-addressed draw of uniforms, decode them and pack
the backend's map payload, on the reachable window around x0 when
``SolverStatic.roi_shape`` is set (one CUDA kernel on the card, the crop
included), then per optimisation iteration draw the noise, roll out (K, M)
costs (a CUDA kernel on the card), take the CVaR over M, add the
control-coupling term and apply the softmax update.  The det_dyn and
speed_map modes (costmap shares speed_map) solve over M = 1 map with a
collapsed PMF; speed_map adds the risk plane to the stage time cost.

On a card the planner replays the solve from a CUDA graph
(``TerrainSolver.capture``, ``SolveGraph``): one launch from the host a
solve.

A batch of B scenarios (the episodes of a benchmark sweep; the JAX
package's solve under ``jax.vmap``) solves as one: every ``MapInputs`` and
``TerrainTask`` field, the controls ``(B, T, 2)``, the map keys ``(B, 2)``
and the noise ``(B, K, T, 2)`` carry a leading scenario axis, the map
sampling and the rollout are one launch each for all B, and the CVaR and
the update reduce over their own axes per scenario.  One ``SolveGraph``
replays a batched solve as it does a single one.

The draws come from a ``torch.Generator``: the map key and the noise.
``TerrainSolver.solve_from_key`` is the rest of the solve as a pure function
of the draws, and ``solve_from_draws`` the same after the map's uniforms
(as does ``BareboneSolver.solve_from_draws``), so tests can feed either the
JAX package's own numbers.
"""

from __future__ import annotations

import functools

import torch

from .config import SolverStatic
from .graphs import Captured, same_tensors
from .models import clip_controls, get_step_fn
from .ops.cvar import cvar_from_costs, cvar_from_costs_dynamic
from .ops.kernels.map_sample import (sample_and_pack_crop,
                                     sample_and_pack_window)
from .ops.kernels.rollout_binned import (MAX_BINS, build_bin_luts,
                                         terrain_rollout_costs_binned)
from .ops.kernels.rollout_byte import build_task_vec, terrain_rollout_costs_byte
from .ops.packing import pack_map_words, pack_payload
from .ops.roi import crop_maps, crop_window_plain, shift_task_limits
from .ops.rollout import (_clipped_controls_tk, barebone_rollout_costs,
                          barebone_vis_states, control_coupling,
                          terrain_rollout_costs, terrain_vis_states)
from .ops.sampling import (decode_bins, draw_map_key,
                           traction_bins_from_uniforms)
from .ops.update import update_useq
from .types import SolveAux, per_scenario

# Sentinel for SolverStatic.cvar_numel: alpha read from the task at run time.
DYNAMIC_CVAR = -1

# Layout backends and their cell_bits; the JAX package's 'pallas',
# 'pallas_binned2', 'pallas_binned' and 'pallas_binned8'.
CELL_BITS = {"binned2": 2, "binned": 4, "binned8": 8}
# 'cuda' is kept as an alias of 'byte', its earlier name.
BACKENDS = ("auto", "eager", "byte", *CELL_BITS, "cuda")


def solver_map_shape(static: SolverStatic):
    """The (H, W) the rollout sees: the reachable window when cropping."""
    return static.roi_shape if static.roi_shape else static.map_shape


def resolve_backend(static: SolverStatic, device) -> str:
    """The rollout layout for a static signature on ``device``.

    'auto' is 'eager' on the CPU (exact trig, the JAX package's off-TPU
    semantics).  On a CUDA device it follows the JAX package's layout
    order without its VMEM tests, on the solver's map shape (the window
    when cropping): H*W <= 512 -> 'byte'; else <= 4 bins ->
    'binned2'; <= 16 bins -> 'binned'; H*W <= 2048 -> 'byte'; else
    'binned8'.  ``static.num_pmf_bins`` is the support-compacted count.
    A kernel backend on CPU tensors runs the wrapper's plain version.
    """
    if static.backend not in BACKENDS:
        raise ValueError("unknown backend {!r}; expected one of {}".format(
            static.backend, BACKENDS))
    if static.backend == "cuda":
        return "byte"
    if static.backend != "auto":
        return static.backend
    if torch.device(device).type != "cuda":
        return "eager"
    H, W = solver_map_shape(static)
    if H * W <= 512:
        return "byte"
    if static.num_pmf_bins <= 4:
        return "binned2"
    if static.num_pmf_bins <= 16:
        return "binned"
    if H * W <= 2048:
        return "byte"
    return "binned8"


def make_rollout_backend(static: SolverStatic, device):
    """The backend's payload layout and rollout:
    ``(backend_name, layout, finish, rollout)``.

    * ``layout``: the layout ``packing.pack_payload`` and the map-sampling
      kernel write for this backend: 'byte' for 'eager' and 'byte', else
      the backend's own;
    * ``finish(packed, maps, task)`` the rollout payload from the packed
      planes: the int32 (M, H, W) words as they are; for the binned
      layouts ``(cells, mask, lut, risk)``, the (2, 16) LUT built here for
      2- and 4-bit cells (whose cells hold bin indices; 8-bit cells hold
      decoded values);
    * ``rollout(payload, task, u, noise) -> (K, M)`` costs.
    """
    backend = resolve_backend(static, device)
    H, W = solver_map_shape(static)
    T = static.num_steps
    speed_map = static.mode == "speed_map"
    step_fn = get_step_fn(static.model)
    # fast_trig replaces the heading update with a unicycle-specific
    # rotation polynomial; the eager path is always exact trig.
    fast_trig = static.fast_trig and static.model == "unicycle"
    cell_bits = CELL_BITS.get(backend)
    layout = "byte" if cell_bits is None else backend

    def finish(packed, maps, task):
        if cell_bits is None:
            return packed
        cells, mask, riskw = packed
        if cell_bits == 8:
            return cells, mask, None, riskw
        return (cells, mask,
                build_bin_luts(task, maps.lin_qbins, maps.ang_qbins), riskw)

    def rollout(payload, task, u, noise):
        if backend == "eager":
            if u.dim() == 3:        # the plain oracle, one scenario a call
                return per_scenario(terrain_rollout_costs,
                                    (payload, task, u, noise),
                                    dict(speed_map=speed_map,
                                         step_fn=step_fn))
            return terrain_rollout_costs(payload, task, u, noise,
                                         speed_map=speed_map, step_fn=step_fn)
        v_all, w_all = _clipped_controls_tk(u, noise, task.vrange,
                                            task.wrange)
        args = (build_task_vec(task), v_all.contiguous(), w_all.contiguous())
        kw = dict(H=H, W=W, T=T, fast_trig=fast_trig, step_fn=step_fn)
        if cell_bits is None:
            return terrain_rollout_costs_byte(payload, *args,
                                              speed_map=speed_map, **kw)
        cells, mask, lut, riskw = payload
        return terrain_rollout_costs_binned(cells, mask, lut, *args, riskw,
                                            cell_bits=cell_bits, **kw)

    return backend, layout, finish, rollout


class TerrainSolver:
    """The terrain solve for one ``SolverStatic`` on one device."""

    def __init__(self, static: SolverStatic, device):
        if static.mode not in ("tdm", "det_dyn", "speed_map"):
            raise ValueError("terrain solver mode {!r}; expected 'tdm', "
                             "'det_dyn' or 'speed_map'".format(static.mode))
        self.static = static
        self.device = torch.device(device)
        self.backend, self._layout, self._finish, self._rollout = (
            make_rollout_backend(static, self.device))

    def __call__(self, generator, maps, task, u0):
        """Draw this solve's map key and noise from ``generator`` and solve.

        Returns ``(u_new (T, 2), SolveAux)``.  With a leading scenario axis
        (``u0`` ``(B, T, 2)``, the maps and the task batched) it draws B
        map keys ``(B, 2)`` and the noise ``(B, K, T, 2)``, and returns
        ``u_new (B, T, 2)`` and a ``SolveAux`` of batched fields.
        """
        s = self.static
        lead = tuple(u0.shape[:-2])
        map_key = draw_map_key(generator, self.device, lead)
        eps_list = [torch.randn(lead + (s.num_control_rollouts, s.num_steps,
                                        2),
                                generator=generator, device=self.device,
                                dtype=torch.float32)
                    for _ in range(s.num_opt)]
        return self.solve_from_key(map_key, eps_list, maps, task, u0)

    def capture(self, generator, maps, task, u0):
        """This solve captured in a CUDA graph on these tensors: a
        ``SolveGraph``, called as the solver is."""
        return SolveGraph(self, generator, maps, task, u0)


    def _check_bins(self, maps):
        """A 2- or 4-bit cell holds at most 4 or 16 bins a plane."""
        cell_bits = CELL_BITS.get(self.backend)
        bins = max(maps.lin_pmf.shape[-3], maps.ang_pmf.shape[-3])
        if cell_bits in (2, 4) and bins > MAX_BINS[cell_bits]:
            raise ValueError(
                "backend {!r} holds at most {} PMF bins; the maps have {} "
                "(set SolverStatic.num_pmf_bins for 'auto' routing)".format(
                    self.backend, MAX_BINS[cell_bits], bins))

    def solve_from_key(self, map_key, eps_list, maps, task, u0):
        """The solve after the draws of the map key and the noise.

        Args:
          map_key: int64 ``(2,)`` tensor of the map draw's uint32 key words
            (JAX's ``jax.random.key_data`` of its map key).
          eps_list: ``num_opt`` float32 ``(K, T, 2)`` standard normal draws
            (scaled by ``task.u_std`` here).
          maps / task: ``MapInputs`` / ``TerrainTask`` on the device, of the
            full padded map.
          u0: float32 ``(T, 2)`` nominal control sequence.

        Scenarios: map keys ``(B, 2)``, noise ``(B, K, T, 2)``, every field
        of the maps and the task and ``u0`` with the same leading B solve B
        scenarios in one map-sampling launch and one rollout launch an
        iteration.

        The maps are sampled, decoded and packed in the backend's layout by
        one ``sample_and_pack_window``, or when cropping one
        ``sample_and_pack_crop``, which also works out the window and the
        shifted task (one kernel launch on the card either way).
        """
        s = self.static
        self._check_bins(maps)
        risk = s.mode == "speed_map"
        if s.roi_shape:
            packed, lin_grids, ang_grids, task, offset = sample_and_pack_crop(
                map_key, maps, task, s.num_grid_samples, self._layout,
                s.roi_shape, risk=risk)
        else:
            packed, lin_grids, ang_grids = sample_and_pack_window(
                map_key, maps, task.alpha_dyn, s.num_grid_samples,
                self._layout, risk=risk)
            offset = None
        # The packed payload holds the window's planes; the rest of the
        # solve reads only the maps' bin values (not spatial).
        return self._solve_packed(packed, lin_grids, ang_grids, eps_list,
                                  maps, task, u0, offset)

    def solve_from_draws(self, uniforms, eps_list, maps, task, u0):
        """The solve after the draws of the map's uniforms and the noise.

        ``uniforms``: float32 ``(M, h*w)`` per-cell map uniforms in [0, 1)
        at the solver's map shape (the reachable window when cropping).
        The other arguments as for ``solve_from_key``, one scenario (no
        leading scenario axis).
        """
        s = self.static
        self._check_bins(maps)
        offset = None
        if s.roi_shape:
            maps, task, offset = crop_window_plain(maps, task, s.map_shape,
                                                   s.roi_shape)
        # The lin and ang bins come from the SAME uniforms: the reference
        # seeds both TDM streams identically, so their draws are comonotone.
        lin_bins = traction_bins_from_uniforms(uniforms, maps.lin_pmf,
                                               task.alpha_dyn)
        ang_bins = traction_bins_from_uniforms(uniforms, maps.ang_pmf,
                                               task.alpha_dyn)
        lin_grids = decode_bins(maps.lin_qbins, lin_bins)
        ang_grids = decode_bins(maps.ang_qbins, ang_bins)
        packed = pack_payload(self._layout, lin_bins, ang_bins, lin_grids,
                              ang_grids, maps, risk=s.mode == "speed_map")
        return self._solve_packed(packed, lin_grids, ang_grids, eps_list,
                                  maps, task, u0, offset)

    def _solve_packed(self, packed, lin_grids, ang_grids, eps_list, maps,
                      task, u0, offset):
        """The solve after the packed map planes and the decoded grids, on
        the (cropped) maps and task.  The grids feed SolveAux (and
        TDM.sample_grid_batch) on every backend."""
        s = self.static
        V = s.num_vis_state_rollouts
        payload = self._finish(packed, maps, task)

        u = u0
        noise = costs = weights = None
        for i in range(s.num_opt):
            noise = eps_list[i] * task.u_std[..., None, None, :]
            costs_km = self._rollout(payload, task, u, noise)
            if s.cvar_numel == DYNAMIC_CVAR:
                cvar = cvar_from_costs_dynamic(costs_km, task.cvar_alpha)
            else:
                cvar = cvar_from_costs(costs_km, s.cvar_numel)
            costs = cvar + control_coupling(u, noise, task.u_std,
                                            task.lambda_weight)
            u, weights = update_useq(costs, noise, u, task.lambda_weight,
                                     task.vrange, task.wrange)
        roi_offset = (torch.zeros(tuple(u0.shape[:-2]) + (2,),
                                  dtype=torch.int32, device=self.device)
                      if offset is None else offset)
        aux = SolveAux(costs=costs, weights=weights,
                       noise_vis=noise[..., :V, :, :],
                       lin_grids=lin_grids, ang_grids=ang_grids,
                       roi_offset=roi_offset)
        return u, aux


class SolveGraph:
    """A terrain solve captured in a CUDA graph: ``u0 <- solve(u0)``.

    Made by ``TerrainSolver.capture(generator, maps, task, u0)`` after one
    eager warm-up call (``graphs.Captured``).  ``graph(generator, maps,
    task, u0)`` replays it and returns ``(u_new, SolveAux)`` as the solver
    does, bit for bit with an eager call from the generator's state:

    * the graph reads the maps, the task and its ``u0`` where they lay at
      capture: pass the same objects, and change them in place (``copy_``)
      between calls, never rebind them; other maps or a task raise;
    * ``u0`` may be another tensor: it is copied into the graph's first
      (no copy when it is that tensor, or the last call's ``u_new``, which
      the graph has already written back there);
    * each replay draws the map key and the noise from the generator
      registered at capture, and advances it as an eager call would;
    * ``u_new`` and the ``SolveAux`` live in the graph's memory pool and
      the next call overwrites them: copy out what must outlive it.
    """

    def __init__(self, solver, generator, maps, task, u0):
        self.generator, self.maps, self.task, self.u0 = (generator, maps,
                                                         task, u0)

        def run():
            u, aux = solver(generator, maps, task, u0)
            u0.copy_(u)
            return u, aux

        self._call = Captured(run, generator, keep=(u0,),
                              device=solver.device)

    @property
    def captured_launches(self):
        """``{kernel wrapper: launches}`` of one call."""
        return self._call.captured_launches

    def __call__(self, generator, maps, task, u0):
        if not (generator is self.generator
                and same_tensors(maps, self.maps)
                and same_tensors(task, self.task)):
            raise ValueError(
                "a captured solve replays on the generator, maps and task "
                "it was captured on: update those tensors in place")
        if u0 is not self.u0 and u0 is not self._call.outputs[0]:
            self.u0.copy_(u0)
        return self._call.replay()


@functools.lru_cache(maxsize=None)
def _cached_solver(static: SolverStatic, device: torch.device):
    return TerrainSolver(static, device)


def get_terrain_solver(static: SolverStatic, device="cuda"):
    """The (cached) terrain solve for ``static`` on ``device``.

    Returned callable: ``(generator, maps, task, u0) -> (u_new, SolveAux)``,
    with ``.solve_from_key(map_key, eps_list, maps, task, u0)`` and
    ``.solve_from_draws(uniforms, eps_list, maps, task, u0)``.  The call
    and ``solve_from_key`` also take a batch of scenarios (a leading axis
    on every tensor).
    """
    return _cached_solver(static, torch.device(device))


def _vis_controls(u_cur, u_prev, noise_vis, task):
    """The det modes' vis controls: ``u_cur``, then V-1 copies of
    ``u_prev`` plus the last iteration's noise rows 1.., clipped."""
    noisy = torch.stack(clip_controls(u_prev[None] + noise_vis, task.vrange,
                                      task.wrange), dim=-1)
    return torch.cat([u_cur[None], noisy[1:]], dim=0)


def get_terrain_vis(static: SolverStatic):
    """The visualisation rollouts of the last solve.

    Returned callable: ``(maps, task, u_cur, u_prev, noise_vis, lin_grids,
    ang_grids, roi_offset=None) -> (V, T+1, 3)`` states.  tdm rolls
    ``u_cur`` across the first V sampled maps; the det modes roll ``u_cur``
    and V-1 noisy, clipped copies of ``u_prev`` on map 0 (the planner
    aliases ``u_prev`` to the solved controls, as the reference does).
    When the solve cropped, the grids are the window's and ``roi_offset``
    (the solve's ``SolveAux.roi_offset``) places it: the masks are cropped
    and the limits shifted to the same window.
    """
    V = static.num_vis_state_rollouts
    det = static.mode in ("det_dyn", "speed_map")
    step_fn = get_step_fn(static.model)

    def vis(maps, task, u_cur, u_prev, noise_vis, lin_grids, ang_grids,
            roi_offset=None):
        if static.roi_shape:
            oy, ox = roi_offset[0], roi_offset[1]
            maps = crop_maps(maps, oy, ox, *static.roi_shape)
            task = shift_task_limits(task, oy, ox)
        if det:
            shape = (V,) + tuple(lin_grids.shape[1:])
            grids_l = lin_grids[0].expand(shape)
            grids_a = ang_grids[0].expand(shape)
            controls = _vis_controls(u_cur, u_prev, noise_vis, task)
        else:
            grids_l, grids_a = lin_grids[:V], ang_grids[:V]
            controls = u_cur[None].expand((V,) + tuple(u_cur.shape))
        packed = pack_map_words(grids_l, grids_a, maps.obstacle, maps.unknown)
        return terrain_vis_states(packed, task, controls, step_fn=step_fn)

    return vis


class BareboneSolver:
    """The barebone solve for one ``SolverStatic`` (mode 'barebone'):
    terrain-free unicycle rollouts against circle obstacles, plain PyTorch
    ops on the device."""

    def __init__(self, static: SolverStatic, device):
        if static.mode != "barebone":
            raise ValueError("barebone solver mode {!r}; expected "
                             "'barebone'".format(static.mode))
        self.static = static
        self.device = torch.device(device)

    def __call__(self, generator, task, u0):
        """Draw this solve's noise from ``generator`` and solve.  Returns
        ``(u_new (T, 2), SolveAux)``."""
        s = self.static
        eps_list = [torch.randn((s.num_control_rollouts, s.num_steps, 2),
                                generator=generator, device=self.device,
                                dtype=torch.float32)
                    for _ in range(s.num_opt)]
        return self.solve_from_draws(eps_list, task, u0)

    def solve_from_draws(self, eps_list, task, u0):
        """The solve after the draws: ``num_opt`` float32 ``(K, T, 2)``
        standard normal draws (scaled by ``task.u_std`` here), a
        ``BareboneTask`` and the ``(T, 2)`` nominal controls ``u0``."""
        u = u0
        noise = costs = weights = None
        for i in range(self.static.num_opt):
            noise = eps_list[i] * task.u_std
            costs = (barebone_rollout_costs(task, u, noise)
                     + control_coupling(u, noise, task.u_std,
                                        task.lambda_weight))
            u, weights = update_useq(costs, noise, u, task.lambda_weight,
                                     task.vrange, task.wrange)
        aux = SolveAux(costs=costs, weights=weights,
                       noise_vis=noise[:self.static.num_vis_state_rollouts],
                       lin_grids=None, ang_grids=None)
        return u, aux


@functools.lru_cache(maxsize=None)
def _cached_barebone_solver(static: SolverStatic, device: torch.device):
    return BareboneSolver(static, device)


def get_barebone_solver(static: SolverStatic, device="cuda"):
    """The (cached) barebone solve for ``static`` on ``device``.

    Returned callable: ``(generator, task, u0) -> (u_new, SolveAux)``, with
    ``.solve_from_draws(eps_list, task, u0)``.
    """
    return _cached_barebone_solver(static, torch.device(device))


def get_barebone_vis(static: SolverStatic):
    """The barebone engine's visualisation rollouts: ``(task, u_cur, u_prev,
    noise_vis) -> (V, T+1, 3)``, rolling ``u_cur`` and V-1 noisy, clipped
    copies of ``u_prev``."""

    def vis(task, u_cur, u_prev, noise_vis):
        return barebone_vis_states(
            task, _vis_controls(u_cur, u_prev, noise_vis, task))

    return vis
