"""Functional solver core: one terrain solve (tdm, det_dyn or speed_map).

One solve runs, on the device that holds the inputs: sample the lin/ang
PMF bins from one shared draw of uniforms, decode them, pack the backend's
map payload, then per optimisation iteration draw the noise, roll out
(K, M) costs (a CUDA kernel on the card), take the CVaR over M, add the
control-coupling term and apply the softmax update.  The det_dyn and
speed_map modes (costmap shares speed_map) solve over M = 1 map with a
collapsed PMF; speed_map adds the risk plane to the stage time cost.

The draws come from a ``torch.Generator``; ``TerrainSolver.solve_from_draws``
is the rest of the solve as a pure function of the draws, so tests can
feed it the JAX package's own numbers.
"""

from __future__ import annotations

import functools

import torch

from .config import SolverStatic
from .models import get_step_fn
from .ops.cvar import cvar_from_costs, cvar_from_costs_dynamic
from .ops.kernels.rollout_binned import (MAX_BINS, build_bin_luts,
                                         terrain_rollout_costs_binned)
from .ops.kernels.rollout_byte import build_task_vec, terrain_rollout_costs_byte
from .ops.packing import (pack_bin_crumbs, pack_bin_nibbles, pack_byte_pairs,
                          pack_map_words, pack_mask_nibbles, pack_risk_bytes)
from .ops.rollout import (_clipped_controls_tk, control_coupling,
                          terrain_rollout_costs)
from .ops.sampling import (decode_bins, draw_map_uniforms,
                           traction_bins_from_uniforms)
from .ops.update import update_useq
from .types import SolveAux

# Sentinel for SolverStatic.cvar_numel: alpha read from the task at run time.
DYNAMIC_CVAR = -1

# Layout backends and their cell_bits; the JAX package's 'pallas',
# 'pallas_binned2', 'pallas_binned' and 'pallas_binned8'.
CELL_BITS = {"binned2": 2, "binned": 4, "binned8": 8}
# 'cuda' is kept as an alias of 'byte', its earlier name.
BACKENDS = ("auto", "eager", "byte", *CELL_BITS, "cuda")


def resolve_backend(static: SolverStatic, device) -> str:
    """The rollout layout for a static signature on ``device``.

    'auto' is 'eager' on the CPU (exact trig, the JAX package's off-TPU
    semantics).  On a CUDA device it follows the JAX package's layout
    order without its VMEM tests: H*W <= 512 -> 'byte'; else <= 4 bins ->
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
    H, W = static.map_shape
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
    """The backend's (pack, rollout) pair: ``(backend_name, pack, rollout)``.

    * ``pack(lin_bins, ang_bins, lin_grids, ang_grids, maps, task)`` builds
      the rollout payload: int32 (M, H, W) words for 'eager' and 'byte';
      ``(cells, mask, lut, risk)`` planes for the binned layouts, whose
      2- and 4-bit cells take bin indices and 8-bit cells decoded values;
    * ``rollout(payload, task, u, noise) -> (K, M)`` costs.
    """
    backend = resolve_backend(static, device)
    H, W = static.map_shape
    T = static.num_steps
    speed_map = static.mode == "speed_map"
    step_fn = get_step_fn(static.model)
    # fast_trig replaces the heading update with a unicycle-specific
    # rotation polynomial; the eager path is always exact trig.
    fast_trig = static.fast_trig and static.model == "unicycle"
    cell_bits = CELL_BITS.get(backend)

    def pack(lin_bins, ang_bins, lin_grids, ang_grids, maps, task):
        risk = maps.risk if speed_map else None
        if cell_bits is None:
            return pack_map_words(lin_grids, ang_grids, maps.obstacle,
                                  maps.unknown, risk)
        mask = pack_mask_nibbles(maps.obstacle, maps.unknown)
        riskw = None if risk is None else pack_risk_bytes(risk)
        if cell_bits == 8:
            return pack_byte_pairs(lin_grids, ang_grids), mask, None, riskw
        bins = max(maps.lin_pmf.shape[0], maps.ang_pmf.shape[0])
        if bins > MAX_BINS[cell_bits]:
            raise ValueError(
                "backend {!r} holds at most {} PMF bins; the maps have {} "
                "(set SolverStatic.num_pmf_bins for 'auto' routing)".format(
                    backend, MAX_BINS[cell_bits], bins))
        pack_cells = pack_bin_crumbs if cell_bits == 2 else pack_bin_nibbles
        return (pack_cells(lin_bins, ang_bins), mask,
                build_bin_luts(task, maps.lin_qbins, maps.ang_qbins), riskw)

    def rollout(payload, task, u, noise):
        if backend == "eager":
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

    return backend, pack, rollout


class TerrainSolver:
    """The terrain solve for one ``SolverStatic`` on one device."""

    def __init__(self, static: SolverStatic, device):
        if static.mode not in ("tdm", "det_dyn", "speed_map"):
            raise ValueError("terrain solver mode {!r}; expected 'tdm', "
                             "'det_dyn' or 'speed_map'".format(static.mode))
        if static.roi_shape:
            raise NotImplementedError(
                "the reachable-window (ROI) crop is a later slice of the port")
        self.static = static
        self.device = torch.device(device)
        self.backend, self._pack, self._rollout = make_rollout_backend(
            static, self.device)

    def __call__(self, generator, maps, task, u0):
        """Draw this solve's random numbers from ``generator`` and solve.

        Returns ``(u_new (T, 2), SolveAux)``.
        """
        s = self.static
        H, W = s.map_shape
        uniforms = draw_map_uniforms(generator, s.num_grid_samples, H * W,
                                     self.device)
        eps_list = [torch.randn((s.num_control_rollouts, s.num_steps, 2),
                                generator=generator, device=self.device,
                                dtype=torch.float32)
                    for _ in range(s.num_opt)]
        return self.solve_from_draws(uniforms, eps_list, maps, task, u0)

    def solve_from_draws(self, uniforms, eps_list, maps, task, u0):
        """The solve after the draws.

        Args:
          uniforms: float32 ``(M, H*W)`` per-cell map uniforms in [0, 1).
          eps_list: ``num_opt`` float32 ``(K, T, 2)`` standard normal draws
            (scaled by ``task.u_std`` here).
          maps / task: ``MapInputs`` / ``TerrainTask`` on the device.
          u0: float32 ``(T, 2)`` nominal control sequence.
        """
        s = self.static
        V = s.num_vis_state_rollouts
        # The lin and ang bins come from the SAME uniforms: the reference
        # seeds both TDM streams identically, so their draws are comonotone.
        lin_bins = traction_bins_from_uniforms(uniforms, maps.lin_pmf,
                                               task.alpha_dyn)
        ang_bins = traction_bins_from_uniforms(uniforms, maps.ang_pmf,
                                               task.alpha_dyn)
        # The decoded grids feed SolveAux (and TDM.sample_grid_batch) on
        # every backend, and the byte / byte-pair payloads.
        lin_grids = decode_bins(maps.lin_qbins, lin_bins)
        ang_grids = decode_bins(maps.ang_qbins, ang_bins)
        payload = self._pack(lin_bins, ang_bins, lin_grids, ang_grids, maps,
                             task)

        u = u0
        noise = costs = weights = None
        for i in range(s.num_opt):
            noise = eps_list[i] * task.u_std
            costs_km = self._rollout(payload, task, u, noise)
            if s.cvar_numel == DYNAMIC_CVAR:
                cvar = cvar_from_costs_dynamic(costs_km, task.cvar_alpha)
            else:
                cvar = cvar_from_costs(costs_km, s.cvar_numel)
            costs = cvar + control_coupling(u, noise, task.u_std,
                                            task.lambda_weight)
            u, weights = update_useq(costs, noise, u, task.lambda_weight,
                                     task.vrange, task.wrange)
        aux = SolveAux(costs=costs, weights=weights, noise_vis=noise[:V],
                       lin_grids=lin_grids, ang_grids=ang_grids,
                       roi_offset=torch.zeros(2, dtype=torch.int32,
                                              device=self.device))
        return u, aux


@functools.lru_cache(maxsize=None)
def _cached_solver(static: SolverStatic, device: torch.device):
    return TerrainSolver(static, device)


def get_terrain_solver(static: SolverStatic, device="cuda"):
    """The (cached) terrain solve for ``static`` on ``device``.

    Returned callable: ``(generator, maps, task, u0) -> (u_new, SolveAux)``,
    with ``.solve_from_draws(uniforms, eps_list, maps, task, u0)``.
    """
    return _cached_solver(static, torch.device(device))


def get_terrain_vis(static: SolverStatic, device="cuda"):
    raise NotImplementedError(
        "visualisation rollouts are a later slice of the port")


def get_barebone_solver(static: SolverStatic, device="cuda"):
    raise NotImplementedError(
        "the barebone (terrain-free) solver is a later slice of the port")
