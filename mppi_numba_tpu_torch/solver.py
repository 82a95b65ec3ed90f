"""Functional solver core: one stochastic (tdm) solve.

One solve runs, on the device that holds the inputs: sample the lin/ang
PMF bins from one shared draw of uniforms, decode them, pack one int32 word
per cell, then per optimisation iteration draw the noise, roll out (K, M)
costs (the CUDA kernel on the card), take the CVaR top-k mean over M, add
the control-coupling term and apply the softmax update.

The draws come from a ``torch.Generator``; ``TerrainSolver.solve_from_draws``
is the rest of the solve as a pure function of the draws, so tests can
feed it the JAX package's own numbers.
"""

from __future__ import annotations

import functools

import torch

from .config import SolverStatic
from .models import get_step_fn
from .ops.cvar import cvar_from_costs
from .ops.kernels.rollout_byte import build_task_vec, terrain_rollout_costs_byte
from .ops.packing import pack_map_words
from .ops.rollout import (_clipped_controls_tk, control_coupling,
                          terrain_rollout_costs)
from .ops.sampling import (decode_bins, draw_map_uniforms,
                           traction_bins_from_uniforms)
from .ops.update import update_useq
from .types import SolveAux

# Sentinel for SolverStatic.cvar_numel: alpha read from the task at run time.
DYNAMIC_CVAR = -1

BACKENDS = ("auto", "eager", "cuda")


def resolve_backend(static: SolverStatic, device) -> str:
    """'auto' is 'cuda' for tensors on a CUDA device and 'eager' on the CPU
    (exact trig, the JAX package's off-TPU semantics).  'cuda' on CPU
    tensors runs the kernel wrapper's plain version."""
    if static.backend not in BACKENDS:
        raise ValueError("unknown backend {!r}; expected one of {}".format(
            static.backend, BACKENDS))
    if static.backend != "auto":
        return static.backend
    return "cuda" if torch.device(device).type == "cuda" else "eager"


def make_rollout_backend(static: SolverStatic, device):
    """The backend's (pack, rollout) pair: ``(backend_name, pack, rollout)``.

    * ``pack(lin_grids, ang_grids, maps)`` builds the int32 (M, H, W) words;
    * ``rollout(words, task, u, noise) -> (K, M)`` costs.
    """
    backend = resolve_backend(static, device)
    H, W = static.map_shape
    T = static.num_steps
    speed_map = static.mode == "speed_map"
    step_fn = get_step_fn(static.model)
    # fast_trig replaces the heading update with a unicycle-specific
    # rotation polynomial; the eager path is always exact trig.
    fast_trig = static.fast_trig and static.model == "unicycle"

    def pack(lin_grids, ang_grids, maps):
        return pack_map_words(lin_grids, ang_grids, maps.obstacle,
                              maps.unknown, maps.risk if speed_map else None)

    def rollout(words, task, u, noise):
        if backend == "cuda":
            v_all, w_all = _clipped_controls_tk(u, noise, task.vrange,
                                                task.wrange)
            return terrain_rollout_costs_byte(
                words, build_task_vec(task), v_all.contiguous(),
                w_all.contiguous(), H=H, W=W, T=T, speed_map=speed_map,
                fast_trig=fast_trig, step_fn=step_fn)
        return terrain_rollout_costs(words, task, u, noise,
                                     speed_map=speed_map, step_fn=step_fn)

    return backend, pack, rollout


class TerrainSolver:
    """The stochastic (tdm) solve for one ``SolverStatic`` on one device."""

    def __init__(self, static: SolverStatic, device):
        if static.mode != "tdm":
            raise NotImplementedError(
                "solver mode {!r}: the det_dyn and speed_map solver modes are "
                "a later slice of the port".format(static.mode))
        if static.roi_shape:
            raise NotImplementedError(
                "the reachable-window (ROI) crop is a later slice of the port")
        if static.cvar_numel == DYNAMIC_CVAR:
            raise NotImplementedError(
                "run-time CVaR alpha (DYNAMIC_CVAR) is a later slice of the "
                "port")
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
        lin_grids = decode_bins(maps.lin_qbins, lin_bins)
        ang_grids = decode_bins(maps.ang_qbins, ang_bins)
        words = self._pack(lin_grids, ang_grids, maps)

        u = u0
        noise = costs = weights = None
        for i in range(s.num_opt):
            noise = eps_list[i] * task.u_std
            costs_km = self._rollout(words, task, u, noise)
            costs = (cvar_from_costs(costs_km, s.cvar_numel)
                     + control_coupling(u, noise, task.u_std,
                                        task.lambda_weight))
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
    """The (cached) stochastic solve for ``static`` on ``device``.

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
