"""Closed-loop episodes on the device: solve -> simulate -> shift, with no
host read inside the loop.

``sim.trial`` crosses the host-device boundary twice a control step (the
solve's controls to the host, the new state back).  Here the simulator
itself, a ground-truth traction lookup and one Euler step, runs on the
device beside the solve, as the JAX package's ``device_sim`` runs it
inside one ``lax.while_loop`` (``mppi_numba_tpu/device_sim.py``).  On a
card one step (solve, simulation, shift) is one CUDA graph
(``graphs.Captured``) whose outputs, the state and the controls, are
written back into its own inputs, so replays chain on the device.

The draws: a ``torch.Generator`` (each step draws the solve's map key and
noise from it, as ``TerrainSolver.__call__`` does), or a callable
``step -> (map_key, eps_list)`` whose draws feed
``TerrainSolver.solve_from_key`` (the tests inject the JAX package's own).
A card with a generator replays graphs; a callable, or the CPU, runs the
same step eagerly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import SolverStatic
from .graphs import Captured
from .solver import get_terrain_solver

# make_device_trial's replays between two reads of ``reached``.
CHUNK_STEPS = 10


class TrialResult(NamedTuple):
    """Per-trial metrics, with the JAX package's ``TrialResult``
    semantics (tensors on the device)."""
    steps: object          # int32: steps taken (t+1 at reach, else max_steps)
    success: object        # bool
    dist_to_goal: object   # final dist - tolerance (even when reached)
    cum_dist_to_goal: object
    cum_obj: object


def _gt_lookup(gt_lin, gt_ang, meta, x, y):
    """The ground truth's tractions at (x, y): zero outside the grid
    (``meta`` = [xlim0, ylim0, inv_res])."""
    Hg, Wg = gt_lin.shape
    xi = torch.floor((x - meta[0]) * meta[2]).to(torch.int32)
    yi = torch.floor((y - meta[1]) * meta[2]).to(torch.int32)
    inb = (xi >= 0) & (xi < Wg) & (yi >= 0) & (yi < Hg)
    # A one-element index tensor: no read on the host.
    idx = (yi.clamp(0, Hg - 1) * Wg + xi.clamp(0, Wg - 1)).reshape(1).long()
    lt = torch.where(inb, gt_lin.reshape(-1).index_select(0, idx)[0], 0.0)
    at = torch.where(inb, gt_ang.reshape(-1).index_select(0, idx)[0], 0.0)
    return lt, at


def _make_step_core(solve):
    """The shared episode step: solve -> ground-truth Euler step -> shift.

    ``solve(maps, task, u) -> (u_new, aux)`` with the step's draws bound.
    Returns ``step(x, u, maps, task, gt_lin, gt_ang, gt_meta) -> (x_new,
    u_shifted, dist_new)``.
    """

    def step(x, u, maps, task, gt_lin, gt_ang, gt_meta):
        u_new, _ = solve(maps, task._replace(x0=x), u)
        u0 = u_new[0]
        lt, at = _gt_lookup(gt_lin, gt_ang, gt_meta, x[0], x[1])
        x_new = torch.stack([
            x[0] + task.dt * lt * torch.cos(x[2]) * u0[0],
            x[1] + task.dt * lt * torch.sin(x[2]) * u0[0],
            x[2] + task.dt * at * u0[1],
        ])
        # Receding-horizon shift (reference: mppi_numba/mppi.py:539-542).
        u_shift = torch.cat([u_new[1:], u_new[-1:]], dim=0)
        dist_new = (torch.linalg.vector_norm(x_new[:2] - task.xgoal)
                    - task.goal_tolerance)
        return x_new, u_shift, dist_new

    return step


class _Episode:
    """One episode's state on the device, updated in place by each step:
    finished episodes (``reached``) keep theirs (masked)."""

    def __init__(self, task, num_steps):
        dev = task.x0.device
        f32 = torch.float32
        self.x = task.x0.detach().clone().contiguous()
        self.u = torch.zeros((num_steps, 2), dtype=f32, device=dev)
        self.reached = torch.zeros((), dtype=torch.bool, device=dev)
        self.steps = torch.zeros((), dtype=torch.int32, device=dev)
        self.cum_obj = torch.zeros((), dtype=f32, device=dev)
        self.cum_dist = torch.zeros((), dtype=f32, device=dev)
        self.dist = torch.full((), math.nan, dtype=f32, device=dev)

    def tensors(self):
        return (self.x, self.u, self.reached, self.steps, self.cum_obj,
                self.cum_dist, self.dist)

    def step(self, step_core, maps, task, gt):
        """One masked step (``make_episode_fn``'s body)."""
        x_new, u_shift, dist_new = step_core(self.x, self.u, maps, task, *gt)
        active = ~self.reached
        self.x.copy_(torch.where(active, x_new, self.x))
        self.u.copy_(torch.where(active, u_shift, self.u))
        self.cum_obj.add_(torch.where(active, task.dt + dist_new, 0.0))
        self.cum_dist.add_(torch.where(active, dist_new, 0.0))
        self.dist.copy_(torch.where(active, dist_new, self.dist))
        self.steps.add_(active.to(torch.int32))
        self.reached.logical_or_(dist_new <= 0)

    def result(self, task):
        # Timeout penalty (reference trial: cum_obj += dist / v_post).
        cum_obj = torch.where(self.reached, self.cum_obj,
                              self.cum_obj + self.dist / task.v_post_rollout)
        return TrialResult(steps=self.steps, success=self.reached,
                           dist_to_goal=self.dist,
                           cum_dist_to_goal=self.cum_dist, cum_obj=cum_obj)


def _episode(static, max_steps, draws, maps, task, gt, early_exit):
    """Run one episode; ``early_exit`` stops once every step after the
    goal's would be masked (read on the host once a chunk of steps)."""
    solver = get_terrain_solver(static, maps.lin_pmf.device)
    ep = _Episode(task, static.num_steps)
    t_box = [0]                    # the step a callable's draws are for

    def solve(m, tk, u):
        if isinstance(draws, torch.Generator):
            return solver(draws, m, tk, u)
        map_key, eps_list = draws(t_box[0])
        return solver.solve_from_key(map_key, eps_list, m, tk, u)

    step_core = _make_step_core(solve)

    def one_step():
        ep.step(step_core, maps, task, gt)

    graphed = isinstance(draws, torch.Generator) and maps.lin_pmf.is_cuda
    if graphed:
        one_step = Captured(one_step, draws, keep=ep.tensors(),
                            device=maps.lin_pmf.device).replay
    t = 0
    while t < max_steps:
        n = min(CHUNK_STEPS if graphed else 1, max_steps - t)
        for _ in range(n):
            t_box[0] = t
            one_step()
            t += 1
        if early_exit and bool(ep.reached):
            break
    return ep.result(task)


def make_device_trial(static: SolverStatic, max_steps: int):
    """Build ``trial_fn(draws, maps, task, gt_lin, gt_ang, gt_meta) ->
    TrialResult``: one closed-loop episode on the device that EXITS EARLY
    at goal reach.

    ``gt_lin`` / ``gt_ang`` are the ground-truth realized traction grids
    (float32 ``(Hg, Wg)``, unpadded) and ``gt_meta`` is ``[xlim0, ylim0,
    inv_res]`` for the simulator's lookup, which returns zero traction
    outside bounds (reference: mppi_numba/terrain.py:775-782).  ``draws``:
    a ``torch.Generator`` or a callable ``step -> (map_key, eps_list)``.
    On a card with a generator the steps replay one CUDA graph, in chunks
    of ``CHUNK_STEPS`` with ``reached`` read on the host once a chunk;
    steps after the goal are masked, so the result is the JAX package's
    ``while_loop``'s.
    """

    def trial_fn(draws, maps, task, gt_lin, gt_ang, gt_meta):
        return _episode(static, max_steps, draws, maps, task,
                        (gt_lin, gt_ang, gt_meta), early_exit=True)

    return trial_fn


def make_episode_fn(static: SolverStatic, max_steps: int):
    """One full masked episode of exactly ``max_steps`` steps:
    ``one(draws, maps, task, gt_lin, gt_ang, gt_meta) -> TrialResult``,
    arguments as for ``make_device_trial``.  Finished episodes freeze their
    state; on a card with a generator no step reads the host."""

    def one(draws, maps, task, gt_lin, gt_ang, gt_meta):
        return _episode(static, max_steps, draws, maps, task,
                        (gt_lin, gt_ang, gt_meta), early_exit=False)

    return one


def make_device_trial_batch(static: SolverStatic, max_steps: int):
    """The batched trial engine: ``batch_fn(draws, maps, task, gt_lin,
    gt_ang, gt_meta) -> TrialResult`` of ``(N,)`` tensors, where every
    tensor argument has a leading scenario axis and ``draws`` is a
    sequence of N generators or callables.

    Each scenario runs ``make_episode_fn``'s masked episode in turn (on a
    card, one graph a scenario); a kernel with a scenario axis is later
    work.
    """
    one = make_episode_fn(static, max_steps)

    def batch_fn(draws, maps, task, gt_lin, gt_ang, gt_meta):
        results = [
            one(d, type(maps)(*(t[i] for t in maps)),
                type(task)(*(None if t is None else t[i] for t in task)),
                gt_lin[i], gt_ang[i], gt_meta[i])
            for i, d in enumerate(draws)]
        return TrialResult(*(torch.stack(list(field))
                             for field in zip(*results)))

    return batch_fn
