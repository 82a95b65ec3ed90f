"""Closed-loop episodes on the device: solve -> simulate -> shift, with no
host read inside the loop, for one episode or a batch of them.

``sim.trial`` crosses the host-device boundary twice a control step (the
solve's controls to the host, the new state back).  Here the simulator
itself, a ground-truth traction lookup and one Euler step, runs on the
device beside the solve, as the JAX package's ``device_sim`` runs it
inside one ``lax.while_loop``, and a batch of B episodes (maps,
realizations, tasks) steps together, as its ``jax.vmap`` of the episode
does (``mppi_numba_tpu/device_sim.py``): one batched solve a step (one
map-sampling launch and one rollout launch an iteration for all B), a
batched ground-truth gather and Euler step, and the masked shift.  On a
card one step of all B episodes is one CUDA graph (``graphs.Captured``)
whose outputs, the states and the controls, are written back into its own
inputs, so replays chain on the device.  A single episode is a batch of
one.

The draws: a ``torch.Generator`` (each step draws the B map keys and the
noise from it, as ``TerrainSolver.__call__`` does), or a callable
``step -> (map_keys, eps_list)`` whose draws feed
``TerrainSolver.solve_from_key`` (the tests inject the JAX package's own).
A card with a generator replays graphs; a callable, or the CPU, runs the
same step eagerly.

Each step's solve takes the episodes' ``reached`` buffer as its skip mask
(``TerrainSolver.solve_from_key``): the rollouts of episodes already at
their goal, whose solve the masked step throws away, are not computed.
The draws, the CVaR and the update still cover the whole batch, so every
active episode's step is the unmasked one's, bit for bit.  In a graph the
rollout kernel reads the buffer at each replay.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .config import SolverStatic
from .graphs import Captured
from .profiling import span
from .solver import draw_solve, get_terrain_solver

# Replays between two reads of ``reached`` on the host.
CHUNK_STEPS = 10


class TrialResult(NamedTuple):
    """Per-trial metrics, with the JAX package's ``TrialResult``
    semantics (tensors on the device; ``(B,)`` for a batch)."""
    steps: object          # int32: steps taken (t+1 at reach, else max_steps)
    success: object        # bool
    dist_to_goal: object   # final dist - tolerance (even when reached)
    cum_dist_to_goal: object
    cum_obj: object


def _gt_lookup(gt_lin, gt_ang, meta, x, y):
    """Each episode's ground-truth tractions at its (x, y): ``gt_*`` ``(B,
    Hg, Wg)``, ``meta`` ``(B, 3)`` = [xlim0, ylim0, inv_res], x and y
    ``(B,)``; zero outside the grid.  A gather on the device: no read on
    the host."""
    Hg, Wg = gt_lin.shape[-2:]
    xi = torch.floor((x - meta[..., 0]) * meta[..., 2]).to(torch.int32)
    yi = torch.floor((y - meta[..., 1]) * meta[..., 2]).to(torch.int32)
    inb = (xi >= 0) & (xi < Wg) & (yi >= 0) & (yi < Hg)
    idx = (yi.clamp(0, Hg - 1) * Wg + xi.clamp(0, Wg - 1)).long()[..., None]
    lt = torch.where(inb, gt_lin.flatten(-2).gather(-1, idx)[..., 0], 0.0)
    at = torch.where(inb, gt_ang.flatten(-2).gather(-1, idx)[..., 0], 0.0)
    return lt, at


def _make_step_core(solve):
    """The shared episode step: solve -> ground-truth Euler step -> shift,
    for a batch of episodes.

    ``solve(maps, task, u) -> (u_new, aux)`` with the step's draws bound.
    Returns ``step(x, u, maps, task, gt_lin, gt_ang, gt_meta) -> (x_new,
    u_shifted, dist_new)``.
    """

    def step(x, u, maps, task, gt_lin, gt_ang, gt_meta):
        u_new, _ = solve(maps, task._replace(x0=x), u)
        u0 = u_new[..., 0, :]
        lt, at = _gt_lookup(gt_lin, gt_ang, gt_meta, x[..., 0], x[..., 1])
        x_new = torch.stack([
            x[..., 0] + task.dt * lt * torch.cos(x[..., 2]) * u0[..., 0],
            x[..., 1] + task.dt * lt * torch.sin(x[..., 2]) * u0[..., 0],
            x[..., 2] + task.dt * at * u0[..., 1],
        ], dim=-1)
        # Receding-horizon shift (reference: mppi_numba/mppi.py:539-542).
        u_shift = torch.cat([u_new[..., 1:, :], u_new[..., -1:, :]], dim=-2)
        dist_new = (torch.linalg.vector_norm(x_new[..., :2] - task.xgoal,
                                             dim=-1)
                    - task.goal_tolerance)
        return x_new, u_shift, dist_new

    return step


class _Episodes:
    """A batch of episodes' state on the device, updated in place by each
    step: finished episodes (``reached``) keep theirs (masked)."""

    def __init__(self, x0, num_steps):
        dev = x0.device
        f32 = torch.float32
        lead = tuple(x0.shape[:-1])
        self.x = torch.empty_like(x0, memory_format=torch.contiguous_format)
        self.u = torch.empty(lead + (num_steps, 2), dtype=f32, device=dev)
        self.reached = torch.empty(lead, dtype=torch.bool, device=dev)
        self.steps = torch.empty(lead, dtype=torch.int32, device=dev)
        self.cum_obj = torch.empty(lead, dtype=f32, device=dev)
        self.cum_dist = torch.empty(lead, dtype=f32, device=dev)
        self.dist = torch.empty(lead, dtype=f32, device=dev)
        self.reset(x0)

    def reset(self, x0):
        """Start every episode afresh from ``x0`` (in place)."""
        self.x.copy_(x0)
        for t in (self.u, self.reached, self.steps, self.cum_obj,
                  self.cum_dist):
            t.zero_()
        self.dist.fill_(math.nan)

    def tensors(self):
        return (self.x, self.u, self.reached, self.steps, self.cum_obj,
                self.cum_dist, self.dist)

    def step(self, step_core, maps, task, gt):
        """One masked step (``make_episode_fn``'s body)."""
        x_new, u_shift, dist_new = step_core(self.x, self.u, maps, task, *gt)
        active = ~self.reached
        self.x.copy_(torch.where(active[..., None], x_new, self.x))
        self.u.copy_(torch.where(active[..., None, None], u_shift, self.u))
        self.cum_obj.add_(torch.where(active, task.dt + dist_new, 0.0))
        self.cum_dist.add_(torch.where(active, dist_new, 0.0))
        self.dist.copy_(torch.where(active, dist_new, self.dist))
        self.steps.add_(active.to(torch.int32))
        self.reached.logical_or_(dist_new <= 0)

    def result(self, task):
        """The metrics, copied out of the state (which the next run
        overwrites); timeout penalty as the reference trial's,
        cum_obj += dist / v_post."""
        cum_obj = torch.where(self.reached, self.cum_obj,
                              self.cum_obj + self.dist / task.v_post_rollout)
        return TrialResult(steps=self.steps.clone(),
                           success=self.reached.clone(),
                           dist_to_goal=self.dist.clone(),
                           cum_dist_to_goal=self.cum_dist.clone(),
                           cum_obj=cum_obj)


class _Graphed:
    """One step of a batch captured in a CUDA graph, on buffers of its own
    (maps, task, ground truth, episode state) into which each run copies
    its inputs: one capture serves every run on the same generator and
    shapes (the chunks of a sweep, its alpha values)."""

    def __init__(self, solve, generator, maps, task, gt, num_steps):
        self.generator = generator
        self.maps = type(maps)(*(t.clone() for t in maps))
        self.task = type(task)(*(None if t is None else t.clone()
                                 for t in task))
        self.gt = tuple(t.clone() for t in gt)
        self.ep = _Episodes(self.task.x0, num_steps)
        step_core = _make_step_core(functools.partial(solve,
                                                      skip=self.ep.reached))

        def one_step():
            self.ep.step(step_core, self.maps, self.task, self.gt)

        self.call = Captured(one_step, generator, keep=self.ep.tensors(),
                             device=maps.lin_pmf.device)

    def fits(self, generator, maps, task, gt):
        """Whether these inputs copy into this graph's buffers."""
        def alike(a, b):
            return (a is None) == (b is None) and (
                a is None or (a.shape == b.shape and a.dtype == b.dtype))

        return (generator is self.generator
                and all(alike(a, b) for a, b in zip(
                    (*maps, *task, *gt),
                    (*self.maps, *self.task, *self.gt))))

    def load(self, maps, task, gt):
        """Copy a run's inputs into the buffers; start its episodes."""
        for src, dst in zip((*maps, *task, *gt),
                            (*self.maps, *self.task, *self.gt)):
            if src is not None and src is not dst:
                dst.copy_(src)
        self.ep.reset(self.task.x0)


class _Engine:
    """A batch of closed-loop episodes (``make_device_trial_batch``);
    ``early_exit`` stops once every episode has reached its goal (read on
    the host once a chunk of replays, or once a step when eager): the
    masked steps after that change nothing.

    ``shard=(index, count)``: the episodes given are slice ``index`` of
    ``count`` equal slices of a larger batch (``parallel.sharded``), whose
    draws each step makes, keeping the slice's rows: the slice's episodes
    then run as they do in the whole batch."""

    def __init__(self, static, max_steps, early_exit, shard=None):
        self.static = static
        self.max_steps = max_steps
        self.early_exit = early_exit
        self.shard = shard
        self._graphed = None
        self.steps_run = 0      # steps the last run stepped (host count)
        self.captures = 0       # graphs captured by this engine
        self._steps = None      # the last run's per-episode steps

    @property
    def skipped_solves(self):
        """The scenario solves of the last run whose rollouts were skipped
        (episodes already at their goal): ``B * steps_run - sum(steps)``,
        worked out from the returned steps when read, not in the loop (0
        before any run).  Over ``B * steps_run`` it is the share of the
        rollout launches' scenarios that the skip mask took off."""
        if self._steps is None:
            return 0
        return (self._steps.numel() * self.steps_run
                - int(self._steps.sum()))

    def _slice(self, b):
        """The rows of a ``b``-episode slice in the whole batch, and its
        size."""
        index, count = self.shard or (0, 1)
        return slice(index * b, (index + 1) * b), b * count

    def _generator_solve(self, solver, generator):
        """``solve(maps, task, u, skip)`` drawing from ``generator``."""
        if self.shard is None:
            return lambda m, tk, u, skip: solver(generator, m, tk, u,
                                                 skip=skip)

        def solve(m, tk, u, skip):
            rows, n = self._slice(u.shape[0])
            map_keys, eps_list = draw_solve(generator, self.static, u.device,
                                            (n,))
            return solver.solve_from_key(map_keys[rows],
                                         [e[rows] for e in eps_list], m, tk,
                                         u, skip=skip)

        return solve

    def __call__(self, draws, maps, task, gt_lin, gt_ang, gt_meta):
        dev = maps.lin_pmf.device
        solver = get_terrain_solver(self.static, dev)
        gt = (gt_lin, gt_ang, gt_meta)
        graphed = isinstance(draws, torch.Generator) and dev.type == "cuda"
        if graphed:
            g = self._graphed
            if g is None or not g.fits(draws, maps, task, gt):
                g = self._graphed = _Graphed(
                    self._generator_solve(solver, draws), draws, maps, task,
                    gt, self.static.num_steps)
                self.captures += 1
            with span("device_sim.load"):
                g.load(maps, task, gt)
            ep, task, one_step = g.ep, g.task, g.call.replay
        else:
            ep = _Episodes(task.x0, self.static.num_steps)
            t_box = [0]            # the step a callable's draws are for
            if isinstance(draws, torch.Generator):
                solve = self._generator_solve(solver, draws)
            else:
                def solve(m, tk, u, skip):
                    map_keys, eps_list = draws(t_box[0])
                    if self.shard is not None:
                        rows, _ = self._slice(u.shape[0])
                        map_keys = map_keys[rows]
                        eps_list = [e[rows] for e in eps_list]
                    return solver.solve_from_key(map_keys, eps_list, m, tk,
                                                 u, skip=skip)

            step_core = _make_step_core(functools.partial(solve,
                                                          skip=ep.reached))

            def one_step():
                ep.step(step_core, maps, task, gt)

        t = 0
        while t < self.max_steps:
            for _ in range(min(CHUNK_STEPS if graphed else 1,
                               self.max_steps - t)):
                if not graphed:
                    t_box[0] = t
                one_step()
                t += 1
            if self.early_exit:
                with span("device_sim.poll"):
                    reached = bool(ep.reached.all())
                if reached:
                    break
        self.steps_run = t
        with span("device_sim.result"):
            result = ep.result(task)
        self._steps = result.steps
        return result


def _single(engine):
    """An engine of one episode: the inputs without a scenario axis, the
    draws a generator or ``step -> (map_key (2,), eps_list [(K, T, 2)])``."""

    def one(draws, maps, task, gt_lin, gt_ang, gt_meta):
        if not isinstance(draws, torch.Generator):
            single_draws = draws

            def draws(t):
                key, eps = single_draws(t)
                return key[None], [e[None] for e in eps]

        out = engine(draws, type(maps)(*(t[None] for t in maps)),
                     type(task)(*(None if t is None else t[None]
                                  for t in task)),
                     gt_lin[None], gt_ang[None], gt_meta[None])
        return TrialResult(*(f[0] for f in out))

    one.engine = engine
    return one


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
    ``while_loop``'s.  The episode is a batch of one
    (``make_device_trial_batch``).
    """
    return _single(_Engine(static, max_steps, early_exit=True))


def make_episode_fn(static: SolverStatic, max_steps: int):
    """One full masked episode of exactly ``max_steps`` steps:
    ``one(draws, maps, task, gt_lin, gt_ang, gt_meta) -> TrialResult``,
    arguments as for ``make_device_trial``.  Finished episodes freeze their
    state; on a card with a generator no step reads the host."""
    return _single(_Engine(static, max_steps, early_exit=False))


def make_device_trial_batch(static: SolverStatic, max_steps: int):
    """The batched trial engine: ``batch_fn(draws, maps, task, gt_lin,
    gt_ang, gt_meta) -> TrialResult`` of ``(B,)`` tensors, where every
    tensor argument has a leading scenario axis B and ``draws`` is one
    ``torch.Generator`` for the batch or a callable ``step -> (map_keys (B,
    2), eps_list [(B, K, T, 2)])``.

    Every step solves all B episodes at once (one map-sampling and one
    rollout launch an iteration) and masks the finished ones, as the JAX
    package's ``jax.vmap`` of ``make_episode_fn`` does.  That batch runs
    the full ``max_steps``; this one stops once every episode has reached
    its goal (read on the host once every ``CHUNK_STEPS`` replays), which
    changes no result, since the steps after are masked.  On a card with a
    generator one step of the batch is one CUDA graph, captured at the
    first call and replayed by every later call on the same generator and
    shapes (the inputs are copied into its buffers): ``batch_fn.captures``
    counts the captures, ``batch_fn.steps_run`` the last call's steps,
    ``batch_fn.skipped_solves`` its scenario solves whose rollouts the
    finished episodes' skip mask took off.
    """
    return _Engine(static, max_steps, early_exit=True)
