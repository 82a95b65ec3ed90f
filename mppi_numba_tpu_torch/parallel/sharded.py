"""The terrain solve and the episode batch over the ranks of a mesh: the
JAX package's ``mppi_numba_tpu/parallel/sharded.py`` (``shard_map``) as
SPMD on ``torch.distributed``.

Each rank computes what one shard of the JAX ``shard_map`` computes, on
the port's own solver pieces (``solver.make_rollout_backend``, the
``map_sample`` kernel, the ``cvar_costs`` kernel, ``update_useq``), with the
scenario axis leading: a rank solves its ``S_local`` scenarios in one
map-sampling launch and one rollout launch an iteration.  Rank ``(s, k,
m)`` rolls out rollouts ``[k K_local, (k+1) K_local)`` against map samples
``[m M_local, (m+1) M_local)`` of scenarios ``[s S_local, (s+1)
S_local)``.  The collectives of one solve:

* once a solve, when the k axis splits the map draw (``n_k > 1`` and
  ``n_k`` divides ``M_local``), one all-gather over k of the per-sample
  payload planes (the byte words, or the 2-, 4- or 8-bit cell words):
  rank ``(k, m)`` samples and packs rows ``[m M_local + k M_local / n_k,
  + M_local / n_k)`` of the full M-row draw in one ``map_sample`` launch
  (its ``m_offset`` and ``full_num_samples``).  The mask and risk words
  are the same on every rank; each computes them and none gathers them.
  The JAX package gathers twice (the lin and the ang bins) and packs
  after; the port packs in the sampling launch, so one gather moves the
  packed planes;
* an optimisation iteration, with the k axis split (``n_k > 1``), three
  all-reduces over k (``update_useq``'s torch ops around them: beta, the
  normalizer, the weighted noise sum; one k rank runs the update kernel,
  ``update_useq_fused``, and no collective), and with the m axis sharded
  one all-gather over m (the CVaR's candidates, or the whole cost slices
  for a run-time alpha, the ``cvar_costs`` kernel run on them; at alpha 1
  the ranks' sums, added in rank order as JAX's ``psum`` adds them).

When ``M`` does not divide over the m axis (the det modes' M = 1) the maps
are replicated over m instead (every m rank rolls out all of them), as the
JAX package does.

The noise.  The port draws its noise with ``torch.randn`` on a generator,
not from a counter, so a rank cannot draw its own rows alone: each rank
draws the whole noise of the single-card solve of all S scenarios from
the same generator state (``solver.draw_solve``) and keeps its rows.  The
sharded solve then rolls out exactly the single solve's rollouts, and
differs from it only in the order of the sums across ranks; on one rank it
equals it bit for bit.

On an NCCL mesh of cards ``ShardedTerrainSolver.capture`` records a rank's
whole solve, its collectives included, in one CUDA graph
(``solver.SolveGraph``): a replay makes no collective from the host.
Gloo runs its collectives on the host, which a graph cannot hold, so a
gloo mesh (or a CPU one) solves eagerly and refuses to capture.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..config import SolverStatic
from ..ops.cvar import cvar_from_costs_distributed, cvar_pool
from ..ops.kernels.cvar_costs import cvar_costs
from ..ops.kernels.map_sample import (sample_and_pack_crop,
                                      sample_and_pack_window)
from ..ops.kernels.update_useq import update_useq_fused
from ..ops.rollout import control_coupling
from ..ops.update import update_useq
from ..solver import (SolveGraph, check_bins, cvar_count, draw_solve,
                      make_rollout_backend)
from .collectives import all_gather_cat
from .mesh import MAP_AXIS, ROLLOUT_AXIS, SCENARIO_AXIS, rank_device


def _axis_sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class ShardedTerrainSolver:
    """The terrain solve of one ``SolverStatic`` on this rank of ``mesh``.

    Called as ``solver(generator, maps, task, u0) -> (u (S_local, T, 2),
    costs (S_local, K_local))``, or ``solver.solve_from_key(map_keys,
    eps_list, maps, task, u0)`` with injected draws:

    * ``maps`` / ``task`` / ``u0``: this rank's scenarios (a leading axis
      ``S_local`` on every tensor, on the rank's device), those of its
      scenario shard, ``[s S_local, (s+1) S_local)`` of the batch
      (``multihost.host_local_scenarios``);
    * the draws are those of the single-card solve of all S = ``S_local *
      n_s`` scenarios: the generator's (every rank's in the same state),
      or the map keys ``(S, 2)`` and ``num_opt`` noise tensors ``(S, K, T,
      2)`` of ``TerrainSolver.solve_from_key``.  Each rank keeps its rows.

    ``u`` is the same on every rank of a scenario shard; ``costs`` are this
    rank's rollouts (JAX's ``out_specs``: u over scenario, costs over
    scenario and k).  ``gather_scenarios`` builds the whole batch.
    """

    def __init__(self, static: SolverStatic, mesh):
        if static.mode not in ("tdm", "det_dyn", "speed_map"):
            raise ValueError("sharded solver mode {!r}; expected 'tdm', "
                             "'det_dyn' or 'speed_map'".format(static.mode))
        sizes = _axis_sizes(mesh)
        K, M = static.num_control_rollouts, static.num_grid_samples
        self.static = static
        self.n_s, self.n_k = sizes[SCENARIO_AXIS], sizes[ROLLOUT_AXIS]
        if K % self.n_k != 0:
            raise ValueError("K={} must divide over {} rollout shards".format(
                K, self.n_k))
        # Indivisible M (the det modes' M = 1): replicated over m.
        self.n_m = sizes[MAP_AXIS] if M % sizes[MAP_AXIS] == 0 else 1
        self.k_local = K // self.n_k
        m_local = M // self.n_m
        self.my_s = mesh.get_local_rank(SCENARIO_AXIS)
        my_k = mesh.get_local_rank(ROLLOUT_AXIS)
        my_m = mesh.get_local_rank(MAP_AXIS) if self.n_m > 1 else 0
        self.k0 = my_k * self.k_local
        # The map samples this rank rolls out.
        self.m_slice = slice(my_m * m_local, (my_m + 1) * m_local)
        self.s_group = mesh.get_group(SCENARIO_AXIS)
        self.k_group = mesh.get_group(ROLLOUT_AXIS)
        self.m_group = mesh.get_group(MAP_AXIS)
        # The k ranks of one m shard split its draw, then gather it.
        self.split_draw = self.n_k > 1 and m_local % self.n_k == 0
        self.m_rows = m_local // self.n_k if self.split_draw else m_local
        self.m_offset = my_m * m_local + (my_k * self.m_rows
                                          if self.split_draw else 0)
        self.device = rank_device(mesh)
        self.backend, self._layout, self._finish, self._rollout = (
            make_rollout_backend(static, self.device))

    def __call__(self, generator, maps, task, u0):
        """Draw the single-card solve's map keys and noise for all S
        scenarios from ``generator`` and solve this rank's shard."""
        S = u0.shape[0] * self.n_s
        map_keys, eps_list = draw_solve(generator, self.static, self.device,
                                        (S,))
        return self.solve_from_key(map_keys, eps_list, maps, task, u0)

    def capture(self, generator, maps, task, u0):
        """This rank's solve captured in a CUDA graph with its collectives
        inside: a ``solver.SolveGraph`` with ``TerrainSolver.capture``'s
        contract (``u0 <- solve(u0)``; the same generator, maps and task
        objects, updated in place; the outputs ``(u, costs)`` in the
        graph's memory pool).  Every replay makes the same collectives
        in the graph, none from the host.

        Collective: every rank of the mesh captures, in the same order.
        First the ranks agree on the inputs' shapes (a bad one raises on
        every rank), then run one collective on each of the mesh's groups
        (NCCL makes a group's communicator at its first collective, which
        cannot happen during a capture), then meet at a barrier.

        Only an NCCL mesh on cards captures.  Gloo's collectives run on
        the host, and a CPU mesh has no graph: both raise, and nothing
        falls back to eager calls (call the solver itself there).
        """
        backends = {str(dist.get_backend(g)) for g in
                    (self.s_group, self.k_group, self.m_group)}
        if self.device.type != "cuda" or any("nccl" not in b
                                             for b in backends):
            raise RuntimeError(
                "the sharded solve captures its collectives in a CUDA graph "
                "only on an NCCL mesh of cards; this mesh runs {} on {} "
                "tensors: call the solver eagerly".format(
                    "/".join(sorted(backends)), self.device.type))
        self._agree_on_inputs(maps, task, u0)
        for group in (self.s_group, self.k_group, self.m_group):
            dist.all_reduce(torch.zeros(1, device=self.device), group=group)
        dist.barrier(device_ids=[self.device.index])
        return SolveGraph(self, generator, maps, task, u0)

    def _agree_on_inputs(self, maps, task, u0):
        """Raise on every rank unless every rank's ``u0`` is ``(S_local,
        T, 2)`` with the same ``S_local`` and every map and task field
        leads with ``S_local`` on this rank's device (one all-reduce over
        the process group)."""
        s_local = u0.shape[0] if u0.dim() == 3 else -1
        ok = (u0.dim() == 3 and tuple(u0.shape[1:]) == (
            self.static.num_steps, 2) and all(
                t.device == self.device and t.dim() > 0
                and t.shape[0] == s_local
                for t in (*maps, *task, u0) if t is not None))
        votes = torch.tensor([float(ok), s_local, -s_local],
                             dtype=torch.float64, device=self.device)
        dist.all_reduce(votes, op=dist.ReduceOp.MIN)
        ok_all, lo, neg_hi = votes.tolist()
        if ok_all != 1.0 or lo != -neg_hi:
            raise ValueError(
                "capture of the sharded solve: a rank's inputs are not "
                "(S_local, ...) on its card with one S_local on every rank "
                "(u0 (S_local, T={}, 2); this rank's u0 {})".format(
                    self.static.num_steps, tuple(u0.shape)))

    def _scenario_rows(self, s_local):
        """This rank's scenarios in the batch of all S."""
        return slice(self.my_s * s_local, (self.my_s + 1) * s_local)

    def sample_payload(self, map_keys, maps, task):
        """This rank's packed map payload: the (S_local, M_local, ...)
        per-sample planes of its m shard (gathered over k when the k ranks
        split the draw) and the shared words, with the task (its limits
        moved to the window when cropping).  ``map_keys``: the ``(S, 2)``
        keys of all S scenarios."""
        s = self.static
        keys = map_keys[self._scenario_rows(task.x0.shape[0])].contiguous()
        risk = s.mode == "speed_map"
        kw = dict(risk=risk, m_offset=self.m_offset,
                  full_num_samples=s.num_grid_samples)
        if s.roi_shape:
            packed, _, _, task, _ = sample_and_pack_crop(
                keys, maps, task, self.m_rows, self._layout, s.roi_shape,
                **kw)
        else:
            packed, _, _ = sample_and_pack_window(
                keys, maps, task.alpha_dyn, self.m_rows, self._layout, **kw)
        if self.split_draw:
            if isinstance(packed, tuple):
                cells, mask, riskw = packed
                packed = (all_gather_cat(cells, 1, self.k_group), mask,
                          riskw)
            else:
                packed = all_gather_cat(packed, 1, self.k_group)
        return packed, task

    def _costs(self, costs_km, noise, u, task):
        """The CVaR over M plus the coupling, ``cvar_costs`` on what this
        rank holds of M, or on the m group's gathered pool: the candidates
        of the two-phase top-k (``cvar_pool``) for a static count, the
        whole cost rows for a run-time alpha.  Bit for bit with the single
        solve, but at alpha 1 over a split M: the ranks gather their
        windowed sums and add them in rank order, as JAX's sharded solve
        does."""
        s = self.static
        kw = cvar_count(s, task)
        if self.n_m > 1:
            if "alpha" in kw:
                costs_km = all_gather_cat(costs_km, -1, self.m_group)
            elif s.cvar_numel >= s.num_grid_samples:
                return (cvar_from_costs_distributed(
                    costs_km, s.cvar_numel, s.num_grid_samples, self.m_group)
                    + control_coupling(u, noise, task.u_std,
                                       task.lambda_weight))
            else:
                costs_km = cvar_pool(costs_km, s.cvar_numel, self.m_group)
        return cvar_costs(costs_km, noise, u, task.u_std, task.lambda_weight,
                          **kw)

    def solve_from_key(self, map_keys, eps_list, maps, task, u0):
        """The solve of this rank's shard after the draws of all S
        scenarios: map keys ``(S, 2)`` and ``num_opt`` noise tensors ``(S,
        K, T, 2)``.  Returns ``(u (S_local, T, 2), costs (S_local,
        K_local))``."""
        s = self.static
        if u0.dim() != 3:
            raise ValueError("the sharded solve takes a leading scenario "
                             "axis: u0 (S_local, T, 2), got {}".format(
                                 tuple(u0.shape)))
        rows = self._scenario_rows(u0.shape[0])
        S = u0.shape[0] * self.n_s
        if tuple(map_keys.shape) != (S, 2) or any(
                tuple(e.shape) != (S, s.num_control_rollouts, s.num_steps, 2)
                for e in eps_list):
            raise ValueError("expected the draws of all {} scenarios: map "
                             "keys (S, 2) and noise (S, K, T, 2)".format(S))
        check_bins(self.backend, maps)
        packed, task = self.sample_payload(map_keys, maps, task)
        payload = self._finish(packed, maps, task)
        ks = slice(self.k0, self.k0 + self.k_local)

        u = u0
        costs = None
        for i in range(s.num_opt):
            noise = eps_list[i][rows, ks] * task.u_std[..., None, None, :]
            costs_km = self._rollout(payload, task, u, noise)
            costs = self._costs(costs_km, noise, u, task)
            # The m ranks of a k shard hold the same CVaR, so they make the
            # same update: the kernel on one k rank, else torch ops around
            # the collectives over k.
            if self.n_k > 1:
                u, _ = update_useq(costs, noise, u, task.lambda_weight,
                                   task.vrange, task.wrange,
                                   group=self.k_group)
            else:
                u, _ = update_useq_fused(costs, noise, u, task.lambda_weight,
                                         task.vrange, task.wrange)
        return u, costs


def make_sharded_terrain_solver(static: SolverStatic, mesh):
    """The sharded terrain solve of ``static`` on this rank of ``mesh``
    (``ShardedTerrainSolver``).  Collective only in its calls."""
    return ShardedTerrainSolver(static, mesh)


@functools.lru_cache(maxsize=None)
def _cached_sharded_solver(static, mesh_key, mesh):
    return make_sharded_terrain_solver(static, mesh)


def get_sharded_terrain_solver(static: SolverStatic, mesh):
    """The sharded solver, cached per static signature and per mesh: its
    axes, shape and ranks, and the mesh object itself (a ``DeviceMesh``
    compares equal to one of the same shape built on a later process
    group, whose groups the cached solver does not hold)."""
    mesh_key = (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                tuple(mesh.mesh.flatten().tolist()), mesh.device_type,
                id(mesh))
    return _cached_sharded_solver(static, mesh_key, mesh)


def gather_scenarios(mesh, x):
    """The whole batch ``(S, ...)`` of a per-rank ``(S_local, ...)``
    tensor: an all-gather over the scenario axis (``u``; for ``costs``
    gather over k first)."""
    return all_gather_cat(x, 0, mesh.get_group(SCENARIO_AXIS))


def make_sharded_trial_batch(static: SolverStatic, max_steps: int, mesh):
    """The batched trial engine over every rank of ``mesh``: the JAX
    package's scenario-sharded episodes, with
    ``device_sim.make_device_trial_batch``'s signature.

    ``batch_fn(draws, maps, task, gt_lin, gt_ang, gt_meta) -> TrialResult``
    of ``(B,)`` tensors, every argument with the whole batch's leading axis
    B on every rank (B a multiple of the mesh's size).  Episodes are
    independent, so rank ``r`` runs episodes ``[r B / n, (r+1) B / n)``
    through its own ``device_sim`` engine (on a card with a generator one
    CUDA graph a step of its slice, as ``make_device_trial_batch`` does)
    and the ranks all-gather the metrics: every rank returns the whole
    batch.  The draws are the whole batch's (a generator in the same state
    on every rank, each step drawing all B episodes' keys and noise, or a
    callable ``step -> (map_keys (B, 2), eps_list [(B, K, T, 2)])``); each
    rank keeps its episodes' rows, so the result is the unsharded batch's.
    """
    from ..device_sim import TrialResult, _Engine

    n = mesh.size()
    coord = mesh.get_coordinate()
    sizes = _axis_sizes(mesh)
    rank = ((coord[0] * sizes[ROLLOUT_AXIS] + coord[1]) * sizes[MAP_AXIS]
            + coord[2])
    engine = _Engine(static, max_steps, early_exit=True, shard=(rank, n))

    def batch_fn(draws, maps, task, gt_lin, gt_ang, gt_meta):
        B = gt_lin.shape[0]
        if B % n != 0:
            raise ValueError("{} episodes do not divide over {} ranks".format(
                B, n))
        rows = slice(rank * (B // n), (rank + 1) * (B // n))

        def mine(tree):
            return type(tree)(*(None if t is None else t[rows] for t in tree))

        res = engine(draws, mine(maps), mine(task), gt_lin[rows],
                     gt_ang[rows], gt_meta[rows])
        # One gather of every metric: int32 steps, bool success and the
        # float32 sums are all exact in float64.
        packed = torch.stack([f.to(torch.float64) for f in res], dim=-1)
        full = all_gather_cat(packed, 0, None)
        return TrialResult(*(full[:, i].to(f.dtype)
                             for i, f in enumerate(res)))

    batch_fn.engine = engine
    return batch_fn
