"""Multi-card scaling of the sharded solve: solves per second and
efficiency(N) = throughput(N) / (N * throughput(1)); the port's
counterpart of ``scripts/scaling_bench.py``.

Runs under ``torchrun``, one rank a card (``multihost.initialize``: NCCL
on cards, gloo with ``--backend gloo``):

    torchrun --standalone --nproc-per-node 4 -m \\
        mppi_numba_tpu_torch.drivers.scaling_bench --scenarios 4 \\
        --rollouts 1024 --samples 1024 --horizon 100 --map-dim 11 \\
        --mesh 1,4,1 --mesh 1,2,2 --mesh 4,1,1

(``--rollouts``, ``--samples`` and ``--horizon`` are the JAX script's
``--k``, ``--m`` and ``--t``, which torchrun's parser takes for
abbreviations of its own options.)

The problem is the JAX script's ``build_case`` (S scenarios, K, M, T, an
HxW map of B bins; defaults S = 8, K = 2048, M = 64, T = 50, 15x15, 22
bins).  Rank 0 first times the single-card ``TerrainSolver`` on all S
scenarios (one batched solve) while the other ranks wait at a barrier;
then each mesh ``(scenario, k, m)`` of ``--mesh`` (default: the JAX
script's split of the world into scenario and k shards) is timed with
``ShardedTerrainSolver``.  Every timing is the JAX script's loop: ``iters``
solves dispatched back to back, each fed the last one's controls, then
one synchronize (and on a mesh one barrier), on the host clock; the least
of ``ROUNDS`` such chains.  On NCCL the solves are CUDA-graph replays
(``TerrainSolver.capture``; ``ShardedTerrainSolver.capture``, its
collectives inside the graph), and the same loop of eager solves runs in
turns with them (graph, eager, eager, graph, ...); on gloo (``--device
cpu``) the solves are eager, and the line says so (``clock``).  Per mesh
rank 0 prints one JSON line:

* ``solves_per_s`` and ``efficiency`` against the single card's
  (``single_solves_per_s``), graph replays on NCCL; ``eager_solves_per_s``
  and ``eager_efficiency`` (against ``eager_single_solves_per_s``) the
  eager loop's, None on gloo, where the first pair is eager;
* ``check``: the gathered u against the single solve of the same
  generator draws, all S scenarios in one batched solve: within rtol 2e-4
  / atol 2e-5 on every mesh (a sum across ranks reorders float32
  additions, and on a card a batch of S_local scenarios reduces in
  another order than a batch of S), bit for bit where it is (reported);
  on a scenario-only mesh ``(N, 1, 1)`` also against one card's solves of
  the ranks' slices of S_local scenarios, bit for bit; on NCCL the graph's
  first replay against the eager sharded solve of the same draws on every
  rank (``graph_bitwise_eager``, reported) and, gathered, against the
  single solve within the same tolerance; a miss raises on every rank;
* ``collectives_share``: NCCL's kernel time over all kernel time of a
  replayed sharded solve on rank 0 (``torch.profiler``, after a warm-up;
  a kernel of a collective includes its wait for the other ranks), None
  on gloo, whose collectives run on the host;
* ``draw_ms``: a rank's draw of the whole solve's noise and map keys
  (``solver.draw_solve``: every rank draws all S scenarios' and keeps its
  rows), CUDA events;
* ``rank_spread``: the ranks' chain times (each rank's, at its own
  synchronize, before the barrier), max over min;
* ``kernel_nodes``: the kernels one replay of the rank's graph launches.

``--episodes`` instead runs ``make_sharded_trial_batch`` on noisy_dyn
episodes of the reference benchmark sweep (``benchmark.DeviceSweep``),
held at full length against the single-card
``device_sim.make_device_trial_batch`` of the same draws (steps and
success exact, cum_obj within ``EPISODE_RTOL``) and against the same
engine run on one card slice by slice (bit for bit), episodes per second
beside the single card's (``run_episodes``).

Left out of the JAX script: its ``--tpu`` flag and the virtual CPU
devices (``--device cpu --backend gloo`` runs on CPU ranks instead).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import SolverStatic
from ..parallel import multihost
from ..parallel.collectives import all_gather_cat
from ..parallel.mesh import make_mesh
from ..parallel.sharded import (gather_scenarios, get_sharded_terrain_solver,
                                make_sharded_trial_batch)
from ..solver import TerrainSolver, draw_solve
from ..terrain import resolve_device
from ..types import MapInputs, TerrainTask
from ._common import (SMALL_EPISODES, SMALL_STEPS, add_device_arg,
                      card_line, emit, launch_counts, launched_since, sync)

CHECK_SEED = 7
ROUNDS = 3       # chains of each loop, in turns
# cum_obj of the sharded episode batch against one card's batch of all E
# episodes at full length: four H100s read 3.6e-7 at E = 8, 150 steps.
EPISODE_RTOL = 1e-5
PROFILED_SOLVES = 3
DRAWS = 5
RTOL, ATOL = 2e-4, 2e-5
# The sweep's episodes (scripts/run_full_benchmark.py:42-66 at alpha 0.6).
SWEEP_DENSITIES = [1.0, 0.7, 0.4, 0.1]
SWEEP_ENVS, SWEEP_TRIALS, SWEEP_MAX_STEPS = 10, 3, 150
SWEEP_GRID, SWEEP_MARGIN, SWEEP_RES, SWEEP_ALPHA = (9, 9), 1, 1.0, 0.6
EPISODES = 8     # world (l)'s noisy_dyn episodes of the sweep


def build_case(S, K, M, T, H, W, B=22, device=None):
    """``scripts/scaling_bench.py::build_case``'s ``(static, maps, task,
    u0)``, the tensors on ``device`` (default: the card).  The JAX script
    also returns S keys; the port's draws come from a generator."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 100, size=(S, B, H, W)).astype(float)
    pmf = (raw / raw.sum(1, keepdims=True) * 100).astype(np.int8)
    pmf[:, -1] = 100 - pmf[:, :-1].sum(1)
    qbins = np.linspace(0, 100, B).astype(np.int8)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    zeros = np.zeros((S, H, W), np.int8)
    maps = MapInputs(t(pmf), t(pmf), t(np.broadcast_to(qbins, (S, B))),
                     t(np.broadcast_to(qbins, (S, B))), t(zeros), t(zeros),
                     t(zeros))
    f32 = np.float32

    def batch(x):
        x = np.asarray(x, f32)
        return t(np.broadcast_to(x, (S,) + x.shape))

    task = TerrainTask(
        x0=batch([2.0, 2.0, 0.3]), xgoal=batch([6.0, 6.0]),
        goal_tolerance=batch(0.4), v_post_rollout=batch(0.3),
        lambda_weight=batch(1.0), u_std=batch([1.0, 1.5]),
        vrange=batch([0.0, 2.0]), wrange=batch([-3.0, 3.0]),
        dt=batch(0.1), dist_weight=batch(1.5), obs_penalty=batch(1e4),
        unknown_penalty=batch(1e2), alpha_dyn=batch(1.0), res=batch(1.0),
        xlim0=batch(0.0), ylim0=batch(0.0), lin_lb=batch(0.0),
        lin_ratio=batch(0.01), ang_lb=batch(0.0), ang_ratio=batch(0.01))
    static = SolverStatic(mode="tdm", num_steps=T, num_control_rollouts=K,
                          num_grid_samples=M, map_shape=(H, W),
                          num_obstacles=0, cvar_numel=max(1, M // 3),
                          num_opt=1, num_vis_state_rollouts=1)
    u0 = torch.zeros((S, T, 2), dtype=torch.float32, device=device)
    return static, maps, task, u0


def sweep_episodes(E, K=1024, M=1024, method="noisy_dyn", device=None):
    """The first ``E`` episodes of the reference benchmark sweep at alpha
    0.6 (``benchmark.DeviceSweep``, K and M as given): ``(static, maps,
    task, (gt_lin, gt_ang, gt_meta))``."""
    from .. import Config, benchmark

    world = benchmark.make_benchmark_world(num_bins=20,
                                           rng=np.random.RandomState(0))
    cfg = Config(T=10.0, dt=0.1, num_grid_samples=M, num_control_rollouts=K,
                 max_speed_padding=5.0, num_vis_state_rollouts=50,
                 max_map_dim=(15, 15), seed=1, use_tdm=True)
    params = benchmark.default_benchmark_params(cfg, SWEEP_GRID,
                                                SWEEP_MARGIN)
    params["u_std"] = np.array([2.0, 3.0])
    sweep = benchmark.DeviceSweep(
        cfg, world, SWEEP_GRID, SWEEP_MARGIN, SWEEP_RES, params,
        SWEEP_DENSITIES, SWEEP_ENVS, SWEEP_TRIALS,
        device=resolve_device(device))
    _, static, maps, task = sweep.inputs(method, SWEEP_ALPHA)

    def first(tree):
        return type(tree)(*(None if x is None else x[:E] for x in tree))

    return static, first(maps), first(task), tuple(g[:E] for g in sweep.gt)


def default_mesh(n, S):
    """The JAX script's split of ``n`` ranks: the most scenario shards of
    4, 2 or 1 that divide both ``n`` and ``S``, the rest over k."""
    n_s = next(c for c in (4, 2, 1) if n % c == 0 and S % c == 0 and c <= n)
    return (n_s, n // n_s, 1)


def _timed(fn, device):
    """Host seconds of ``fn()``, ended by a synchronize."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def _chain(solve, u, iters, device):
    """Host seconds of ``iters`` solves dispatched back to back, each fed
    the last one's controls, then one synchronize (the JAX script's loop);
    ``solve(u) -> u``."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        u = solve(u)
    sync(device)
    return time.perf_counter() - t0


def _loops(solvers, u0, iters, device, meet=False):
    """``{name: [seconds of each chain]}``: ``ROUNDS`` chains of each of
    ``solvers`` (``{name: solve(u) -> u}``), in turns (a, b, b, a, ...).
    With ``meet``, the ranks start each chain together after a barrier
    and end it at one: each entry is then ``(seconds to the end of the
    slowest rank, this rank's seconds at its synchronize)``."""
    names = list(solvers)
    out = {name: [] for name in names}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            if not meet:
                out[name].append(_chain(solvers[name], u0, iters, device))
                continue
            dist.barrier()
            t0 = time.perf_counter()
            mine = _chain(solvers[name], u0, iters, device)
            dist.barrier()
            out[name].append((time.perf_counter() - t0, mine))
    return out


def _rows(tree, rows):
    return type(tree)(*(None if f is None else f[rows].contiguous()
                        for f in tree))


def _broadcast(values, device):
    """Rank 0's float values on every rank."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return t.tolist()


def draw_ms(static, S, device):
    """ms of one whole-solve draw (``solver.draw_solve`` of all S
    scenarios), CUDA events on a card, the host clock on the CPU."""
    gen = torch.Generator(device=device).manual_seed(0)
    draw_solve(gen, static, device, (S,))
    if device.type != "cuda":
        t, _ = _timed(lambda: [draw_solve(gen, static, device, (S,))
                               for _ in range(DRAWS)], device)
        return t * 1e3 / DRAWS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(DRAWS):
        draw_solve(gen, static, device, (S,))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / DRAWS


def collectives_share(solve, device):
    """``(share, nccl us, kernel us)`` a solve on this rank over
    ``PROFILED_SOLVES`` solves (``torch.profiler``): None on the CPU.
    Every rank profiles.  A first profiled solve, not counted, starts
    each rank's tracer (a start-up of up to a second, which the other
    ranks' collectives would wait out); the ranks meet at a barrier before
    the counted ones."""
    if device.type != "cuda":
        return None, None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        solve()
        torch.cuda.synchronize(device)
    dist.barrier()
    torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        for _ in range(PROFILED_SOLVES):
            solve()
        torch.cuda.synchronize(device)
    rows = [(e.key, float(e.device_time_total))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    total = sum(us for _, us in rows)
    nccl = sum(us for key, us in rows if "nccl" in key.lower())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no kernel time")
    return nccl / total, nccl / PROFILED_SOLVES, total / PROFILED_SOLVES


def _graphed(device):
    """Whether this run times graph replays: NCCL on cards."""
    return device.type == "cuda" and "nccl" in str(dist.get_backend())


def single_rates(static, maps, task, u0, iters, device):
    """Rank 0's single-card solves per second over all S scenarios (one
    batched solve a call): ``{"graph": ..., "eager": ...}`` on NCCL (the
    solve replayed from a ``SolveGraph`` and eager, in turns), ``{"eager":
    ...}`` on gloo."""
    solver = TerrainSolver(static, device)
    gens = {name: torch.Generator(device=device).manual_seed(0)
            for name in ("graph", "eager")}
    solvers = {}
    if _graphed(device):
        graph = solver.capture(gens["graph"], maps, task, u0.clone())
        solvers["graph"] = lambda u: graph(gens["graph"], maps, task, u)[0]
    solvers["eager"] = lambda u: solver(gens["eager"], maps, task, u)[0]
    for solve in solvers.values():
        solve(u0)
    chains = _loops(solvers, u0, iters, device)
    return {name: u0.shape[0] * iters / min(t) for name, t in chains.items()}


def measure_mesh(shape, static, maps, task, u0, args, device, single):
    """One mesh: its checks, throughput and costs; a record on every rank
    (rank 0's is printed).  ``single``: the single card's rates
    (``single_rates``)."""
    rank, n = dist.get_rank(), dist.get_world_size()
    S = u0.shape[0]
    graphed = _graphed(device)
    mesh = make_mesh(shape[0], shape[1], devices=device.type,
                     num_map_shards=shape[2])
    solver = get_sharded_terrain_solver(static, mesh)
    s_local = S // shape[0]
    rows = slice(solver.my_s * s_local, (solver.my_s + 1) * s_local)
    l_maps, l_task, l_u0 = _rows(maps, rows), _rows(task, rows), u0[rows]

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # The check: the gathered u against the single solve of the same draws
    # (all S in one batched solve); on a scenario-only mesh also against
    # one card's solves of the ranks' slices, each a batch of S_local as a
    # rank solves it, bit for bit; on NCCL the graph's first replay
    # against the eager sharded solve, and gathered against the single.
    scenario_only = shape[1] == 1 and shape[2] == 1
    u, _ = solver(gen(CHECK_SEED), l_maps, l_task, l_u0)
    got = gather_scenarios(mesh, u)
    graph = graph_got = None
    graph_bitwise = torch.ones(1, device=device)
    if graphed:
        g_graph = gen(CHECK_SEED)
        graph = solver.capture(g_graph, l_maps, l_task, l_u0.clone())
        u_g = graph(g_graph, l_maps, l_task, l_u0)[0]
        graph_bitwise[0] = float(torch.equal(u_g, u))
        graph_got = gather_scenarios(mesh, u_g)
    dist.all_reduce(graph_bitwise, op=dist.ReduceOp.MIN)
    verdict = [0.0] * 6
    if rank == 0:
        single_solver = TerrainSolver(static, device)
        want, _ = single_solver(gen(CHECK_SEED), maps, task, u0)

        def within(x):
            return float(bool((((x - want).abs() <= ATOL + RTOL
                                * want.abs()).all())))

        err = (got - want).abs()
        slices_bitwise = -1.0
        if scenario_only:
            keys, eps = draw_solve(gen(CHECK_SEED), static, device, (S,))
            parts = []
            for i in range(shape[0]):
                r = slice(i * s_local, (i + 1) * s_local)
                parts.append(single_solver.solve_from_key(
                    keys[r], [e[r] for e in eps], _rows(maps, r),
                    _rows(task, r), u0[r])[0])
            slices_bitwise = float(torch.equal(torch.cat(parts), got))
        graph_err = graph_within = -1.0
        if graph_got is not None:
            graph_err = float((graph_got - want).abs().max())
            graph_within = within(graph_got)
        verdict = [float(err.max()), float(torch.equal(got, want)),
                   within(got), slices_bitwise, graph_err, graph_within]
    (max_err, bitwise, within_tol, slices_bitwise, graph_err,
     graph_within) = _broadcast(verdict, device)
    check = dict(u_max_abs_err=max_err, bitwise=bool(bitwise),
                 within_tolerance=bool(within_tol),
                 slices_bitwise=(bool(slices_bitwise) if scenario_only
                                 else None),
                 expected="bit for bit" if scenario_only else
                 "rtol 2e-4 / atol 2e-5",
                 graph_bitwise_eager=(bool(graph_bitwise.item()) if graphed
                                      else None),
                 graph_u_max_abs_err=graph_err if graphed else None,
                 graph_within_tolerance=(bool(graph_within) if graphed
                                         else None))
    if (not within_tol or slices_bitwise == 0.0 or graph_within == 0.0):
        raise RuntimeError("scaling_bench mesh {}: the sharded u is off the "
                           "single solve: {}".format(shape, check))

    g = gen(0)
    solvers = {}
    if graphed:
        solvers["graph"] = lambda x: graph(g_graph, l_maps, l_task, x)[0]
    solvers["eager"] = lambda x: solver(g, l_maps, l_task, x)[0]
    before = launch_counts()
    next(iter(solvers.values()))(l_u0)
    launches = launched_since(before)
    for solve in solvers.values():
        solve(l_u0)
    chains = _loops(solvers, l_u0, args.iters, device, meet=True)
    timed = "graph" if graphed else "eager"
    best = min(range(ROUNDS), key=lambda r: chains[timed][r][0])
    mine = all_gather_cat(torch.tensor(
        [chains[timed][best][1]], dtype=torch.float64, device=device), 0,
        None).tolist()
    rate = {name: S * args.iters / min(t for t, _ in c)
            for name, c in chains.items()}
    share, nccl_us, kernel_us = collectives_share(
        lambda: solvers[timed](l_u0), device)
    sps, eager_sps = rate[timed], rate["eager"] if graphed else None
    return dict(
        scenario="scaling", devices=n,
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        solves_per_s=sps, efficiency=sps / (n * single[timed]),
        single_solves_per_s=single[timed],
        eager_solves_per_s=eager_sps,
        eager_efficiency=(eager_sps / (n * single["eager"]) if graphed
                          else None),
        eager_single_solves_per_s=single["eager"] if graphed else None,
        check=check,
        collectives_share=share, nccl_us_per_solve=nccl_us,
        kernel_us_per_solve=kernel_us,
        draw_ms=draw_ms(static, S, device),
        rank_chain_ms=[t * 1e3 / args.iters for t in mine],
        rank_spread=max(mine) / min(mine),
        backend=solver.backend, collectives=dist.get_backend(),
        launches_per_solve=launches,
        kernel_nodes=graph.kernel_nodes if graphed else None,
        shape=dict(S=S, K=static.num_control_rollouts,
                   M=static.num_grid_samples, T=static.num_steps,
                   map=list(static.map_shape)),
        clock=("host clock: {} CUDA-graph replays (collectives inside) "
               "dispatched back to back, then one synchronize and one "
               "barrier, the least of {} chains; eager_*: the same loop of "
               "eager solves, in turns".format(args.iters, ROUNDS)
               if graphed else
               "host clock, eager ({} collectives run on the host: no "
               "graph): {} solves dispatched back to back, then one "
               "synchronize and one barrier, the least of {} chains".format(
                   dist.get_backend(), args.iters, ROUNDS)))


def episode_batch(args, n):
    """``(episodes, steps)`` of ``--episodes`` on ``n`` ranks."""
    if args.small:
        return SMALL_EPISODES * n, SMALL_STEPS
    return EPISODES, SWEEP_MAX_STEPS


def run_episodes(shape, args, device):
    """The sharded episode batch, held twice against one card's results of
    the same draws, and timed; a record on every rank.

    * Against the single-card batch of all E episodes
      (``make_device_trial_batch``), at full length: steps and success
      exact, cum_obj within ``EPISODE_RTOL``.  A batch of E / n episodes
      sums in another float32 order on the card than one of E.
    * Against the same engine run on one card slice by slice (each slice
      drawing the whole batch's draws, as every rank does): every metric
      bit for bit.

    The timed call is the second (the first captures each rank's graph),
    beside the single card's batch timed the same way."""
    from ..device_sim import _Engine, make_device_trial_batch

    rank, n = dist.get_rank(), dist.get_world_size()
    E, steps = episode_batch(args, n)
    static, maps, task, gt = sweep_episodes(E, args.k, args.m, device=device)
    mesh = make_mesh(shape[0], shape[1], devices=device.type,
                     num_map_shards=shape[2])

    def seeded():
        return torch.Generator(device=device).manual_seed(CHECK_SEED)

    batch = make_sharded_trial_batch(static, steps, mesh)
    g = seeded()
    res = batch(g, maps, task, *gt)
    dist.barrier()
    before = launch_counts()
    wall, _ = _timed(lambda: batch(g, maps, task, *gt), device)
    launches = launched_since(before)
    verdict = [0.0] * 5
    if rank == 0:
        b = E // n
        parts = []
        for r in range(n):
            rows = slice(r * b, (r + 1) * b)
            engine = _Engine(static, steps, early_exit=True,
                             shard=(r, n))
            parts.append(engine(seeded(), _rows(maps, rows),
                                _rows(task, rows), *(x[rows] for x in gt)))
        slices_bitwise = all(torch.equal(torch.cat(list(f)), got)
                             for f, got in zip(zip(*parts), res))
        single = make_device_trial_batch(static, steps)
        gs = seeded()
        want = single(gs, maps, task, *gt)
        single_wall, _ = _timed(lambda: single(gs, maps, task, *gt), device)
        verdict = [float(torch.equal(res.steps, want.steps)),
                   float(torch.equal(res.success, want.success)),
                   float(((res.cum_obj - want.cum_obj) / want.cum_obj).abs()
                         .max()),
                   float(slices_bitwise), single_wall]
    steps_equal, success_equal, rel, slices_bitwise, single_wall = (
        _broadcast(verdict, device))
    check = dict(steps_equal=bool(steps_equal),
                 success_equal=bool(success_equal),
                 cum_obj_max_rel_err=rel, cum_obj_rtol=EPISODE_RTOL,
                 slices_bitwise=bool(slices_bitwise))
    if not (steps_equal and success_equal and rel <= EPISODE_RTOL
            and slices_bitwise):
        raise RuntimeError("scaling_bench --episodes: check failed: "
                           "{}".format(check))
    return dict(
        scenario="sharded_episodes", devices=n,
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), episodes=E,
        max_steps=steps, steps_run=batch.engine.steps_run,
        wall_s=wall, episodes_per_s=E / wall,
        single_wall_s=single_wall, single_episodes_per_s=E / single_wall,
        check=check, success_rate=float(res.success.float().mean()),
        launches=launches, draw_ms=draw_ms(static, E, device),
        clock="host clock, the whole batch on every rank, ended by a "
              "synchronize")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collectives (default: nccl, one rank a card; "
                         "--device cpu implies gloo)")
    ap.add_argument("--scenarios", type=int, default=8)
    # The JAX script's --k, --m and --t; under torchrun, whose own options
    # --m and --t abbreviate, spell them --rollouts, --samples, --horizon.
    ap.add_argument("--k", "--rollouts", dest="k", type=int, default=2048)
    ap.add_argument("--m", "--samples", dest="m", type=int, default=64)
    ap.add_argument("--t", "--horizon", dest="t", type=int, default=50)
    ap.add_argument("--map-dim", type=int, default=15)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mesh", action="append", default=None,
                    help="S,K,M shards; repeat for several meshes")
    ap.add_argument("--episodes", action="store_true",
                    help="the sharded episode batch instead of the solve")
    ap.add_argument("--small", action="store_true",
                    help="with --episodes: {} episodes a rank of at most "
                         "{} steps, a quick run".format(SMALL_EPISODES,
                                                        SMALL_STEPS))
    return ap.parse_args(argv)


def run(args):
    """Every mesh's record (the process group joined); rank 0 prints the
    card line and one JSON line a mesh."""
    rank, n = dist.get_rank(), dist.get_world_size()
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        if int(os.environ.get("LOCAL_RANK", rank)) == 0:
            from ..ops.kernels import _build

            for name in ("map_sample", "rollout_byte", "rollout_binned"):
                _build.build(name)       # once a host, before the others
    dist.barrier()
    if rank == 0:
        print(card_line(device), flush=True)
    S = episode_batch(args, n)[0] if args.episodes else args.scenarios
    meshes = ([tuple(int(v) for v in m.split(",")) for m in args.mesh]
              if args.mesh else [default_mesh(n, S)])
    records = []
    if args.episodes:
        for shape in meshes:
            records.append(run_episodes(shape, args, device))
            if rank == 0:
                emit(records[-1])
        return records
    static, maps, task, u0 = build_case(
        args.scenarios, args.k, args.m, args.t, args.map_dim, args.map_dim,
        device=device)
    # The port's 'auto' routes by the bins (JAX's tests VMEM instead).
    static = dataclasses.replace(static,
                                 num_pmf_bins=maps.lin_qbins.shape[-1])
    names = ("graph", "eager") if _graphed(device) else ("eager",)
    rates = (single_rates(static, maps, task, u0, args.iters, device)
             if rank == 0 else dict.fromkeys(names, 0.0))
    dist.barrier()
    single = dict(zip(names, _broadcast([rates[k] for k in names], device)))
    for shape in meshes:
        records.append(measure_mesh(shape, static, maps, task, u0, args,
                                    device, single))
        if rank == 0:
            emit(records[-1])
    return records


def main(argv=None):
    args = parse_args(argv)
    joined = not dist.is_initialized()
    if joined:
        multihost.initialize(backend=args.backend or (
            "gloo" if args.device == "cpu" else None))
    try:
        run(args)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
