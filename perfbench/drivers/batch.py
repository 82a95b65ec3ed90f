"""Chunks of episodes as one device batch.

Each chunk runs through ``device_sim.make_device_trial_batch`` on
``benchmark.DeviceSweep``'s inputs: the protocol's paired episodes
(``"inputs": "protocol"``) or robots on one map (``"inputs": "fleet"``).
The chunks cycle in an order drawn from the seed, each (method, alpha)
once before any comes again, and the mix's methods take turns chunk by
chunk.  The window runs whole chunks; its rate is all their episodes over
all their time.

The check follows the first chunk of each (method, alpha) of the window
(``checked chunks``) through every one of its steps: the episodes' state
is read after each step of the batch (after each replay of the step's
graph on a card, after each eager step elsewhere).  Then, after the
window:

* at each checked chunk's step 0 and at ``check_steps`` more steps drawn
  from the seed, the plain reference steps the chunk from the state
  before the step (at step 0 the benchmark's own inputs: starts, zero
  controls; else the program's state, which the reference follows), the
  chunk's draws replayed: every episode's controls after the step
  (``u_gap``, over each control's range) and its state (``x_gap``, metres
  and radians);
* at every step of a checked chunk, the episode's bookkeeping, from the
  state before it and the position after it: the goal distance
  (``dist_gap``, metres), the running sums (``cum_gap``, ``cum_obj`` and
  ``cum_dist`` over the larger of the reference's and 1), ``reached``
  and ``steps`` (``reached_mismatch``, ``steps_mismatch``: counts of
  episodes that differ; ``reached`` within ``BOUNDARY_M`` of the goal's
  tolerance is rounding's to decide), and that finished episodes keep
  their state (into ``x_gap`` and ``u_gap``);
* ``unchecked``: the steps that were run and not read, or read and not
  run, and the checked chunks that the window never ran.  A step read is
  one step of every episode: should one read cover more, the steps and
  distances cannot follow.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import check, inputs
from ..drive import (METHOD_MODES, Result, Tracer, program_config, settle,
                     solve_shape, task_params)
from ..reference import mppi as ref

# The state of a batch of episodes, in the order of the program's
# ``device_sim._Episodes.tensors()``.
EPISODE_FIELDS = ("x", "u", "reached", "steps", "cum_obj", "cum_dist", "dist")
# A goal distance within this many metres of the tolerance leaves
# ``reached`` to rounding: a flip there is no mismatch.
BOUNDARY_M = 1e-3


def make_sweep(DeviceSweep, conf, world, grids, rows, res, params, device):
    """A ``DeviceSweep`` on the benchmark's own episodes: its inputs
    (``inputs(method, alpha)``) built from these grids and world."""
    H, W = next(iter(grids.values())).shape

    class Sweep(DeviceSweep):
        def __init__(self):
            self.device = device
            self.orig_cfg, self.world, self.res = conf, world, res
            self.params = params
            self.env_grids, self.episodes = grids, rows
            self.limits = ((0, W * res), (0, H * res))
            self._maps = {}

    return Sweep()


@dataclasses.dataclass
class Chunk:
    method: str
    alpha: float
    rows: np.ndarray           # the episodes' indices
    starts: int                # the fleet's set of starts and goals
    maps: Any = None
    task: Any = None
    gt: Any = None


def chunk_seed(base, j):
    """The draws' seed of the window's chunk ``j``."""
    return (int(base) * 1_000_003 + j) % (1 << 62)


def read_each_step(engines, current, record, spans, device):
    """After each step of a batch, ``record(the engine's episode
    tensors)``; on a card, each replay of the running engine's step graph
    is also a ``batch.replay`` span while the profiler runs.  Returns the
    undo."""
    if device.type == "cuda":
        from mppi_numba_tpu_torch.graphs import Captured

        replay = Captured.replay

        def replayed(self, *a, **kw):
            if spans.profiling:
                with spans("batch.replay"):
                    out = replay(self, *a, **kw)
            else:
                out = replay(self, *a, **kw)
            g = engines[current()]._graphed
            if g is not None and self is g.call:
                record(g.ep.tensors())
            return out

        Captured.replay = replayed
        return lambda: setattr(Captured, "replay", replay)
    import mppi_numba_tpu_torch.device_sim as device_sim

    step = device_sim._Episodes.step

    def stepped(self, *a, **kw):
        out = step(self, *a, **kw)
        record(self.tensors())
        return out

    device_sim._Episodes.step = stepped
    return lambda: setattr(device_sim._Episodes, "step", step)


def drive(run):
    from mppi_numba_tpu_torch.benchmark import DeviceSweep
    from mppi_numba_tpu_torch.config import Config
    from mppi_numba_tpu_torch.device_sim import make_device_trial_batch

    cfg, mix, spans, dev = run.cfg, run.mix, run.spans, run.device
    s = inputs.sub_seeds(run.seed, ("inputs", "order", "draws", "check",
                                    "starts", "rows"))
    res = cfg["grid"]["res"]
    fleet = mix["inputs"] == "fleet"
    if fleet:
        world, sg, truths = inputs.one_map(cfg, s["inputs"], mix["chunk"],
                                           mix.get("grass_density"))
        grids = {(0, 0): sg}
        rows = [dict(density_i=0, env_i=0, trial_i=b, gt=truths[b])
                for b in range(mix["chunk"])]
        alphas = [cfg["params"]["cvar_alpha"]]
        roi = ref.reach_window(cfg, sg.shape)
        st_rng = np.random.RandomState(s["starts"])
        starts = [[inputs.start_goal(st_rng, sg.shape, res, mix["margin_m"],
                                     mix["start_goal_m"])
                   for _ in rows] for _ in range(mix["start_sets"])]
    else:
        world, grids, rows = inputs.protocol(cfg, s["inputs"])
        alphas = cfg["protocol"]["alphas"]
        roi = None
        starts = [None]
    params = task_params(cfg)
    params.setdefault("x0", np.zeros(3))          # the fleet's: per chunk
    params.setdefault("xgoal", np.zeros(2))
    conf = program_config(Config, cfg, 0, use_tdm=True)
    sweep = make_sweep(DeviceSweep, conf, inputs.program_world(world), grids,
                       rows, res, params, dev)
    gt = tuple(torch.tensor(a, device=dev) for a in (
        np.stack([r["gt"][0] for r in rows]).astype(np.float32),
        np.stack([r["gt"][1] for r in rows]).astype(np.float32),
        np.tile(np.array([0.0, 0.0, 1.0 / res], np.float32),
                (len(rows), 1))))
    B = mix["chunk"]
    max_steps = cfg["episode"]["max_steps"]
    mixed = np.random.RandomState(s["rows"]).permutation(len(rows))

    # Every chunk's inputs, in set-up: the TDMs of each (method, alpha),
    # then each chunk's rows of them.  A chunk's episodes are drawn from
    # all of the protocol's densities (the rows in an order drawn from the
    # seed), the same chunks at every alpha.
    order_rng = np.random.RandomState(s["order"])
    per_method = {}
    engines, gens, statics = {}, {}, {}
    M_of = {}
    for method in mix["methods"]:
        per_alpha = []
        for alpha in alphas:
            _, static, maps, task = sweep.inputs(method, alpha)
            if fleet:
                static = dataclasses.replace(
                    static, roi_shape=tuple(roi),
                    cvar_numel=ref.cvar_count(static.num_grid_samples,
                                              alpha))
            statics[method] = static
            M_of[method] = static.num_grid_samples
            lst = []
            for si, st in enumerate(starts):
                for lo in range(0, len(rows), B):
                    c = Chunk(method, alpha, mixed[lo:lo + B], si)
                    tidx = torch.tensor(c.rows, device=dev)
                    tk = task
                    if st is not None:
                        tk = task._replace(
                            x0=torch.tensor(np.array([a for a, _ in st]),
                                            dtype=torch.float32, device=dev),
                            xgoal=torch.tensor(np.array([b for _, b in st]),
                                               dtype=torch.float32,
                                               device=dev))
                    c.maps = type(maps)(*(t[tidx] for t in maps))
                    c.task = type(tk)(*(None if t is None else t[tidx]
                                        for t in tk))
                    c.gt = tuple(g[tidx] for g in gt)
                    lst.append(c)
            per_alpha.append([lst[i] for i in order_rng.permutation(len(lst))])
        # Each alpha once before any comes again, in an order drawn from
        # the seed.
        a_order = order_rng.permutation(len(alphas))
        per_method[method] = [per_alpha[a][i]
                              for i in range(len(per_alpha[0]))
                              for a in a_order]
        engines[method] = make_device_trial_batch(statics[method], max_steps)
        gens[method] = torch.Generator(device=dev)
    # The methods take turns chunk by chunk.
    order = [per_method[m][i] for i in range(max(map(len,
                                                     per_method.values())))
             for m in mix["methods"] if i < len(per_method[m])]
    n_checked = len(mix["methods"]) * len(alphas)

    # Warm-up: one chunk a method (the step's graph is captured there).
    for method in mix["methods"]:
        c = per_method[method][0]
        gens[method].manual_seed(s["draws"])
        out = engines[method](gens[method], c.maps, c.task, *c.gt)
        [f.cpu() for f in out]

    # The episodes' state after each step of the checked chunks.
    cur = dict(j=-1, method=mix["methods"][0])
    states = {j: [] for j in range(n_checked)}

    def record(tensors):
        if cur["j"] in states:
            states[cur["j"]].append(tuple(t.clone() for t in tensors))

    undo = read_each_step(engines, lambda: cur["method"], record, spans, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    tracer = Tracer(run, run.seconds)
    settle()
    calls, chunks, results = [], [], []
    slice_work, slice_calls = [], 0
    episodes = 0
    try:
        w0 = time.perf_counter()
        j = 0
        while True:
            elapsed = time.perf_counter() - w0
            if elapsed >= run.seconds:
                break
            c = order[j % len(order)]
            seed_j = chunk_seed(s["draws"], j)
            engine = engines[c.method]
            gens[c.method].manual_seed(seed_j)
            cur.update(j=j, method=c.method)
            profiled = tracer.before(elapsed)
            t0 = time.perf_counter()
            with spans("batch.engine"):
                out = engine(gens[c.method], c.maps, c.task, *c.gt)
            with spans("batch.result"):
                got = [f.cpu().numpy() for f in out]
            t1 = time.perf_counter()
            tracer.after()
            n = engine.steps_run
            calls.append((B * n, t1 - t0, profiled))
            chunks.append((c, seed_j, n))
            results.append(got)
            if profiled:
                slice_work.append((B * n, solve_shape(
                    cfg, M_of[c.method],
                    roi if roi else tuple(c.maps.lin_pmf.shape[-2:]),
                    c.alpha, METHOD_MODES[c.method])))
                slice_calls += n
            episodes += B
            j += 1
        window = time.perf_counter() - w0
    finally:
        undo()
    tracer.close()
    peak = (torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0)
    del engines, gens, sweep
    failed = sum(int(np.sum(~np.isfinite(r[4]))) for r in results)
    done = sum(int(np.sum(r[1])) for r in results)
    return Result(
        e2e={mix.get("rate_metric", "episodes_per_s"): episodes / window},
        attempted=episodes, failed=failed, setup_s=w0 - run.t_start,
        memory_peak_bytes=int(peak),
        check=dict(world=world, grids=grids, rows=rows, chunks=chunks,
                   states=states, roi=roi, M_of=M_of, starts=starts,
                   check_seed=s["check"]),
        slice=tracer.slice, slice_work=slice_work, slice_calls=slice_calls,
        batch_calls=calls,
        info=dict(chunks=j, success=done / max(episodes, 1),
                  steps_run=[n for _, _, n in chunks],
                  slice_replays=slice_calls, **tracer.info()))


# -- the check --------------------------------------------------------------


def _gap(a, b):
    """``|a - b|``, nought where both are NaN, infinite where one is."""
    d = (a.float() - b.float()).abs()
    both = torch.isnan(a.float()) & torch.isnan(b.float())
    d = torch.where(both, torch.zeros_like(d), d)
    return torch.nan_to_num(d, nan=float("inf"))


def bookkeeping(before, after, goal, tol, dt, scale):
    """The episodes' bookkeeping of the steps from ``before`` to ``after``
    (dicts of ``EPISODE_FIELDS``, any leading axes before the episodes'),
    from the position after each step: ``{number: value}``; ``scale``
    each control's range."""
    act = ~before["reached"]
    d = after["x"][..., :2].float() - goal
    dist = torch.where(act, torch.sqrt(d[..., 0] * d[..., 0]
                                       + d[..., 1] * d[..., 1]) - tol,
                       before["dist"].float())
    reached = before["reached"] | (act & (dist <= 0))
    rounding = act & (dist.abs() <= BOUNDARY_M)
    steps = before["steps"] + act.to(before["steps"].dtype)
    sums = [(after[f], before[f].float() + torch.where(act, add, 0.0))
            for f, add in (("cum_obj", dt + dist), ("cum_dist", dist))]
    cum = max(float((_gap(a, r) / r.abs().clamp(min=1.0)).max())
              for a, r in sums)
    done = ~act
    return dict(
        reached_mismatch=int(((after["reached"] != reached)
                              & ~rounding).sum()),
        steps_mismatch=int((after["steps"] != steps).sum()),
        cum_gap=cum,
        dist_gap=float(_gap(after["dist"], dist).max()),
        x_gap=float((_gap(after["x"], before["x"])
                     * done[..., None]).max()),
        u_gap=float((_gap(after["u"], before["u"]) / scale
                     * done[..., None, None]).max()))


def _merge(out, new):
    for k, v in new.items():
        out[k] = out[k] + v if isinstance(v, int) else max(out[k], v)


def numbers(run, result, control=False):
    """The batch cells' numbers: ``{name: value}``."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    c = result.check
    pc, p = cfg["planner"], cfg["params"]
    K = pc["num_control_rollouts"]
    T = int(pc["T"] / pc["dt"] + 1e-6)
    res = cfg["grid"]["res"]
    pad = ref.pad_cells(cfg)
    ft = ref.fast_trig(cfg, dev.type == "cuda")
    inv_res = float(np.float32(1.0 / res))
    tol = float(np.float32(p["goal_tolerance"]))
    dt = float(np.float32(pc["dt"]))
    scale = check.widths(cfg)
    scale_t = torch.tensor(scale, device=dev)
    check_rng = np.random.RandomState(c["check_seed"])
    cache = {}
    out = dict(u_gap=0.0, x_gap=0.0, reached_mismatch=0, steps_mismatch=0,
               cum_gap=0.0, dist_gap=0.0,
               unchecked=sum(j >= len(c["chunks"]) for j in c["states"]))
    steps_checked = 0
    for j in sorted(j for j in c["states"] if j < len(c["chunks"])):
        chunk, seed_j, n = c["chunks"][j]
        read = c["states"][j]
        out["unchecked"] += abs(len(read) - n)
        mode = METHOD_MODES[chunk.method]
        M = c["M_of"][chunk.method]
        det_alpha, cvar_alpha, alpha_dyn = ref.method_alphas(chunk.method,
                                                             chunk.alpha)
        rows = [c["rows"][i] for i in chunk.rows]
        S = len(rows)
        if c["starts"][chunk.starts] is None:
            x0 = np.broadcast_to(np.asarray(p["x0"], np.float32), (S, 3))
            goals = np.broadcast_to(np.asarray(p["xgoal"], np.float32),
                                    (S, 2))
        else:
            st = c["starts"][chunk.starts]
            x0 = np.array([st[i][0] for i in chunk.rows], np.float32)
            goals = np.array([st[i][1] for i in chunk.rows], np.float32)
        # The state before the chunk's first step: the benchmark's own.
        start = dict(
            x=torch.tensor(x0, device=dev),
            u=torch.zeros((S, T, 2), device=dev),
            reached=torch.zeros(S, dtype=torch.bool, device=dev),
            steps=torch.zeros(S, dtype=torch.int32, device=dev),
            cum_obj=torch.zeros(S, device=dev),
            cum_dist=torch.zeros(S, device=dev),
            dist=torch.full((S,), float("nan"), device=dev))
        seq = [start] + [dict(zip(EPISODE_FIELDS, t)) for t in read]
        goal_t = torch.tensor(goals, device=dev)
        if not control and len(seq) > 1:
            stacked = {f: torch.stack([s[f] for s in seq]) for f in
                       EPISODE_FIELDS}
            _merge(out, bookkeeping({f: v[:-1] for f, v in stacked.items()},
                                    {f: v[1:] for f, v in stacked.items()},
                                    goal_t, tol, dt, scale_t))
        ks = [0]
        if min(n, len(seq) - 1) > 1:
            ks += sorted(int(k) for k in check_rng.choice(
                np.arange(1, min(n, len(seq) - 1)),
                size=min(mix["check_steps"], min(n, len(seq) - 1) - 1),
                replace=False))
        ks = [k for k in ks if k + 1 < len(seq)]
        if not ks:
            continue
        pl = []
        for r in rows:
            key = (r["density_i"], r["env_i"], mode, det_alpha)
            if key not in cache:
                cache[key] = ref.planes(c["world"], c["grids"][key[:2]],
                                        mode, det_alpha, pad)
            pl.append(cache[key])
        draws = ref.replay_draws(seed_j, set(ks), (S,), K, T, dev)
        numel = ref.cvar_count(M, cvar_alpha) if (c["roi"] or M == 1) \
            else None
        gt_lin = torch.tensor(np.stack([r["gt"][0] for r in rows]),
                              dtype=torch.float32, device=dev)
        gt_ang = torch.tensor(np.stack([r["gt"][1] for r in rows]),
                              dtype=torch.float32, device=dev)
        for k in ks:
            before = seq[k]
            key_k, eps_k = draws[k]
            tk = ref.task(cfg, c["world"], before["x"].cpu().numpy(), goals,
                          alpha_dyn, cvar_alpha, dev)

            def stepped(dtype):
                u_new = torch.zeros((S, T, 2), dtype=dtype, device=dev)
                act = torch.nonzero(~before["reached"]).flatten().tolist()
                blk = max(1, check.LANES // (K * M))
                for i in range(0, len(act), blk):
                    ix = act[i:i + blk]
                    t = torch.tensor(ix, device=dev)
                    sub = tk._replace(**{f: getattr(tk, f)[t]
                                         for f in tk._fields})
                    r = ref.solve(
                        check.on_card([pl[b].lin for b in ix], dev),
                        check.on_card([pl[b].ang for b in ix], dev),
                        torch.tensor(pl[0].lin_q, device=dev),
                        torch.tensor(pl[0].ang_q, device=dev),
                        check.on_card([pl[b].risk for b in ix], dev), sub,
                        before["u"][t], key_k[t], eps_k[t], M=M,
                        roi=c["roi"], fast_trig=ft,
                        speed_map=mode == "speed_map", numel=numel,
                        dtype=dtype)
                    u_new[t] = r["u"]
                return ref.episode_step(before, u_new, gt_lin, gt_ang,
                                        inv_res, tk, dtype)

            r = stepped(torch.float32)
            prog = stepped(torch.bfloat16) if control else seq[k + 1]
            if control:
                _merge(out, bookkeeping(before, prog, goal_t, tol, dt,
                                        scale_t))
            out["u_gap"] = max(out["u_gap"],
                               check.u_gap(prog["u"], r["u"], scale))
            out["x_gap"] = max(out["x_gap"], float(
                (prog["x"].float() - r["x"].float()).abs().max()))
            steps_checked += 1
    out["steps_checked"] = steps_checked
    return out
