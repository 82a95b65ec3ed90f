"""One robot through the planner's host path.

A control step is ``shift_and_update()`` with the new state (an episode's
first: ``set_params`` and the controls reset to zeros), then ``solve()``;
between steps the host's Euler step on one ground truth.  A new episode
(start and goal drawn from the seed) when the goal is reached or after
``max_steps``.  The mix names the protocol's ``method`` the planner runs
(its mode, and the alphas it states), and may name the map's
``grass_density`` where the configuration has none.

The check: each sampled solve of the window (the first, and each other
with probability ``1 / check_every`` drawn from the seed), from its own
inputs: the state the benchmark handed over, the goal, the controls in
(zeros at an episode's first solve, else the last solve's controls
shifted: there the reference follows the program's own state), and the
solve's draws replayed from a generator seeded as the planner's.
Compared: the sampled maps on the window and its offset
(``grid_mismatch``, a count), each rollout's CVaR-plus-coupling cost
(``cost_gap``), and the controls (``u_gap``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import check, inputs
from ..drive import (MODE_FLAGS, METHOD_MODES, Result, Tracer, program_config,
                     settle, solve_shape, task_params)
from ..reference import mppi as ref


def planner_mode(cfg, mix):
    """What the planner states under the mix: ``(mode, M, det_alpha,
    cvar_alpha, alpha_dyn)``; alpha_dyn is the task's, which the planner
    sets to 1 in the M = 1 modes."""
    method = mix["method"]
    mode = METHOD_MODES[method]
    p = cfg["params"]
    det_alpha, _, _ = ref.method_alphas(method, p["cvar_alpha"])
    M = cfg["planner"]["num_grid_samples"] if mode == "tdm" else 1
    alpha_dyn = p["alpha_dyn"] if mode == "tdm" else 1.0
    return mode, M, det_alpha, p["cvar_alpha"], alpha_dyn


def drive(run):
    from mppi_numba_tpu_torch.config import Config
    from mppi_numba_tpu_torch.mppi import MPPIPlanner
    from mppi_numba_tpu_torch.terrain import TDM

    cfg, mix, spans = run.cfg, run.mix, run.spans
    s = inputs.sub_seeds(run.seed, ("map", "episodes", "planner", "check"))
    world, sg, (truth,) = inputs.one_map(cfg, s["map"], 1,
                                         mix.get("grass_density"))
    pw = inputs.program_world(world)
    res = cfg["grid"]["res"]
    dt = cfg["planner"]["dt"]
    mode, M, det_alpha, cvar_alpha, _ = planner_mode(cfg, mix)
    conf = program_config(Config, cfg, s["planner"],
                          **{MODE_FLAGS[mode]: True})
    lims = ((0, sg.shape[1] * res), (0, sg.shape[0] * res))
    tdms = []
    for plane in ("lin", "ang"):
        tdm = TDM(conf, device=run.device)
        tdm.set_TDM_from_semantic_grid(
            sg, res, pw["num_pmf_bins"], pw["bin_values"],
            pw["bin_values_bounds"], *lims, pw["id2name"],
            pw["name2terrain"], pw[plane + "_terrain2pmf"],
            det_dynamics_cvar_alpha=det_alpha)
        tdms.append(tdm)
    params = task_params(cfg)
    tol = params["goal_tolerance"]
    ep_rng = np.random.RandomState(s["episodes"])

    def episode():
        return inputs.start_goal(ep_rng, sg.shape, res, mix["margin_m"],
                                 mix["start_goal_m"])

    planner = MPPIPlanner(conf, device=run.device)
    x, goal = episode()
    params.update(x0=x, xgoal=goal)
    planner.setup(params, *tdms)
    zeros = np.zeros((conf.num_steps, 2), np.float32)
    st = dict(x=x, goal=goal, k=0, start=True, useq=None)
    log, outputs, kept = [], [], {}
    counts = dict(failed=0, episodes=0)
    step_s = []

    def new_episode():
        st["x"], st["goal"] = episode()
        st.update(k=0, start=True, useq=None)
        counts["episodes"] += 1

    def step(keep):
        t0 = time.perf_counter()
        with spans("planner.update"):
            if st["start"]:
                params.update(x0=st["x"], xgoal=st["goal"])
                planner.set_params(params)
                planner.shift_optimal_control_sequence(zeros)
            else:
                planner.shift_and_update(st["x"], st["useq"], num_shifts=1)
        with spans("planner.solve"):
            useq = planner.solve()
        step_s.append(time.perf_counter() - t0)
        if useq is None:            # refused before it drew: no round
            counts["failed"] += 1
            new_episode()
            return
        counts["failed"] += int(not np.all(np.isfinite(useq)))
        n = len(log)
        log.append((np.asarray(st["x"], np.float32),
                    np.asarray(st["goal"], np.float32), st["start"]))
        outputs.append(useq)
        if keep:
            aux = planner._last_aux
            kept[n] = dict(lin=aux.lin_grids.clone(),
                           ang=aux.ang_grids.clone(),
                           offset=aux.roi_offset.clone(),
                           costs=aux.costs.clone())
        with spans("sim.step"):
            lt, at = inputs.truth_at(truth, res, st["x"][0], st["x"][1])
            x_new = inputs.simulate_step(st["x"], useq[0], lt, at, dt)
        st["k"] += 1
        dist = math.hypot(x_new[0] - st["goal"][0],
                          x_new[1] - st["goal"][1]) - tol
        if dist <= 0 or st["k"] >= cfg["episode"]["max_steps"]:
            new_episode()
        else:
            st.update(x=x_new, start=False, useq=useq)

    for _ in range(mix["warmup_steps"]):
        step(False)
    torch.cuda.synchronize(run.device) if run.device.type == "cuda" else None
    step_s.clear()
    spans.durations.clear()
    check_rng = np.random.RandomState(s["check"])
    tracer = Tracer(run, run.seconds)
    settle()
    slice_solves = 0
    w0 = time.perf_counter()
    steps = 0
    while True:
        elapsed = time.perf_counter() - w0
        if elapsed >= run.seconds:
            break
        keep = steps == 0 or check_rng.rand() < 1.0 / mix["check_every"]
        profiled = tracer.before(elapsed)
        before = len(log)
        step(keep)
        slice_solves += (len(log) - before) if profiled else 0
        tracer.after()
        steps += 1
    window = time.perf_counter() - w0
    tracer.close()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    roi = ref.reach_window(cfg, sg.shape)
    shape = solve_shape(cfg, M, roi, cvar_alpha, mode)
    del planner, tdms
    return Result(
        e2e=dict(step_ms=1e3 * window / steps,
                 step_ms_p95=1e3 * float(np.percentile(step_s, 95))),
        attempted=steps, failed=counts["failed"], setup_s=w0 - run.t_start,
        memory_peak_bytes=int(peak),
        check=dict(world=world, grid=sg, planner_seed=s["planner"],
                   log=log, outputs=outputs, kept=kept),
        slice=tracer.slice, slice_work=[(slice_solves, shape)],
        slice_calls=slice_solves,
        info=dict(steps=steps, episodes=counts["episodes"],
                  slice_solves=slice_solves, **tracer.info()))


def numbers(run, result, control=False):
    """The closed loop's numbers: ``{name: value}``."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    c = result.check
    pc, p = cfg["planner"], cfg["params"]
    K = pc["num_control_rollouts"]
    T = int(pc["T"] / pc["dt"] + 1e-6)
    mode, M, det_alpha, cvar_alpha, alpha_dyn = planner_mode(cfg, mix)
    P = ref.planes(c["world"], c["grid"], mode, det_alpha,
                   ref.pad_cells(cfg))
    lin, ang, risk = (torch.tensor(a, device=dev)[None]
                      for a in (P.lin, P.ang, P.risk))
    qb_lin = torch.tensor(P.lin_q, device=dev)
    qb_ang = torch.tensor(P.ang_q, device=dev)
    roi = ref.reach_window(cfg, c["grid"].shape)
    ft = ref.fast_trig(cfg, dev.type == "cuda")
    numel = int(math.ceil(M * cvar_alpha))
    draws = ref.replay_draws(c["planner_seed"], set(c["kept"]), (), K, T,
                             dev)
    scale = check.widths(cfg)
    out = dict(grid_mismatch=0, cost_gap=0.0, u_gap=0.0)
    for n in sorted(c["kept"]):
        x0, goal, start = c["log"][n]
        u_in = np.zeros((T, 2), np.float32)
        if not start:
            prev = c["outputs"][n - 1]
            u_in = np.concatenate([prev[1:], prev[-1:]])
        key, eps = draws[n]
        tk = ref.task(cfg, c["world"], x0[None], goal[None], alpha_dyn,
                      cvar_alpha, dev)
        args = (lin, ang, qb_lin, qb_ang, risk, tk,
                torch.tensor(u_in, device=dev)[None], key[None], eps[None])
        kw = dict(M=M, roi=roi, fast_trig=ft, speed_map=mode == "speed_map",
                  numel=numel)
        r = ref.solve(*args, **kw)
        if control:
            q = ref.solve(*args, dtype=torch.bfloat16, **kw)
            prog = dict(u=q["u"][0], costs=q["costs"][0], lin=q["lin"][0],
                        ang=q["ang"][0], offset=q["offset"][0])
        else:
            k = c["kept"][n]
            prog = dict(u=torch.from_numpy(c["outputs"][n]), costs=k["costs"],
                        lin=k["lin"], ang=k["ang"], offset=k["offset"])
        out["grid_mismatch"] += int(
            (prog["lin"].cpu() != r["lin"][0].cpu()).sum()
            + (prog["ang"].cpu() != r["ang"][0].cpu()).sum()
            + (prog["offset"].long().cpu() != r["offset"][0].cpu()).sum())
        out["cost_gap"] = max(out["cost_gap"],
                              check.cost_gap(prog["costs"], r["costs"][0]))
        out["u_gap"] = max(out["u_gap"],
                           check.u_gap(prog["u"], r["u"][0], scale))
    out["solves_checked"] = len(c["kept"])
    return out
