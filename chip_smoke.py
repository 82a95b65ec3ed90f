#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mppi_numba_tpu_torch``) on one
NVIDIA GPU: build every kernel, hold each against its plain PyTorch
version, drive the planner's main path, and time it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no error is swallowed):

1. Build ``csrc/*.cu`` with nvcc for sm_90a and print the ptxas report
   (registers, spills) and the card's name and power limit.
2. The rollout kernel against its plain version at full K, on the byte
   layout cases of the JAX package's on-chip parity record; then one small
   whole solve, the kernel path against its plain version on the card and
   against the CPU (``small_solve_witness``).
3. The main path: ``MPPIPlanner`` on ``device="cuda"`` through ``setup``,
   ``solve`` and ``shift_and_update`` -- (a) the flagship (a 9x9 22-bin PMF
   padded to 11x11, K = M = 1024, T = 100, CVaR alpha 0.2) and (b) a
   246x246 external PMF padded to 250x250, 20 closed-loop solves each.
   Every kernel's launch count is set to 0 just before and read just after.
4. Timing with CUDA events (kernel and plain version at the flagship shape,
   in turns), then per world, in turns, chained solves on the device clock
   beside the host's time to enqueue them and planner ``solve()`` times on
   the host clock, and the device's busy time per solve by kernel.  Each
   figure is printed as a JSON line with the card's name and power limit.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32, non-tensor-core

# float32 operations per lane-step of the rollout kernel, counted from
# csrc/rollout_byte.cu (a sqrtf, sinf or cosf counts as one): cell index 10,
# decode 4, dynamics (fast-trig rotation 24 | exact 11; x and y share the
# product dt*lin_tr*v), goal distance 5, stage cost 7, masking 9; speed_map
# adds 4.  Per lane once: 6 for the terminal cost, plus the start heading's
# cosf/sinf in fast-trig mode.
OPS_STEP_FAST, OPS_STEP_EXACT, OPS_SPEED_MAP = 59, 46, 4


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed nothing")
    return out[0].strip()


def rollout_bound_ms(K, M, T, H, W, fast_trig, speed_map):
    """Least time for one rollout call: the larger of its bytes (words,
    task, controls in; costs out) over HBM bandwidth and its float32
    operations over the float32 peak.  Returns (ms, bound_by)."""
    nbytes = 4 * (M * H * W + 19 + 2 * T * K + K * M)
    per_step = ((OPS_STEP_FAST if fast_trig else OPS_STEP_EXACT)
                + (OPS_SPEED_MAP if speed_map else 0))
    ops = K * M * (T * per_step + 6 + (2 if fast_trig else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one",
              file=sys.stderr)
        return 2

    from mppi_numba_tpu_torch import Config, MPPIPlanner, TDM
    from mppi_numba_tpu_torch.ops.kernels import _build, rollout_byte
    from mppi_numba_tpu_torch.ops.packing import pack_map_words
    from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
    from mppi_numba_tpu_torch.types import TerrainTask

    dev = torch.device("cuda")
    kernel = rollout_byte.terrain_rollout_costs_byte
    plain = rollout_byte.terrain_rollout_costs_byte_plain

    # -- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build("rollout_byte")
    build_s = time.perf_counter() - t0
    if report is None:
        print("rollout_byte: already built from this source at {}".format(
            _build.library_path("rollout_byte")))
    for line in (report or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas[rollout_byte]: {}".format(line.strip()))
    print("build: {:.1f} s".format(build_s))
    card = card_line()
    print(card)
    card_name, _, power_limit = card.rpartition(", ")
    tag = {"card": card_name, "power_limit": power_limit}

    def emit(metric, value, unit, **extra):
        print(json.dumps(dict(metric=metric, value=value, unit=unit,
                              **extra, **tag)), flush=True)

    # -- phase 2: kernel vs plain version ---------------------------------------
    def make_task(H, W, res):
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        return TerrainTask(
            x0=f([0.3 * W * res, 0.3 * H * res, 0.785]),
            xgoal=f([0.8 * W * res, 0.8 * H * res]),
            goal_tolerance=f(0.5), v_post_rollout=f(0.01),
            lambda_weight=f(1.0), u_std=f([2.0, 3.0]), vrange=f([0.0, 3.0]),
            wrange=f([-3.14, 3.14]), dt=f(0.1), dist_weight=f(1.0),
            obs_penalty=f(1e5), unknown_penalty=f(1e2), alpha_dyn=f(1.0),
            res=f(res), xlim0=f(0.0), ylim0=f(0.0), lin_lb=f(0.0),
            lin_ratio=f(0.01), ang_lb=f(0.0), ang_ratio=f(0.01),
            cvar_alpha=f(0.2))

    def make_case(K, M, T, H, W, res, penalties, speed_map, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        i8 = torch.int8
        lin = torch.randint(0, 101, (M, H, W), generator=g, device=dev, dtype=i8)
        ang = torch.randint(0, 101, (M, H, W), generator=g, device=dev, dtype=i8)
        p = 0.1 if penalties else 0.0
        obs = (torch.rand((H, W), generator=g, device=dev) < p).to(i8)
        unk = (torch.rand((H, W), generator=g, device=dev) < p).to(i8)
        risk = torch.randint(1, 101, (H, W), generator=g, device=dev, dtype=i8)
        words = pack_map_words(lin, ang, obs, unk, risk if speed_map else None)
        task = make_task(H, W, res)
        u = torch.rand((T, 2), generator=g, device=dev) * 2.0 - 0.5
        noise = torch.randn((K, T, 2), generator=g, device=dev) * task.u_std
        v, w = _clipped_controls_tk(u, noise, task.vrange, task.wrange)
        return (words, rollout_byte.build_task_vec(task), v.contiguous(),
                w.contiguous())

    cases = [
        # name, K, M, T, H, W, res, fast_trig, penalties, speed_map
        ("flagship_fast", 1024, 1024, 100, 11, 11, 1.0, True, False, False),
        ("flagship_exact_obs", 1024, 1024, 100, 11, 11, 1.0, False, True, False),
        ("multichunk_13x15", 1024, 256, 40, 13, 15, 1.0, False, True, False),
        ("speed_map_risk", 1024, 1, 60, 11, 11, 1.0, False, True, True),
        ("map_250x250", 1024, 256, 100, 250, 250, 0.25, True, False, False),
        ("ragged", 1000, 37, 37, 13, 15, 1.0, False, True, False),
        # World (b)'s shape on the main path, with its penalty cells.
        ("main_path_250x250", 1024, 1024, 100, 250, 250, 0.25, True, True,
         False),
    ]
    timed = {"flagship_fast": None, "main_path_250x250": None}
    case_results = []
    for seed, (name, K, M, T, H, W, res, ft, pen, sm) in enumerate(cases):
        args = make_case(K, M, T, H, W, res, pen, sm, seed)
        kw = dict(H=H, W=W, T=T, speed_map=sm, fast_trig=ft)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        check(got.shape == (K, M) and bool(torch.isfinite(got).all()),
              "{}: kernel output not finite (K, M)".format(name))
        diff = (got - want).abs()
        rel = diff / want.abs().clamp_min(1e-6)
        tol = 5e-3 if ft else 1e-4
        outliers = int((rel > tol).sum())
        allowed = int(1e-4 * rel.numel()) if pen else 0
        inliers = rel[rel <= tol]
        res_case = dict(case=name, K=K, M=M, T=T, map="{}x{}".format(H, W),
                        fast_trig=ft, speed_map=sm, penalty_cells=pen,
                        tol=tol, max_abs_err=float(diff.max()),
                        max_rel_err=float(rel.max()),
                        max_rel_err_inliers=float(inliers.max())
                        if inliers.numel() else 0.0,
                        outliers=outliers, outliers_allowed=allowed)
        print(json.dumps(res_case), flush=True)
        check(outliers <= allowed,
              "{}: {} entries beyond rtol {} (allowed {})".format(
                  name, outliers, tol, allowed))
        case_results.append(res_case)
        if name in timed:
            timed[name] = (args, kw, K, M, T, H, W)
        del args, got, want, diff, rel, inliers

    small_solve_witness(torch, dev, plain)

    # -- phase 3: the main path ---------------------------------------------------
    kernel.launches = 0
    planner_runs = {}
    for world in ("flagship_11x11", "external_250x250"):
        torch.cuda.reset_peak_memory_stats()
        before = kernel.launches
        planner_runs[world] = run_planner(world, Config, TDM, MPPIPlanner,
                                          torch)
        planner_runs[world]["launches"] = kernel.launches - before
        planner_runs[world]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    main_path_launches = kernel.launches
    for world, r in planner_runs.items():
        check(r["launches"] == r["solves"] * r["num_opt"],
              "{}: {} kernel launches for {} solves".format(
                  world, r["launches"], r["solves"]))
        emit("planner_solve_host_ms_median", r["solve_ms_median"], "ms",
             world=world, first_solve_ms=r["solve_ms_first"],
             solves=r["solves"], K=r["K"], M=r["M"], T=r["T"],
             map=r["map"], fast_trig=r["fast_trig"],
             kernel_launches=r["launches"])
        emit("planner_peak_device_memory", r["peak_mem_bytes"], "bytes",
             world=world)
        print(json.dumps(dict(world=world, goal_dist_start=r["dist0"],
                              goal_dist_end=r["dist_end"])))
    a = planner_runs["flagship_11x11"]
    check(a["dist_end"] < a["dist0"], "flagship: goal distance did not shrink")

    # -- phase 4: timing ------------------------------------------------------------
    args, kw, K, M, T, H, W = timed["flagship_fast"]
    kernel_ms, plain_ms = [], []
    for turn in ("kernel", "plain", "plain", "kernel"):
        if turn == "kernel":
            kernel_ms.append(time_cuda(lambda: kernel(*args, **kw), 50, 5,
                                       torch))
        else:
            plain_ms.append(time_cuda(lambda: plain(*args, **kw), 3, 1,
                                      torch))
    bound_ms, bound_by = rollout_bound_ms(K, M, T, H, W, True, False)
    emit("rollout_kernel_ms", min(kernel_ms), "ms", runs=kernel_ms,
         shape="K1024_M1024_T100_11x11_fast_trig", bound_ms=bound_ms,
         bound_by=bound_by)
    emit("rollout_plain_ms", min(plain_ms), "ms", runs=plain_ms,
         shape="K1024_M1024_T100_11x11_fast_trig")
    big_args, big_kw, bK, bM, bT, bH, bW = timed["main_path_250x250"]
    big_bound, big_by = rollout_bound_ms(bK, bM, bT, bH, bW, True, False)
    emit("rollout_kernel_ms",
         time_cuda(lambda: kernel(*big_args, **big_kw), 20, 3, torch), "ms",
         shape="K1024_M1024_T100_250x250_fast_trig", bound_ms=big_bound,
         bound_by=big_by)
    # Solve times in one phase, in turns: chained solves on the device
    # clock (with the host's enqueue time of the same chain beside them)
    # and planner solve() calls on the host clock; then the device's busy
    # time per solve, from kernel times under torch.profiler, over the
    # unprofiled chained time.
    for world, run in planner_runs.items():
        n, reps = (50, 5) if world == "flagship_11x11" else (10, 3)
        chain = _solve_chain(run, torch)
        chain(2)
        chain_ms, enqueue_ms, solve_ms = [], [], []
        for _ in range(reps):
            ms, enq = time_chain(chain, n, torch)
            chain_ms.append(ms)
            enqueue_ms.append(enq)
            solve_ms.append(time_planner_solves(run["planner"], n))
        prof = profile_solves(chain, torch)
        chain_med = float(np.median(chain_ms))
        emit("chained_solve_ms", chain_med, "ms", world=world, solves=n,
             runs=chain_ms, host_enqueue_ms=enqueue_ms,
             device_busy_ms=prof["device_busy_us_per_solve"] / 1e3,
             device_busy_share=prof["device_busy_us_per_solve"] / 1e3
             / chain_med, K=run["K"], M=run["M"], T=run["T"], map=run["map"])
        emit("planner_solve_host_ms_turns", float(np.median(solve_ms)), "ms",
             world=world, solves=n, runs=solve_ms)
        emit("solve_device_time_by_kernel", prof, "us", world=world)

    flag = case_results[0]
    print(json.dumps({"kernels": [{
        "name": "rollout_byte",
        "route": "cuda",
        "source": rollout_byte.KERNEL_SOURCE,
        "replaces": rollout_byte.REPLACES,
        "launches": main_path_launches,
        "max_abs_err": flag["max_abs_err"],
        "ms": min(kernel_ms),
        "plain_ms": min(plain_ms),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "max_rel_err": max(c["max_rel_err"] for c in case_results),
        "outliers": sum(c["outliers"] for c in case_results),
        "cases": len(case_results),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def small_solve_witness(torch, dev, plain):
    """The whole solve at small size, the same draws on every device.

    (i)  Two iterations on the card, the kernel path against the same solve
         with its rollout swapped for the plain version: bit for bit.
    (ii) One iteration, card against CPU: within the JAX package's
         whole-solve tolerance, rtol 2e-4 / atol 2e-5.
    (iii) Two iterations, card against CPU: reported, not held to (ii)'s
         tolerance.  The costs of the two devices differ by an ulp (about
         1.2e-4 at costs near 1e3) in both iterations, and the softmax at
         lambda = 1 turns an ulp in a heavily weighted cost into a weight
         change of that order, which the update scales by the noise: u
         then moves by about 1e-4, past (ii)'s tolerance.  (i) shows that
         the kernel adds no gap of its own.
    """
    from mppi_numba_tpu_torch.convert import maps_to_port, task_to_port
    from mppi_numba_tpu_torch.ops.kernels.rollout_byte import build_task_vec
    from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
    from mppi_numba_tpu_torch.solver import TerrainSolver

    static, maps_np, task_np = small_world()
    gen = np.random.RandomState(5)
    H, W = static.map_shape
    T = static.num_steps
    uni = gen.rand(static.num_grid_samples, H * W).astype(np.float32)
    eps = [gen.randn(static.num_control_rollouts, T, 2).astype(np.float32)
           for _ in range(2)]

    def plain_rollout(words, task, u, noise):
        v_all, w_all = _clipped_controls_tk(u, noise, task.vrange,
                                            task.wrange)
        return plain(words, build_task_vec(task), v_all.contiguous(),
                     w_all.contiguous(), H=H, W=W, T=T, fast_trig=True)

    def solve(num_opt, d, swap_plain=False):
        solver = TerrainSolver(dataclasses.replace(static, num_opt=num_opt),
                               torch.device(d))
        check(solver.backend == "cuda", "small solve not on the kernel path")
        if swap_plain:
            solver._rollout = plain_rollout
        u, aux = solver.solve_from_draws(
            torch.tensor(uni, device=d),
            [torch.tensor(e, device=d) for e in eps[:num_opt]],
            maps_to_port(maps_np, d), task_to_port(task_np, d),
            torch.zeros((T, 2), device=d))
        return dict(u=u.cpu().numpy(), costs=aux.costs.cpu().numpy(),
                    weights=aux.weights.cpu().numpy())

    def diffs(a, b):
        return {k: float(np.abs(a[k] - b[k]).max()) for k in a}

    kernel_2, plain_2 = solve(2, dev), solve(2, dev, swap_plain=True)
    card_1, cpu_1 = solve(1, dev), solve(1, "cpu")
    cpu_2 = solve(2, "cpu")
    witness = dict(check="small_solve", K=static.num_control_rollouts,
                   M=static.num_grid_samples, T=T, map="{}x{}".format(H, W),
                   kernel_vs_plain_on_card_2it=diffs(kernel_2, plain_2),
                   card_vs_cpu_1it=diffs(card_1, cpu_1),
                   card_vs_cpu_2it=diffs(kernel_2, cpu_2))
    print(json.dumps(witness), flush=True)
    check(all(np.array_equal(kernel_2[k], plain_2[k]) for k in kernel_2),
          "small solve, 2 iterations: kernel path differs from plain on the "
          "card: {}".format(witness["kernel_vs_plain_on_card_2it"]))
    for k in card_1:
        check(np.allclose(card_1[k], cpu_1[k], rtol=2e-4, atol=2e-5),
              "small solve {}, 1 iteration: card vs CPU max abs diff {}"
              .format(k, witness["card_vs_cpu_1it"][k]))
    check(all(np.isfinite(v).all() for v in (*kernel_2.values(),
                                             *cpu_2.values())),
          "small solve, 2 iterations: non-finite output")


def small_world():
    """A flagship-shaped world at small size (22 bins on an 11x11 map, CVaR
    alpha 0.2, fast trig), as numpy NamedTuples for ``convert``."""
    from mppi_numba_tpu_torch.config import SolverStatic
    from mppi_numba_tpu_torch.types import MapInputs, TerrainTask

    K, M, T, H, W, B = 128, 16, 20, 11, 11, 22
    pmf = random_pmf(np.random.RandomState(0), B, H, W)
    qbins = np.linspace(0, 100, B).astype(np.int8)
    z = np.zeros((H, W), np.int8)
    maps = MapInputs(pmf, pmf, qbins, qbins, z, z, z)
    f = np.float32
    task = TerrainTask(
        x0=np.array([0.5, 0.5, 0.785], f), xgoal=np.array([8.5, 8.5], f),
        goal_tolerance=f(0.5), v_post_rollout=f(0.01), lambda_weight=f(1.0),
        u_std=np.array([2.0, 3.0], f), vrange=np.array([0.0, 3.0], f),
        wrange=np.array([-3.14, 3.14], f), dt=f(0.1), dist_weight=f(1.0),
        obs_penalty=f(1e5), unknown_penalty=f(1e2), alpha_dyn=f(1.0),
        res=f(1.0), xlim0=f(-1.0), ylim0=f(-1.0), lin_lb=f(0.0),
        lin_ratio=f(0.01), ang_lb=f(0.0), ang_ratio=f(0.01))
    static = SolverStatic(mode="tdm", num_steps=T, num_control_rollouts=K,
                          num_grid_samples=M, map_shape=(H, W),
                          num_obstacles=0, cvar_numel=math.ceil(M * 0.2),
                          num_opt=2, num_vis_state_rollouts=1,
                          backend="cuda", fast_trig=True)
    return static, maps, task


def random_pmf(rng, B, H, W):
    """bench.py's flagship PMF: random int8 percentages summing to 100."""
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    return pmf


def external_pmf(B, H, W, seed=0):
    """A synthetic learned-model PMF: per cell a Gaussian over the bins
    around a smoothly varying mode, quantized as the reference does (the
    last bin absorbs the rounding residue)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W]).reshape(2, 1, 1)
    mode = 0.6 + 0.35 * np.sin(6.0 * xx + rng.rand()) * np.cos(5.0 * yy)
    mode = np.clip(mode, 0.05, 0.95) * (B - 1)
    bins = np.arange(B).reshape(B, 1, 1)
    p = np.exp(-0.5 * ((bins - mode[None]) / 2.0) ** 2)
    p /= p.sum(0, keepdims=True)
    pmf = (p * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    return pmf


def run_planner(world, Config, TDM, MPPIPlanner, torch):
    """20 closed-loop solves through the planner's public entry points."""
    B, solves = 22, 20
    bin_values = np.linspace(0.0, 1.0, B)
    if world == "flagship_11x11":
        rows = cols = 9
        res = 1.0
        pmf = random_pmf(np.random.RandomState(0), B, rows, cols)
        obstacle = unknown = None
        x0 = np.array([0.5, 0.5, 0.785])
        goal = np.array([8.5, 8.5])
    else:
        rows = cols = 246
        res = 0.25
        pmf = external_pmf(B, rows, cols)
        obstacle = np.zeros((rows, cols), np.int8)
        obstacle[100:104, 60:180] = 1           # a wall across the map
        unknown = np.zeros((rows, cols), np.int8)
        unknown[150:190, 20:70] = 1             # an unobserved patch
        x0 = np.array([5.0, 5.0, 0.785])
        goal = np.array([50.0, 50.0])
    cfg = Config(T=10.0, dt=0.1, num_grid_samples=1024,
                 num_control_rollouts=1024, max_speed_padding=5.0,
                 max_map_dim=(250, 250), seed=0, use_tdm=True)
    tdm_dict = dict(res=res, xlimits=(0.0, cols * res),
                    ylimits=(0.0, rows * res), bin_values=bin_values,
                    bin_values_bounds=np.array([0.0, 1.0]),
                    det_dynamics_cvar_alpha=1.0)
    lin, ang = TDM(cfg, device="cuda"), TDM(cfg, device="cuda")
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict, obstacle, unknown)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict, obstacle, unknown)
    check(lin.get_padded_grid_xy_dim() in ((11, 11), (250, 250)),
          "unexpected padded map {}".format(lin.get_padded_grid_xy_dim()))
    params = dict(dt=cfg.dt, x0=x0, xgoal=goal, goal_tolerance=0.5,
                  v_post_rollout=0.01, cvar_alpha=0.2, alpha_dyn=1.0,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([2.0, 3.0]), vrange=np.array([0.0, 3.0]),
                  wrange=np.array([-3.14, 3.14]))
    planner = MPPIPlanner(cfg)
    planner.setup(params, lin, ang)
    static = planner._static()
    check(static.fast_trig, "{}: planner guard did not enable fast_trig"
          .format(world))
    # Ground truth for the closed loop: the PMF's mean traction per cell.
    mean_tr = np.tensordot(bin_values, pmf.astype(float) / 100.0, axes=1)
    x = x0.astype(float).copy()
    dist0 = float(np.hypot(*(goal - x[:2])))
    times = []
    for _ in range(solves):
        t0 = time.perf_counter()
        u = planner.solve()
        times.append((time.perf_counter() - t0) * 1e3)
        check(u is not None and u.shape == (cfg.num_steps, 2)
              and np.isfinite(u).all(), "{}: bad controls".format(world))
        ci = int(np.clip((x[0] - 0.0) // res, 0, cols - 1))
        ri = int(np.clip((x[1] - 0.0) // res, 0, rows - 1))
        tr = mean_tr[ri, ci]
        v, w = float(u[0, 0]), float(u[0, 1])
        x = x + cfg.dt * np.array([tr * v * np.cos(x[2]),
                                   tr * v * np.sin(x[2]), tr * w])
        planner.shift_and_update(x, u, num_shifts=1)
    return dict(solves=solves, num_opt=static.num_opt,
                solve_ms_first=times[0],
                solve_ms_median=float(np.median(times[1:])),
                K=cfg.num_control_rollouts, M=cfg.num_grid_samples,
                T=cfg.num_steps, map="{}x{}".format(*static.map_shape),
                fast_trig=static.fast_trig, dist0=dist0,
                dist_end=float(np.hypot(*(goal - x[:2]))),
                planner=planner, static=static)


def time_cuda(fn, reps, warmup, torch):
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_chain(chain, n, torch):
    """One chain of ``n`` solves: (device ms per solve, CUDA events; host
    ms per solve spent enqueuing it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    chain(n)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, enqueue_ms / n


def time_planner_solves(planner, n):
    """Median host ms of ``n`` planner ``solve()`` calls in a row."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        planner.solve()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_solves(chain, torch, n=5, top=8):
    """Device time by kernel over ``n`` chained solves (torch.profiler):
    the kernels' summed time per solve and the ``top`` kernels, in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chain(n)
        torch.cuda.synchronize()
    # Kernel entries only: an operator's entry repeats its kernels' time.
    rows = [(e.key, float(e.device_time_total)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    check(rows, "torch.profiler recorded no kernel time")
    rows.sort(key=lambda r: -r[1])
    return dict(device_busy_us_per_solve=sum(us for _, us in rows) / n,
                top_us_per_solve=[[k[:60], us / n] for k, us in rows[:top]])


def _solve_chain(run, torch):
    """``chain(k)``: k solves on the device, each fed the last one's
    controls, with no host sync inside."""
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    planner, static = run["planner"], run["static"]
    solver = get_terrain_solver(static, planner.device)
    maps, task = planner._map_inputs(), planner._task_device
    gen = torch.Generator(device=planner.device).manual_seed(1)

    def chain(k):
        u = torch.zeros((static.num_steps, 2), device=planner.device)
        for _ in range(k):
            u, _ = solver(gen, maps, task, u)
        return u

    return chain


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print("chip_smoke: FAIL: {}".format(exc), file=sys.stderr)
        sys.exit(1)
