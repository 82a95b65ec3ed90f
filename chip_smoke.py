#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mppi_numba_tpu_torch``) on one
NVIDIA GPU: build every kernel, hold each against its plain PyTorch
version, drive the planner's main paths, and time them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no error is swallowed):

1. Build ``csrc/rollout_byte.cu`` and ``csrc/rollout_binned.cu`` with
   nvcc for sm_90a, both at once, and print each ptxas report (registers,
   spills) and the card's name and power limit.
2. Each rollout kernel against its plain version at full K: the byte
   layout cases of the JAX package's on-chip parity record; the binned
   layouts (2-, 4- and 8-bit cells) x {tdm, speed_map} x {fast, exact
   trig}, with draws one past the last bin; each binned layout against the
   byte kernel, bit for bit, on maps whose columns sum to 100.  Then one
   small whole solve, the kernel path against its plain version on the
   card and against the CPU (``small_solve_witness``).
3. The main paths: ``MPPIPlanner`` on ``device="cuda"`` through ``setup``,
   ``solve`` and ``shift_and_update``, 20 closed-loop solves in each world
   of ``WORLDS`` -- the flagship 11x11 (byte kernel), a 250x250 external
   PMF (8-bit cells), a forest-size 140x84 learned-model PMF under tdm
   (4-bit cells), det_dyn and speed_map (2- or 4-bit cells, M = 1), a
   140x84 costmap (2-bit cells), and the reference benchmark's 9x9
   semantic world under all three methods (byte kernel).  Both kernels'
   launch counts are set to 0 just before each world and read just after.
4. Timing with CUDA events: each kernel against its plain version, the
   binned kernel in turns with the byte kernel on the same inputs at the
   forest, 250x250 and speed-map worlds' shapes; then per timed world, in
   turns, chained solves on the device clock beside the host's time to
   enqueue them and planner ``solve()`` times on the host clock, and the
   device's busy time per solve by kernel.  Each figure is printed as a
   JSON line with the card's name and power limit.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32, non-tensor-core

# float32 operations per lane-step of the rollout kernels, counted from
# csrc/rollout_byte.cu and csrc/rollout_binned.cu (a sqrtf, sinf or cosf
# counts as one): cell index 10, decode 4 (lb + ratio * value for lin and
# ang; none where a 2- or 4-bit cell reads the LUT), dynamics (fast-trig
# rotation 24 | exact 11; x and y share the product dt*lin_tr*v), goal
# distance 5, stage cost 7, masking 9; speed_map adds 4.  Per lane once: 6
# for the terminal cost, plus the start heading's cosf/sinf in fast-trig
# mode.
OPS_STEP_FAST, OPS_STEP_EXACT, OPS_SPEED_MAP, OPS_DECODE = 59, 46, 4, 4
CELLS_PER_WORD = {2: 8, 4: 4, 8: 2}
SOLVES = 20
# World -> (planning mode, the layout 'auto' must route it to); None: 2-
# or 4-bit cells, as the support-compacted bin count falls (printed).
WORLDS = {
    "flagship_11x11": ("tdm", "byte"),
    "external_250x250": ("tdm", "binned8"),
    "forest_140x84": ("tdm", "binned"),
    "forest_140x84_det_dyn": ("det_dyn", None),
    "forest_140x84_speed_map": ("speed_map", "binned2"),
    "costmap_140x84": ("costmap", "binned2"),
    "benchmark_9x9_tdm": ("tdm", "byte"),
    "benchmark_9x9_det_dyn": ("det_dyn", "byte"),
    "benchmark_9x9_speed_map": ("speed_map", "byte"),
}
TIMED_WORLDS = ("flagship_11x11", "external_250x250", "forest_140x84",
                "forest_140x84_speed_map")
FOREST_ROWS, FOREST_COLS, FOREST_RES, FOREST_BINS = 138, 82, 0.5, 12


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


def rollout_bound_ms(K, M, T, H, W, fast_trig, speed_map, cell_bits=None):
    """Least time for one rollout call: the larger of its bytes over HBM
    bandwidth and its float32 operations over the float32 peak.  Bytes:
    the map planes, task and controls in, the costs out.  The byte layout
    (``cell_bits`` None) reads one word per cell and sample; the binned
    layouts read the per-sample cell plane, the shared mask plane (16 cells
    a word), in speed-map mode the shared risk plane (4 cells a word), and
    for 2- and 4-bit cells the 2 x 16 float LUT.  Returns (ms, bound_by)."""
    hw = H * W
    if cell_bits is None:
        map_words = M * hw
    else:
        map_words = (M * -(-hw // CELLS_PER_WORD[cell_bits]) + -(-hw // 16)
                     + (-(-hw // 4) if speed_map else 0)
                     + (32 if cell_bits != 8 else 0))
    nbytes = 4 * (map_words + 19 + 2 * T * K + K * M)
    per_step = ((OPS_STEP_FAST if fast_trig else OPS_STEP_EXACT)
                + (OPS_SPEED_MAP if speed_map else 0)
                - (OPS_DECODE if cell_bits in (2, 4) else 0))
    ops = K * M * (T * per_step + 6 + (2 if fast_trig else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def build_kernels(_build, names):
    """Build every source at once (one nvcc each); print the reports."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        if reports[name] is None:
            print("{}: already built from this source at {}".format(
                name, _build.library_path(name)))
        for line in (reports[name] or "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas[{}]: {}".format(name, line.strip()))
    print("build: {:.1f} s".format(time.perf_counter() - t0))


def compare(name, got, want, fast_trig, penalties, **info):
    """Hold a kernel's (K, M) costs against its plain version: rtol 1e-4
    (exact trig) or 5e-3 (fast trig); on maps with penalty cells at most
    0.01% knife-edge entries, where an ulp moves a rollout across a cell
    edge and one step's penalty with it."""
    check(got.shape == want.shape and bool(got.isfinite().all()),
          "{}: kernel output not finite {}".format(name, tuple(want.shape)))
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-6)
    tol = 5e-3 if fast_trig else 1e-4
    outliers = int((rel > tol).sum())
    allowed = int(1e-4 * rel.numel()) if penalties else 0
    inliers = rel[rel <= tol]
    res = dict(case=name, **info, fast_trig=fast_trig,
               penalty_cells=penalties, tol=tol,
               max_abs_err=float(diff.max()), max_rel_err=float(rel.max()),
               max_rel_err_inliers=float(inliers.max())
               if inliers.numel() else 0.0,
               outliers=outliers, outliers_allowed=allowed)
    print(json.dumps(res), flush=True)
    check(outliers <= allowed, "{}: {} entries beyond rtol {} (allowed {})"
          .format(name, outliers, tol, allowed))
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one",
              file=sys.stderr)
        return 2

    from mppi_numba_tpu_torch.ops.kernels import (_build, rollout_binned,
                                                  rollout_byte)
    from mppi_numba_tpu_torch.ops import packing
    from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
    from mppi_numba_tpu_torch.ops.sampling import decode_bins
    from mppi_numba_tpu_torch.solver import get_terrain_solver
    from mppi_numba_tpu_torch.types import TerrainTask

    dev = torch.device("cuda")
    kernel = rollout_byte.terrain_rollout_costs_byte
    plain = rollout_byte.terrain_rollout_costs_byte_plain
    bkernel = rollout_binned.terrain_rollout_costs_binned
    bplain = rollout_binned.terrain_rollout_costs_binned_plain

    # -- phase 1: build -------------------------------------------------------
    build_kernels(_build, ("rollout_byte", "rollout_binned"))
    card = card_line()
    print(card)
    card_name, _, power_limit = card.rpartition(", ")
    tag = {"card": card_name, "power_limit": power_limit}

    def emit(metric, value, unit, **extra):
        print(json.dumps(dict(metric=metric, value=value, unit=unit,
                              **extra, **tag)), flush=True)

    # -- phase 2: kernels vs plain versions -------------------------------------
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

    def make_controls(g, task, K, T):
        u = torch.rand((T, 2), generator=g, device=dev) * 2.0 - 0.5
        noise = torch.randn((K, T, 2), generator=g, device=dev) * task.u_std
        v, w = _clipped_controls_tk(u, noise, task.vrange, task.wrange)
        return v.contiguous(), w.contiguous()

    def make_planes(g, H, W, penalties):
        i8 = torch.int8
        p = 0.1 if penalties else 0.0
        obs = (torch.rand((H, W), generator=g, device=dev) < p).to(i8)
        unk = (torch.rand((H, W), generator=g, device=dev) < p).to(i8)
        risk = torch.randint(1, 101, (H, W), generator=g, device=dev, dtype=i8)
        return obs, unk, risk

    def make_case(K, M, T, H, W, res, penalties, speed_map, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        i8 = torch.int8
        lin = torch.randint(0, 101, (M, H, W), generator=g, device=dev, dtype=i8)
        ang = torch.randint(0, 101, (M, H, W), generator=g, device=dev, dtype=i8)
        obs, unk, risk = make_planes(g, H, W, penalties)
        words = packing.pack_map_words(lin, ang, obs, unk,
                                       risk if speed_map else None)
        task = make_task(H, W, res)
        return (words, rollout_byte.build_task_vec(task),
                *make_controls(g, task, K, T))

    def make_binned_case(K, M, T, H, W, res, cell_bits, bins, penalties,
                         speed_map, seed, past_last):
        """Binned inputs and the byte words of the same decoded grids:
        ``(binned args, byte args)``.  Bin draws reach one past the last
        bin when ``past_last`` (a column summing below 100)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        hi = bins + 1 if past_last else bins
        lin_b, ang_b = (torch.randint(0, hi, (M, H, W), generator=g,
                                      device=dev, dtype=torch.int32)
                        for _ in range(2))
        qbins = torch.sort(torch.randperm(101, generator=g, device=dev)
                           [:bins]).values.to(torch.int8)
        obs, unk, risk = make_planes(g, H, W, penalties)
        task = make_task(H, W, res)
        v, w = make_controls(g, task, K, T)
        tv = rollout_byte.build_task_vec(task)
        lin_g, ang_g = decode_bins(qbins, lin_b), decode_bins(qbins, ang_b)
        if cell_bits == 8:
            cells, lut = packing.pack_byte_pairs(lin_g, ang_g), None
        else:
            pack = (packing.pack_bin_crumbs if cell_bits == 2
                    else packing.pack_bin_nibbles)
            cells = pack(lin_b, ang_b)
            lut = rollout_binned.build_bin_luts(task, qbins, qbins)
        mask = packing.pack_mask_nibbles(obs, unk)
        riskw = packing.pack_risk_bytes(risk) if speed_map else None
        words = packing.pack_map_words(lin_g, ang_g, obs, unk,
                                       risk if speed_map else None)
        return (cells, mask, lut, tv, v, w, riskw), (words, tv, v, w)

    cases = [
        # name, K, M, T, H, W, res, fast_trig, penalties, speed_map
        ("flagship_fast", 1024, 1024, 100, 11, 11, 1.0, True, False, False),
        ("flagship_exact_obs", 1024, 1024, 100, 11, 11, 1.0, False, True, False),
        ("multichunk_13x15", 1024, 256, 40, 13, 15, 1.0, False, True, False),
        ("speed_map_risk", 1024, 1, 60, 11, 11, 1.0, False, True, True),
        ("map_250x250", 1024, 256, 100, 250, 250, 0.25, True, False, False),
        ("ragged", 1000, 37, 37, 13, 15, 1.0, False, True, False),
        # World (b)'s shape, with its penalty cells.
        ("main_path_250x250", 1024, 1024, 100, 250, 250, 0.25, True, True,
         False),
    ]
    case_results = []
    flagship_args = None
    for seed, (name, K, M, T, H, W, res, ft, pen, sm) in enumerate(cases):
        args = make_case(K, M, T, H, W, res, pen, sm, seed)
        kw = dict(H=H, W=W, T=T, speed_map=sm, fast_trig=ft)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        case_results.append(compare(
            name, got, want, ft, pen, K=K, M=M, T=T,
            map="{}x{}".format(H, W), speed_map=sm))
        if name == "flagship_fast":
            flagship_args = (args, kw, K, M, T, H, W)
        del args, got, want

    binned_cases = [
        # name, K, M, T, H, W, res, cell_bits, bins, fast_trig, penalties,
        # speed_map.  The first of each layout is a main-path shape.
        ("nibble_140x84_fast", 1024, 1024, 100, 140, 84, 0.5, 4, 16, True,
         False, False),
        ("nibble_140x84_exact_obs", 1024, 256, 100, 140, 84, 0.5, 4, 16,
         False, True, False),
        ("nibble_140x84_fast_speed_map", 1024, 1, 100, 140, 84, 0.5, 4, 16,
         True, True, True),
        ("nibble_140x84_exact_speed_map", 1024, 64, 100, 140, 84, 0.5, 4, 16,
         False, True, True),
        ("bytepair_250x250_fast", 1024, 1024, 100, 250, 250, 0.25, 8, 22,
         True, True, False),
        ("bytepair_250x250_exact", 1024, 128, 100, 250, 250, 0.25, 8, 22,
         False, True, False),
        ("bytepair_250x250_fast_speed_map", 1024, 16, 100, 250, 250, 0.25, 8,
         22, True, True, True),
        ("bytepair_250x250_exact_speed_map", 1024, 1, 100, 250, 250, 0.25, 8,
         22, False, True, True),
        ("crumb_140x84_fast", 1024, 1024, 100, 140, 84, 0.5, 2, 4, True,
         True, False),
        ("crumb_140x84_exact", 1024, 256, 100, 140, 84, 0.5, 2, 4, False,
         True, False),
        ("crumb_140x84_fast_speed_map", 1024, 1, 100, 140, 84, 0.5, 2, 4,
         True, True, True),
        ("crumb_140x84_exact_speed_map", 1024, 64, 100, 140, 84, 0.5, 2, 4,
         False, True, True),
        ("ragged_nibble", 1000, 37, 37, 140, 84, 0.5, 4, 12, False, True,
         False),
    ]
    binned_results = []
    for seed, (name, K, M, T, H, W, res, cb, B, ft, pen, sm) in enumerate(
            binned_cases, start=100):
        args, _ = make_binned_case(K, M, T, H, W, res, cb, B, pen, sm, seed,
                                   past_last=True)
        kw = dict(H=H, W=W, T=T, cell_bits=cb, fast_trig=ft)
        got = bkernel(*args, **kw)
        want = bplain(*args, **kw)
        torch.cuda.synchronize()
        binned_results.append(compare(
            name, got, want, ft, pen, K=K, M=M, T=T,
            map="{}x{}".format(H, W), cell_bits=cb, bins=B, speed_map=sm))
        del args, got, want

    # Each binned layout against the byte kernel, bit for bit, on the same
    # decoded grids of maps whose columns sum to 100.
    for seed, (cb, B, ft, sm) in enumerate(
            [(cb, B, ft, sm) for cb, B in ((2, 4), (4, 16), (8, 22))
             for ft, sm in ((True, False), (False, True))], start=200):
        K, M, T, H, W = 1024, 64, 100, 140, 84
        bargs, wargs = make_binned_case(K, M, T, H, W, 0.5, cb, B, True, sm,
                                        seed, past_last=False)
        got = bkernel(*bargs, H=H, W=W, T=T, cell_bits=cb, fast_trig=ft)
        want = kernel(*wargs, H=H, W=W, T=T, speed_map=sm, fast_trig=ft)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        print(json.dumps(dict(check="binned_equals_byte", cell_bits=cb,
                              bins=B, K=K, M=M, T=T, map="{}x{}".format(H, W),
                              fast_trig=ft, speed_map=sm,
                              entries_differing=differ)), flush=True)
        check(differ == 0, "cell_bits {}: {} costs differ from the byte "
              "kernel's".format(cb, differ))
        del bargs, wargs, got, want

    small_solve_witness(torch, dev, plain)

    # -- phase 3: the main paths ------------------------------------------------
    planner_runs = {}
    totals = {"rollout_byte": 0, "rollout_binned": 0}
    for world, (_, want_backend) in WORLDS.items():
        torch.cuda.reset_peak_memory_stats()
        kernel.launches = bkernel.launches = 0
        run = run_planner(world)
        launches = {"rollout_byte": kernel.launches,
                    "rollout_binned": bkernel.launches}
        run["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        backend = get_terrain_solver(run["static"], dev).backend
        expect = (want_backend or
                  ("binned2" if run["static"].num_pmf_bins <= 4 else "binned"))
        check(backend == expect, "{}: routed to {}, expected {}".format(
            world, backend, expect))
        used = "rollout_byte" if backend == "byte" else "rollout_binned"
        other = "rollout_binned" if used == "rollout_byte" else "rollout_byte"
        check(launches[used] == run["solves"] * run["num_opt"]
              and launches[other] == 0,
              "{}: launches {} for {} solves on {}".format(
                  world, launches, run["solves"], backend))
        for k in totals:
            totals[k] += launches[k]
        run.update(backend=backend, launches=launches)
        planner_runs[world] = run
        emit("planner_solve_host_ms_median", run["solve_ms_median"], "ms",
             world=world, backend=backend,
             num_pmf_bins=run["static"].num_pmf_bins,
             mode=run["static"].mode, first_solve_ms=run["solve_ms_first"],
             solves=run["solves"], K=run["K"], M=run["static"].num_grid_samples,
             T=run["T"], map=run["map"], fast_trig=run["fast_trig"],
             kernel_launches=launches)
        emit("planner_peak_device_memory", run["peak_mem_bytes"], "bytes",
             world=world)
        print(json.dumps(dict(world=world, goal_dist_start=run["dist0"],
                              goal_dist_end=run["dist_end"])))
        if world not in TIMED_WORLDS:
            del run["planner"]
    a = planner_runs["flagship_11x11"]
    check(a["dist_end"] < a["dist0"], "flagship: goal distance did not shrink")

    # -- phase 4: timing ------------------------------------------------------------
    args, kw, K, M, T, H, W = flagship_args
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
    del args

    # The binned kernel at the shapes worlds (c), (b) and (e) give it, and
    # 2-bit cells at (c)'s shape, in turns with the byte kernel on the same
    # decoded grids.
    binned_timed = {}
    for name, M, H, W, res, cb, B, sm in (
            ("forest_140x84", 1024, 140, 84, 0.5, 4, 12, False),
            ("external_250x250", 1024, 250, 250, 0.25, 8, 22, False),
            ("forest_140x84_speed_map", 1, 140, 84, 0.5, 2, 2, True),
            ("forest_140x84_2bit", 1024, 140, 84, 0.5, 2, 4, False)):
        K, T = 1024, 100
        bargs, wargs = make_binned_case(K, M, T, H, W, res, cb, B, True, sm,
                                        300, past_last=False)
        bkw = dict(H=H, W=W, T=T, cell_bits=cb, fast_trig=True)
        wkw = dict(H=H, W=W, T=T, speed_map=sm, fast_trig=True)
        reps = 50 if M > 1 else 500
        b_ms, w_ms = [], []
        for turn in ("binned", "byte", "byte", "binned"):
            if turn == "binned":
                b_ms.append(time_cuda(lambda: bkernel(*bargs, **bkw), reps,
                                      5, torch))
            else:
                w_ms.append(time_cuda(lambda: kernel(*wargs, **wkw), reps, 5,
                                      torch))
        p_ms = [time_cuda(lambda: bplain(*bargs, **bkw), 3, 1, torch)
                for _ in range(2)]
        b_bound = rollout_bound_ms(K, M, T, H, W, True, sm, cb)
        w_bound = rollout_bound_ms(K, M, T, H, W, True, sm)
        shape = "K{}_M{}_T{}_{}x{}_fast_trig{}".format(
            K, M, T, H, W, "_speed_map" if sm else "")
        emit("rollout_binned_kernel_ms", min(b_ms), "ms", runs=b_ms,
             shape=shape, cell_bits=cb, at=name, bound_ms=b_bound[0],
             bound_by=b_bound[1])
        emit("rollout_byte_kernel_ms", min(w_ms), "ms", runs=w_ms,
             shape=shape, at=name, bound_ms=w_bound[0],
             bound_by=w_bound[1])
        emit("rollout_binned_plain_ms", min(p_ms), "ms", runs=p_ms,
             shape=shape, cell_bits=cb, at=name)
        binned_timed[name] = dict(ms=min(b_ms), plain_ms=min(p_ms),
                                  bound=b_bound)
        del bargs, wargs

    # Solve times in one phase, in turns: chained solves on the device
    # clock (with the host's enqueue time of the same chain beside them)
    # and planner solve() calls on the host clock; then the device's busy
    # time per solve, from kernel times under torch.profiler, over the
    # unprofiled chained time.
    for world in TIMED_WORLDS:
        run = planner_runs[world]
        n, reps = (10, 3) if world == "external_250x250" else (50, 5)
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
             backend=run["backend"], runs=chain_ms,
             host_enqueue_ms=enqueue_ms,
             device_busy_ms=prof["device_busy_us_per_solve"] / 1e3,
             device_busy_share=prof["device_busy_us_per_solve"] / 1e3
             / chain_med, K=run["K"], M=run["static"].num_grid_samples,
             T=run["T"], map=run["map"])
        emit("planner_solve_host_ms_turns", float(np.median(solve_ms)), "ms",
             world=world, solves=n, runs=solve_ms)
        emit("solve_device_time_by_kernel", prof, "us", world=world)

    flag = case_results[0]
    forest = binned_timed["forest_140x84"]
    nib = binned_results[0]
    print(json.dumps({"kernels": [{
        "name": "rollout_byte",
        "route": "cuda",
        "source": rollout_byte.KERNEL_SOURCE,
        "replaces": rollout_byte.REPLACES,
        "launches": totals["rollout_byte"],
        "max_abs_err": flag["max_abs_err"],
        "ms": min(kernel_ms),
        "plain_ms": min(plain_ms),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "max_rel_err": max(c["max_rel_err"] for c in case_results),
        "outliers": sum(c["outliers"] for c in case_results),
        "cases": len(case_results),
    }, {
        "name": "rollout_binned",
        "route": "cuda",
        "source": rollout_binned.KERNEL_SOURCE,
        "replaces": rollout_binned.REPLACES,
        "launches": totals["rollout_binned"],
        "max_abs_err": nib["max_abs_err"],
        "ms": forest["ms"],
        "plain_ms": forest["plain_ms"],
        "bound_ms": forest["bound"][0],
        "bound_by": forest["bound"][1],
        "library_ms": None,
        "timed_at": "forest_140x84: 4-bit cells, K1024_M1024_T100, fast trig",
        "ms_at": {k: v["ms"] for k, v in binned_timed.items()},
        "max_rel_err": max(c["max_rel_err"] for c in binned_results),
        "outliers": sum(c["outliers"] for c in binned_results),
        "cases": len(binned_results),
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
        check(solver.backend == "byte", "small solve not on the byte layout")
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
                          backend="byte", fast_trig=True)
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


def forest_maps(seed=0):
    """World (c)'s map at the size of the reference's wp_forest1 learned
    model (138 x 82 cells at 0.5 m): a 12-bin synthetic learned-model PMF,
    the unknown mask of a detector whose confidence falls below 0.3 (and
    of a never-observed patch), and a fallen log of obstacle cells.
    Returns ``(pmf, obstacle, unknown)``."""
    from mppi_numba_tpu_torch import unknown_mask_from_confidence

    rows, cols = FOREST_ROWS, FOREST_COLS
    pmf = external_pmf(FOREST_BINS, rows, cols, seed)
    rng = np.random.RandomState(seed + 1)
    confidence = np.clip(rng.normal(0.8, 0.3, (rows, cols)), -1.0, 1.0)
    never_seen = np.zeros((rows, cols), np.int8)
    never_seen[95:115, 50:75] = 1
    unknown = unknown_mask_from_confidence(confidence, 0.3, never_seen)
    obstacle = np.zeros((rows, cols), np.int8)
    obstacle[60:62, 8:45] = 1
    unknown[:20, :20] = obstacle[:20, :20] = 0       # clear start area
    return pmf, obstacle, unknown


def forest_costmap(seed=0):
    """World (f): a uint8 occupancy costmap of world (c)'s size: a lethal
    wall with a gap, scattered lethal debris, and an unexplored (255)
    region; lethal above 100."""
    rows, cols = FOREST_ROWS, FOREST_COLS
    rng = np.random.RandomState(seed)
    cm = np.zeros((rows, cols), np.uint8)
    cm[70:72, :] = 220
    cm[70:72, 30:38] = 0                              # the gap
    cm[100:125, 45:80] = 255                          # unexplored
    debris = (rng.rand(rows, cols) < 0.01) & (cm == 0)
    cm[debris] = 180
    cm[:20, :20] = 0                                  # clear start area
    return cm


def benchmark_world(num_bins=20, rng=None):
    """The reference benchmark's two-terrain world, as
    ``mppi_numba_tpu/benchmark.py::make_benchmark_world`` builds it:
    Vegetation bimodal {0, 0.8} traction, Dirt unimodal 0.65."""
    from mppi_numba_tpu_torch import GaussianMixture, Terrain

    pmf_bounds = [0, 1.0]
    bush_lin = GaussianMixture(pmf_bounds, pmf_bounds, [0.6, 0.4], [0, 0.8],
                               [0.15, 0.1], rng=rng)
    bush_ang = GaussianMixture(pmf_bounds, pmf_bounds, [0.6, 0.4], [0, 0.8],
                               [0.15, 0.1], rng=rng)
    dirt_lin = GaussianMixture(pmf_bounds, pmf_bounds, [1], [0.65], [0.1],
                               rng=rng)
    dirt_ang = GaussianMixture(pmf_bounds, pmf_bounds, [1], [0.65], [0.1],
                               rng=rng)
    bush = Terrain("Vegetation", np.array((0, 250, 0)) / 255.0,
                   bush_lin, bush_ang)
    dirt = Terrain("Dirt", np.array((200, 190, 160)) / 255.0,
                   dirt_lin, dirt_ang)
    lin_terrain2pmf = {bush: bush_lin.get_pmf(num_bins),
                       dirt: dirt_lin.get_pmf(num_bins)}
    ang_terrain2pmf = {bush: bush_ang.get_pmf(num_bins),
                       dirt: dirt_ang.get_pmf(num_bins)}
    bin_values = lin_terrain2pmf[bush][0]
    return dict(id2name={0: dirt.name, 1: bush.name},
                name2terrain={bush.name: bush, dirt.name: dirt},
                lin_terrain2pmf=lin_terrain2pmf,
                ang_terrain2pmf=ang_terrain2pmf, bin_values=bin_values,
                bin_values_bounds=(np.min(bin_values), np.max(bin_values)),
                num_pmf_bins=len(bin_values))


def semantic_grid(grid_shape, mud_margin, grass_density, rng):
    """The benchmark's random semantic map: Vegetation (1) inside a Dirt
    (0) margin (``mppi_numba_tpu/benchmark.py::make_semantic_grid``)."""
    sg = np.zeros(grid_shape, dtype=np.int8)
    rand_num = rng.rand(grid_shape[0] - 2 * mud_margin,
                        grid_shape[1] - 2 * mud_margin)
    sg[mud_margin:-mud_margin, mud_margin:-mud_margin][
        rand_num < grass_density] = 1
    return sg


def setup_world(world):
    """A planner set up on ``world`` through the public entry points, and
    the ground truth its closed loop runs on: ``(planner, truth, goal)``
    where ``truth(x, y) -> (lin, ang)`` tractions."""
    from mppi_numba_tpu_torch import Config, MPPIPlanner, TDM

    mode = WORLDS[world][0]
    det_alpha = 0.2
    params = dict(dt=0.1, goal_tolerance=0.5, v_post_rollout=0.01,
                  cvar_alpha=0.2 if mode == "tdm" else 1.0,
                  alpha_dyn=1.0 if mode == "tdm" else det_alpha,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([2.0, 3.0]), vrange=np.array([0.0, 3.0]),
                  wrange=np.array([-3.14, 3.14]))
    flags = dict(use_tdm=mode == "tdm", use_det_dynamics=mode == "det_dyn",
                 use_nom_dynamics_with_speed_map=mode == "speed_map",
                 use_costmap=mode == "costmap")
    cfg = Config(T=10.0, dt=0.1, num_grid_samples=1024,
                 num_control_rollouts=1024, max_speed_padding=5.0,
                 max_map_dim=(250, 250), seed=0, **flags)
    lin, ang = TDM(cfg, device="cuda"), TDM(cfg, device="cuda")

    def pmf_world(pmf, bin_values, res, obstacle=None, unknown=None):
        rows, cols = pmf.shape[1:]
        tdm_dict = dict(res=res, xlimits=(0.0, cols * res),
                        ylimits=(0.0, rows * res), bin_values=bin_values,
                        bin_values_bounds=np.array([0.0, 1.0]),
                        det_dynamics_cvar_alpha=(1.0 if mode == "tdm"
                                                 else det_alpha))
        lin.set_TDM_from_PMF_grid(pmf, tdm_dict, obstacle, unknown)
        ang.set_TDM_from_PMF_grid(pmf, tdm_dict, obstacle, unknown)
        mean = np.tensordot(bin_values, pmf.astype(float) / 100.0, axes=1)
        return mean, mean, res

    if world == "flagship_11x11":
        B = 22
        mean_lin, mean_ang, res = pmf_world(
            random_pmf(np.random.RandomState(0), B, 9, 9),
            np.linspace(0.0, 1.0, B), 1.0)
        x0, goal = np.array([0.5, 0.5, 0.785]), np.array([8.5, 8.5])
    elif world == "external_250x250":
        B, rows = 22, 246
        obstacle = np.zeros((rows, rows), np.int8)
        obstacle[100:104, 60:180] = 1           # a wall across the map
        unknown = np.zeros((rows, rows), np.int8)
        unknown[150:190, 20:70] = 1             # an unobserved patch
        mean_lin, mean_ang, res = pmf_world(
            external_pmf(B, rows, rows), np.linspace(0.0, 1.0, B), 0.25,
            obstacle, unknown)
        x0, goal = np.array([5.0, 5.0, 0.785]), np.array([50.0, 50.0])
    elif world.startswith("forest"):
        pmf, obstacle, unknown = forest_maps()
        mean_lin, mean_ang, res = pmf_world(
            pmf, np.linspace(0.0, 1.0, FOREST_BINS), FOREST_RES, obstacle,
            unknown)
        x0, goal = np.array([4.0, 4.0, 1.2]), np.array([15.0, 60.0])
    elif world == "costmap_140x84":
        cm = forest_costmap()
        res = FOREST_RES
        rows, cols = cm.shape
        costmap_dict = dict(costmap=cm, res=res, xlimits=(0.0, cols * res),
                            ylimits=(0.0, rows * res),
                            costmap_lethal_threshold=100)
        lin.set_TDM_from_costmap(costmap_dict)
        ang.set_TDM_from_costmap(costmap_dict)
        mean_lin = np.where((cm > 100) & (cm != 255), 0.0, 1.0)
        mean_ang = mean_lin
        x0, goal = np.array([4.0, 4.0, 1.2]), np.array([15.0, 60.0])
    else:
        rng = np.random.RandomState(1)
        bw = benchmark_world(num_bins=20, rng=rng)
        sg = semantic_grid((9, 9), 1, 0.4, rng)
        res = 1.0
        det = None if mode == "tdm" else det_alpha
        for tdm, key in ((lin, "lin_terrain2pmf"), (ang, "ang_terrain2pmf")):
            tdm.set_TDM_from_semantic_grid(
                sg, res, bw["num_pmf_bins"], bw["bin_values"],
                bw["bin_values_bounds"], (0, 9 * res), (0, 9 * res),
                bw["id2name"], bw["name2terrain"], bw[key],
                det_dynamics_cvar_alpha=det)

        def terrain_mean(key):
            means = {sid: float(np.dot(*bw[key][bw["name2terrain"][name]]))
                     for sid, name in bw["id2name"].items()}
            return np.vectorize(means.get)(sg)

        mean_lin = terrain_mean("lin_terrain2pmf")
        mean_ang = terrain_mean("ang_terrain2pmf")
        x0, goal = np.array([0.5, 0.5, 0.785]), np.array([8.5, 8.5])

    params.update(x0=x0, xgoal=goal)
    planner = MPPIPlanner(cfg, device="cuda")
    planner.setup(params, lin, ang)
    rows, cols = mean_lin.shape

    def truth(x, y):
        ci = int(np.clip(x // res, 0, cols - 1))
        ri = int(np.clip(y // res, 0, rows - 1))
        return mean_lin[ri, ci], mean_ang[ri, ci]

    return planner, truth, goal


def run_planner(world):
    """``SOLVES`` closed-loop solves of ``world`` through the planner's
    public entry points."""
    planner, truth, goal = setup_world(world)
    static = planner._static()
    check(static.fast_trig, "{}: planner guard did not enable fast_trig"
          .format(world))
    x = np.asarray(planner.params["x0"], dtype=float).copy()
    dist0 = float(np.hypot(*(goal - x[:2])))
    dt = planner.dt
    times = []
    for _ in range(SOLVES):
        t0 = time.perf_counter()
        u = planner.solve()
        times.append((time.perf_counter() - t0) * 1e3)
        check(u is not None and u.shape == (planner.num_steps, 2)
              and np.isfinite(u).all(), "{}: bad controls".format(world))
        check(not planner.det_dyn or planner.u_prev is planner.u_cur,
              "{}: u_prev does not alias the solved controls".format(world))
        lin_tr, ang_tr = truth(x[0], x[1])
        v, w = float(u[0, 0]), float(u[0, 1])
        x = x + dt * np.array([lin_tr * v * np.cos(x[2]),
                               lin_tr * v * np.sin(x[2]), ang_tr * w])
        planner.shift_and_update(x, u, num_shifts=1)
    return dict(solves=SOLVES, num_opt=static.num_opt,
                solve_ms_first=times[0],
                solve_ms_median=float(np.median(times[1:])),
                K=planner.num_control_rollouts, T=planner.num_steps,
                map="{}x{}".format(*static.map_shape),
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
