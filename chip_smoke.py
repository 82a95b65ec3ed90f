#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mppi_numba_tpu_torch``) on one
NVIDIA GPU: build every kernel, hold each against its plain PyTorch
version, drive the planner's main paths, and time them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no error is swallowed):

1. Build ``csrc/rollout_byte.cu``, ``csrc/rollout_binned.cu``,
   ``csrc/map_sample.cu``, ``csrc/gather_probe.cu``,
   ``csrc/cvar_costs.cu``, ``csrc/cvar_wide.cu``,
   ``csrc/update_useq.cu``, ``csrc/update_wide.cu``,
   ``csrc/barebone_rollout.cu`` and ``csrc/vis_rollout.cu`` with nvcc for
   sm_90a, all at once, and print
   the build time, each ptxas report (registers, spills: none allowed
   in the barebone rollout's, the wide update's, ``cvar_wide.cu``'s and
   the vis kernels' instantiations), each
   rollout kernel's SASS instructions per lane-step by class
   (``sass_counts``, where the toolkit has ``cuobjdump``), each vis
   kernel's registers, stack, static and dynamic shared memory
   (``vis_rollout.kernel_attributes``) and its chain in cycles from its
   SASS (``vis_sass_chain``), and the card's name and power limit.
2. Each kernel against its plain version, bit for bit (the 2.7 m bicycle
   within rtol 1e-4), each row with its instantiation's tiling: the byte
   layout cases of the JAX package's on-chip parity record; the binned
   layouts (2-, 4- and 8-bit cells) x {tdm, speed_map} x {fast, exact
   trig}, with draws one past the last bin; the bicycle model (exact
   trig, steering within +-0.5 rad) on the byte kernel and each binned
   layout, in tdm and speed_map at the default wheelbase and in tdm at a
   car's; each binned layout against the byte kernel, bit for bit, on
   maps whose columns sum to 100; edge cases (T across the loop's
   remainders, ragged M and K, det_dyn's M = 1 launch at T = 33, a NaN
   cell coordinate landing in cell 0, risk bytes of all 256 values).
   The map-sampling kernel against its plain version, bit for bit, in its
   'bins' mode (bins and grids) and fused with the pack in every payload
   layout (byte words, 2-, 4- and 8-bit cells with the shared mask and
   risk words, with and without the risk and the ang plane): each timed
   world's shape, interior and corner-clamped windows, a slice of the M
   axis, 1-22 and 255 bins, alpha 1 and 0.2 (and 1.5 and -0.7, outside
   the tables' range), columns summing below 100 and of random int8 of
   any sign, M = 1, 3 and 4 (blocks of a few map samples),
   PARITY.md's ragged 13x15 maps, and known answers of
   ``jax.random.uniform`` (``KNOWN_UNIFORMS``).  The kernel's crop mode
   (``sample_and_pack_crop``: the window worked out from the task and
   read from the map in the same launch) against its plain version
   (``crop_window_plain`` then ``sample_and_pack_window_plain``): payload,
   grids, offset and limits bit for bit in every layout, with and
   without the risk plane, for robots near each edge of the map, at its
   centre, at every cell edge of a row, an ulp either side and off the
   map, at the big-map world's shape (padded origin 0 and -res) and a
   ragged one; and its M slices (``m_offset``, ``full_num_samples``: the
   sharded solve's draw), rows [a, b) against the plain version and
   against the rows of the whole draw, every layout x risk.
   The scenario axis (B scenarios in one launch, each with its own keys,
   alpha_dyn, windows, robots, maps, tasks and controls): the map sampler
   in its window mode (bins and every payload layout x risk) and its crop
   mode (every layout x risk, robots in different windows and off the
   map) at B = 3, both rollout kernels (byte and 2-, 4- and 8-bit cells x
   fast, exact and bicycle x speed map) at B = 3, and the sweep's shape
   (B = 30 episodes of the benchmark's 11x11 maps, M = K = 1024), each
   batched launch bit for bit against its plain version and against the B
   single launches.
   Then one small whole solve, the kernel path
   against its plain version on the card and against the CPU
   (``small_solve_witness``).  The solve's tail
   (``drivers.tail_bench.TAIL_CASES``): the
   CVaR plus coupling kernel (``cvar_costs``) and the update kernel
   (``update_useq_fused``, on the first one's costs), each bit for bit
   against its plain version at every path's shape -- world (a) at static
   numel 205 and at the planner's run-time alpha, the sweep's B = 30 at
   alphas 1.0 .. 0.2, the det modes' M = 1 at T = 40, 80 and 100,
   external PMF's K = 2048 / M = 512 / T = 80, the confidence example's M
   = 64 / T = 60, the barebone engine's K = 1000 / T = 50, model_bench's
   K = 10240, the m-sharded candidate pools and gathered rows, M 2048
   and 4096, and past the kernel's former cap up to the Config's largest
   M: a ragged 5000, 8192 and 15,000; then the shapes the kernels once
   refused: T = 4,097 and 20,000 (the coupling its own launch), the barebone
   engine's K = 40,000, 100,000 and 1e6 (the wide update's three
   launches), M = 16,384, 32,768 and 70,000 (the wide CVaR past 16,384)
   at numel ceil(0.2 M) and alpha 1, and the windowed sum's counts (XLA's
   CPU order): numel 33 and a static count of M (the row as stored) at
   world (a), a static count of M at M = 16,384 and 70,000 -- and each
   static count's alpha against its plain version, bit for bit.  Past
   the caps also ``check_lifted_tail_edges``: three scenarios (an alpha
   each) at T = 4,097, 8,193 and 20,000 x M = 16, 1,024 and 20,000;
   the wide CVaR on clustered, equal, tied and non-finite costs at M =
   16,385 and 40,000, with its coupling in the block and launched before
   it; the coupling kernel alone (``coupling_sums``) at one row, an odd
   K, 20,000 and 40,000 steps.  The
   barebone rollout kernel (``barebone_rollout_fused``) against the plain
   loop, bit for bit, at K = 1, 255, 256, 257, 1,000, 40,000 and 1e6, T
   = 1, 7, 50, 100 and 257 (the staged tiles' edges), N = 0, 1, 2, 5
   and 9 obstacles (1 and 2 held in registers, the rest in the generic
   instantiation).  The wide update (``update_useq_wide``) against its
   plain version, bit for bit, at K = 32,769, 40,000, 65,537, 1e6,
   1,048,577 and 2,097,153, B = 1 and 3, T = 1, 3, 50 and 4,097 (its
   chunks' edges and the eta kernel's streamed groups; K from 1e6 at T =
   4,097 left out: the plain version's temporaries pass the card's 80 GB),
   a NaN cost among them.  The visualisation rollouts
   (``ops/kernels/vis_rollout.py``: ``terrain_vis_fused``,
   ``barebone_vis_fused``) against their plain versions, bit for bit
   (the 2.7 m bicycle too): the terrain vis in
   tdm, det_dyn, speed_map and the costmap x the unicycle, the bicycle
   and the car's bicycle x crop on and off x grids with and without
   -128 draws, at V = 20, T = 100 on an 88 x 144 map (a 45 x 45 window
   when cropped), then V = 1, 31, 32, 33, 100 and 4,225 at T = 1 and
   100; each route of the terrain kernel (the grid in shared memory where
   the shape lets it, and global memory at every shape) at 11 x 11 planes
   at odd byte offsets, odd T, T = 4,097 (five chunks of the control
   ring), 250 x 250, 340 x 340 (past the shared-memory budget) and V =
   4,225, in tdm and det_dyn x the unicycle and the bicycle; the barebone
   vis at V = 1, 20, 31, 32, 33, 100 and 4,225 x T = 1, 7, 33, 50, 100 and
   4,097 (``check_vis_cases``).  Launches past one grid
   (``check_launch_chunks``): 65,539 scenarios through the map sampler
   (byte and 8-bit cells), both rollout kernels and the update, each two
   launches bit for bit with the calls on their slices and the plain
   versions, and both rollout kernels at M = 70,000 (two launches a
   scenario) against their plain versions.  PARITY.md's rollout shapes
   among the cases: large-map 52x52, bin-roi and bin-smooth-ft 85x85,
   crumb-250, crumb-speed-250, bin-speed-250 and the 13x15 small maps on
   2-, 4- and 8-bit cells.
3. The main paths, each with every kernel's launch count set to 0 just
   before it and read just after: ``MPPIPlanner`` on ``device="cuda"``
   through ``setup``, ``solve``, ``shift_and_update`` and, after the last
   solve, ``get_state_rollout``, 20 closed-loop solves, replayed from the
   planner's CUDA graphs, each held bit for bit (controls, every
   ``SolveAux`` field, the last vis) against an eager solve of the same
   solver from a generator of the same seed (``EagerMirror``; its
   launches are not counted), the vis also against the plain loop
   (``backend="eager"``), its vis graph one launch of the vis kernel and
   at most ``VIS_MAX_NODES`` kernels a replay, in each world of
   ``WORLDS`` -- the flagship 11x11 (byte kernel), a 250x250 external PMF
   (8-bit cells), a forest-size 140x84 learned-model PMF under tdm (4-bit
   cells), det_dyn and speed_map (2- or 4-bit cells, M = 1), the forest
   under tdm with the bicycle model (4-bit cells, exact trig), a 140x84
   costmap (2-bit cells), the reference benchmark's 9x9 semantic world
   under all three methods (byte kernel), and the reference's big-map
   regime, 250x250 at 0.5 m cropped to its 85x85 reachable window (4-bit
   cells), closed loop through ``sim.trial`` on a ground truth drawn from
   its PMF; every solve samples and packs its maps through the
   map-sampling kernel once (``sample_and_pack_window``, or
   ``sample_and_pack_crop`` when cropped: no torch packer, no launch of
   its own for the crop) and the rollout, CVaR and update kernels once an
   iteration, and the big-map world's ``TDM.sample_grids``
   draws once more in the kernel's bins mode, bit for bit with the plain
   draw.  Then that big-map world cropped against uncropped,
   the same seed: the same controls bit for bit, the cropped grids the
   window of the uncropped ones, over 20 solves of a moving window; and
   again with the padded origin at -res (a TDM's limits from 0): grids and
   offsets exact, controls within rtol 2e-4 / atol 2e-5;
   ``BareboneMPPI`` on ``examples/barebone_mppi.py``'s task (the
   ``barebone_rollout``, ``cvar_costs`` and ``update_useq_fused`` kernels
   once an iteration, at most ``BAREBONE_MAX_NODES`` kernels a replay),
   20 closed-loop solves replayed from its CUDA graph
   and the vis from its vis graph, each held bit for bit against eager
   calls from a generator of the same seed (``BareboneMirror``); one
   episode of the big-map world through
   ``device_sim.make_device_trial`` (one CUDA graph a step, ``reached``
   read once a chunk); and the gather probe's entry point
   (``probes.gather_probe.run``), every (mode, table size, rows), each
   case's 512-step chain held bit for bit against the plain chain.
   World (l), the reference benchmark sweep
   (``scripts/run_full_benchmark.py``'s protocol: 4 densities x 10
   environments x 3 realizations = 120 paired episodes, K = M = 1024, T =
   100, max_steps 150, 22 bins, 9x9 padded to 11x11), each of the four
   paper methods at alpha 0.6 through ``benchmark.run_trials_device_rows``
   in chunks of 30: one CUDA graph a batched step, captured once a
   method, one map_sample launch and one rollout launch a replay (not an
   episode); one batched solve step of a chunk against its 30 solves made
   one at a time from the same draws (the kernels' outputs bit for bit, u
   within rtol 2e-4 / atol 2e-5); ``benchmark.run_trials_rows`` (the
   sequential engine) on 2 realizations a method; a graphed planner's
   checkpoint round trip (``checkpoint``), its next solve bit for bit;
   and the shapes the kernels once refused, through the planners' entry
   points, 3 solves each, every replay bit for bit with an eager solve:
   the flagship planner at ``Config(T=409.7)`` (4,097 steps) and at
   ``num_grid_samples`` 20,000 and 70,000 (the wide CVaR), at most
   ``LIFTED_MAX_NODES`` kernels a replay, the barebone planner at K =
   100,000 and 1e6 (the wide update), their launches counted (the
   ``kernels`` line's ``launches_lifted_solves``).
4. Timing with CUDA events: each rollout kernel over launches captured in
   a CUDA graph and over eager launches, in turns, against its plain
   version; the binned kernel in turns with the byte kernel on the same
   inputs at the forest, 250x250 and speed-map worlds' shapes, the bicycle
   against the unicycle (both exact trig) at the forest's shape on every
   layout; the
   probe's ns per chain step at every (mode, S, R) beside its bound; the
   map-sampling kernel at world (b)'s shape, fused in (b)'s layout and in
   its bins mode (and the bins mode followed by the torch packers), and
   fused at (a)'s, (c)'s and (k)'s, and the crop mode at the big-map
   world's, each against its bound and its plain version; the solve's
   tail kernels at (a)'s shape (static and the planner's alpha), the
   sweep's, the det modes', the barebone engine's, model_bench's K =
   10240, every M past 1024 and the shapes past the former caps (T =
   4,097 and 20,000, K = 40,000, 1e5 and 1e6, M = 16,384, 32,768 and
   70,000),
   in turns with the torch calls the CVaR
   kernel replaced (the library call), ``torch.sort`` and a masked sum,
   all the torch ops it replaced (the coupling's too), past T = 4,096 the
   coupling kernel alone and its torch ops, and an empty kernel (one
   graph node's floor), against their bounds (and bound shares) and
   plain versions, and the wide update's three launches each on its own
   (``torch.profiler``) at K = 40,000, 1e5 and 1e6; the barebone rollout
   kernel at K = 1,000 and 1e6 (graph and eager, in turns) against its
   bound and the plain loop; the
   visualisation rollouts of worlds (a), (c), (k), (d), (e), (f) and (h)
   and of the barebone planner, one vis graph replay (the vis kernel) on
   the device clock and ``get_state_rollout()`` on the host's, with the
   graph's kernels, beside the plain loop's own vis graph and the bytes
   and latency bounds (``time_vis_rollouts``), and the terrain vis kernel
   on a 250 x 250 grid at V past the blocks the card holds at once, both
   routes (``time_vis_queue``); then
   per timed world, in turns, chained solves replayed from a CUDA graph
   and eager (``profiling.chained_solve_time``) on the device clock
   beside the host's time to enqueue them, and planner ``solve()`` times
   on the host clock, and the device's busy time and kernel launches per
   solve by kernel (a replay launching the CVaR and update kernels once an
   iteration, and no solve launching torch's sort or top-k kernels); the
   host time of ``get_state_rollout`` (graph) and
   of the eager vis in the forest world; the barebone chained solve,
   replayed from a graph and eager in turns (with its kernels a replay); the
   big-map world's chained solves (graph and eager) and planner
   ``solve()`` calls cropped against uncropped, in turns; one device
   trial of the big-map world against ``sim.trial``'s host loop, steps
   per second; the kernels with a scenario axis at the sweep's shape (B =
   30, and the det modes' M = 1) against 30 single launches; the sweep's
   episodes per second for each method on one chunk, batched (its capture
   apart) against in turn (one graph a scenario), and the peak device
   memory of a batched step at chunks of 10, 30, 60 and 120.  Each figure
   is printed as a JSON line with the card's name and power limit.

5. The sharded solve (``mppi_numba_tpu_torch.parallel``).  NCCL at world
   size 1 in this process: world (a)'s solve on a (1, 1, 1) mesh through
   the sharded entry point, bit for bit with the single ``TerrainSolver``
   from the same generator state, both eager and timed in turns (what
   the sharding code costs at one rank), its launches counted (the
   rollout, CVaR and update kernels once an iteration: one k rank updates
   with the kernel and makes no collective); then the
   sharded solve of each ``SHARDED_CASES`` problem (world, scenarios,
   run-time alpha) on that mesh captured in a CUDA graph with its NCCL
   collectives (``ShardedTerrainSolver.capture``), 3 replays each bit for
   bit against the eager sharded solve and the single solve, no
   collective from the host during a replay; world (a)'s graph timed in
   turns with the eager sharded and single solves.  Then
   ``SHARDED_RANKS`` gloo ranks spawned on the one card (the kernels built
   by this process), each at full width: world (a) on meshes (1, 4, 1),
   (1, 2, 2) and (2, 2, 1) with 4 scenarios and the run-time-alpha solve
   at (1, 2, 2), world (k) (the big map's 85x85 window, 4-bit cells: the
   crop with an m offset) at (1, 2, 2) and world (d) (det_dyn, M = 1:
   replicated over m) at (1, 4, 1), each rank's u within rtol 2e-4 /
   atol 2e-5 of the single solve of the same draws and its gathered
   payload bit for bit the unsharded launch's rows, its ``map_sample``
   and rollout launches counted around the solve and its collectives
   counted against the port's design (none staged through the host),
   each solve eager (gloo runs its collectives on the host: capture
   raises on every rank, and that is checked);
   and ``make_sharded_trial_batch`` on 8 noisy_dyn episodes of world (l)
   against ``make_device_trial_batch`` on the same episodes (steps and
   success exact, cum_obj within rtol 1e-4).  Each figure is a JSON line
   with the card's name and power limit; the 4-rank times are labelled
   "4 ranks sharing one card: not a scaling figure".

6. The drivers (``mppi_numba_tpu_torch.drivers``, the counterparts of the
   JAX package's ``bench.py`` and ``scripts/*_bench.py``), each run as a
   subprocess at full width on the card and its lines echoed: ``bench``
   (the headline line), every ``bigmap_bench`` row, ``model_bench``,
   ``serve_bench``, ``profile_flagship`` (its sampler checks included)
   and ``scaling_bench`` under ``torchrun`` on one NCCL rank at world
   (a)'s shape; the barebone row must carry its graph's kernels and its
   eager time, the scaling line its graph replay bit for bit with the
   eager sharded solve.  A non-zero exit, a missing line, a number that is not
   finite, a failed check or a driver whose lines show no launch of the
   map-sampling and rollout kernels fails the run.

7. The examples and the sweep drivers (``mppi_numba_tpu_torch.examples``,
   the counterparts of ``examples/*.py``, and ``drivers.full_benchmark`` /
   ``drivers.engine_ab_check``, of ``scripts/run_full_benchmark.py`` /
   ``scripts/engine_ab_check.py``), each run as a subprocess from the
   repository's root at full width on the card, its lines echoed: every
   mode of every example, ``full_benchmark`` at one environment and
   realization a density with the four paper methods (80 trials) and
   ``engine_ab_check`` at one of each (8 trials an engine).  A non-zero
   exit, a first line that is not the card line, a number that is not
   finite, a missing outcome line, a terrain example that did not launch
   the map-sampling and a rollout kernel, a planner that replayed no CUDA
   graph, or a file written outside the run's ``--out-dir`` (under
   ``build/smoke_phase7/``) fails the run; so does a sweep pickle without
   the JAX script's keys, or a ``drivers.summarize_benchmark`` rendering
   of it without its three tables and this card's name.  Each example's
   success, time to goal and steps are printed; a miss does not fail the
   run.  Then, in this process,
   every terrain world of the examples, built by its example (every mode
   of terrain_planning and planner_animation; external PMF at K = 2048 /
   M = 512, the costmap's M = 1 route, the confidence map with its
   unknown mask), each over 5 closed-loop solves replayed from the
   planner's graphs and held bit for bit against eager solves
   (``EagerMirror``), with the last vis; every kernel call of those eager
   solves held bit for bit against the wrapper's plain version on the
   same inputs (``held_against_plain``: the map sampler, the rollout, the
   CVaR and the update kernels); and for the animation's worlds
   each step's frame rollouts (``get_state_rollout()`` before the shift)
   bit for bit with the eager vis and the plain loop, the subprocess's
   per-frame ``get_state_rollout()`` time beside its solves printed.
   Phase 2's cases hold the kernels at
   these shapes too.  Their launches and the subprocesses' are the
   ``kernels`` line's ``launches_phase7``.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.

The run reaps every process it starts, orphans included
(``become_subreaper``).  Before its last two lines it stops them all
(``stop_started_processes``): multiprocessing's resource tracker, which
phase 5's ``mp.spawn`` starts and the interpreter would leave to end after
it, and any other, which fails the run.  It stops them again on its way
out if a phase failed.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import re
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32, non-tensor-core

# float32 operations per lane-step of the rollout kernels, counted from
# the plain version's arithmetic (a sqrtf, sinf, cosf or tanf counts as
# one): cell index 10, decode 4 (lb + ratio * value for lin and ang; none
# where a 2- or 4-bit cell reads the LUT), dynamics (fast-trig rotation 24
# | exact unicycle 11, x and y sharing the product dt*lin_tr*v | exact
# bicycle 13 per lane-step: v_eff and dt*v_eff shared 2, x 3, y 3, heading
# dt*ang_tr*v*tan/wheelbase + th 5, and its tanf(w) once per (t, k),
# shared by the map samples), goal distance 5, stage cost 7, masking 9.
# Per lane once: 6 for the terminal cost, plus the start heading's
# cosf/sinf in fast-trig mode.  The speed-map step time dt / (eff + 1e-6)
# is a table over the 256 values of a risk byte, 4 operations an entry
# (csrc/rollout_step.cuh), not an operation per lane-step.
OPS_STEP_FAST, OPS_STEP_EXACT, OPS_DECODE = 59, 46, 4
OPS_STEP_BICYCLE = OPS_STEP_EXACT + 2
OPS_STEP_TABLE = 4 * 256
# The gather chain: 3 integer operations per lane-step (the two % and the
# ^), counted at the card's non-tensor-core float32 rate, the only
# non-tensor-core rate the data sheet gives: a faster rate than the
# integer units', so the bound stays a lower bound.
OPS_GATHER_STEP = 3
# The map draw's work, what the function needs (not what
# csrc/map_sample.cu spends), counted per pipe.  Per element threefry2x32
# takes 20 rounds x (add, rotate, xor) + 5 key injections x 2 adds + the
# counter's multiply-add 2, the uniform's xor, shift and or 3 (75), and in
# a payload layout the pack's shift and OR 2.  Of these only the rotates
# (funnel shifts), the xors, the uniform's 3 and the pack's 2 must run on
# the ALU pipe (45 with the pack); the adds may issue on the FMA pipe too.
# The float work, 4 an element (multiply, subtraction, ceil, conversion),
# and every integer operation share the schedulers' issue slots.  The rank
# and the decode are shared-memory loads (another pipe) and are not
# counted.  Per cell and plane, once: the cumulative's add and the table's
# count per bin, and the table's prefix over sampled = 0..100.
OPS_MAP_HASH, OPS_MAP_PACK, FLOPS_MAP_SAMPLE = 75, 2, 4
ALU_OPS_MAP_HASH = 20 + 20 + 3
OPS_TABLE_PER_BIN, TABLE_LEVELS = 2, 101
# Bytes an element that the map draw writes beside its two int8 grids:
# int32 bins of both planes, or the payload of a layout.
MAP_OUT_BYTES = {"bins": 8, "byte": 4, "binned8": 2, "binned": 1,
                 "binned2": 0.5}
# Integer rates at the H100 SXM's 1,980 MHz boost clock (NVIDIA data
# sheet), 132 SMs (Hopper white paper): the ALU pipe's 64 INT32 lanes an
# SM a clock (16 a sub-partition), and the 4 schedulers' issue of one warp
# instruction each a clock, 128 lanes an SM, across all pipes.
ALU_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
CELLS_PER_WORD = {2: 8, 4: 4, 8: 2}
SOLVES = 20
# Phase 3's solves at the shapes the kernels once refused: the flagship
# planner's overrides of setup_world's T and M, the barebone planner's K.
LIFTED_PLANNERS = (("flagship_T4097", dict(T=409.7)),
                   ("flagship_M20000", dict(M=20000)),
                   ("flagship_M70000", dict(M=70000)))
LIFTED_BAREBONE_K = (100000, 1000000)
LIFTED_SOLVES = 3
# The barebone solve graph's kernels a replay at most: the draw, its
# scaling, the rollout, CVaR and update kernels and a few copies' kernels
# (the plain loop's replay had some 1,700); at the lifted K, where the
# update takes the wide path's three launches, at most
# LIFTED_BAREBONE_MAX_NODES.
BAREBONE_MAX_NODES = 10
LIFTED_BAREBONE_MAX_NODES = 8
# Phase 2's barebone rollout cases (K x T x N obstacles: a block's 256
# rollouts and one either side, whole and partial tiles of 8 steps, 1 and
# 2 obstacles in registers, none, 5 and 9 in the generic instantiation)
# and phase 4's timed shapes (the example's K = 1,000 and the Config's
# 1e6, T = 50, its two obstacles).
BAREBONE_KS = (1, 255, 256, 257, 1000, 40000, 1000000)
BAREBONE_TS = (1, 7, 50, 100, 257)
BAREBONE_NS = (0, 1, 2, 5, 9)
BAREBONE_TIMED = ((1000, 50, 2), (1000000, 50, 2))
# The kernels a vis graph replays at most: the vis kernel alone (the torch
# loops it replaced replayed 3,716 at T = 100 and 557 at T = 50).
VIS_MAX_NODES = 3
# The lifted tdm planners' solve graphs, kernels a replay at most: world
# (a)'s 26; past T = 4,096 the coupling kernel's launch more; at M =
# 20,000 the wide CVaR in the CVaR's place; at M = 70,000 a second rollout
# launch past 65,535 map samples and the copy of each launch's columns
# into the costs (rollout_byte.chunked_launches).  The counts of an H100
# run of this script (PERF.md section 6).
LIFTED_MAX_NODES = {"flagship_T4097": 27, "flagship_M20000": 26,
                    "flagship_M70000": 29}
# Phase 2's vis cases: every mode, model and crop of the planners' vis
# (the costmap is the speed-map vis on nominal grids; the bicycle at the
# default and a car's wheelbase), on the forest's padded map or an
# 45 x 45 window of it at VIS_OFFSET; then V of one rollout, a warp's
# width and one either side, 100, and 4,225, past the rollouts an H100
# holds at once (a block a rollout: vis_rollout.vis_route).
VIS_MODES = ("tdm", "det_dyn", "speed_map", "costmap")
VIS_MODELS = ("unicycle", "bicycle", "bicycle_car")
VIS_VS = (1, 31, 32, 33, 100, 4225)
VIS_MAP, VIS_ROI, VIS_OFFSET = (88, 144), (45, 45), (20, 37)
# Phase 2's route cases of the terrain vis kernel (grid, T, V): 11 x 11
# planes at every byte offset, odd T, T = 4,097 (five chunks of the
# control ring), 250 x 250 (dynamic shared memory past 48 KB), 340 x 340
# (the global route by its shape: its grid does not fit), 250 x 250 past
# the 132 blocks an H100 holds at once with the grid shared (the global
# route by its waves) and V past the blocks the card holds at once; each
# on the route its shape takes and on each route it fits.
VIS_ROUTE_CASES = (((11, 11), 1, 20), ((11, 11), 7, 20), ((11, 11), 101, 20),
                   ((11, 11), 4097, 5), ((250, 250), 101, 20),
                   ((250, 250), 4097, 3), ((340, 340), 101, 20),
                   ((250, 250), 100, 133), ((140, 84), 100, 4225))
VIS_BAREBONE_TS = (1, 7, 33, 50, 100, 4097)
# Headings past the terrain chain's fast sine (|th| < 105,615): the chunk
# is stepped again with sincosf.
VIS_FAR_HEADINGS = (1.2e5, -3.5e5, 2.0e7)
# The float32 inputs the fast sine is checked on: every magnitude below
# 105,615 (bit patterns 0 .. 0x47ce477f, each sign) and every NaN.
FAST_SINCOS_INPUTS = 2 * 0x47ce4780 + 2 * (2 ** 23 - 1)
# Phase 4's timed queue: tdm on a 250 x 250 grid (one block an SM on the
# shared route), T = 100, at V = 132, just past and twice.
VIS_QUEUE_VS = (132, 133, 264)
# Phase 4's timed vis: worlds (a), (c), (k), (d), (e), (f), (h); and the
# barebone planner.
VIS_TIMED_WORLDS = ("flagship_11x11", "forest_140x84", "bigmap_250x250_roi",
                    "forest_140x84_det_dyn", "forest_140x84_speed_map",
                    "costmap_140x84", "forest_140x84_bicycle")
# Phase 2's wide update cases (K x B x T): just past the fused path's
# 32,768, the lifted 40,000, just past a power of two, the Config's 1e6,
# and just past 2^20 and 2^21 (update_wide_eta's 32 and 64 positions a
# thread: its streamed groups of 16); one scenario and three; T of one
# step, three, the engine's 50 and 4,097 (33 chunks of columns).  K past
# 1e6 at T = 4,097 is left out: its noise is 33 GB or more and the plain
# version's tree needs three times that.
WIDE_UPDATE_KS = (32769, 40000, 65537, 1000000, 1048577, 2097153)
WIDE_UPDATE_BS = (1, 3)
WIDE_UPDATE_TS = (1, 3, 50, 4097)
WIDE_UPDATE_SKIP = ((1000000, 4097), (1048577, 4097), (2097153, 4097))
# Phase 4's wide update launches, each timed on its own (torch.profiler).
WIDE_UPDATE_TIMED = (40000, 100000, 1000000)
# World -> (planning mode, the layout 'auto' must route it to); None: 2-
# or 4-bit cells, as the support-compacted bin count falls (printed).
WORLDS = {
    "flagship_11x11": ("tdm", "byte"),
    "external_250x250": ("tdm", "binned8"),
    "forest_140x84": ("tdm", "binned"),
    "forest_140x84_det_dyn": ("det_dyn", None),
    "forest_140x84_speed_map": ("speed_map", "binned2"),
    "forest_140x84_bicycle": ("tdm", "binned"),
    "costmap_140x84": ("costmap", "binned2"),
    "benchmark_9x9_tdm": ("tdm", "byte"),
    "benchmark_9x9_det_dyn": ("det_dyn", "byte"),
    "benchmark_9x9_speed_map": ("speed_map", "byte"),
    "bigmap_250x250_roi": ("tdm", "binned"),
}
TIMED_WORLDS = ("flagship_11x11", "external_250x250", "forest_140x84",
                "forest_140x84_speed_map", "bigmap_250x250_roi")
# The reference's big-map regime (scripts/bigmap_bench.py:34-79): a random
# 12-bin PMF on a 250x250 padded map at 0.5 m, vmax 2 m/s, T = 100 steps
# of 0.1 s: an 85x85 reachable window.
BIGMAP = "bigmap_250x250_roi"
BIGMAP_BINS, BIGMAP_RES, BIGMAP_VMAX, BIGMAP_ROI = 12, 0.5, 2.0, (85, 85)
# Closed-loop solves of the cropped-against-uncropped check: the big-map
# trial's, over which the window moves.
CROP_CHECK_SOLVES = SOLVES
# The big-map world's device trial: its steps (its goal lies beyond them).
DEVICE_TRIAL_STEPS = 100
# jax.random.uniform(jax.random.PRNGKey(s) or a split key, (3, 25 * 40))
# at (m, y, x) of the (3, 25, 40) draw, computed with JAX 0.9.0 on the
# CPU: (key words, [((m, y, x), the float32's bits, ceil(100 u) - 1)]).
KNOWN_UNIFORMS_SHAPE = (3, 25, 40)
_KNOWN_AT = ((0, 0, 0), (1, 24, 39), (2, 0, 0), (2, 19, 17))
KNOWN_UNIFORMS = [
    (words, list(zip(_KNOWN_AT, bits, ranks)))
    for words, bits, ranks in (
        ((0, 0), (1064475214, 1051566116, 1065034092, 1049801792),
         (94, 33, 98, 28)),
        ((0, 42), (1056585764, 1050110876, 1062315750, 1053003512),
         (48, 29, 81, 38)),
        ((2877103387, 1697627890),
         (1064228840, 1063075418, 1058989292, 1041854504),
         (93, 86, 62, 14)))]
# The gather probe's case in the kernels line: the TPU probe's own (column
# gather, its largest table, its 32-row tile).
PROBE_TIMED_AT = "column_S6568_R32"
# An SM's L1 and shared memory (H100): a larger table cannot sit in L1.
L1_BYTES = 256 * 1024
# The reference benchmark sweep (scripts/run_full_benchmark.py:42-66,
# benchmark.ipynb[cell 5]): 4 vegetation densities x 10 environments x 3
# realizations = 120 paired episodes of a 9x9 grid (padded to 11x11, 22
# bins) per (method, alpha), max_steps 150, K = M = 1024, T = 100; world
# (l) runs the four paper methods at one alpha, in chunks of 30 episodes
# (the JAX package's default batch_chunk).
SWEEP_DENSITIES = [1.0, 0.7, 0.4, 0.1]
SWEEP_ENVS, SWEEP_TRIALS, SWEEP_MAX_STEPS = 10, 3, 150
SWEEP_GRID, SWEEP_MARGIN, SWEEP_RES = (9, 9), 1, 1.0
SWEEP_ALPHA, SWEEP_CHUNK = 0.6, 30
# The scenario-axis cases of phase 2: scenarios a launch.
SCENARIOS = 3
# The skip mask: phase 4 times the sweep's B = 30 byte launch with these
# many of its scenarios skipped; phase 2 holds the masked launches at the
# sweep's shape and at the fleet's (16 robots' 65x65 windows of the
# 250x250 map, 8-bit cells) against the masked plain versions.
SKIP_COUNTS = (0, 8, 15, 22, 29)
FLEET_ROBOTS, FLEET_WINDOW = 16, (65, 65)
# Chunk sizes whose peak device memory phase 4 records (noisy_dyn, M = K =
# 1024; 120 is the whole sweep in one batch).
PEAK_CHUNKS = (10, 30, 60, 120)
FOREST_ROWS, FOREST_COLS, FOREST_RES, FOREST_BINS = 138, 82, 0.5, 12
# Steering range of the bicycle cases and world (rad): a vehicle's, and far
# from tan's pole at pi/2.
STEER = 0.5
WHEELBASE = 0.5
# A car's wheelbase (m): its float32 reciprocal is inexact, so a kernel
# that ignored its wheelbase argument, or divided otherwise than the plain
# version, shows there.
CAR_WHEELBASE = 2.7


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def rollout_bound_ms(K, M, T, H, W, fast_trig, speed_map, cell_bits=None,
                     bicycle=False):
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
    per_step = ((OPS_STEP_FAST if fast_trig
                 else OPS_STEP_BICYCLE if bicycle else OPS_STEP_EXACT)
                - (OPS_DECODE if cell_bits in (2, 4) else 0))
    ops = (K * M * (T * per_step + 6 + (2 if fast_trig else 0))
           + (K * T if bicycle else 0)
           + (OPS_STEP_TABLE if speed_map else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def gather_bound_ms(touched, R, L, iters):
    """Least time for one gather chain: the larger of its bytes over HBM
    bandwidth and its integer operations over the non-tensor-core rate.
    Bytes: each table entry the chain reads (``touched``, what this run's
    data needs; at most the whole table) once, idx in and out once.
    Returns (ms, bound_by)."""
    nbytes = 4 * (touched + 2 * R * L)
    ops = OPS_GATHER_STEP * R * L * iters
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def map_sample_bound_ms(M, rH, rW, B_lin, B_ang, layout="bins",
                        risk=False):
    """Least time for one map-sampling call in ``layout``: the larger of
    its bytes over HBM bandwidth and its operations, which is the larger
    of its ALU-only integer operations over the ALU pipe's rate and all of
    its operations (integer and float) over the issue rate.  Bytes: the
    two int8 PMF windows and LUTs and the key in, and in a payload layout
    the obstacle, unknown (and with ``risk`` the risk) windows; out the
    int8 grids of both planes and the bins or payload (``MAP_OUT_BYTES``),
    and in a binned layout the shared mask (16 cells a word) and risk (4
    cells a word) words.  Returns (ms, bound_by)."""
    n, cells, bins = M * rH * rW, rH * rW, B_lin + B_ang
    payload = layout != "bins"
    shared = (-(-cells // 16) + (-(-cells // 4) if risk else 0)) * 4
    nbytes = (bins * (cells + 1) + 16 + (2 + MAP_OUT_BYTES[layout]) * n
              + ((2 + risk) * cells if payload else 0)
              + (shared if layout.startswith("binned") else 0))
    pack = OPS_MAP_PACK if payload else 0
    alu_ops = n * (ALU_OPS_MAP_HASH + pack)
    all_ops = (n * (OPS_MAP_HASH + pack + FLOPS_MAP_SAMPLE)
               + cells * (OPS_TABLE_PER_BIN * bins + 2 * TABLE_LEVELS))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(alu_ops / ALU_OPS_PER_S, all_ops / ISSUE_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


# Timed in phase 4: world (a) static (the profile's), as the planner runs
# it, the sweep's batch, the det modes' M = 1, the barebone engine,
# model_bench's K = 10240, every M past 1024, and the shapes past the
# former caps (the coupling's own launch, the wide update and the wide
# CVaR).
TAIL_TIMED = ("a_static_205", "a_planner_alpha", "sweep_b30_alphas",
              "det_M1_T100", "barebone_K1000_T50", "model_bench_K10240_tdm",
              "shared_memory_sort_M2048", "shared_memory_sort_M4096",
              "ragged_M5000", "M8192_alpha", "config_max_M15000",
              "streamed_T4097", "streamed_T20000", "wide_update_K40000",
              "wide_update_K100000", "wide_update_K1000000", "M16384_numel", "wide_M32768_numel",
              "wide_M70000_numel", "wide_M70000_alpha1", "a_static_all_1024",
              "wide_M70000_static_all")


def bits_differ(torch, got, want):
    """Entries whose float32 bits differ (a shape mismatch: all)."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel(), 1)
    return int((got.contiguous().view(torch.int32)
                != want.contiguous().view(torch.int32)).sum())


def check_tail_cases(torch, dev):
    """Phase 2's solve-tail cases: at every ``drivers.tail_bench.TAIL_CASES``
    shape (every path's) the CVaR plus coupling kernel against its plain
    version, the update kernel (from the kernel's costs) against its plain
    version, bit for bit, and a static count's alpha (ceil(M * alpha) =
    numel, its own order: windows over M) against its plain version, bit
    for bit.  One JSON line a case; returns the records."""
    from mppi_numba_tpu_torch.drivers.tail_bench import (TAIL_CASES,
                                                         tail_case_inputs)
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = []
    for case in TAIL_CASES:
        name, B, K, M, T, count = case
        a_args, kw, (lam, vr, wr) = tail_case_inputs(case, dev)
        noise, u = a_args[1], a_args[2]
        got = kc.cvar_costs(*a_args, **kw)
        want = kc.cvar_costs_plain(*a_args, **kw)
        u_got, w_got = ku.update_useq_fused(got, noise, u, lam, vr, wr)
        u_want, w_want = ku.update_useq_plain(got, noise, u, lam, vr, wr)
        differ = {"cvar_costs": bits_differ(torch, got, want),
                  "update_u": bits_differ(torch, u_got, u_want),
                  "update_weights": bits_differ(torch, w_got, w_want)}
        if "numel" in kw:
            alpha = torch.full(lam.shape, (kw["numel"] - 0.5) / M,
                               device=dev)
            differ["alpha_of_count"] = bits_differ(
                torch, kc.cvar_costs(*a_args, alpha=alpha),
                kc.cvar_costs_plain(*a_args, alpha=alpha))
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in (
            (got, want), (u_got, u_want), (w_got, w_want)))
        rec = dict(case="solve_tail_" + name, scenarios=B, K=K, M=M, T=T,
                   count=count if isinstance(count, (int, str))
                   else list(count),
                   threads_per_row=kc.threads_per_row(B, K, M, sms),
                   cvar_path=list(kc.kernel_path(B, K, M, T, sms)),
                   update_shape=(list(ku.launch_shape(B, K, T, sms))
                                 if K <= ku.FUSED_K
                                 else ku.wide_launch_shape(B, K, T)),
                   entries_differing=differ, max_abs_err=err,
                   finite=bool(torch.isfinite(u_got).all()))
        print(json.dumps(rec), flush=True)
        check(not any(differ.values()) and rec["finite"],
              "solve tail {}: the kernels differ from their plain versions: "
              "{}".format(name, differ))
        results.append(rec)
        del a_args, got, want, noise, u
    return results


# Phase 2's edges of the two kernels past the tail's caps (as the card-only
# tests' ``test_cvar_costs_past_the_former_caps_on_card``,
# ``test_cvar_wide_kernel_edges_on_card`` and ``test_coupling_sums_on_card``):
# three scenarios (each its own alpha) at T = 4,097, 8,193 and 20,000 (the
# coupling kernel's one to four groups a thread) and M = 16 (a warp team),
# 1,024 and 20,000 (the wide kernel after the coupling); rows of clustered
# (one bin of the first histogram), equal, tied and non-finite costs for
# the wide kernel at M = 16,385 and 40,000, its coupling summed in the
# block (T = 9) and launched before it (T = 4,097); the coupling kernel
# alone at one row, an odd K, 20,000 and 40,000 steps (super-groups past
# its register stack).
LIFTED_TAIL_SHAPES = [(3, 37, M, T) for M in (16, 1024, 20000)
                      for T in (4097, 8193, 20000)]
WIDE_EDGE_KINDS = ("equal", "ties", "specials", "one_bin")
WIDE_EDGE_SHAPES = ((40000, 9), (16385, 9), (40000, 4097))
COUPLING_EDGES = ((None, 1, 4097), (None, 37, 8193), (3, 1024, 20000),
                  (2, 5, 40000), (None, 3, 100))


def wide_edge_costs(torch, dev, kind, B, K, M, seed=0):
    """Rows that stress the wide CVaR's walk: ``equal`` (one value a row),
    ``ties`` (most costs 1e5, the rest around it), ``specials`` (NaN,
    +-inf, +0.0 beside -0.0 among ordinary costs), ``one_bin`` (costs in
    [256, 288): every key's top 12 bits alike, one bin of the first
    histogram)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    costs = torch.rand((B, K, M), generator=g, device=dev) * 300
    if kind == "one_bin":
        return costs * (31.9 / 300.0) + 256.0
    if kind == "equal":
        return costs[..., :1].expand(B, K, M).contiguous()
    if kind == "ties":
        pick = torch.rand((B, K, M), generator=g, device=dev)
        return torch.where(pick < 0.7, torch.full_like(costs, 1e5),
                           torch.where(pick < 0.85, costs + 1e5, costs))
    pick = torch.randint(0, 8, (B, K, M), generator=g, device=dev)
    for code, value in ((0, float("nan")), (1, float("inf")),
                        (2, -float("inf")), (3, 0.0), (4, -0.0)):
        costs = torch.where(pick == code, torch.full_like(costs, value),
                            costs)
    return costs


def check_lifted_tail_edges(torch, dev):
    """Phase 2's edges past the tail's caps (``LIFTED_TAIL_SHAPES``,
    ``WIDE_EDGE_KINDS`` x ``WIDE_EDGE_SHAPES``, ``COUPLING_EDGES``): the
    CVaR plus coupling kernel (and the coupling kernel alone) against the
    plain versions, bit for bit, at static counts and run-time alphas.
    One JSON line a shape; returns the records."""
    from mppi_numba_tpu_torch.drivers.tail_bench import tail_case_inputs
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc

    results = []

    def held(name, calls, **shape):
        differ = {}
        err = 0.0
        for tag, got_fn, want_fn in calls:
            got, want = got_fn(), want_fn()
            torch.cuda.synchronize()
            differ[tag] = bits_differ(torch, got, want)
            both = torch.isfinite(got) & torch.isfinite(want)
            if bool(both.any()):
                err = max(err, float((got - want)[both].abs().max()))
        rec = dict(case=name, entries_differing=differ, max_abs_err=err,
                   **shape)
        print(json.dumps(rec), flush=True)
        check(not any(differ.values()), "{} {}: the kernels differ from "
              "their plain versions: {}".format(name, shape, differ))
        results.append(rec)

    def cvar_calls(args, counts):
        return [(json.dumps({k: v if isinstance(v, int) else v.tolist()
                             for k, v in kw.items()}),
                 lambda kw=kw: kc.cvar_costs(*args, **kw),
                 lambda kw=kw: kc.cvar_costs_plain(*args, **kw))
                for kw in counts]

    for B, K, M, T in LIFTED_TAIL_SHAPES:
        args, _, _ = tail_case_inputs(("lifted_edge", B, K, M, T, 1), dev,
                                      seed=M + T)
        counts = [dict(numel=v) for v in (math.ceil(0.2 * M), 1, M)]
        counts += [dict(alpha=torch.tensor(a, device=dev))
                   for a in ([0.2] * B, [1.0] * B, [0.2, 0.6, 1.0])]
        held("solve_tail_lifted_edge", cvar_calls(args, counts), scenarios=B,
             K=K, M=M, T=T, cvar_path=list(kc.kernel_path(B, K, M, T)))
        del args
    for kind in WIDE_EDGE_KINDS:
        for M, T in WIDE_EDGE_SHAPES:
            B, K = 2, 5
            (_, noise, u, u_std, lam), _, _ = tail_case_inputs(
                ("wide_edge", B, K, 8, T, 1), dev, seed=T)
            args = (wide_edge_costs(torch, dev, kind, B, K, M), noise, u,
                    u_std, lam)
            counts = [dict(numel=v) for v in (1, 16384, 16385, 33000, M,
                                              M + 5) if v <= M + 5]
            counts += [dict(alpha=torch.tensor(a, device=dev))
                       for a in ([1.3, 1.3], [0.0, 0.0], [-0.5, -0.5],
                                 [0.2, 1.0])]
            held("solve_tail_wide_edge", cvar_calls(args, counts),
                 kind=kind, scenarios=B, K=K, M=M, T=T)
            del args
    for B, K, T in COUPLING_EDGES:
        (_, noise, u, u_std, _), _, _ = tail_case_inputs(
            ("coupling_edge", B or 1, K, 1, T, 1), dev, seed=T)
        held("coupling_sums", [("coupling", lambda: kc.coupling_sums(
            noise, u, u_std), lambda: kc.coupling_sums_plain(
                noise, u, u_std))], scenarios=B, K=K, T=T,
             launch=list(kc.coupling_launch_shape(B or 1, K, T)))
    return results


def barebone_case(torch, dev, K, T, N, seed=0):
    """A barebone rollout's inputs on the card: the example's task with N
    obstacles past a goal at (2, 1.5), controls and noise (sigma 1.5) that
    reach the goal, hit obstacles and clip.  Returns ``(task, u,
    noise)``."""
    from mppi_numba_tpu_torch.types import BareboneTask

    g = torch.Generator(device=dev).manual_seed(seed)

    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    obs = torch.rand((N, 2), generator=g, device=dev) * 2.5 + f([2.5, 2.0])
    task = BareboneTask(
        x0=f([0.0, 0.0, math.pi / 4]), xgoal=f([2.0, 1.5]),
        goal_tolerance=f(0.5), lambda_weight=f(1.0), u_std=f([1.0, 1.0]),
        vrange=f([0.0, 2.0]), wrange=f([-math.pi, math.pi]), dt=f(0.1),
        dist_weight=f(10.0), obs_penalty=f(1e6), obs_pos=obs,
        obs_r=torch.rand((N,), generator=g, device=dev) * 0.5 + 0.5)
    u = torch.stack([torch.rand((T,), generator=g, device=dev) * 2 + 0.5,
                     torch.rand((T,), generator=g, device=dev) - 0.5], -1)
    noise = torch.randn((K, T, 2), generator=g, device=dev) * 1.5
    return task, u, noise


def check_barebone_cases(torch, dev):
    """Phase 2's barebone rollout cases: the kernel
    (``barebone_rollout_fused``) against the plain loop
    (``ops/rollout.py::barebone_rollout_costs``) on the same CUDA tensors,
    bit for bit, at every K x T x N of ``BAREBONE_KS`` x ``BAREBONE_TS`` x
    ``BAREBONE_NS``.  One JSON line a case; returns the records."""
    from mppi_numba_tpu_torch.ops.kernels.barebone_rollout import (
        barebone_rollout_fused, launch_shape)
    from mppi_numba_tpu_torch.ops.rollout import barebone_rollout_costs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = []
    for K in BAREBONE_KS:
        for T in BAREBONE_TS:
            for N in BAREBONE_NS:
                task, u, noise = barebone_case(torch, dev, K, T, N,
                                               seed=K + T + N)
                got = barebone_rollout_fused(task, u, noise)
                want = barebone_rollout_costs(task, u, noise)
                torch.cuda.synchronize()
                differ = bits_differ(torch, got, want)
                hit = float((want >= 1e6).float().mean())
                threads, blocks, tiles, smem = launch_shape(K, T, N, sms)
                rec = dict(case="barebone_rollout", K=K, T=T, N=N,
                           threads=threads, blocks=blocks, tiles=tiles,
                           shared_bytes=smem, entries_differing=differ,
                           max_abs_err=float((got - want).abs().max()),
                           hit_share=hit)
                print(json.dumps(rec), flush=True)
                check(differ == 0, "barebone rollout K {} T {} N {}: {} "
                      "entries differ from the plain loop".format(
                          K, T, N, differ))
                results.append(rec)
                del task, u, noise, got, want
    return results


def wide_update_case(torch, dev, B, K, T, seed):
    """A wide update's inputs on the card: ``drivers.tail_bench``'s
    rollout-like costs (a tenth crashed), noise scaled by sigma (2, 3),
    controls, lambda 1 and the flagship's ranges, with a leading axis of
    B scenarios where B > 1.  Returns ``(costs, noise, u, lam, vrange,
    wrange)``."""
    from mppi_numba_tpu_torch.drivers.tail_bench import tail_case_inputs

    (costs, noise, u, _, lam), _, (_, vr, wr) = tail_case_inputs(
        ("wide_update", B, K, 1, T, 1), dev, seed=seed)
    return costs[..., 0].contiguous(), noise, u, lam, vr, wr


def check_wide_update_cases(torch, dev):
    """Phase 2's wide update cases: ``update_useq_wide`` against
    ``update_useq_plain`` on the same CUDA tensors, bit for bit (u and
    the weights), at every K x B x T of ``WIDE_UPDATE_KS`` x
    ``WIDE_UPDATE_BS`` x ``WIDE_UPDATE_TS`` but ``WIDE_UPDATE_SKIP``, and
    at B = 1, T = 3 again with a NaN cost.  One JSON line a case; returns
    the records."""
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    results = []
    for K in WIDE_UPDATE_KS:
        for B in WIDE_UPDATE_BS:
            for T in WIDE_UPDATE_TS:
                if (K, T) in WIDE_UPDATE_SKIP:
                    continue
                args = wide_update_case(torch, dev, B, K, T, seed=K + B + T)
                variants = [("", args[0])]
                if B == 1 and T == 3:
                    variants.append(("_nan_cost", args[0].clone().index_fill_(
                        -1, torch.tensor([K // 3], device=dev),
                        float("nan"))))
                for tag, costs in variants:
                    got = ku.update_useq_wide(costs, *args[1:])
                    want = ku.update_useq_plain(costs, *args[1:])
                    torch.cuda.synchronize()
                    differ = {"u": bits_differ(torch, got[0], want[0]),
                              "weights": bits_differ(torch, got[1], want[1])}
                    rec = dict(case="wide_update" + tag, K=K, scenarios=B,
                               T=T, shape=ku.wide_launch_shape(B, K, T),
                               entries_differing=differ,
                               max_abs_err=float((got[0] - want[0]).abs()
                                                 .max()))
                    print(json.dumps(rec), flush=True)
                    check(not any(differ.values()),
                          "wide update K {} B {} T {}{}: {} differ from the "
                          "plain version".format(K, B, T, tag, differ))
                    results.append(rec)
                    del got, want
                del args, variants
    return results


def time_wide_update_launches(torch, dev, emit):
    """Phase 4's wide update at each ``WIDE_UPDATE_TIMED`` K (B = 1, T =
    50): each of its three launches' own device time, from
    ``torch.profiler`` over 20 eager calls, beside the call's bound.
    Returns ``{K: {kernel: us a call}}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mppi_numba_tpu_torch.drivers.tail_bench import tail_bound_ms
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    out = {}
    for K in WIDE_UPDATE_TIMED:
        args = wide_update_case(torch, dev, 1, K, 50, seed=K)
        for _ in range(3):
            ku.update_useq_wide(*args)
        torch.cuda.synchronize()
        calls = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ku.update_useq_wide(*args)
            torch.cuda.synchronize()
        us = {}
        for e in prof.key_averages():
            name = re.search(r"update_wide_[a-z]+", e.key)
            if e.device_type == DeviceType.CUDA and name:
                us[name.group(0)] = (us.get(name.group(0), 0.0)
                                     + float(e.device_time_total) / calls)
        check(len(us) == 3, "wide update K {}: the profiler saw {}".format(
            K, sorted(us)))
        bound = tail_bound_ms(1, K, 1, 50, 1)[1]
        emit("wide_update_launch_us", sum(us.values()), "us", K=K, T=50,
             launch_us=us, bound_ms=bound[0], bound_by=bound[1],
             bound_share=bound[0] / (sum(us.values()) / 1e3),
             shape=ku.wide_launch_shape(1, K, 50))
        out[K] = us
        del args
    return out


def barebone_bound_ms(K, T, N):
    """Least time of the barebone rollout at (K, T, N obstacles), the
    larger of its bytes over HBM bandwidth and its float32 operations over
    the float32 peak.  Bytes: the noise (K, T, 2), u (T, 2), the task's
    values and obstacles read once, the (K,) costs written once.
    Operations a rollout-step: the two noisy controls' adds and clamps
    (2 + 4), cos and sin (counted as one each), the state update (3
    products, 3 adds), the goal distance (2 subtractions, 2 products, an
    add), each obstacle's 2 subtractions, 2 products, an add, r^2 and a
    comparison, the step cost (2 products, an add), the goal comparison
    and the masked add (2); the terminal cost once a rollout (3)."""
    nbytes = 4 * (K * T * 2 + T * 2 + 13 + 3 * N + K)
    ops = K * T * (6 + 2 + 6 + 5 + 7 * N + 3 + 2) + 3 * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def time_barebone_kernel(torch, dev, time_kernels, time_cuda, emit):
    """Phase 4's barebone rollout timings at each ``BAREBONE_TIMED``
    shape: the kernel over launches captured in a CUDA graph and eager, in
    turns, the plain loop eagerly, and the bound.  Returns ``{shape:
    {...}}``."""
    from mppi_numba_tpu_torch.ops.kernels import barebone_rollout
    from mppi_numba_tpu_torch.ops.kernels.barebone_rollout import (
        barebone_rollout_fused)
    from mppi_numba_tpu_torch.ops.rollout import barebone_rollout_costs

    out = {}
    for K, T, N in BAREBONE_TIMED:
        task, u, noise = barebone_case(torch, dev, K, T, N, seed=7)
        runs = time_kernels({"kernel": lambda: barebone_rollout_fused(
            task, u, noise)}, 50)["kernel"]
        plain = [time_cuda(lambda: barebone_rollout_costs(task, u, noise),
                           3, 1) for _ in range(2)]
        bound = barebone_bound_ms(K, T, N)
        shape = "K{}_T{}_N{}".format(K, T, N)
        rec = dict(shape=shape, ms=min(runs["graph"]),
                   launch_shape=list(barebone_rollout.launch_shape(
                       K, T, N, torch.cuda.get_device_properties(
                           dev).multi_processor_count)),
                   eager_ms=min(runs["eager"]), runs=runs["graph"],
                   eager_runs=runs["eager"], plain_ms=min(plain),
                   bound_ms=bound[0], bound_by=bound[1],
                   bound_share=bound[0] / min(runs["graph"]))
        emit("barebone_rollout_kernel_ms", rec["ms"], "ms", **rec)
        out[shape] = rec
        del task, u, noise
    return out


def vis_terrain_case(torch, dev, mode, V, T, crop, past_last, seed,
                     hw=VIS_MAP, M=None):
    """``terrain_vis_fused``'s positional arguments on the card: int8 grids
    of ``M`` samples (V + 2 in tdm, else 1) at ``hw``, or at ``VIS_ROI``
    when cropping (-128 among them with ``past_last``; all 100 for the
    costmap), controls that turn and clip, noise rows (sigma 1, 0.6), the
    window's offset and a task at 0.5 m whose robot crosses cell edges;
    steering within +-``STEER``."""
    from mppi_numba_tpu_torch.types import TerrainTask

    rng = np.random.RandomState(seed)

    def t(a, dtype=None):
        return torch.tensor(np.asarray(a, dtype), device=dev)

    M = (V + 2 if mode == "tdm" else 1) if M is None else M
    H, W = VIS_ROI if crop else hw
    if mode == "costmap":
        lin = np.full((M, H, W), 100, np.int8)
        ang = lin.copy()
    else:
        lin = rng.randint(0, 101, (M, H, W)).astype(np.int8)
        ang = rng.randint(0, 101, (M, H, W)).astype(np.int8)
    if past_last:
        lin[rng.rand(*lin.shape) < 0.3] = -128
        ang[rng.rand(*ang.shape) < 0.3] = -128
    u_cur = np.stack([rng.uniform(0.5, 2.0, T), rng.uniform(-0.5, 0.5, T)],
                     axis=-1)
    u_prev = np.stack([rng.uniform(0.5, 2.0, T),
                       rng.uniform(-0.5, 0.5, T)], axis=-1)
    noise = rng.randn(V, T, 2) * [1.0, 0.6]
    oy, ox = VIS_OFFSET if crop else (0, 0)
    res, lim0 = 0.5, -0.5
    f = np.float32
    task = TerrainTask(
        x0=t([lim0 + (ox + 0.3 * W) * res, lim0 + (oy + 0.4 * H) * res,
              0.7], f),
        xgoal=t([0.0, 0.0], f), goal_tolerance=t(0.5, f),
        v_post_rollout=t(0.5, f), lambda_weight=t(1.0, f),
        u_std=t([1.0, 0.6], f), vrange=t([0.0, 2.0], f),
        wrange=t([-STEER, STEER], f), dt=t(0.1, f), dist_weight=t(1.0, f),
        obs_penalty=t(1e4, f), unknown_penalty=t(1e2, f),
        alpha_dyn=t(1.0, f), res=t(res, f), xlim0=t(lim0, f),
        ylim0=t(lim0, f), lin_lb=t(0.05, f), lin_ratio=t(0.0093, f),
        ang_lb=t(0.1, f), ang_ratio=t(0.0071, f))
    return (t(lin), t(ang), t(u_cur, f), t(u_prev, f), t(noise, f),
            t([oy, ox], np.int32), task)


def vis_step_fn(model):
    """The step function of a ``VIS_MODELS`` name."""
    from mppi_numba_tpu_torch.models import (make_bicycle_step,
                                             unicycle_step)

    return {"unicycle": unicycle_step,
            "bicycle": make_bicycle_step(WHEELBASE),
            "bicycle_car": make_bicycle_step(CAR_WHEELBASE)}[model]


def vis_barebone_case(torch, dev, V, T, seed):
    """``barebone_vis_fused``'s arguments: ``barebone_case``'s task (the
    example's), controls that clip, and V noise rows (sigma 1.5)."""
    task, u, noise = barebone_case(torch, dev, V, T, 2, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    u_prev = torch.stack([torch.rand((T,), generator=g, device=dev) * 2.5,
                          torch.rand((T,), generator=g, device=dev) * 8 - 4],
                         -1)
    return task, u, u_prev, noise


def vis_route_case(torch, dev, mode, hw, V, T, seed):
    """``terrain_vis_fused``'s arguments on an ``hw`` grid whose planes lie
    at an odd byte offset (a view one byte into its memory), -128 among
    the draws, the robot mid-map."""
    rng = np.random.RandomState(seed)
    args = list(vis_terrain_case(torch, dev, mode, V, T, False, False, seed,
                                 hw=(1, 1)))
    M = V + 2 if mode == "tdm" else 1
    for i in range(2):
        g = rng.randint(0, 101, M * hw[0] * hw[1] + 1).astype(np.int8)
        g[rng.rand(*g.shape) < 0.3] = -128
        args[i] = torch.tensor(g, device=dev)[1:].view((M,) + hw)
    res = float(args[6].res)
    args[6] = args[6]._replace(x0=torch.tensor(
        [0.45 * hw[1] * res, 0.55 * hw[0] * res, 0.3], device=dev),
        xlim0=torch.tensor(0.0, device=dev),
        ylim0=torch.tensor(0.0, device=dev))
    return tuple(args)


def check_vis_cases(torch, dev):
    """Phase 2's vis cases: each vis kernel against its plain version on
    the same CUDA tensors, bit for bit (the 2.7 m bicycle too): the
    terrain vis in every ``VIS_MODES`` x ``VIS_MODELS`` x crop on and off
    x grids with and without -128 draws at V = 20, T = 100; then each
    ``VIS_VS`` at T = 1 and 100 in tdm and det_dyn; each
    ``VIS_ROUTE_CASES`` in tdm and det_dyn x the unicycle and the bicycle,
    on the route its shape takes (``route_on_card``), on the global route
    and, where the grid fits, on the shared route (the wrapper's
    ``route``); ``VIS_FAR_HEADINGS`` (the chunk stepped again
    with sincosf) in tdm and det_dyn x ``VIS_MODELS``; the barebone vis at
    each ``VIS_VS`` and 20 x ``VIS_BAREBONE_TS``.  First the chain's fast
    sine and cosine against sincosf on every float32 it takes
    (``FAST_SINCOS_INPUTS``).  Each terrain record names the route its launch
    counted under.  One JSON line a case; returns the records."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.ops.rollout import (barebone_vis_fused_plain,
                                                  terrain_vis_fused_plain)

    fused = vis_rollout.terrain_vis_fused

    def held(args, kw, model, route=None, want=None, **info):
        before = dict(fused.route_launches)
        got = fused(*args, **kw, route=route)
        if want is None:
            want = terrain_vis_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        (route,) = [r for r, n in fused.route_launches.items()
                    if n != before[r]]
        return vis_record(torch, "terrain_vis", got, want, model=model,
                          route=route,
                          hw=list(args[0].shape[1:]), **info)

    cases = [(m, model, crop, past, 20, 100)
             for m in VIS_MODES for model in VIS_MODELS
             for crop in (False, True) for past in (False, True)]
    cases += [(m, "unicycle", False, True, V, T) for m in ("tdm", "det_dyn")
              for V in VIS_VS for T in (1, 100)]
    bad, checked = vis_rollout.check_fast_sincos(dev.index or 0)
    rec = dict(case="fast_sincos", mismatches=bad, checked=checked)
    print(json.dumps(rec), flush=True)
    check(bad == 0 and checked == FAST_SINCOS_INPUTS,
          "fast_sincos: {} of {} inputs differ from sincosf".format(
              bad, checked))
    results = [rec]
    for i, (mode, model, crop, past, V, T) in enumerate(cases):
        args = vis_terrain_case(torch, dev, mode, V, T, crop, past, seed=i)
        kw = dict(V=V, det=mode != "tdm", crop=crop,
                  step_fn=vis_step_fn(model))
        results.append(held(args, kw, model, mode=mode, crop=crop,
                            past_last=past, V=V, T=T))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (hw, T, V) in enumerate(VIS_ROUTE_CASES):
        for mode in ("tdm", "det_dyn"):
            args = vis_route_case(torch, dev, mode, hw, V, T, seed=100 + i)
            for model in ("unicycle", "bicycle"):
                kw = dict(V=V, det=mode != "tdm", step_fn=vis_step_fn(model))
                det, bike = mode != "tdm", model == "bicycle"
                want_route = vis_rollout.route_on_card(
                    V, T, *hw, det, bike, dev.index or 0).route
                fits = (vis_rollout.smem_bytes(T, *hw, det, bike, True)
                        <= vis_rollout._prepared(dev.index or 0))
                if hw == (340, 340) or (hw == (250, 250) and V > sms):
                    expect = "global"   # no fit; one block an SM queues
                else:
                    expect = "shared" if V <= sms else want_route
                check(fits == (hw != (340, 340)) and want_route == expect,
                      "terrain_vis {} x {} at V {}: route {}".format(
                          *hw, V, want_route))
                want = terrain_vis_fused_plain(*args, **kw)
                for route in (None, "global") + (("shared",) if fits
                                                 else ()):
                    rec = held(args, kw, model, route, want, mode=mode,
                               crop=False, past_last=True, V=V, T=T,
                               forced_route=route is not None)
                    check(rec["route"] == (route or want_route),
                          "terrain_vis {}: launched on the {} route".format(
                              rec, rec["route"]))
                    results.append(rec)
    for th0 in VIS_FAR_HEADINGS:
        for mode in ("tdm", "det_dyn"):
            args = vis_route_case(torch, dev, mode, (11, 11), 6, 40, seed=7)
            args = args[:6] + (args[6]._replace(x0=torch.tensor(
                [2.5, 3.0, th0], device=dev)),)
            for model in VIS_MODELS:
                kw = dict(V=6, det=mode != "tdm", step_fn=vis_step_fn(model))
                results.append(held(args, kw, model, mode=mode, crop=False,
                                    past_last=True, V=6, T=40, th0=th0))
    for V in VIS_VS[:1] + (20,) + VIS_VS[1:]:
        for T in VIS_BAREBONE_TS:
            args = vis_barebone_case(torch, dev, V, T, seed=V + T)
            got = vis_rollout.barebone_vis_fused(*args)
            want = barebone_vis_fused_plain(*args)
            torch.cuda.synchronize()
            results.append(vis_record(torch, "barebone_vis", got, want, V=V,
                                      T=T))
    return results


def vis_record(torch, name, got, want, **info):
    """Hold vis states against the plain version's: finite, the shape,
    bit for bit (the 2.7 m bicycle too: the kernel multiplies by the
    wheelbase's float32 reciprocal, as PyTorch divides by a Python scalar
    on CUDA).  Prints and returns the record."""
    check(got.shape == want.shape and bool(got.isfinite().all()),
          "{} {}: states {} not finite or not {}".format(
              name, info, tuple(got.shape), tuple(want.shape)))
    differ = bits_differ(torch, got, want)
    err = float((got - want).abs().max())
    rec = dict(case=name, **info, bitwise=True, entries_differing=differ,
               max_abs_err=err)
    print(json.dumps(rec), flush=True)
    check(differ == 0, "{} {}: {} entries differ from the plain "
          "version".format(name, info, differ))
    return rec


def vis_cells(states, task, det, crop, roi_offset, hw):
    """The distinct (grid, cell) pairs a terrain vis read: each step's
    cell of the pre-update state (a float64 recomputation from the
    states: a count, not a parity check)."""
    H, W = hw
    x = states[:, :-1, 0].astype(np.float64)
    y = states[:, :-1, 1].astype(np.float64)
    res = float(task.res)
    xlim0, ylim0 = float(task.xlim0), float(task.ylim0)
    if crop:
        oy, ox = (int(v) for v in roi_offset)
        xlim0, ylim0 = xlim0 + ox * res, ylim0 + oy * res
    xi = np.clip(np.floor((x - xlim0) / res), 0, W - 1)
    yi = np.clip(np.floor((y - ylim0) / res), 0, H - 1)
    grid = 0 if det else np.arange(states.shape[0])[:, None]
    return len(np.unique((grid * H + yi) * W + xi))


def vis_bound_ms(V, T, cells, det, model):
    """Least time of a vis call at V rollouts x T steps, the larger of its
    bytes over HBM bandwidth and its float32 operations over the float32
    peak.  Bytes: the ``cells`` distinct cells read (an int8 of each
    plane; None: the barebone vis, no map), u_cur (and in the det modes
    u_prev and the V - 1 noise rows) read once, the task's values, the
    (V, T+1, 3) states written once.  Operations a rollout-step: the cell
    index 10 and the decode 4 (terrain), the dynamics (unicycle 11,
    bicycle 13 and its tanf, the barebone's 8), and the noisy rows' add
    and clamp 6."""
    noisy = V - 1 if det else 0
    nbytes = (2 * (cells or 0) + 4 * (T * 2 * (2 if det else 1)
                                      + noisy * T * 2 + 20)
              + 4 * V * (T + 1) * 3)
    step = 8 if cells is None else 14 + (14 if model == "bicycle" else 11)
    ops = V * T * step + noisy * T * 6
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def time_vis_rollouts(torch, time_cuda, time_cuda_graph, planners, step_ns,
                      chain, emit):
    """The planners' visualisation rollouts: ``get_state_rollout()``
    (replayed from the planner's vis graph: the vis kernel) on the host
    clock, its graph's replay on the device clock (20 back to back, and
    20 single replays each behind a spin kernel, ``time_single_calls``),
    with its kernels a replay, and the vis kernel alone (20 launches in
    one graph; a terrain world's in turns with the same call on the other
    route, where its grid fits), beside the plain loop's (``backend="eager"``) captured in a ``VisGraph`` on
    the same buffers (bit for bit with it), and the bounds: bytes or
    operations (``vis_bound_ms``, this run's cells); latency, T dependent
    steps: a terrain step waits on its cell's load, at least ``step_ns``
    (the gather probe's quickest L1 chain step, this run), a barebone step
    on its heading's add (4 cycles at 1,980 MHz); and the chain of the
    kernel's own SASS (``chain``: ``vis_sass_chain``) at the SM clock
    nvidia-smi reads while the vis replays: T critical cycles of a terrain
    step on the route the world takes, and T heading adds, T position adds
    and one sincosf for the barebone vis; ``latency_share`` and
    ``chain_latency_share``: each bound over the kernel alone.  ``planners``: ``{world:
    planner}``, each solved at least once.  Returns ``{world: record}``."""
    from mppi_numba_tpu_torch.graphs import VisGraph
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.solver import get_barebone_vis, get_terrain_vis

    out = {}
    for world, planner in planners.items():
        planner.get_state_rollout()
        static = planner._last_static
        graph = planner._vis_graphs[static]._call
        aux = planner._last_aux
        plain_static = dataclasses.replace(static, backend="eager")
        barebone = static.mode == "barebone"
        if barebone:
            head, tail = (planner._task_device,), (aux.noise_vis,)
            plain_vis = get_barebone_vis(plain_static)
            vis = get_barebone_vis(static)
        else:
            head = (planner._map_inputs(), planner._task_device)
            tail = (aux.noise_vis, aux.lin_grids, aux.ang_grids,
                    aux.roi_offset)
            plain_vis = get_terrain_vis(plain_static)
            vis = get_terrain_vis(static)
        plain_graph = VisGraph(plain_vis, head, tail, planner.u_cur)
        host = []
        for _ in range(6):
            t0 = time.perf_counter()
            states = planner.get_state_rollout()
            host.append((time.perf_counter() - t0) * 1e3)
        plain_states = plain_graph(planner.u_cur, planner.u_prev)
        check(np.array_equal(states, plain_states.cpu().numpy()),
              "{}: the vis kernel's graph differs from the plain loop's"
              .format(world))
        device = [time_cuda(graph.replay, 20, 2) for _ in range(3)]
        single = time_single_calls(torch, graph.replay, 20)
        args = head + (planner.u_cur, planner.u_prev) + tail
        other = None if barebone else other_route_call(vis_rollout, static,
                                                       args)
        kernel, other_runs = [], []
        for _ in range(2):
            kernel.append(time_cuda_graph(lambda: vis(*args), 20, 2))
            if other:
                other_runs.append(time_cuda_graph(other[1], 20, 2))
        plain = [time_cuda(plain_graph._call.replay, 3, 1) for _ in range(2)]
        clock = sm_clock_mhz_under(torch, graph.replay)
        V, T1, _ = states.shape
        T = T1 - 1
        det = barebone or static.mode != "tdm"
        cells = None if barebone else vis_cells(
            states, planner._task_device, det, bool(static.roi_shape),
            aux.roi_offset.tolist(), tuple(aux.lin_grids.shape[1:]))
        bound = vis_bound_ms(V, T, cells, det, static.model)
        latency = T * (4 / 1.98e9 * 1e3 if barebone else step_ns * 1e-6)
        if barebone:
            kname, route, per_sm = "barebone_vis_kernel", None, None
            c = (chain or {}).get(kname)
            cycles = c and 2 * T * c["add_cycles"] + c["sincos_cycles"]
        else:
            H, W = aux.lin_grids.shape[1:]
            r = vis_rollout.route_on_card(V, T, H, W, det,
                                          static.model == "bicycle",
                                          torch.cuda.current_device())
            route = r.route
            kname = vis_rollout.kernel_name(static.model == "bicycle", route)
            per_sm = vis_rollout.blocks_per_sm(kname, r.smem_bytes,
                                               torch.cuda.current_device())
            c = (chain or {}).get(kname)
            cycles = c and T * c["cycles_per_step"]
        chain_ms = cycles / (clock * 1e3) if cycles else None
        rec = dict(world=world, ms=min(device), device_runs=device,
                   replay_device_ms=float(np.median(single)),
                   replay_device_min_ms=min(single),
                   kernel_in_graph_ms=min(kernel), kernel_runs=kernel,
                   kernels_per_replay=graph.kernel_nodes,
                   host_ms_median=float(np.median(host[1:])), host_runs=host,
                   plain_ms=min(plain), plain_runs=plain,
                   plain_kernels_per_replay=plain_graph._call.kernel_nodes,
                   bound_ms=bound[0], bound_by=bound[1], cells_read=cells,
                   latency_bound_ms=latency,
                   latency_share=latency / min(kernel),
                   chain_bound_ms=chain_ms,
                   chain_latency_share=chain_ms and chain_ms / min(kernel),
                   chain_cycles=cycles, chain_kernel=kname,
                   chain_model=c, sm_clock_mhz=clock, route=route,
                   other_route=other and other[0],
                   other_route_kernel_ms=min(other_runs, default=None),
                   other_route_runs=other_runs,
                   chain_bound_is="a model: the SASS chain's cycles under "
                                  "SASS_LATENCY's assumed latencies (not "
                                  "measured) at the SM clock read in this "
                                  "run",
                   blocks_per_sm=per_sm,
                   V=V, T=T, mode=static.mode, model=static.model,
                   roi=static.roi_shape, states_shape=list(states.shape),
                   timing="device clock: ms, 20 vis graph replays back "
                          "to back (the plain loop's: its own VisGraph; "
                          "host-bound where a replay is shorter than the "
                          "host's graph launch); replay_device_ms: the "
                          "median of 20 single replays behind a spin kernel; "
                          "kernel_in_graph_ms: 20 vis launches in one graph; "
                          "host clock: get_state_rollout()")
        check(graph.kernel_nodes <= VIS_MAX_NODES,
              "{}: {} kernels a vis replay".format(world, graph.kernel_nodes))
        emit("vis_rollout_graph_ms", rec["ms"], "ms", **{
            k: v for k, v in rec.items() if k != "ms"})
        out[world] = rec
        del plain_graph
    return out


def other_route_call(vis_rollout, static, args):
    """``(route, call)``: the terrain vis of ``static`` on ``args`` (the
    vis function's) through ``terrain_vis_fused`` on the route its shape
    does not take, or None where that is the shared route and the grid
    does not fit."""
    from mppi_numba_tpu_torch.models import get_step_fn

    _, task, u_cur, u_prev, noise_vis, lin, ang, roi_offset = args
    kw = dict(V=static.num_vis_state_rollouts,
              det=static.mode in ("det_dyn", "speed_map"),
              crop=bool(static.roi_shape), step_fn=get_step_fn(static.model))
    rows = vis_rollout.vis_rows(kw["V"], kw["det"], lin, noise_vis)
    T, (H, W) = u_cur.shape[0], lin.shape[1:]
    bike = static.model == "bicycle"
    dev = lin.device.index
    route = {"shared": "global", "global": "shared"}[
        vis_rollout.route_on_card(rows, T, H, W, kw["det"], bike, dev).route]
    if (route == "shared" and vis_rollout.smem_bytes(T, H, W, kw["det"], bike,
                                                     True)
            > vis_rollout._prepared(dev)):
        return None
    return route, functools.partial(
        vis_rollout.terrain_vis_fused, lin, ang, u_cur, u_prev, noise_vis,
        roi_offset, task, route=route, **kw)


def time_single_calls(torch, fn, reps):
    """Device time (ms) of each of ``reps`` single calls of ``fn``, CUDA
    events around the call alone, each call enqueued behind a spin kernel
    (``torch.cuda._sleep``, some 0.1 ms) so that the device is not left
    waiting on the host's launch."""
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(200000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def time_vis_queue(torch, dev, time_cuda_graph, emit):
    """The terrain vis kernel in tdm on a 250 x 250 grid at T = 100 and each
    ``VIS_QUEUE_VS``: the shared route (one block an SM: the card holds
    ``blocks_per_sm`` x SMs rollouts at once, the rest queue) in turns with
    the global route, 10 launches in one graph each, beside the route its
    shape takes (``route_on_card``).  Returns ``{V: record}``."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout

    index = dev.index or 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for V in VIS_QUEUE_VS:
        args = vis_route_case(torch, dev, "tdm", (250, 250), V, 100,
                              seed=V)
        kw = dict(V=V, det=False, step_fn=vis_step_fn("unicycle"))
        runs = {"shared": [], "global": []}
        for _ in range(2):
            for route in runs:
                runs[route].append(time_cuda_graph(
                    lambda: vis_rollout.terrain_vis_fused(*args, **kw,
                                                          route=route),
                    10, 1))
        r = vis_rollout.route_on_card(V, 100, 250, 250, False, False, index)
        smem = vis_rollout.smem_bytes(100, 250, 250, False, False, True)
        per_sm = vis_rollout.blocks_per_sm(
            vis_rollout.kernel_name(False, "shared"), smem, index)
        rec = dict(V=V, T=100, hw=[250, 250], shared_ms=min(runs["shared"]),
                   global_ms=min(runs["global"]), runs=runs, route=r.route,
                   smem_bytes=smem, blocks_per_sm=per_sm, sms=sms,
                   blocks_at_once=per_sm * sms,
                   waves=vis_rollout.waves(V, per_sm * sms))
        emit("vis_queue_kernel_ms", rec["shared_ms"], "ms", **{
            k: v for k, v in rec.items() if k != "shared_ms"})
        out[V] = rec
        del args
    return out


CHUNK_SCENARIOS = 65535 + 4       # past one launch's 65,535 scenarios
CHUNK_SAMPLES = 70000             # past one launch's 65,535 map samples


def check_launch_chunks(torch, dev, make_task, make_case, make_binned_case):
    """Phase 2's launches past one grid: ``CHUNK_SCENARIOS`` scenarios (K =
    32, M = 1, 11x11; their own keys, tasks and controls, one random PMF)
    through the map sampler (byte and 8-bit-cell payloads), both rollout
    kernels and the update kernel, each launching twice (65,535 and 4
    scenarios) and bit for bit the calls on those two slices, its last
    scenarios bit for bit the plain versions'; and both rollout kernels at
    ``CHUNK_SAMPLES`` map samples (two launches a scenario) against their
    plain versions.  One JSON line a check; returns the records."""
    from mppi_numba_tpu_torch.ops.kernels import (map_sample, rollout_binned,
                                                  rollout_byte, update_useq)
    from mppi_numba_tpu_torch.types import MapInputs

    B, K, M, T, H, W = CHUNK_SCENARIOS, 32, 1, 5, 11, 11
    parts = (slice(0, 65535), slice(65535, B))
    g = torch.Generator(device=dev).manual_seed(65)
    records = []

    def held(name, counted, call, cut, plain=None):
        """``call(slice)`` on all B scenarios (two launches) against the
        calls on the two slices and, on the last three, ``plain``."""
        before = counted.launches
        whole = call(slice(0, B))
        launches = counted.launches - before
        differ = sum(bits_differing(torch, a, b)
                     for p in parts
                     for a, b in zip(cut(whole, p), cut(call(p), slice(None))))
        if plain is not None:
            differ += sum(bits_differing(torch, a, b) for a, b in zip(
                cut(whole, slice(B - 3, B)), cut(plain(slice(B - 3, B)),
                                                 slice(None))))
        rec = dict(check="launch_chunks", case=name, scenarios=B,
                   launches=launches, entries_differing=differ)
        print(json.dumps(rec), flush=True)
        check(launches == 2 and differ == 0,
              "launch chunks {}: {}".format(name, rec))
        records.append(rec)
        return whole

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in flat(o) if t is not None] \
            if isinstance(out, tuple) else []

    def cut(out, p):
        return [t[p] for t in flat(out)]

    pmf = torch.randint(0, 101, (12, H, W), generator=g, device=dev,
                        dtype=torch.int8)
    qbins = torch.arange(0, 120, 10, device=dev).to(torch.int8)
    plane = torch.zeros((H, W), dtype=torch.int8, device=dev)
    one = MapInputs(pmf, pmf, qbins, qbins, plane, plane, plane)
    maps = MapInputs(*(t.expand((B,) + tuple(t.shape)).contiguous()
                       for t in one))
    key = torch.randint(0, 2 ** 31, (B, 2), generator=g, device=dev)
    alpha = torch.ones(B, device=dev)
    fused = map_sample.sample_and_pack_window
    payload = {}
    for layout in ("byte", "binned8"):
        out = held("map_sample_" + layout, fused, lambda p: fused(
            key[p], MapInputs(*(t[p] for t in maps)), alpha[p], M, layout),
            cut, lambda p: map_sample.sample_and_pack_window_plain(
                key[p], MapInputs(*(t[p] for t in maps)), alpha[p], M,
                layout))
        payload[layout] = out[0]
    tv = rollout_byte.build_task_vec(make_task(H, W, 1.0))
    tv = tv.expand(B, tv.shape[-1]).contiguous()
    v = torch.rand((B, T, K), generator=g, device=dev) * 2
    w = torch.rand((B, T, K), generator=g, device=dev) * 2 - 1
    words = payload["byte"]
    byte = rollout_byte.terrain_rollout_costs_byte
    costs = held("rollout_byte", byte, lambda p: byte(
        words[p], tv[p], v[p], w[p], H=H, W=W, T=T), cut,
        lambda p: rollout_byte.terrain_rollout_costs_byte_plain(
            words[p], tv[p], v[p], w[p], H=H, W=W, T=T))
    cells, mask, _ = payload["binned8"]
    binned = rollout_binned.terrain_rollout_costs_binned
    held("rollout_binned", binned, lambda p: binned(
        cells[p], mask[p], None, tv[p], v[p], w[p], H=H, W=W, T=T,
        cell_bits=8), cut,
        lambda p: rollout_binned.terrain_rollout_costs_binned_plain(
            cells[p], mask[p], None, tv[p], v[p], w[p], H=H, W=W, T=T,
            cell_bits=8))
    noise = torch.randn((B, K, T, 2), generator=g, device=dev)
    u = torch.rand((B, T, 2), generator=g, device=dev)
    lam = torch.ones(B, device=dev)
    vr = torch.tensor([0.0, 2.0], device=dev).expand(B, 2).contiguous()
    wr = torch.tensor([-2.5, 2.5], device=dev).expand(B, 2).contiguous()
    c = costs[..., 0].contiguous()
    upd = update_useq.update_useq_fused
    held("update_useq", upd, lambda p: upd(c[p], noise[p], u[p], lam[p],
                                            vr[p], wr[p]), cut,
         lambda p: update_useq.update_useq_plain(c[p], noise[p], u[p], lam[p],
                                                 vr[p], wr[p]))
    del maps, key, words, cells, mask, noise, costs, c

    # M past 65,535: two launches a scenario, the second's costs copied
    # into their columns.
    Km, Tm = 32, 7
    for name, kern, args, kw in (
            ("rollout_byte_M70000", byte,
             make_case(Km, CHUNK_SAMPLES, Tm, 13, 15, 1.0, True, False, 650),
             dict(H=13, W=15, T=Tm, fast_trig=True)),
            ("rollout_binned_M70000", binned,
             make_binned_case(Km, CHUNK_SAMPLES, Tm, 13, 15, 1.0, 4, 12, True,
                              False, 651, past_last=True)[0],
             dict(H=13, W=15, T=Tm, cell_bits=4, fast_trig=True))):
        plain = (rollout_byte.terrain_rollout_costs_byte_plain
                 if kern is byte
                 else rollout_binned.terrain_rollout_costs_binned_plain)
        before = kern.launches
        got = kern(*args, **kw)
        launches = kern.launches - before
        differ = bits_differ(torch, got, plain(*args, **kw))
        rec = dict(check="launch_chunks", case=name, M=CHUNK_SAMPLES, K=Km,
                   T=Tm, launches=launches, entries_differing=differ)
        print(json.dumps(rec), flush=True)
        check(launches == 2 and differ == 0,
              "launch chunks {}: {}".format(name, rec))
        records.append(rec)
        del args, got
    return records


def time_tail_kernels(torch, dev, time_kernels, time_cuda, emit):
    """Phase 4's solve-tail timings at each ``TAIL_TIMED`` shape, in
    turns, over launches captured in a CUDA graph and eager: the CVaR
    plus coupling kernel, the update kernel, the torch calls that the
    CVaR kernel replaced (``torch.topk(sorted=True)`` and ``mean`` for a
    static count, ``torch.sort`` and a masked sum for alpha: the library
    call), ``torch.sort`` and a masked sum at every case (the yardstick
    past M = 1024), the torch ops that the CVaR plus coupling kernel
    replaced (``drivers.tail_bench.torch_cvar_costs``: the library call
    and the coupling's product and sum) and an empty kernel (one graph
    node's floor); past ``STAGED_T`` steps also the coupling kernel alone
    (``coupling_sums``) and the torch ops it replaced; the plain versions
    eagerly.  Each kernel's bound and bound share beside it.  Returns
    ``{case: {...}}``."""
    from mppi_numba_tpu_torch.drivers.tail_bench import (
        TAIL_CASES, case_count, coupling_bound_ms, tail_bound_ms,
        tail_case_inputs, torch_coupling, torch_cvar_costs)
    from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc
    from mppi_numba_tpu_torch.ops.kernels import update_useq as ku

    out = {}
    for case in TAIL_CASES:
        name, B, K, M, T, count = case
        if name not in TAIL_TIMED:
            continue
        a_args, kw, (lam, vr, wr) = tail_case_inputs(case, dev)
        costs, noise, u = a_args[:3]
        costs_k = kc.cvar_costs(*a_args, **kw)
        # The count a scenario on the card, static or from alpha.
        counts = (torch.full(lam.shape, float(min(kw["numel"], M)),
                             device=dev) if "numel" in kw
                  else torch.ceil(M * kw["alpha"]))

        def sort_masked():
            srt = torch.sort(costs, dim=-1, descending=True).values
            n = counts.to(torch.int32)[..., None]
            keep = (torch.arange(M, device=dev)
                    < n[..., None]).to(costs.dtype)
            return (srt * keep).sum(-1) / n.to(costs.dtype)

        calls = {
            "cvar_costs": lambda: kc.cvar_costs(*a_args, **kw),
            "update_useq": lambda: ku.update_useq_fused(costs_k, noise, u,
                                                        lam, vr, wr),
            "library": sort_masked,
            "torch_ops": lambda: torch_cvar_costs(*a_args, **kw),
            "empty": lambda: kc.empty_launch(dev)}
        coupled = kc.kernel_path(B, K, M, T)[3]
        if coupled:
            calls["coupling"] = lambda: kc.coupling_sums(noise, u, a_args[3])
            calls["coupling_torch_ops"] = lambda: torch_coupling(
                noise, u, a_args[3])
        if "numel" in kw:
            n = min(kw["numel"], M)
            calls["sort_masked"] = sort_masked
            calls["library"] = lambda: torch.topk(
                costs, n, dim=-1, sorted=True).values.mean(-1)
        runs = time_kernels(calls, 100)
        sort_ms = min(runs["sort_masked" if "numel" in kw
                           else "library"]["graph"])
        plain_a = [time_cuda(lambda: kc.cvar_costs_plain(*a_args, **kw), 3,
                             1) for _ in range(2)]
        plain_b = [time_cuda(lambda: ku.update_useq_plain(
            costs_k, noise, u, lam, vr, wr), 5, 1) for _ in range(2)]
        # The fold's terms a row, this run's: the mean count.
        numel, unsorted = case_count(case, kw)
        bound_a, bound_b = tail_bound_ms(B, K, M, T, numel, unsorted)
        cvar_ms = min(runs["cvar_costs"]["graph"])
        rec = dict(
            shape="B{}_K{}_M{}_T{}".format(B, K, M, T),
            count=count if isinstance(count, (int, str)) else list(count),
            cvar_ms=min(runs["cvar_costs"]["graph"]),
            cvar_eager_ms=min(runs["cvar_costs"]["eager"]),
            cvar_plain_ms=min(plain_a), cvar_bound=bound_a,
            library_ms=min(runs["library"]["graph"]),
            library_eager_ms=min(runs["library"]["eager"]),
            faster_than_library=(min(runs["cvar_costs"]["graph"])
                                 < min(runs["library"]["graph"])),
            library="torch.topk(sorted=True) + mean" if "numel" in kw
            else "torch.sort + masked sum",
            cvar_bound_share=bound_a[0] / cvar_ms,
            torch_ops_ms=min(runs["torch_ops"]["graph"]),
            no_slower_than_torch_ops=(
                cvar_ms <= min(runs["torch_ops"]["graph"])),
            sort_masked_ms=sort_ms,
            faster_than_sort=min(runs["cvar_costs"]["graph"]) < sort_ms,
            update_ms=min(runs["update_useq"]["graph"]),
            update_eager_ms=min(runs["update_useq"]["eager"]),
            update_plain_ms=min(plain_b), update_bound=bound_b,
            empty_node_ms=min(runs["empty"]["graph"]),
            empty_eager_ms=min(runs["empty"]["eager"]),
            runs={k: v["graph"] for k, v in runs.items()})
        rec["update_bound_share"] = bound_b[0] / rec["update_ms"]
        if coupled:
            c_bound = coupling_bound_ms(B, K, T)
            rec.update(coupling_plain_ms=min(time_cuda(
                lambda: kc.coupling_sums_plain(noise, u, a_args[3]), 3, 1)
                for _ in range(2)),
                       coupling_ms=min(runs["coupling"]["graph"]),
                       coupling_torch_ops_ms=min(
                           runs["coupling_torch_ops"]["graph"]),
                       coupling_bound=c_bound,
                       coupling_bound_share=c_bound[0] / min(
                           runs["coupling"]["graph"]))
        emit("solve_tail_kernel_ms", rec["cvar_ms"] + rec["update_ms"], "ms",
             case=name, **rec)
        out[name] = rec
        del a_args, costs, noise, u, costs_k
    return out


# Libraries whose every instantiation must build without a ptxas spill.
NO_SPILL_LIBRARIES = ("barebone_rollout", "update_wide", "cvar_wide",
                      "vis_rollout")
_SPILL = re.compile(r"(\d+) bytes spill (?:stores|loads)")


def build_kernels(_build, names):
    """Build every source at once (one nvcc each); print the reports, and
    fail on a spill in ``NO_SPILL_LIBRARIES``."""
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
            if name in NO_SPILL_LIBRARIES:
                check(not any(int(n) for n in _SPILL.findall(line)),
                      "ptxas[{}] spilled: {}".format(name, line.strip()))
    print("build: {:.1f} s".format(time.perf_counter() - t0))


# SASS opcode -> class, for sass_counts; any other opcode is "int".
SASS_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FCHK"),
    "conversion": ("F2I", "I2F", "F2F", "FRND", "I2FP", "F2IP"),
    "mufu": ("MUFU",),
    "fp64": ("DADD", "DMUL", "DFMA", "DSETP"),
    "load_store": ("LDG", "LD", "LDS", "LDL", "LDC", "ULDC", "STG", "STS",
                   "STL", "ST"),
    "control": ("BRA", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BREAK",
                "WARPSYNC", "BAR", "NOP"),
    "move": ("MOV", "SEL", "PRMT", "S2R", "S2UR", "R2UR", "CS2R", "UMOV",
             "P2R", "R2P", "PLOP3"),
}


def sass_counts(lib_path):
    """Static SASS instructions per lane-step of each rollout kernel's T
    loop in a built library, by class (``cuobjdump -sass``).  The loop is
    the kernel's largest backward branch; its lane-steps are its MUFU.RSQ
    (one IEEE sqrtf per lane-step), so an unrolled loop or one over
    several map samples is divided by what it covers.  Static: slow paths
    inside the loop (sinf/cosf/tanf's large-argument reduction) count,
    subroutines it calls (the IEEE sqrt and division slow paths) do not.
    Returns one dict per kernel, or None without cuobjdump."""
    import shutil
    import subprocess
    from pathlib import Path
    from mppi_numba_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    return loop_counts(subprocess.run(
        [tool, "-sass", str(lib_path)], check=True, capture_output=True,
        text=True).stdout)


def loop_counts(text):
    """``sass_counts`` of a ``cuobjdump -sass`` listing."""
    import re

    cls = {op: c for c, ops in SASS_CLASSES.items() for op in ops}
    out = []
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        body = [(int(a, 16), t.strip().split(None, 1)[-1]
                 if t.strip().startswith("@") else t.strip())
                for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                       chunk)]
        index = {a: i for i, (a, _) in enumerate(body)}
        loop = None
        for i, (a, ins) in enumerate(body):
            m = re.match(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in index:
                j = index[int(m.group(1), 16)]
                if loop is None or i - j > loop[1] - loop[0]:
                    loop = (j, i)
        if loop is None:
            continue
        ops = [ins.split()[0].split(".")[0] for _, ins in
               body[loop[0]:loop[1] + 1]]
        steps = sum(1 for _, ins in body[loop[0]:loop[1] + 1]
                    if ins.startswith("MUFU.RSQ"))
        if not steps:
            continue
        by_class = {}
        for op in ops:
            c = cls.get(op, "int")
            by_class[c] = by_class.get(c, 0) + 1
        kernel = re.search(r"\d+(rollout_\w+?_kernel)I(.*?)EEv", name)
        out.append(dict(
            kernel=kernel.group(1) if kernel else name,
            template_args=[int(a) for a in re.findall(
                r"L[ib](\d+)E", kernel.group(2))] if kernel else [],
            lane_steps_in_loop=steps,
            per_lane_step=round(len(ops) / steps, 1),
            by_class={c: round(n / steps, 1)
                      for c, n in sorted(by_class.items())}))
    return out


def print_sass_counts(lib_paths):
    """Print ``sass_counts`` of each library as JSON lines."""
    for path in lib_paths:
        counts = sass_counts(path)
        if counts is None:
            print("sass: cuobjdump not found; no instruction counts")
            return
        for c in counts:
            print(json.dumps(dict(sass=str(path).rsplit("/", 1)[-1], **c)))


# Dependent-issue latency, in cycles, that the vis kernels' chain bound
# assumes of an H100 SM (vis_chain_cycles): a model, of the order that
# microbenchmarks of Hopper report, not a measurement of this run.  Any
# opcode not listed is a fixed-latency ALU instruction, 4 cycles.
SASS_LATENCY = {"LDS": 30, "LDG": 33, "LDL": 33, "LD": 33, "SHFL": 24,
                "MUFU": 14, "F2I": 6, "I2F": 6, "F2F": 6, "FRND": 6,
                "DADD": 8, "DMUL": 8, "DFMA": 8}
_SASS_STORES = ("STS", "STG", "STL", "ST", "RED", "ATOM", "ATOMS", "BAR",
                "BRA", "EXIT", "CALL", "RET", "BSSY", "BSYNC", "NOP",
                "DEPBAR", "LDGDEPBAR", "WARPSYNC", "MEMBAR")
_TWO_OVER_PI = "0.63661974668502807617"


def sass_functions(text):
    """``{mangled name: [(address, guard, opcode, operands)]}`` of a
    ``cuobjdump -sass`` listing."""
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        body = []
        for a, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk):
            ins = ins.strip()
            guard = None
            if ins.startswith("@"):
                guard, ins = ins.split(None, 1)
            op, _, rest = ins.partition(" ")
            body.append((int(a, 16), guard, op,
                         [o.strip() for o in rest.split(",") if o.strip()]))
        out[name] = body
    return out


def _regs(operand):
    """The registers an operand names (a 64-bit address ``R2.64``: R2 and
    R3); RZ, PT and uniform registers are constants here."""
    regs = []
    for r, wide in re.findall(r"(?<![A-Z])(R\d+|P\d)(\.64)?", operand):
        regs.append(r)
        if wide and r[0] == "R":
            regs.append("R{}".format(int(r[1:]) + 1))
    return regs


def _defs_uses(guard, op, operands):
    """The registers an instruction writes and reads."""
    base = op.split(".")[0]
    uses = _regs(guard) if guard else []
    if base in _SASS_STORES:
        return [], uses + [r for o in operands for r in _regs(o)]
    defs, i = [], 0
    while i < len(operands) and re.fullmatch(r"!?(P\d|PT)", operands[i]):
        defs += _regs(operands[i])
        i += 1
    if not base.endswith("SETP") and i < len(operands):
        d = _regs(operands[i].split("[")[0])
        if d and d[0][0] == "R":
            width = (4 if ".128" in op else
                     2 if (".64" in op or op.startswith("IMAD.WIDE")
                           or base in ("DADD", "DMUL", "DFMA")
                           or ".F64" in op.split(".", 1)[-1][:4]) else 1)
            defs += ["R{}".format(int(d[0][1:]) + k) for k in range(width)]
        i += 1
        while i < len(operands) and re.fullmatch(r"P\d", operands[i]):
            defs += _regs(operands[i])
            i += 1
    if guard:
        uses += defs      # a predicated write keeps the old value
    return defs, uses + [r for o in operands[i:] for r in _regs(o)]


def _hot_path(body, j, i):
    """Instructions j..i of a loop on its fast path: a forward branch over
    a block holding a slow path (local memory, a loop or a call: sinf's
    large-argument reduction, division's subroutine) is taken as taken."""
    index = {a: k for k, (a, _, _, _) in enumerate(body)}
    hot, k = [], j
    while k <= i:
        a, guard, op, ops = body[k]
        if op.startswith("BRA") and ops:
            target = int(ops[-1], 16)
            if target > a and target in index and index[target] <= i + 1:
                skipped = body[k + 1:index[target]]
                slow = any(o.split(".")[0] in ("STL", "LDL", "CALL")
                           or (o.startswith("BRA") and q
                               and int(q[-1], 16) < b)
                           for b, _, o, q in skipped)
                if slow or guard is None:
                    k = index[target]
                    continue
        else:
            hot.append(body[k])
        k += 1
    return hot


def _latency(op):
    return SASS_LATENCY.get(op.split(".")[0], 4)


def _dataflow(hot, ready):
    """Each register's ready time after the straight-line ``hot`` code,
    from ``ready`` (register -> cycle; a register absent is no dependence)
    at its start; also each instruction's start time (None: it depends on
    none of them)."""
    ready, starts = dict(ready), []
    for _, guard, op, ops in hot:
        defs, uses = _defs_uses(guard, op, ops)
        t = max((ready[r] for r in uses if r in ready), default=None)
        starts.append(t)
        if t is not None:
            for r in defs:
                ready[r] = max(ready.get(r, t), t + _latency(op))
        else:
            for r in defs:
                ready.pop(r, None)
    return ready, starts


def _max_cycle_mean(nodes, weight):
    """Karp's maximum mean cycle of the graph ``weight[(u, v)]``."""
    n = len(nodes)
    if not n:
        return 0.0
    neg = float("-inf")
    F = [{v: 0.0 for v in nodes}]
    for _ in range(n):
        F.append({v: max((F[-1][u] + w for (u, x), w in weight.items()
                          if x == v and F[-1][u] > neg), default=neg)
                  for v in nodes})
    best = neg
    for v in nodes:
        if F[n][v] == neg:
            continue
        best = max(best, min((F[n][v] - F[k][v]) / (n - k)
                             for k in range(n) if F[k][v] > neg))
    return best


def vis_chain_cycles(text):
    """The vis kernels' chain, in cycles, from a ``cuobjdump -sass``
    listing of the vis library, under ``SASS_LATENCY``: each terrain
    instantiation's critical cycle a step (the maximum mean cycle of its
    fast chain loop's loop-carried registers, slow-path blocks skipped,
    over the steps the unrolled loop covers: its round-down adds, two a
    step), and for
    the barebone kernel the latency of one sincosf (its heading's first
    product to the sine's and cosine's products) and of a float add.
    ``{kernel: dict}``."""
    out = {}
    for name, body in sass_functions(text).items():
        m = re.search(r"(terrain|barebone)_vis_kernel(?:ILi(\d)ELb(\d))?",
                      name)
        if not m:
            continue
        index = {a: k for k, (a, _, _, _) in enumerate(body)}
        loops = [(index[int(ops[-1], 16)], k)
                 for k, (a, _, op, ops) in enumerate(body)
                 if op.startswith("BRA") and ops
                 and int(ops[-1], 16) < a and int(ops[-1], 16) in index]
        if m.group(1) == "terrain":
            # The chain's loop: round-down adds, no barrier; the fast one
            # (no reconvergence for sincosf's slow path) before the loop
            # that steps a flagged chunk again.
            best = None
            for j, i in loops:
                hot = _hot_path(body, j, i)
                rounds = sum(op == "FADD.RM" for _, _, op, _ in hot)
                fast = not any(op.startswith("BSSY")
                               for _, _, op, _ in body[j:i + 1])
                if rounds and not any(op.startswith("BAR")
                                      for _, _, op, _ in hot):
                    if best is None or (fast, rounds) > best[:2]:
                        best = (fast, rounds, hot)
            if best is None:
                continue
            _, rounds, hot = best
            carried = sorted({r for _, g, op, ops in hot
                              for r in _defs_uses(g, op, ops)[0]})
            weight = {}
            for r in carried:
                after, _ = _dataflow(hot, {r: 0})
                for q in carried:
                    if q in after:
                        weight[(r, q)] = after[q]
            cycle = _max_cycle_mean(carried, weight)
            model = "bicycle" if m.group(2) == "1" else "unicycle"
            route = "shared" if m.group(3) == "1" else "global"
            out["terrain_vis_kernel<{}, {}>".format(model, route)] = dict(
                steps_in_loop=rounds // 2, cycles_per_loop=cycle,
                cycles_per_step=cycle / (rounds // 2))
        else:
            j, i = max(loops, key=lambda l: l[1] - l[0])
            hot = _hot_path(body, j, i)
            first = next((k for k, (_, _, op, ops) in enumerate(hot)
                          if op == "FMUL" and _TWO_OVER_PI in ops), None)
            if first is None:
                continue
            head = hot[first]
            seed = {r: _latency(head[2]) for r in _defs_uses(*head[1:])[0]}
            ready = dict(seed)
            sincos = 0
            for _, guard, op, ops in hot[first + 1:]:
                defs, uses = _defs_uses(guard, op, ops)
                dep = [ready[r] for r in uses if r in ready]
                if op == "FMUL" and dep and len(dep) < len(
                        [r for r in uses if r[0] == "R"]):
                    sincos = max(sincos, max(dep))
                if dep:
                    for r in defs:
                        ready[r] = max(ready.get(r, 0),
                                       max(dep) + _latency(op))
            out["barebone_vis_kernel"] = dict(sincos_cycles=sincos,
                                              add_cycles=_latency("FADD"))
    return out


def vis_sass_chain(lib_path):
    """``vis_chain_cycles`` of the built vis library, or None without
    cuobjdump."""
    import shutil
    import subprocess
    from pathlib import Path
    from mppi_numba_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    return vis_chain_cycles(subprocess.run(
        [tool, "-sass", str(lib_path)], check=True, capture_output=True,
        text=True).stdout)


def sm_clock_mhz_under(torch, fn):
    """The SM clock (MHz) that ``nvidia-smi --query-gpu=clocks.sm`` reads
    while ``fn`` runs back to back on the card (an idle card reads its
    idle clock)."""
    import subprocess

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
        text=True)
    t0 = time.perf_counter()
    while proc.poll() is None and time.perf_counter() - t0 < 60:
        for _ in range(20):
            fn()
    text = proc.communicate(timeout=60)[0]
    torch.cuda.synchronize()
    return float(text.split()[0])


def compare(name, got, want, fast_trig, penalties, bitwise=True, **info):
    """Hold a kernel's (K, M) costs against its plain version: bit for bit
    where ``bitwise`` (every case but the 2.7 m bicycle, where PyTorch
    divides by the wheelbase as a multiply by its reciprocal); and in any
    case rtol 1e-4 (exact trig) or 5e-3 (fast trig), on maps with penalty
    cells with at most 0.01% knife-edge entries, where an ulp moves a
    rollout across a cell edge and one step's penalty with it."""
    check(got.shape == want.shape and bool(got.isfinite().all()),
          "{}: kernel output not finite {}".format(name, tuple(want.shape)))
    differ = int((got != want).sum())
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
               outliers=outliers, outliers_allowed=allowed,
               bitwise=bitwise, entries_differing=differ)
    print(json.dumps(res), flush=True)
    check(outliers <= allowed, "{}: {} entries beyond rtol {} (allowed {})"
          .format(name, outliers, tol, allowed))
    check(not bitwise or differ == 0, "{}: {} entries differ from the plain "
          "version; bit for bit expected".format(name, differ))
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one",
              file=sys.stderr)
        return 2

    become_subreaper()
    from mppi_numba_tpu_torch._card import (card_line, time_cuda,
                                            time_cuda_graph)
    from mppi_numba_tpu_torch.models import bicycle_step, make_bicycle_step
    from mppi_numba_tpu_torch.ops.kernels import (_build, barebone_rollout,
                                                  cvar_costs, map_sample,
                                                  rollout_binned,
                                                  rollout_byte, update_useq,
                                                  vis_rollout)
    from mppi_numba_tpu_torch.ops import packing
    from mppi_numba_tpu_torch.probes import gather_probe
    from mppi_numba_tpu_torch import device_sim, sim
    from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
    from mppi_numba_tpu_torch.ops.sampling import decode_bins
    from mppi_numba_tpu_torch.profiling import chained_solve_time
    from mppi_numba_tpu_torch.solver import (get_barebone_solver,
                                             get_terrain_solver,
                                             get_terrain_vis)
    from mppi_numba_tpu_torch.types import TerrainTask, scenario

    dev = torch.device("cuda")
    kernel = rollout_byte.terrain_rollout_costs_byte
    plain = rollout_byte.terrain_rollout_costs_byte_plain
    bkernel = rollout_binned.terrain_rollout_costs_binned
    bplain = rollout_binned.terrain_rollout_costs_binned_plain
    sampler = map_sample.sample_traction_window
    splain = map_sample.sample_traction_window_plain
    fused = map_sample.sample_and_pack_window
    fplain = map_sample.sample_and_pack_window_plain
    cropper = map_sample.sample_and_pack_crop
    cplain = map_sample.sample_and_pack_crop_plain
    chains = gather_probe.CHAINS
    tail_a = cvar_costs.cvar_costs
    tail_b = update_useq.update_useq_fused
    wide_a = cvar_costs.cvar_costs_wide
    wide_b = update_useq.update_useq_wide
    coupling = cvar_costs.coupling_sums
    bb_kernel = barebone_rollout.barebone_rollout_fused
    vis_a = vis_rollout.terrain_vis_fused
    vis_b = vis_rollout.barebone_vis_fused
    counted = (kernel, bkernel, sampler, fused, cropper, tail_a, tail_b,
               wide_a, wide_b, coupling, bb_kernel, vis_a, vis_b,
               *(chain for chain, _ in chains.values()))

    def set_counts(value=0):
        for wrapper in counted:
            wrapper.launches = value
        vis_a.route_launches = dict.fromkeys(vis_a.route_launches, value)

    def read_counts():
        return {"rollout_byte": kernel.launches,
                "rollout_binned": bkernel.launches,
                "map_sample": (sampler.launches + fused.launches
                               + cropper.launches),
                "map_sample_pack": fused.launches,
                "map_sample_crop": cropper.launches,
                "map_sample_bins": sampler.launches,
                "cvar_costs": tail_a.launches,
                "update_useq": tail_b.launches,
                "cvar_costs_wide": wide_a.launches,
                "update_useq_wide": wide_b.launches,
                "cvar_coupling": coupling.launches,
                "barebone_rollout": bb_kernel.launches,
                "terrain_vis": vis_a.launches,
                "barebone_vis": vis_b.launches,
                "gather_probe": sum(c.launches for c, _ in chains.values())}

    # -- phase 1: build -------------------------------------------------------
    build_kernels(_build, ("rollout_byte", "rollout_binned", "map_sample",
                           "gather_probe", "cvar_costs", "cvar_wide",
                           "update_useq", "update_wide",
                           "barebone_rollout", "vis_rollout"))
    print_sass_counts([_build.library_path(name)
                       for name in ("rollout_byte", "rollout_binned")])
    for name, attrs in vis_rollout.kernel_attributes(0).items():
        print(json.dumps(dict(kernel=name, **attrs)))
    vis_chain = vis_sass_chain(_build.library_path("vis_rollout"))
    print(json.dumps(dict(vis_chain_cycles=vis_chain,
                          latency_model=SASS_LATENCY)))
    card = card_line()
    print(card)
    card_name, _, power_limit = card.rpartition(", ")
    tag = {"card": card_name, "power_limit": power_limit}

    def emit(metric, value, unit, **extra):
        print(json.dumps(dict(metric=metric, value=value, unit=unit,
                              **extra, **tag)), flush=True)

    # -- phase 2: kernels vs plain versions -------------------------------------
    def make_task(H, W, res, steer=3.14):
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        return TerrainTask(
            x0=f([0.3 * W * res, 0.3 * H * res, 0.785]),
            xgoal=f([0.8 * W * res, 0.8 * H * res]),
            goal_tolerance=f(0.5), v_post_rollout=f(0.01),
            lambda_weight=f(1.0), u_std=f([2.0, 3.0]), vrange=f([0.0, 3.0]),
            wrange=f([-steer, steer]), dt=f(0.1), dist_weight=f(1.0),
            obs_penalty=f(1e5), unknown_penalty=f(1e2), alpha_dyn=f(1.0),
            res=f(res), xlim0=f(0.0), ylim0=f(0.0), lin_lb=f(0.0),
            lin_ratio=f(0.01), ang_lb=f(0.0), ang_ratio=f(0.01),
            cvar_alpha=f(0.2))

    def make_controls(g, task, K, T):
        u = torch.rand((T, 2), generator=g, device=dev) * 2.0 - 0.5
        noise = torch.randn((K, T, 2), generator=g, device=dev) * task.u_std
        v, w = _clipped_controls_tk(u, noise, task.vrange, task.wrange)
        return v.contiguous(), w.contiguous()

    def make_planes(g, H, W, penalties, risk_all=False):
        """Obstacle, unknown and risk grids; with ``risk_all`` the risk
        bytes take all 256 values (H * W >= 256)."""
        i8 = torch.int8
        p = 0.1 if penalties else 0.0
        obs = (torch.rand((H, W), generator=g, device=dev) < p).to(i8)
        unk = (torch.rand((H, W), generator=g, device=dev) < p).to(i8)
        if risk_all:
            risk = (torch.randperm(H * W, generator=g, device=dev) % 256
                    - 128).to(i8).reshape(H, W)
        else:
            risk = torch.randint(1, 101, (H, W), generator=g, device=dev,
                                 dtype=i8)
        return obs, unk, risk

    def make_case(K, M, T, H, W, res, penalties, speed_map, seed,
                  steer=3.14, risk_all=False):
        g = torch.Generator(device=dev).manual_seed(seed)
        i8 = torch.int8
        lin = torch.randint(0, 101, (M, H, W), generator=g, device=dev, dtype=i8)
        ang = torch.randint(0, 101, (M, H, W), generator=g, device=dev, dtype=i8)
        obs, unk, risk = make_planes(g, H, W, penalties, risk_all)
        words = packing.pack_map_words(lin, ang, obs, unk,
                                       risk if speed_map else None)
        task = make_task(H, W, res, steer)
        return (words, rollout_byte.build_task_vec(task),
                *make_controls(g, task, K, T))

    def make_binned_case(K, M, T, H, W, res, cell_bits, bins, penalties,
                         speed_map, seed, past_last, steer=3.14,
                         risk_all=False):
        """Binned inputs and the byte words of the same decoded grids:
        ``(binned args, byte args)``.  Bin draws reach one past the last
        bin when ``past_last`` (a column summing below 100).  The risk
        plane holds the risk grid's bytes as they are (all 256 values with
        ``risk_all``)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        hi = bins + 1 if past_last else bins
        lin_b, ang_b = (torch.randint(0, hi, (M, H, W), generator=g,
                                      device=dev, dtype=torch.int32)
                        for _ in range(2))
        qbins = torch.sort(torch.randperm(101, generator=g, device=dev)
                           [:bins]).values.to(torch.int8)
        obs, unk, risk = make_planes(g, H, W, penalties, risk_all)
        task = make_task(H, W, res, steer)
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
        riskw = None
        if speed_map:
            flat = risk.reshape(-1)
            riskw = torch.cat([flat, flat.new_zeros(-flat.numel() % 4)]
                              ).view(torch.int32)
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
        # The examples' byte-route shapes (phase 7): terrain_planning's
        # det and speed at M = 1 on its 11x11 map, and planner_animation's
        # 8x14 worlds (tdm, det, speed; T = 80) and 14x8 example world.
        ("terrain_det_11x11_M1", 1024, 1, 100, 11, 11, 1.0, True, True,
         False),
        ("terrain_speed_11x11_M1", 1024, 1, 100, 11, 11, 1.0, True, True,
         True),
        ("animation_tdm_8x14", 1024, 1024, 80, 8, 14, 1.0, True, True,
         False),
        ("animation_det_8x14_M1", 1024, 1, 80, 8, 14, 1.0, True, True, False),
        ("animation_speed_8x14_M1", 1024, 1, 80, 8, 14, 1.0, True, True,
         True),
        ("animation_example_14x8", 1024, 1024, 100, 14, 8, 1.0, True, True,
         False),
        # PARITY.md's large-map row: 52x52, fast trig.
        ("parity_large_map_52x52", 256, 32, 30, 52, 52, 0.5, True, False,
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
            map="{}x{}".format(H, W), speed_map=sm,
            tiling=rollout_byte.kernel_tiling(speed_map=sm, fast_trig=ft)))
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
        # The examples' shapes (phase 7): external PMF at K = 2048 / M =
        # 512, the costmap's M = 1 speed map, the confidence map.
        ("crumb_32x42_external_pmf", 2048, 512, 80, 32, 42, 0.5, 2, 4, True,
         True, False),
        ("crumb_26x32_costmap_speed_map", 1024, 1, 40, 26, 32, 0.5, 2, 2,
         True, True, True),
        ("crumb_62x42_confidence", 1024, 64, 60, 62, 42, 0.5, 2, 4, True,
         True, False),
        # PARITY.md's rows this list lacked: bin-roi (85x85, 4-bit, 12
        # bins), bin-smooth-ft (one bin, fast trig), crumb-250 (2-bit, M
        # = 256), crumb-speed-250 and bin-speed-250 (M = 1 on 250x250),
        # and the ragged 13x15 small maps on 2-, 4- and 8-bit cells.
        ("parity_bin_roi_85x85", 1024, 256, 50, 85, 85, 0.5, 4, 12, False,
         True, False),
        ("parity_bin_smooth_ft_85x85", 512, 64, 50, 85, 85, 0.5, 4, 1, True,
         False, False),
        ("parity_crumb_250x250", 512, 256, 50, 250, 250, 0.25, 2, 4, False,
         True, False),
        ("parity_crumb_speed_250x250", 1024, 1, 60, 250, 250, 0.25, 2, 4,
         False, True, True),
        ("parity_bin_speed_250x250", 1024, 1, 60, 250, 250, 0.25, 4, 12,
         False, True, True),
        ("parity_crumb_small_13x15", 256, 64, 40, 13, 15, 1.0, 2, 4, False,
         True, False),
        ("parity_bin_small_13x15", 256, 64, 40, 13, 15, 1.0, 4, 12, False,
         True, False),
        ("parity_byte2_small_13x15", 256, 64, 40, 13, 15, 1.0, 8, 22, False,
         True, False),
        ("parity_bin_speed_small_13x15", 512, 1, 40, 13, 15, 1.0, 4, 12,
         False, True, True),
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
            map="{}x{}".format(H, W), cell_bits=cb, bins=B, speed_map=sm,
            tiling=rollout_binned.kernel_tiling(cell_bits=cb, speed_map=sm,
                                                fast_trig=ft)))
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

    # The bicycle model on every layout, exact trig, at the forest's shape
    # with its penalty cells: tdm and speed_map at the default wheelbase,
    # and tdm at a car's.
    layouts = ((None, 12), (2, 4), (4, 12), (8, 22))
    car_step = make_bicycle_step(CAR_WHEELBASE)
    bicycle_results = {"rollout_byte": [], "rollout_binned": []}
    for seed, (cb, B, sm, step) in enumerate(
            [(cb, B, sm, bicycle_step) for cb, B in layouts
             for sm in (False, True)]
            + [(cb, B, False, car_step) for cb, B in layouts], start=400):
        K, M, T, H, W, res = 1024, 64, 100, 140, 84, 0.5
        if cb is None:
            args = make_case(K, M, T, H, W, res, True, sm, seed, steer=STEER)
            kw = dict(H=H, W=W, T=T, speed_map=sm, step_fn=step)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            name, which = "bicycle_byte", "rollout_byte"
            tiling = rollout_byte.kernel_tiling(speed_map=sm, step_fn=step)
        else:
            args, _ = make_binned_case(K, M, T, H, W, res, cb, B, True, sm,
                                       seed, past_last=True, steer=STEER)
            kw = dict(H=H, W=W, T=T, cell_bits=cb, step_fn=step)
            got, want = bkernel(*args, **kw), bplain(*args, **kw)
            name, which = "bicycle_{}bit".format(cb), "rollout_binned"
            tiling = rollout_binned.kernel_tiling(cell_bits=cb, speed_map=sm,
                                                  step_fn=step)
        torch.cuda.synchronize()
        wheelbase = step.kernel_model[1]
        if wheelbase != WHEELBASE:
            name += "_L{}".format(wheelbase)
        bicycle_results[which].append(compare(
            name + ("_speed_map" if sm else ""), got, want, False, True,
            bitwise=wheelbase == WHEELBASE, K=K, M=M, T=T,
            map="{}x{}".format(H, W), cell_bits=cb, bins=B, speed_map=sm,
            model="bicycle", steer=STEER, wheelbase=wheelbase,
            tiling=tiling))
        del args, got, want

    # Edge cases, each bit for bit against its plain version, each row with
    # its instantiation's tiling: T across the loop's remainders in every
    # model; ragged M (the bicycle's two samples a thread) and K; det_dyn's
    # launch (4-bit cells, 140x84, M = 1) at T = 33; a NaN cell coordinate
    # (NaN inv_res), which lands in cell 0, held against the plain version
    # on maps whose every cell is cell 0; and speed maps on 16 x 16 cells
    # whose risk bytes take all 256 values.
    models = {"fast": (True, None), "exact": (False, None),
              "bicycle": (False, bicycle_step)}
    cell_mask = {2: 0xF, 4: 0xFF, 8: 0xFFFF}
    cell_repeat = {2: 0x11111111, 4: 0x01010101, 8: 0x00010001}

    def repeat_first(words, low, repeat):
        """Every word of each row made of the row's first cell."""
        first = words[..., :1].to(torch.int64) & low
        return (first * repeat).expand(words.shape).to(torch.int32) \
            .contiguous()

    def edge_case(name, layout, model, K, M, T, H, W, res, B, sm, seed,
                  nan_cell=False, risk_all=False):
        ft, step = models[model]
        steer = STEER if step is not None else 3.14
        if layout == "byte":
            args = make_case(K, M, T, H, W, res, True, sm, seed, steer=steer,
                             risk_all=risk_all)
            kw = dict(H=H, W=W, T=T, speed_map=sm, fast_trig=ft, step_fn=step)
            fn, pfn, tv_at = kernel, plain, 1
            tiling = rollout_byte.kernel_tiling(speed_map=sm, fast_trig=ft,
                                                step_fn=step)
            uniform = [args[0][:, :1, :1].expand_as(args[0]).contiguous(),
                       *args[1:]]
        else:
            args, _ = make_binned_case(K, M, T, H, W, res, layout, B, True,
                                       sm, seed, past_last=True, steer=steer,
                                       risk_all=risk_all)
            kw = dict(H=H, W=W, T=T, cell_bits=layout, fast_trig=ft,
                      step_fn=step)
            fn, pfn, tv_at = bkernel, bplain, 3
            tiling = rollout_binned.kernel_tiling(
                cell_bits=layout, speed_map=sm, fast_trig=ft, step_fn=step)
            cells, mask, lut, tv, v, w, riskw = args
            uniform = [repeat_first(cells, cell_mask[layout],
                                    cell_repeat[layout]),
                       repeat_first(mask[None], 3, 0x55555555)[0], lut, tv,
                       v, w, None if riskw is None
                       else repeat_first(riskw[None], 0xFF, 0x01010101)[0]]
        want = pfn(*(uniform if nan_cell else args), **kw)
        if nan_cell:
            args = list(args)
            args[tv_at] = args[tv_at].clone()
            args[tv_at][11] = float("nan")
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        return compare(name, got, want, ft, True, K=K, M=M, T=T,
                       map="{}x{}".format(H, W), layout=layout, model=model,
                       bins=B, speed_map=sm, nan_cell=nan_cell,
                       risk_all=risk_all, tiling=tiling)

    edges = []
    for T in (1, 33, 47, 99, 100):
        for model in models:
            edges += [("T{}_{}_byte".format(T, model), "byte", model, 1000,
                       3, T, 140, 84, 0.5, 12, False, {}),
                      ("T{}_{}_4bit".format(T, model), 4, model, 1024, 3, T,
                       140, 84, 0.5, 12, False, {})]
    for M in (1, 3, 1023):
        for K in (1000, 1024):
            for layout, B in (("byte", 12), (2, 4)):
                edges.append(("M{}_K{}_bicycle_{}".format(M, K, layout),
                              layout, "bicycle", K, M, 20, 140, 84, 0.5, B,
                              False, {}))
    edges.append(("det_dyn_4bit_M1_T33", 4, "fast", 1024, 1, 33, 140, 84,
                  0.5, 9, False, {}))
    for layout, B, model in (("byte", 12, "fast"), ("byte", 12, "exact"),
                             ("byte", 12, "bicycle"), (4, 12, "exact"),
                             (8, 22, "fast")):
        edges.append(("nan_cell_{}_{}".format(model, layout), layout, model,
                      1024, 3, 50, 140, 84, 0.5, B, True,
                      {"nan_cell": True}))
    for layout, B, model in (("byte", 12, "fast"), ("byte", 12, "exact"),
                             (2, 4, "fast"), (4, 12, "bicycle"),
                             (8, 22, "exact")):
        edges.append(("risk256_{}_{}".format(model, layout), layout, model,
                      1024, 2, 100, 16, 16, 1.0, B, True, {"risk_all": True}))
    edge_results = [edge_case(name, *rest, seed, **opt) for seed, (
        name, *rest, opt) in enumerate(edges, start=600)]

    # The map-sampling kernel against its plain version: bins and grids,
    # bit for bit.  The first rows are the main paths' shapes (world (b)'s
    # whole 250x250 map, world (c)'s 140x84 map, the big-map world's 85x85
    # window of 250x250, a det mode's M = 1).
    sample_cases = [
        # name, M, (H, W), (oy, ox, rH, rW), B_lin, B_ang, alpha_dyn,
        # unnormalized, m_offset
        ("main_path_250x250_22bins", 1024, (250, 250), (0, 0, 250, 250),
         22, 22, 1.0, False, 0),
        ("main_path_140x84_12bins", 1024, (140, 84), (0, 0, 140, 84), 12, 12,
         1.0, False, 0),
        ("main_path_85x85_of_250x250", 1024, (250, 250), (70, 101, 85, 85),
         12, 12, 1.0, False, 0),
        ("det_140x84_M1", 1, (140, 84), (0, 0, 140, 84), 9, 9, 1.0, False,
         0),
        ("window_interior_alpha0.2", 256, (140, 84), (31, 17, 85, 50), 12,
         12, 0.2, False, 0),
        ("window_corner", 256, (140, 84), (55, 0, 85, 84), 22, 22, 1.0,
         False, 0),
        ("window_far_corner", 64, (250, 250), (165, 165, 85, 85), 4, 4, 0.2,
         False, 0),
        ("m_offset_384", 128, (140, 84), (20, 10, 85, 60), 12, 12, 1.0, False,
         384),
        ("bins_1_and_2", 128, (60, 70), (0, 0, 60, 70), 1, 2, 1.0, False, 0),
        ("bins_4_and_22_alpha0.2", 128, (60, 70), (5, 6, 33, 41), 4, 22, 0.2,
         False, 0),
        ("unnormalized_12bins", 256, (60, 70), (0, 0, 60, 70), 12, 12, 1.0,
         True, 0),
        ("unnormalized_2bins_alpha0.2", 64, (60, 70), (9, 13, 40, 40), 2, 2,
         0.2, True, 0),
        ("M1_window", 1, (250, 250), (100, 90, 85, 85), 12, 22, 1.0, False,
         0),
        ("main_path_11x11_22bins", 1024, (11, 11), (0, 0, 11, 11), 22, 22,
         1.0, False, 0),
        # PARITY.md's small cases: 13x15 maps, ragged in every layout.
        ("ragged_13x15_4bins", 64, (13, 15), (0, 0, 13, 15), 4, 4, 1.0,
         True, 0),
        ("ragged_13x15_12bins", 64, (13, 15), (0, 0, 13, 15), 12, 12, 1.0,
         True, 0),
        ("ragged_13x15_22bins", 64, (13, 15), (0, 0, 13, 15), 22, 22, 0.2,
         False, 0),
        ("ragged_13x15_M1", 1, (13, 15), (0, 0, 13, 15), 12, 12, 1.0, True,
         0),
        # Columns of random int8 of any sign (and bin values of any sign),
        # 255 bins a plane (the tables' and LUTs' limit), alpha_dyn outside
        # (0, 1] (`sampled` outside 0..100: the kernel's loop rank beside
        # its tables), and blocks of a few map samples (M = 1, 3, 4).
        ("signed_22bins", 128, (60, 70), (9, 13, 40, 40), 22, 22, 1.0,
         "signed", 0),
        ("cold_alpha1.5_signed", 64, (60, 70), (5, 6, 33, 41), 12, 22, 1.5,
         "signed", 0),
        ("cold_alpha-0.7_signed", 64, (60, 70), (0, 0, 60, 70), 22, 4, -0.7,
         "signed", 0),
        ("bins_255_signed", 32, (40, 50), (3, 4, 30, 40), 255, 255, 1.0,
         "signed", 0),
        ("bins_255_and_3_alpha1.5", 40, (40, 50), (0, 0, 40, 50), 255, 3,
         1.5, "signed", 0),
        ("bins_255_normalized", 64, (40, 50), (0, 0, 40, 50), 255, 255, 1.0,
         False, 0),
        ("M1_signed_alpha1.5", 1, (60, 70), (5, 6, 33, 41), 22, 12, 1.5,
         "signed", 0),
        ("M3_bins_255_signed", 3, (40, 50), (3, 4, 30, 40), 255, 255, 1.0,
         "signed", 0),
        ("M4_signed_alpha-0.7", 4, (60, 70), (0, 0, 60, 70), 12, 12, -0.7,
         "signed", 0),
        # The examples' maps and support-compacted bins (phase 7); the
        # fused check's random planes hold unknown cells.
        ("terrain_11x11_21bins", 1024, (11, 11), (0, 0, 11, 11), 21, 21, 1.0,
         False, 0),
        ("terrain_det_11x11_M1_3bins", 1, (11, 11), (0, 0, 11, 11), 3, 3,
         0.2, False, 0),
        ("terrain_speed_11x11_M1_2bins", 1, (11, 11), (0, 0, 11, 11), 2, 2,
         0.2, False, 0),
        ("external_pmf_32x42_4bins", 512, (32, 42), (0, 0, 32, 42), 4, 4,
         1.0, False, 0),
        ("costmap_26x32_M1_2bins", 1, (26, 32), (0, 0, 26, 32), 2, 2, 1.0,
         False, 0),
        ("confidence_62x42_4bins", 64, (62, 42), (0, 0, 62, 42), 4, 4, 1.0,
         False, 0),
        ("animation_8x14_21bins", 1024, (8, 14), (0, 0, 8, 14), 21, 21, 1.0,
         False, 0),
        ("animation_det_8x14_M1_3bins", 1, (8, 14), (0, 0, 8, 14), 3, 3,
         0.2, False, 0),
        ("animation_speed_8x14_M1_2bins", 1, (8, 14), (0, 0, 8, 14), 2, 2,
         0.2, False, 0),
        ("animation_example_14x8_21bins", 1024, (14, 8), (0, 0, 14, 8), 21,
         21, 1.0, False, 0),
    ]
    # The shapes each timed world's solve gives the fused kernel, and its
    # layout there (det_140x84_M1: world (d)'s M = 1).
    fused_timed_at = {"main_path_250x250_22bins": "binned8",
                      "main_path_140x84_12bins": "binned",
                      "main_path_85x85_of_250x250": "binned",
                      "main_path_11x11_22bins": "byte",
                      "det_140x84_M1": "binned"}
    fused_results, fused_timed_args = [], {}
    sample_results = []
    for seed, (name, M, hw, win, bl, ba, alpha, unnorm, m_off) in enumerate(
            sample_cases, start=700):
        args, kw = make_sample_case(torch, dev, M, hw, win, bl, ba, alpha,
                                    unnorm, m_off, seed)
        got = sampler(*args, **kw)
        want = splain(*args, **kw)
        torch.cuda.synchronize()
        differ = [int((g != w).sum()) for g, w in zip(got, want)]
        res = dict(case=name, M=M, map="{}x{}".format(*hw),
                   window=list(win), bins=[bl, ba], alpha_dyn=alpha,
                   unnormalized=unnorm, m_offset=m_off,
                   entries_differing=differ,
                   max_abs_err=max(float((g.to(torch.int64)
                                          - w.to(torch.int64)).abs().max())
                                   for g, w in zip(got, want)),
                   fill_decodes=int((got[2] == -128).sum()
                                    + (got[3] == -128).sum()))
        print(json.dumps(res), flush=True)
        check(all(g.dtype == w.dtype and g.shape == w.shape
                  for g, w in zip(got, want)) and not any(differ),
              "map_sample {}: {} entries differ from the plain version"
              .format(name, differ))
        check(unnorm is not True or alpha != 1.0 or res["fill_decodes"] > 0,
              "map_sample {}: no draw past the last bin".format(name))
        sample_results.append(res)
        del got, want
        maps = fused_case_maps(torch, args, seed)
        fused_results.append(check_fused_case(torch, fused, fplain, name,
                                              args, kw, maps))
        if name in fused_timed_at:
            fused_timed_args[name] = (args, kw, maps, fused_timed_at[name],
                                      M, win[2], win[3], bl, ba)
        del args, maps
    check_known_uniforms(torch, dev, sampler)

    # The crop mode against its plain version (crop_window_plain, then
    # sample_and_pack_window_plain at the window): payload, grids, offset
    # and shifted limits bit for bit, in every layout, with and without the
    # risk plane, at the big-map world's shape (M = 1024 in its layout,
    # 4-bit cells; fewer map samples in the others) with its padded origin
    # at 0 and at -res, the robot near each edge of the map, at its centre,
    # on a cell edge, an ulp either side and off the map; and at a ragged
    # shape with the robot at every cell edge of a row, an ulp either side
    # and off the map.
    crop_results = []
    crop_timed_args = None
    for seed, (name, H, W, rH, rW, bl, ba, res, lim0, Ms, scan) in enumerate([
            ("main_path_85x85_of_250x250", 250, 250, 85, 85, BIGMAP_BINS,
             BIGMAP_BINS, BIGMAP_RES, 0.0, {"binned": 1024}, False),
            ("origin_minus_res_85x85", 250, 250, 85, 85, BIGMAP_BINS,
             BIGMAP_BINS, BIGMAP_RES, -BIGMAP_RES, {"binned": 1024}, False),
            ("ragged_13x11_of_64x48", 64, 48, 13, 11, 6, 22, 0.3, -1.3, {},
             True)], start=750):
        res_crop = check_crop_mode(torch, dev, cropper, cplain, name, H, W,
                                   rH, rW, bl, ba, res, lim0, Ms, scan, seed)
        crop_results.append(res_crop)
        timed = res_crop.pop("timed_args")
        if name == "main_path_85x85_of_250x250":
            crop_timed_args = timed
    # The crop mode's M slices, as the sharded solve draws them: rows [a,
    # b) of an M-row draw at m_offset = a (world (k)'s rank at (k, m) = (0,
    # 1) of a (1, 2, 2) mesh; a ragged slice), against the plain version
    # and against the rows of the kernel's whole draw, bit for bit.
    for seed, (name, H, W, rH, rW, bins, res, lim0, M, a, b) in enumerate([
            ("m_slice_85x85_of_250x250", 250, 250, 85, 85, BIGMAP_BINS,
             BIGMAP_RES, 0.0, 1024, 512, 768),
            ("m_slice_13x11_of_64x48", 64, 48, 13, 11, 6, 0.3, -1.3, 8, 3,
             7)], start=780):
        crop_results.append(check_crop_m_slices(
            torch, dev, cropper, cplain, name, H, W, rH, rW, bins, res, lim0,
            M, a, b, seed))

    # The scenario axis: SCENARIOS scenarios (their own keys, alpha_dyn,
    # windows, robots, maps, tasks and controls) in one launch of each
    # kernel, against the single launches and the batched plain version,
    # bit for bit.
    scenario_results = {"map_sample": [], "rollout_byte": [],
                        "rollout_binned": []}
    for seed, (name, M, hw, rwin, bins, layouts) in enumerate([
            ("31x37_window_13x11", 16, (31, 37), (13, 11), 12,
             FUSED_LAYOUTS[:1] + FUSED_LAYOUTS[2:]),
            ("31x37_window_13x11_4bins", 16, (31, 37), (13, 11), 4,
             FUSED_LAYOUTS),
            ("11x11_M1", 1, (11, 11), (11, 11), 22, ("byte",))],
            start=800):
        scenario_results["map_sample"].append(check_scenario_sampling(
            torch, dev, sampler, splain, fused, fplain, name,
            scenario_sample_cases(torch, dev, M, hw, rwin, bins, 10 * seed),
            layouts))
    for seed, (name, H, W, rH, rW, bins, res, lim0, M) in enumerate([
            ("13x11_of_64x48", 64, 48, 13, 11, 4, 0.3, -1.3, 5),
            ("85x85_of_250x250", 250, 250, 85, 85, 4, BIGMAP_RES, 0.0, 8)],
            start=850):
        scenario_results["map_sample"].append(check_scenario_crop(
            torch, dev, cropper, cplain, name, H, W, rH, rW, bins, res, lim0,
            M, 10 * seed))

    def vary_task(tv, b):
        """Scenario b's task vector: x0, the goal, dt and the origin
        moved."""
        tv = tv.clone()
        tv[0] += 0.25 * b
        tv[3] -= 0.5 * b
        tv[7] += 0.01 * b
        tv[12] -= 0.1 * b
        return tv

    for seed, (layout, bins, model, sm) in enumerate(
            [(layout, bins, model, sm)
             for layout, bins in (("byte", 12), (2, 4), (4, 12), (8, 22))
             for model in ("fast", "exact", "bicycle")
             for sm in (False, True)], start=900):
        K, M, T, H, W, res = 1024, 4, 60, 21, 30, 0.5
        ft, step = models[model]
        steer = STEER if step is not None else 3.14
        if layout == "byte":
            parts = [make_case(K, M, T, H, W, res, True, sm, 37 * seed + b,
                               steer=steer) for b in range(SCENARIOS)]
            parts = [(p[0], vary_task(p[1], b), *p[2:])
                     for b, p in enumerate(parts)]
            fn, pfn, which = kernel, plain, "rollout_byte"
            kw = dict(H=H, W=W, T=T, speed_map=sm, fast_trig=ft,
                      step_fn=step)
        else:
            parts = [make_binned_case(K, M, T, H, W, res, layout, bins, True,
                                      sm, 37 * seed + b, past_last=True,
                                      steer=steer)[0]
                     for b in range(SCENARIOS)]
            parts = [(*p[:3], vary_task(p[3], b), *p[4:])
                     for b, p in enumerate(parts)]
            fn, pfn, which = bkernel, bplain, "rollout_binned"
            kw = dict(H=H, W=W, T=T, cell_bits=layout, fast_trig=ft,
                      step_fn=step)
        single = torch.stack([fn(*q, **kw) for q in parts])
        args = stack_scenarios(torch, parts)
        got = fn(*args, **kw)
        want = pfn(*args, **kw)
        torch.cuda.synchronize()
        scenario_results[which].append(compare(
            "scenarios_{}_{}{}".format(layout, model,
                                       "_speed_map" if sm else ""),
            got, want, ft, True, K=K, M=M, T=T, scenarios=SCENARIOS,
            map="{}x{}".format(H, W), layout=layout, model=model,
            speed_map=sm, single_launches_differing=int(
                (got != single).sum())))
        check(torch.equal(got, single), "rollout scenarios {} {}: the "
              "batched launch differs from the single launches".format(
                  layout, model))
        del parts, args, got, want, single

    # One case at the sweep's shape: 30 episodes of the benchmark sweep
    # (11x11 padded maps, 22 bins, M = K = 1024, T = 100, fast trig), the
    # map draw in the byte layout and the byte rollout, each batched
    # against the 30 single launches and the batched plain version.
    sweep_static, sweep_maps, sweep_task, _ = sweep_chunk("noisy_dyn",
                                                          SWEEP_CHUNK)
    B, M = SWEEP_CHUNK, sweep_static.num_grid_samples
    K, T = sweep_static.num_control_rollouts, sweep_static.num_steps
    H, W = sweep_static.map_shape
    g = torch.Generator(device=dev).manual_seed(31)
    sweep_keys = torch.randint(0, 2 ** 32, (B, 2), generator=g, device=dev)
    got = fused(sweep_keys, sweep_maps, sweep_task.alpha_dyn, M, "byte")
    want = fplain(sweep_keys, sweep_maps, sweep_task.alpha_dyn, M, "byte")
    single = stack_scenarios(torch, [
        fused(sweep_keys[b], scenario(sweep_maps, b),
              sweep_task.alpha_dyn[b], M, "byte") for b in range(B)])
    torch.cuda.synchronize()
    differ = [bits_differing(torch, got, want),
              bits_differing(torch, got, single)]
    print(json.dumps(dict(case="map_sample_scenarios_sweep_shape",
                          scenarios=B, M=M, map="{}x{}".format(H, W),
                          layout="byte",
                          entries_differing_plain_single=differ)), flush=True)
    check(not any(differ), "map_sample at the sweep's shape: {}".format(
        differ))
    sweep_words = got[0]
    u_sweep = torch.rand((B, T, 2), generator=g, device=dev) * 2.0 - 0.5
    noise = (torch.randn((B, K, T, 2), generator=g, device=dev)
             * sweep_task.u_std[:, None, None, :])
    v_all, w_all = (x.contiguous() for x in _clipped_controls_tk(
        u_sweep, noise, sweep_task.vrange, sweep_task.wrange))
    sweep_tv = rollout_byte.build_task_vec(sweep_task)
    sweep_kw = dict(H=H, W=W, T=T, fast_trig=sweep_static.fast_trig)
    got = kernel(sweep_words, sweep_tv, v_all, w_all, **sweep_kw)
    want = plain(sweep_words, sweep_tv, v_all, w_all, **sweep_kw)
    single = torch.stack([kernel(sweep_words[b], sweep_tv[b], v_all[b],
                                 w_all[b], **sweep_kw) for b in range(B)])
    torch.cuda.synchronize()
    scenario_results["rollout_byte"].append(compare(
        "scenarios_sweep_shape", got, want, sweep_static.fast_trig, True,
        K=K, M=M, T=T, scenarios=B, map="{}x{}".format(H, W),
        single_launches_differing=int((got != single).sum())))
    check(torch.equal(got, single), "rollout at the sweep's shape: the "
          "batched launch differs from the single launches")
    sweep_timed_args = dict(keys=sweep_keys, maps=sweep_maps,
                            task=sweep_task, M=M, words=sweep_words,
                            tv=sweep_tv, v=v_all, w=w_all, kw=sweep_kw)
    del got, want, single, noise

    # The skip mask at the sweep's shape (the byte kernel, B = 30) and at
    # the fleet's (binned8, 16 windows of 65x65): none, some and all of
    # the scenarios skipped, bit for bit against the masked plain version.
    fH, fW = FLEET_WINDOW
    fleet = [make_binned_case(K, M, T, fH, fW, 1.0, 8, 22, True, False,
                              1000 + b, past_last=False)[0]
             for b in range(FLEET_ROBOTS)]
    fleet = stack_scenarios(torch, [(*p[:3], vary_task(p[3], b), *p[4:])
                                    for b, p in enumerate(fleet)])
    skip_results = check_skip_masks(torch, dev, [
        ("sweep_shape_byte", kernel, plain,
         (sweep_words, sweep_tv, v_all, w_all), sweep_kw),
        ("fleet_shape_binned8", bkernel, bplain, fleet,
         dict(H=fH, W=fW, T=T, cell_bits=8, fast_trig=True))])
    del fleet

    small_solve_witness(torch, dev, plain)

    # The solve's tail at every path's shape: the CVaR plus coupling
    # kernel and the update kernel, each against its plain version bit for
    # bit (and the static count against the same count from alpha).
    tail_results = check_tail_cases(torch, dev)
    lifted_edge_results = check_lifted_tail_edges(torch, dev)

    # The barebone rollout kernel against the plain loop, and the wide
    # update against its plain version, bit for bit, at their edges.
    barebone_results = check_barebone_cases(torch, dev)
    wide_update_results = check_wide_update_cases(torch, dev)

    # Both vis kernels against their plain versions, bit for bit (the
    # 2.7 m bicycle too), in every mode, model and crop, on grids
    # with -128 draws, at V's edges.
    vis_results = check_vis_cases(torch, dev)

    # Launches past what one grid holds: 65,539 scenarios and 70,000 map
    # samples, each in chunks, bit for bit with the chunks' own calls and
    # the plain versions.
    chunk_results = check_launch_chunks(torch, dev, make_task,
                                        make_case, make_binned_case)

    # -- phase 3: the main paths ------------------------------------------------
    planner_runs = {}
    set_counts(0)
    totals = dict.fromkeys(read_counts(), 0)
    vis_routes = dict.fromkeys(vis_a.route_launches, 0)
    for world, (_, want_backend) in WORLDS.items():
        torch.cuda.reset_peak_memory_stats()
        set_counts(0)
        run = run_planner(world)
        launches = read_counts()
        run["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        backend = get_terrain_solver(run["static"], dev).backend
        expect = (want_backend or
                  ("binned2" if run["static"].num_pmf_bins <= 4 else "binned"))
        check(backend == expect, "{}: routed to {}, expected {}".format(
            world, backend, expect))
        used = "rollout_byte" if backend == "byte" else "rollout_binned"
        other = "rollout_binned" if used == "rollout_byte" else "rollout_byte"
        crops = run["solves"] if run["static"].roi_shape else 0
        check(launches[used] == run["solves"] * run["num_opt"]
              and launches["map_sample_pack"] == run["solves"] - crops
              and launches["map_sample_crop"] == crops
              and launches["map_sample_bins"] == run["sample_grids_calls"]
              and launches["cvar_costs"] == launches["update_useq"]
              == launches[used]
              and launches["terrain_vis"] == 1
              and vis_a.route_launches == {"shared": 1, "global": 0}
              and launches[other] == launches["gather_probe"]
              == launches["barebone_vis"] == 0,
              "{}: launches {} for {} solves on {}".format(
                  world, launches, run["solves"], backend))
        for k in totals:
            totals[k] += launches[k]
        for k in vis_routes:
            vis_routes[k] += vis_a.route_launches[k]
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
                              goal_dist_end=run["dist_end"],
                              model=run["static"].model,
                              roi_shape=run["static"].roi_shape,
                              state_rollout_shape=run["vis_shape"],
                              **run.get("trial", {}))))
        if world not in TIMED_WORLDS + VIS_TIMED_WORLDS:
            del run["planner"]
    a = planner_runs["flagship_11x11"]
    check(a["dist_end"] < a["dist0"], "flagship: goal distance did not shrink")

    # The big-map world cropped against uncropped, the same seed, its padded
    # origin at 0: the same controls bit for bit, the cropped grids the
    # window of the uncropped.
    set_counts(0)
    roi_check = bigmap_crop_equals_full(torch, CROP_CHECK_SOLVES)
    launches = read_counts()
    check(launches["rollout_binned"] == 2 * CROP_CHECK_SOLVES
          == launches["cvar_costs"] == launches["update_useq"]
          and launches["map_sample_pack"] == launches["map_sample_crop"]
          == CROP_CHECK_SOLVES and launches["map_sample_bins"] == 0
          and launches["rollout_byte"] == launches["gather_probe"] == 0,
          "big map cropped vs uncropped: launches {}".format(launches))
    for k in totals:
        totals[k] += launches[k]
    print(json.dumps(dict(roi_check, kernel_launches=launches)), flush=True)

    # The same at the padded origin -res, the layout of a TDM whose limits
    # start at 0: the grids and the offsets exact, the controls within the
    # whole-solve tolerance (a rollout on a cell edge in one frame may not
    # be on it in the other).
    set_counts(0)
    roi_check = bigmap_crop_at_default_origin(torch, CROP_CHECK_SOLVES)
    launches = read_counts()
    check(launches["rollout_binned"] == 2 * CROP_CHECK_SOLVES
          == launches["cvar_costs"] == launches["update_useq"]
          and launches["map_sample_pack"] == launches["map_sample_crop"]
          == CROP_CHECK_SOLVES and launches["map_sample_bins"] == 0
          and launches["rollout_byte"] == launches["gather_probe"] == 0,
          "big map at origin -res: launches {}".format(launches))
    for k in totals:
        totals[k] += launches[k]
    print(json.dumps(dict(roi_check, kernel_launches=launches)), flush=True)

    # The barebone planner: its rollout kernel, then the solve's tail
    # kernels on its (K, 1) costs, once an iteration; a replay is a few
    # kernels (the draw, its scaling and the three kernels).
    set_counts(0)
    barebone = run_barebone()
    launches = read_counts()
    tail = barebone["solves"] * barebone["num_opt"]
    check(launches["cvar_costs"] == launches["update_useq"]
          == launches["barebone_rollout"] == tail
          and launches["barebone_vis"] == 1
          and not any(n for k, n in launches.items()
                      if k not in ("cvar_costs", "update_useq",
                                   "barebone_rollout", "barebone_vis")),
          "barebone: launched {}".format(launches))
    check(barebone["kernel_nodes"] <= BAREBONE_MAX_NODES,
          "barebone: {} kernels a replay".format(barebone["kernel_nodes"]))
    for k in totals:
        totals[k] += launches[k]
    emit("barebone_solve_host_ms_median", barebone["solve_ms_median"], "ms",
         first_solve_ms=barebone["solve_ms_first"], solves=barebone["solves"],
         K=barebone["K"], T=barebone["T"], kernel_launches=launches,
         goal_dist_start=barebone["dist0"], goal_dist_end=barebone["dist_end"],
         state_rollout_shape=barebone["vis_shape"],
         graph_equals_eager=barebone["graph_equals_eager"],
         kernels_per_replay=barebone["kernel_nodes"],
         vis_kernels_per_replay=barebone["vis_kernel_nodes"])
    check(barebone["dist_end"] < barebone["dist0"],
          "barebone: goal distance did not shrink")

    # One episode of the big-map world through the device simulator: one
    # CUDA graph a step (solve, simulation, shift), no host read inside a
    # chunk of steps; held bit for bit against its eager loop.
    set_counts(0)
    device_trial = run_device_trial(torch, DEVICE_TRIAL_STEPS)
    launches = read_counts()
    replays = launches["map_sample_crop"]
    check(launches["rollout_binned"] == replays * device_trial["num_opt"]
          == launches["cvar_costs"] == launches["update_useq"]
          and device_trial["steps"] <= replays
          < device_trial["steps"] + device_trial["chunk_steps"]
          and launches["map_sample_pack"] == launches["map_sample_bins"]
          == launches["rollout_byte"] == launches["gather_probe"] == 0,
          "device trial: launches {} for {} steps".format(
              launches, device_trial["steps"]))
    for k in totals:
        totals[k] += launches[k]
    print(json.dumps(dict({k: v for k, v in device_trial.items()
                           if k != "timed_args"}, kernel_launches=launches)),
          flush=True)

    # The gather probe's entry point: every (mode, S, R), each checked
    # against the plain chain, bit for bit, and timed by the probe itself.
    set_counts(0)
    probe_runs = gather_probe.run(device=dev)
    launches = read_counts()
    check(launches["gather_probe"] > 0
          and launches["rollout_byte"] == launches["rollout_binned"]
          == launches["map_sample"] == launches["cvar_costs"]
          == launches["update_useq"] == 0,
          "gather probe: launches {}".format(launches))
    check(all(r["correct"] for r in probe_runs),
          "gather probe: a chain differs from its plain version: {}".format(
              [r for r in probe_runs if not r["correct"]]))
    totals["gather_probe"] += launches["gather_probe"]

    # World (l), the reference benchmark sweep: 120 paired episodes (4
    # densities x 10 environments x 3 realizations) of each paper method
    # at one alpha, through the row producer of run_trials_device on the
    # card: one CUDA graph steps a chunk of 30 episodes, captured once per
    # method; one map_sample launch and one rollout launch a replay, not an
    # episode.
    from mppi_numba_tpu_torch import benchmark
    sweep_runs = {}
    for method in benchmark.PAPER_METHODS:
        torch.cuda.reset_peak_memory_stats()
        set_counts(0)
        args, kw = sweep_args(method_list=[method], batch_chunk=SWEEP_CHUNK,
                              stats={})
        t0 = time.perf_counter()
        rows = benchmark.run_trials_device_rows(*args, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        st = kw["stats"][method]
        replays = sum(st["chunk_steps"])
        check(launches["map_sample_pack"] == launches["rollout_byte"]
              == replays == launches["cvar_costs"] == launches["update_useq"]
              and st["captures"] == 1
              and launches["rollout_binned"] == launches["map_sample_crop"]
              == launches["map_sample_bins"] == launches["gather_probe"]
              == 0, "sweep {}: launches {} for {} replays of {} "
              "episodes".format(method, launches, replays, len(rows)))
        for k in totals:
            totals[k] += launches[k]
        check(len(rows) == len(SWEEP_DENSITIES) * SWEEP_ENVS * SWEEP_TRIALS
              and all(np.isfinite(r["cum_obj"]) for r in rows),
              "sweep {}: {} rows".format(method, len(rows)))
        success = float(np.mean([r["success"] for r in rows]))
        sweep_runs[method] = dict(
            seconds=seconds, success_rate=success, replays=replays,
            chunk_steps=st["chunk_steps"], captures=st["captures"],
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        print(json.dumps(dict(world="benchmark_sweep", method=method,
                              alpha=SWEEP_ALPHA, episodes=len(rows),
                              kernel_launches=launches,
                              launches_per_replay=1,
                              episodes_per_launch=SWEEP_CHUNK,
                              **sweep_runs[method])), flush=True)
    check(sweep_runs["noisy_dyn"]["success_rate"] > 0.5,
          "sweep: noisy_dyn succeeded in {} of its episodes".format(
              sweep_runs["noisy_dyn"]["success_rate"]))

    # One batched solve step of a sweep chunk against its 30 solves made
    # one at a time from the same draws: the kernels' outputs (the map
    # draw and the rollout) bit for bit, u within rtol 2e-4 / atol 2e-5.
    check_batched_solve_step(torch, dev, fused, scenario)

    # run_trials (the sequential engine: sim.trial, one graphed planner a
    # method) on 2 realizations for each method.
    set_counts(0)
    args, kw = sweep_args(method_list=list(benchmark.PAPER_METHODS))
    args = args[:7] + ([0.4], 1, 2) + args[10:]
    seq_rows = benchmark.run_trials_rows(*args, **kw)
    launches = read_counts()
    solves = sum(int(round(r["time_to_goal"] / 0.1)) if r["success"]
                 else SWEEP_MAX_STEPS for r in seq_rows)
    check(len(seq_rows) == 8 and launches["map_sample_pack"]
          == launches["rollout_byte"] == solves == launches["cvar_costs"]
          == launches["update_useq"] and launches["rollout_binned"] == 0,
          "run_trials: {} rows, launches {} for {} solves".format(
              len(seq_rows), launches, solves))
    for k in totals:
        totals[k] += launches[k]
    print(json.dumps(dict(check="run_trials", rows=len(seq_rows),
                          solves=solves, kernel_launches=launches,
                          success=[bool(r["success"]) for r in seq_rows])),
          flush=True)

    # A planner's checkpoint round trip, its solves replayed from a graph.
    set_counts(0)
    ckpt = check_checkpoint_round_trip(torch)
    launches = read_counts()
    for k in totals:
        totals[k] += launches[k]
    print(json.dumps(dict(ckpt, kernel_launches=launches)), flush=True)

    # The shapes the kernels once refused, through the entry points a user
    # calls, each solve a graph replay held bit for bit against an eager
    # solve: the flagship planner at Config(T=409.7) (4,097 steps: the
    # coupling a launch of its own) and at num_grid_samples 20,000 and
    # 70,000 (set after the Config, as its message invites: the wide
    # CVaR), and the barebone planner at K = 100,000 and its Config's 1e6
    # (the wide update).
    lifted = {}
    set_counts(0)
    for name, shape in LIFTED_PLANNERS:
        set_counts(0)
        run = run_planner("flagship_11x11", solves=LIFTED_SOLVES, **shape)
        launches = read_counts()
        M = run["static"].num_grid_samples
        wide = M > cvar_costs.SORTED_M
        coupled = run["T"] > cvar_costs.STAGED_T
        tail = run["solves"] * run["num_opt"]
        # A rollout launch takes at most MAX_SAMPLES map samples.
        runs = -(-M // rollout_byte.MAX_SAMPLES)
        check(launches["rollout_byte"] == tail * runs
              and launches["cvar_costs_wide" if wide else "cvar_costs"]
              == launches["update_useq"] == tail
              and launches["cvar_coupling"] == (tail if coupled else 0)
              and launches["terrain_vis"] == 1
              and launches["cvar_costs" if wide else "cvar_costs_wide"]
              == launches["update_useq_wide"] == 0,
              "lifted {}: launches {}".format(name, launches))
        check(run["kernel_nodes"] <= LIFTED_MAX_NODES[name],
              "lifted {}: {} kernels a replay".format(name,
                                                     run["kernel_nodes"]))
        for k in totals:
            totals[k] += launches[k]
        lifted[name] = dict(
            T=run["T"], M=run["static"].num_grid_samples, K=run["K"],
            solves=run["solves"], graph_equals_eager=True,
            solve_ms_median=run["solve_ms_median"],
            kernels_per_replay=run["kernel_nodes"], kernel_launches=launches)
        print(json.dumps(dict(check="lifted_solve", world=name,
                              **lifted[name])), flush=True)
        del run
    for K in LIFTED_BAREBONE_K:
        set_counts(0)
        run = run_barebone(K=K, solves=LIFTED_SOLVES)
        launches = read_counts()
        tail = run["solves"] * run["num_opt"]
        check(launches["cvar_costs"] == launches["barebone_rollout"] == tail
              and launches["update_useq_wide"] == tail
              and launches["barebone_vis"] == 1
              and not any(n for k, n in launches.items()
                          if k not in ("cvar_costs", "update_useq_wide",
                                       "barebone_rollout", "barebone_vis")),
              "lifted barebone K {}: launches {}".format(K, launches))
        check(run["kernel_nodes"] <= LIFTED_BAREBONE_MAX_NODES,
              "lifted barebone K {}: {} kernels a replay".format(
                  K, run["kernel_nodes"]))
        for k in totals:
            totals[k] += launches[k]
        name = "barebone_K{}".format(K)
        lifted[name] = dict(
            K=K, T=run["T"], solves=run["solves"], graph_equals_eager=True,
            solve_ms_median=run["solve_ms_median"],
            kernels_per_replay=run["kernel_nodes"], kernel_launches=launches)
        print(json.dumps(dict(check="lifted_solve", world=name,
                              **lifted[name])), flush=True)
        del run
    lifted_launches = {k: sum(r["kernel_launches"][k]
                              for r in lifted.values())
                       for k in ("cvar_costs_wide", "update_useq_wide",
                                 "cvar_coupling")}
    check(lifted_launches["cvar_coupling"] > 0,
          "the coupling kernel was not launched on the main path: "
          "{}".format(lifted_launches))

    # -- phase 4: timing ------------------------------------------------------------
    def time_kernels(fns, reps):
        """Each of ``fns`` ({name: call}) over ``reps`` launches captured in
        a CUDA graph and over eager launches, in turns (a b .. b a):
        {name: {"graph": [ms, ms], "eager": [ms, ms]}}."""
        runs = {name: {"graph": [], "eager": []} for name in fns}
        for name in [*fns, *reversed(list(fns))]:
            runs[name]["graph"].append(time_cuda_graph(fns[name], reps, 5))
            runs[name]["eager"].append(time_cuda(fns[name], reps, 5))
        return runs

    args, kw, K, M, T, H, W = flagship_args
    flag_runs = time_kernels({"byte": lambda: kernel(*args, **kw)}, 50)["byte"]
    kernel_ms = flag_runs["graph"]
    plain_ms = [time_cuda(lambda: plain(*args, **kw), 3, 1) for _ in range(2)]
    bound_ms, bound_by = rollout_bound_ms(K, M, T, H, W, True, False)
    emit("rollout_kernel_ms", min(kernel_ms), "ms", runs=kernel_ms,
         eager_runs=flag_runs["eager"],
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
        runs = time_kernels({"binned": lambda: bkernel(*bargs, **bkw),
                             "byte": lambda: kernel(*wargs, **wkw)},
                            50 if M > 1 else 500)
        b_ms, w_ms = runs["binned"]["graph"], runs["byte"]["graph"]
        p_ms = [time_cuda(lambda: bplain(*bargs, **bkw), 3, 1)
                for _ in range(2)]
        b_bound = rollout_bound_ms(K, M, T, H, W, True, sm, cb)
        w_bound = rollout_bound_ms(K, M, T, H, W, True, sm)
        shape = "K{}_M{}_T{}_{}x{}_fast_trig{}".format(
            K, M, T, H, W, "_speed_map" if sm else "")
        emit("rollout_binned_kernel_ms", min(b_ms), "ms", runs=b_ms,
             eager_runs=runs["binned"]["eager"], shape=shape, cell_bits=cb,
             at=name, bound_ms=b_bound[0], bound_by=b_bound[1])
        emit("rollout_byte_kernel_ms", min(w_ms), "ms", runs=w_ms,
             eager_runs=runs["byte"]["eager"], shape=shape, at=name,
             bound_ms=w_bound[0], bound_by=w_bound[1])
        emit("rollout_binned_plain_ms", min(p_ms), "ms", runs=p_ms,
             shape=shape, cell_bits=cb, at=name)
        binned_timed[name] = dict(ms=min(b_ms), plain_ms=min(p_ms),
                                  bound=b_bound)
        del bargs, wargs

    # The bicycle against the unicycle, both exact trig (the bicycle has no
    # fast-trig form), at the forest world's shape on each binned layout
    # and on byte words of the same grids, in turns.
    K, M, T, H, W = 1024, 1024, 100, 140, 84
    bicycle_timed = {}
    for cb, B in ((4, FOREST_BINS), (None, FOREST_BINS), (2, 4), (8, 22)):
        bargs, wargs = make_binned_case(K, M, T, H, W, FOREST_RES,
                                        4 if cb is None else cb, B, True,
                                        False, 500, past_last=False,
                                        steer=STEER)
        name = "rollout_byte" if cb is None else "rollout_binned"
        fn, args, kw = ((kernel, wargs, {}) if cb is None
                        else (bkernel, bargs, dict(cell_bits=cb)))
        runs = time_kernels(
            {m: (lambda step=step: fn(*args, H=H, W=W, T=T, step_fn=step,
                                      **kw))
             for m, step in (("bicycle", bicycle_step), ("unicycle", None))},
            50)
        b_bound = rollout_bound_ms(K, M, T, H, W, False, False, cb,
                                   bicycle=True)
        u_bound = rollout_bound_ms(K, M, T, H, W, False, False, cb)
        b_ms, u_ms = runs["bicycle"]["graph"], runs["unicycle"]["graph"]
        emit("rollout_bicycle_kernel_ms", min(b_ms), "ms",
             kernel=name, runs=b_ms, eager_runs=runs["bicycle"]["eager"],
             unicycle_exact_ms=min(u_ms), unicycle_exact_runs=u_ms,
             unicycle_exact_eager_runs=runs["unicycle"]["eager"],
             shape="K{}_M{}_T{}_{}x{}_exact_trig".format(K, M, T, H, W),
             cell_bits=cb, bound_ms=b_bound[0], bound_by=b_bound[1],
             unicycle_bound_ms=u_bound[0])
        if cb in (None, 4):
            bicycle_timed[name] = dict(ms=min(b_ms), bound=b_bound,
                                       unicycle_ms=min(u_ms))
        del bargs, wargs

    # The gather probe's ns per chain step (timed by its entry point in
    # phase 3) beside each case's bound; the plain chain timed at the
    # TPU probe's own case (column gather, its largest table, its tile).
    probe_timed = {}
    for r in probe_runs:
        bound = gather_bound_ms(r["touched_entries"], r["R"], r["L"],
                                r["iters"])
        key = "{}_S{}_R{}".format(r["mode"], r["S"], r["R"])
        probe_timed[key] = dict(r, bound=bound)
        emit("gather_chain_ns_per_step", r["ns_per_step"], "ns",
             mode=r["mode"], S=r["S"], R=r["R"], L=r["L"], iters=r["iters"],
             ms=r["ms"], runs_ms=r["runs_ms"], table_bytes=r["table_bytes"],
             touched_entries=r["touched_entries"], bound_ms=bound[0],
             bound_by=bound[1], over_bound=r["ms"] / bound[0])
    r = probe_timed[PROBE_TIMED_AT]
    table, idx, mod = gather_probe.make_inputs(r["mode"], r["S"], r["R"], dev)
    probe_plain_ms = [time_cuda(lambda: chains[r["mode"]][1](
        table, idx, mod, r["iters"]), 3, 1) for _ in range(2)]
    emit("gather_chain_plain_ms", min(probe_plain_ms), "ms",
         runs=probe_plain_ms, at=PROBE_TIMED_AT)
    del table, idx

    # The map-sampling kernel at world (b)'s shape (M = 1024, the whole
    # 250x250 map, 22 bins a plane): its fused launch in (b)'s layout
    # (8-bit cells) in turns with its 'bins' mode, against their bounds and
    # the plain versions; then the fused launch at the other timed worlds'
    # shapes and layouts.
    args, kw, maps, layout, M, rH, rW, bl, ba = fused_timed_args[
        "main_path_250x250_22bins"]
    sample_runs = time_kernels({
        "pack": lambda: fused(args[0], maps, args[5], M, layout, **kw),
        "bins": lambda: sampler(*args, **kw)}, 20)
    fused_plain_ms = [time_cuda(lambda: fplain(args[0], maps, args[5], M,
                                               layout, **kw), 2, 1)
                      for _ in range(2)]
    sample_plain_ms = [time_cuda(lambda: splain(*args, **kw), 2, 1)
                       for _ in range(2)]
    sample_bound = map_sample_bound_ms(M, rH, rW, bl, ba, layout)
    bins_bound = map_sample_bound_ms(M, rH, rW, bl, ba)
    sample_shape = "M{}_{}x{}_bins{}+{}".format(M, rH, rW, bl, ba)
    emit("map_sample_kernel_ms", min(sample_runs["pack"]["graph"]), "ms",
         runs=sample_runs["pack"]["graph"],
         eager_runs=sample_runs["pack"]["eager"], shape=sample_shape,
         layout=layout, bound_ms=sample_bound[0], bound_by=sample_bound[1])
    emit("map_sample_bins_kernel_ms", min(sample_runs["bins"]["graph"]), "ms",
         runs=sample_runs["bins"]["graph"],
         eager_runs=sample_runs["bins"]["eager"], shape=sample_shape,
         bound_ms=bins_bound[0], bound_by=bins_bound[1])
    emit("map_sample_plain_ms", min(fused_plain_ms), "ms",
         runs=fused_plain_ms, shape=sample_shape, layout=layout,
         bins_plain_runs=sample_plain_ms)
    fused_ms_at = {}
    for name, (fargs, fkw, fmaps, flayout, fM, frH, frW, fbl,
               fba) in fused_timed_args.items():
        runs = time_kernels({name: lambda: fused(
            fargs[0], fmaps, fargs[5], fM, flayout, **fkw)}, 20)[name]
        bound = map_sample_bound_ms(fM, frH, frW, fbl, fba, flayout)
        fused_ms_at[name] = min(runs["graph"])
        emit("map_sample_kernel_ms_at", min(runs["graph"]), "ms", at=name,
             layout=flayout, runs=runs["graph"], eager_runs=runs["eager"],
             bound_ms=bound[0], bound_by=bound[1])
    del args, maps, fused_timed_args

    # The crop mode at the big-map world's shape (an 85x85 window of
    # 250x250, 12 bins a plane, M = 1024, 4-bit cells): the launch that
    # crops, samples and packs, against its bound (the window mode's at
    # that shape: the crop adds a few scalar operations and 16 bytes out)
    # and its plain version (the crop in torch ops, then the window's plain
    # draw and pack).
    key, cmaps, ctask, cM, clayout, croi = crop_timed_args
    crop_runs = time_kernels({"crop": lambda: cropper(
        key, cmaps, ctask, cM, clayout, croi)}, 20)["crop"]
    crop_plain_ms = [time_cuda(lambda: cplain(key, cmaps, ctask, cM, clayout,
                                              croi), 2, 1)
                     for _ in range(2)]
    crop_bound = map_sample_bound_ms(cM, *croi, cmaps.lin_pmf.shape[0],
                                     cmaps.ang_pmf.shape[0], clayout)
    crop_shape = "M{}_{}x{}_of_{}x{}_bins{}+{}".format(
        cM, *croi, *cmaps.obstacle.shape, cmaps.lin_pmf.shape[0],
        cmaps.ang_pmf.shape[0])
    emit("map_sample_crop_kernel_ms", min(crop_runs["graph"]), "ms",
         runs=crop_runs["graph"], eager_runs=crop_runs["eager"],
         shape=crop_shape, layout=clayout, bound_ms=crop_bound[0],
         bound_by=crop_bound[1],
         window_mode_ms=fused_ms_at["main_path_85x85_of_250x250"])
    emit("map_sample_crop_plain_ms", min(crop_plain_ms), "ms",
         runs=crop_plain_ms, shape=crop_shape)
    del key, cmaps, ctask, crop_timed_args

    # The solve's tail kernels at the main path's shapes, in turns with
    # the torch calls the CVaR kernel replaced and an empty kernel.
    tail_timed = time_tail_kernels(torch, dev, time_kernels, time_cuda, emit)

    # The barebone rollout kernel against its bound and the plain loop,
    # and the wide update's three launches, each on its own.
    barebone_timed = time_barebone_kernel(torch, dev, time_kernels,
                                          time_cuda, emit)
    wide_launch_us = time_wide_update_launches(torch, dev, emit)

    # The visualisation rollouts (the vis kernels in the planners' vis
    # graphs) of every VIS_TIMED_WORLDS world and of the barebone planner
    # beside the plain loops (in vis graphs of their own) and the bounds;
    # the latency bound's step is the probe's quickest chain step in L1.
    l1_step_ns = min(r["ns_per_step"] for r in probe_timed.values()
                     if r["table_bytes"] <= L1_BYTES)
    vis_timed = time_vis_rollouts(torch, time_cuda, time_cuda_graph, dict(
        {w: planner_runs[w]["planner"] for w in VIS_TIMED_WORLDS},
        barebone=barebone["planner"]), l1_step_ns, vis_chain, emit)
    vis_queue = time_vis_queue(torch, dev, time_cuda_graph, emit)

    # The planner's visualisation rollouts on the host clock, world (c):
    # get_state_rollout() (replayed from its graph) in turns with the same
    # rollouts made eagerly.
    forest_planner = planner_runs["forest_140x84"]["planner"]
    aux = forest_planner._last_aux
    eager_vis = functools.partial(
        get_terrain_vis(forest_planner._last_static),
        forest_planner._map_inputs(), forest_planner._task_device,
        forest_planner.u_cur, forest_planner.u_prev, aux.noise_vis,
        aux.lin_grids, aux.ang_grids, aux.roi_offset)
    vis_ms, vis_eager_ms = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        forest_planner.get_state_rollout()
        vis_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        eager_vis().cpu()
        vis_eager_ms.append((time.perf_counter() - t0) * 1e3)
    emit("get_state_rollout_host_ms", float(np.median(vis_ms[1:])), "ms",
         world="forest_140x84", runs=vis_ms,
         eager_vis_host_ms=float(np.median(vis_eager_ms[1:])),
         eager_runs=vis_eager_ms, V=forest_planner.num_vis_state_rollouts,
         T=forest_planner.num_steps)
    del aux, eager_vis

    # The barebone solve: chained on the device clock, replayed from a
    # CUDA graph (a SolveGraph on the planner's task and a controls buffer
    # of its own) and eager, in turns, with the host's enqueue time beside
    # each, and planner solve() calls between.
    bb = barebone["planner"]
    bsolver = get_barebone_solver(bb._static(), dev)
    bu0 = torch.zeros((barebone["T"], 2), device=dev)
    bgens = {name: torch.Generator(device=dev).manual_seed(1)
             for name in ("graph", "eager")}
    bfns = {"graph": bsolver.capture(bgens["graph"], bb._task_device,
                                     torch.zeros_like(bu0)),
            "eager": bsolver}
    chain_ms = {"graph": [], "eager": []}
    enqueue_ms = {"graph": [], "eager": []}
    solve_ms = []
    for r in range(3):
        for name in (("graph", "eager") if r % 2 == 0
                     else ("eager", "graph")):
            fn = bfns[name]
            per, enq = chained_solve_time(
                lambda g, _maps, task, u: fn(g, task, u), None,
                bb._task_device, bu0, num_iters=20, generator=bgens[name],
                with_enqueue=True)
            chain_ms[name].append(per * 1e3)
            enqueue_ms[name].append(enq * 1e3)
        solve_ms.append(time_planner_solves(bb, 20))
    emit("barebone_chained_solve_ms", float(np.median(chain_ms["graph"])),
         "ms", solves=20, runs=chain_ms["graph"],
         host_enqueue_ms=enqueue_ms["graph"],
         eager_ms=float(np.median(chain_ms["eager"])),
         eager_runs=chain_ms["eager"],
         eager_host_enqueue_ms=enqueue_ms["eager"],
         kernels_per_replay=bfns["graph"].kernel_nodes,
         planner_solve_host_ms=solve_ms, K=barebone["K"], T=barebone["T"],
         timing="device clock, CUDA-graph replays and eager chains in "
                "turns")
    del bfns

    # Solve times in one phase, in turns: chained solves replayed from a
    # CUDA graph and eager, on the device clock (with the host's enqueue
    # time of the same chain beside them), and planner solve() calls on the
    # host clock; then the device's busy time per solve, from kernel times
    # under torch.profiler over eager chained solves (and over graph
    # replays, where the profiler sees their kernels), over each
    # unprofiled chained time.
    for world in TIMED_WORLDS:
        run = planner_runs[world]
        n, reps = (10, 4) if world == "external_250x250" else (50, 6)
        res = time_solve_chains(run, torch, n, reps)
        prof = res["profile"]
        busy_ms = prof["eager"]["device_busy_us_per_solve"] / 1e3
        chain_med = float(np.median(res["ms"]["eager"]))
        graph_med = float(np.median(res["ms"]["graph"]))
        emit("chained_solve_ms", chain_med, "ms", world=world, solves=n,
             backend=run["backend"], runs=res["ms"]["eager"],
             host_enqueue_ms=res["enqueue_ms"]["eager"],
             device_busy_ms=busy_ms, device_busy_share=busy_ms / chain_med,
             kernels_per_solve=prof["eager"]["kernels_per_solve"],
             K=run["K"], M=run["static"].num_grid_samples,
             T=run["T"], map=run["map"])
        emit("graph_chained_solve_ms", graph_med, "ms", world=world,
             solves=n, backend=run["backend"], runs=res["ms"]["graph"],
             host_enqueue_ms=res["enqueue_ms"]["graph"],
             device_busy_ms=busy_ms, device_busy_share=busy_ms / graph_med,
             graph_profile=prof["graph"],
             launches_per_replay=res["launches_per_replay"])
        emit("planner_solve_host_ms_turns", float(np.median(res["solve_ms"])),
             "ms", world=world, solves=n, runs=res["solve_ms"])
        emit("solve_device_time_by_kernel", prof["eager"], "us", world=world)
        per_replay = res["launches_per_replay"]
        check(per_replay.get("cvar_costs") == per_replay.get(
            "update_useq_fused") == run["num_opt"],
            "{}: a replay launched {}".format(world, per_replay))
        sorts = [p["sort_kernels"] for p in prof.values() if p]
        check(not any(sorts), "{}: the solve launched torch's sort kernels "
              "{}".format(world, sorts))

    # The big-map world cropped against uncropped, in turns (cropped,
    # uncropped, uncropped, cropped): chained solves (graph and eager) and
    # device busy time.  The planner's solve() on the host clock, the same
    # turns, from a cropped planner and an uncropped one of the same world.
    run = planner_runs[BIGMAP]
    bigmap_runs = {
        "cropped": run,
        "uncropped": dict(run, static=dataclasses.replace(
            run["static"], roi_shape=None),
            planner=setup_world(BIGMAP, crop=False)[0])}
    bigmap_res = {name: [] for name in bigmap_runs}
    for name in ["cropped", "uncropped", "uncropped", "cropped"]:
        bigmap_res[name].append(time_solve_chains(bigmap_runs[name], torch,
                                                  20, 2))
    for name, results in bigmap_res.items():
        def pooled(*keys):
            return [v for r in results for v in r[keys[0]][keys[1]]]

        prof = results[-1]["profile"]
        emit("bigmap_chained_solve_ms", float(np.median(
            pooled("ms", "eager"))), "ms", world=BIGMAP, crop=name,
            runs=pooled("ms", "eager"), solves=20,
            host_enqueue_ms=pooled("enqueue_ms", "eager"),
            graph_chained_ms=float(np.median(pooled("ms", "graph"))),
            graph_runs=pooled("ms", "graph"),
            graph_host_enqueue_ms=pooled("enqueue_ms", "graph"),
            device_busy_ms=prof["eager"]["device_busy_us_per_solve"] / 1e3,
            kernels_per_solve=prof["eager"]["kernels_per_solve"],
            top_us_per_solve=prof["eager"]["top_us_per_solve"],
            graph_profile=prof["graph"],
            launches_per_replay=results[-1]["launches_per_replay"])
        emit("bigmap_planner_solve_host_ms", float(np.median(
            [v for r in results for v in r["solve_ms"]])), "ms", world=BIGMAP,
            crop=name, runs=[v for r in results for v in r["solve_ms"]],
            solves=20)

    # One device trial of the big-map world (one CUDA graph a step, its
    # capture included; a one-step episode times the capture) in turns
    # with sim.trial's host loop on a planner of the same world (its
    # graphs captured by a first, untimed call): steps per second.
    trial_ms, one_step_ms, trial_steps, host_ms, host_steps = [], [], [], [], []
    trial, tmaps, ttask, gt, meta = device_trial["timed_args"]
    one_step = device_sim.make_episode_fn(run["static"], 1)
    host_planner, truth, _ = setup_world(BIGMAP)
    params0 = dict(host_planner.params)
    sim.trial(host_planner, truth, host_planner.dt, 2, params0)
    for turn in range(2):
        gen = torch.Generator(device=dev).manual_seed(20 + turn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trial(gen, tmaps, ttask, *gt, meta)
        trial_steps.append(int(out.steps))
        trial_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        one_step(gen, tmaps, ttask, *gt, meta).steps.item()
        one_step_ms.append((time.perf_counter() - t0) * 1e3)
        host_planner.set_params(params0)
        t0 = time.perf_counter()
        out = sim.trial(host_planner, truth, host_planner.dt,
                        DEVICE_TRIAL_STEPS, params0, return_history=True)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        host_steps.append(len(out["uhist"]))
    emit("device_trial_steps_per_s", float(np.median(
        [s / ms * 1e3 for s, ms in zip(trial_steps, trial_ms)])), "steps/s",
        world=BIGMAP, steps=trial_steps, ms=trial_ms,
        one_step_episode_ms=one_step_ms,
        replay_steps_per_s=[(s - 1) / (ms - o) * 1e3 for s, ms, o in zip(
            trial_steps, trial_ms, one_step_ms)],
        host_loop_steps_per_s=float(np.median(
            [s / ms * 1e3 for s, ms in zip(host_steps, host_ms)])),
        host_loop_steps=host_steps, host_loop_ms=host_ms)
    del trial, tmaps, ttask, gt, meta, host_planner

    # The kernels with a scenario axis at the sweep's shape (B = 30
    # episodes of 11x11 maps, M = K = 1024, T = 100; and the det modes' M =
    # 1) against 30 single launches of the same work, in turns, each over
    # launches captured in a CUDA graph.
    st = sweep_timed_args
    B = SWEEP_CHUNK
    m1 = dict(words=st["words"][:, :1].contiguous(), keys=st["keys"])
    scenario_timed = {}
    for name, batched, singles, bound in (
            ("map_sample", lambda: fused(st["keys"], st["maps"],
                                         st["task"].alpha_dyn, st["M"],
                                         "byte"),
             lambda: [fused(st["keys"][b], scenario(st["maps"], b),
                            st["task"].alpha_dyn[b], st["M"], "byte")
                      for b in range(B)],
             map_sample_bound_ms(B * st["M"], 11, 11, 22, 22, "byte")),
            ("map_sample_M1", lambda: fused(st["keys"], st["maps"],
                                            st["task"].alpha_dyn, 1, "byte"),
             lambda: [fused(st["keys"][b], scenario(st["maps"], b),
                            st["task"].alpha_dyn[b], 1, "byte")
                      for b in range(B)],
             map_sample_bound_ms(B, 11, 11, 22, 22, "byte")),
            ("rollout_byte", lambda: kernel(st["words"], st["tv"], st["v"],
                                            st["w"], **st["kw"]),
             lambda: [kernel(st["words"][b], st["tv"][b], st["v"][b],
                             st["w"][b], **st["kw"]) for b in range(B)],
             rollout_bound_ms(1024, B * st["M"], 100, 11, 11, True, False)),
            ("rollout_byte_M1", lambda: kernel(m1["words"], st["tv"],
                                               st["v"], st["w"],
                                               **st["kw"]),
             lambda: [kernel(m1["words"][b], st["tv"][b], st["v"][b],
                             st["w"][b], **st["kw"]) for b in range(B)],
             rollout_bound_ms(1024, B, 100, 11, 11, True, False))):
        runs = time_kernels({"batched": batched, "singles": singles},
                            5 if name.endswith("M1") else 3)
        scenario_timed[name] = dict(
            ms=min(runs["batched"]["graph"]),
            singles_ms=min(runs["singles"]["graph"]),
            bound_ms=bound[0], bound_by=bound[1])
        emit("scenario_kernel_ms", scenario_timed[name]["ms"], "ms",
             kernel=name, scenarios=B, runs=runs["batched"]["graph"],
             eager_runs=runs["batched"]["eager"],
             singles_ms=scenario_timed[name]["singles_ms"],
             singles_runs=runs["singles"]["graph"],
             singles_eager_runs=runs["singles"]["eager"],
             bound_ms=bound[0], bound_by=bound[1])
    skip_timed = time_skip_masks(torch, dev, time_kernels, kernel, st, emit)
    del st, sweep_timed_args, m1

    # The sweep's trials per second for each method on one chunk of 30
    # episodes: the batch engine (one CUDA graph steps all 30; its capture
    # timed apart: the first call captures, the second replays) against
    # the in-turn engine (make_device_trial: one graph a scenario, each
    # captured on its first call), in turns; and the peak device memory
    # of a batched step of noisy_dyn at each chunk size of PEAK_CHUNKS.
    sweep_timed = {}
    for method in benchmark.PAPER_METHODS:
        static, maps, task, gt = sweep_chunk(method, SWEEP_CHUNK)
        res = time_sweep_chunk(torch, device_sim, static, maps, task, gt)
        sweep_timed[method] = res
        emit("sweep_episodes_per_s", res["batched_episodes_per_s"],
             "episodes/s", method=method, episodes=SWEEP_CHUNK,
             alpha=SWEEP_ALPHA, **{k: v for k, v in res.items()
                                   if k != "batched_episodes_per_s"})
    peak = {}
    static, maps, task, gt = sweep_chunk("noisy_dyn", max(PEAK_CHUNKS))
    for chunk in PEAK_CHUNKS:
        engine = device_sim.make_device_trial_batch(static, 1)
        sub = [type(t)(*(None if x is None else x[:chunk] for x in t))
               for t in (maps, task)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine(torch.Generator(device=dev).manual_seed(0), *sub,
               *(x[:chunk] for x in gt))
        torch.cuda.synchronize()
        peak[chunk] = torch.cuda.max_memory_allocated() - base
        del engine, sub
    emit("sweep_step_peak_device_memory", peak[SWEEP_CHUNK], "bytes",
         method="noisy_dyn", by_chunk=peak, M=1024, K=1024)
    del static, maps, task, gt

    flag = case_results[0]
    bb_at = barebone_timed["K1000000_T50_N2"]
    tail_at = tail_timed["a_static_205"]
    tail_wide = tail_timed["wide_M70000_numel"]
    tail_wide_timed = {
        k: v for k, v in tail_timed.items()
        if int(v["shape"].split("_M")[1].split("_")[0]) > cvar_costs.SORTED_M}
    tail_coupled = tail_timed["streamed_T20000"]
    tail_big_k = tail_timed["wide_update_K1000000"]
    forest = binned_timed["forest_140x84"]
    nib = binned_results[0]
    # The probe's latency bound: a dependent chain cannot take less than
    # its steps times one load from where its table lives.  The table of
    # PROBE_TIMED_AT (3.4 MB) lives in L2, so the step is an L2 hit: one
    # step of the same chain (mode and rows) on the smallest table of
    # this run that an SM's L1 cannot hold (L1_BYTES).
    probe_at = probe_timed[PROBE_TIMED_AT]
    l2_size = min(r["S"] for r in probe_timed.values()
                  if r["table_bytes"] > L1_BYTES)
    l2_step_ns = next(r["ns_per_step"] for r in probe_timed.values()
                      if r["mode"] == probe_at["mode"]
                      and r["R"] == probe_at["R"] and r["S"] == l2_size)
    probe_latency_bound_ms = probe_at["iters"] * l2_step_ns * 1e-6
    # -- phase 5: the sharded solve ---------------------------------------------
    set_counts()
    ws1_launches, ws1_graph_launches = sharded_world_size_one(torch, emit)
    sharded_multi_rank(torch, emit)

    # -- phase 6: the drivers ----------------------------------------------------
    run_drivers(card, emit)

    # -- phase 7: the examples and the sweep drivers ------------------------------
    set_counts()
    phase7 = run_phase7(card, emit)
    in_process = read_counts()
    for k in phase7:
        phase7[k] += in_process[k]
    left = stop_started_processes()
    check(not left, "processes left running: {}".format(left))

    print(json.dumps({"kernels": [{
        "name": "rollout_byte",
        "route": "cuda",
        "launches_phase7": phase7["rollout_byte"],
        "source": rollout_byte.KERNEL_SOURCE,
        "replaces": rollout_byte.REPLACES,
        "launches": totals["rollout_byte"],
        "launches_sharded_world_size_1": ws1_launches.get(
            "terrain_rollout_costs_byte", 0),
        "launches_sharded_graph_replays": ws1_graph_launches.get(
            "terrain_rollout_costs_byte", 0),
        "max_abs_err": flag["max_abs_err"],
        "ms": min(kernel_ms),
        "plain_ms": min(plain_ms),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "max_rel_err": max(c["max_rel_err"] for c in case_results),
        "outliers": sum(c["outliers"] for c in case_results),
        "cases": len(case_results),
        "edge_cases": len(edge_results),
        "bicycle_cases": len(bicycle_results["rollout_byte"]),
        "bicycle_max_rel_err": max(
            c["max_rel_err"] for c in bicycle_results["rollout_byte"]),
        "bicycle_ms_forest": bicycle_timed["rollout_byte"]["ms"],
        "scenario_cases": len(scenario_results["rollout_byte"]),
        "scenarios_b30": scenario_timed["rollout_byte"],
        "scenarios_b30_M1": scenario_timed["rollout_byte_M1"],
        "skip_mask_cases": len(skip_results),
        "scenarios_b30_skipped_ms": {str(n): ms
                                     for n, ms in skip_timed.items()},
    }, {
        "name": "rollout_binned",
        "route": "cuda",
        "launches_phase7": phase7["rollout_binned"],
        "source": rollout_binned.KERNEL_SOURCE,
        "replaces": rollout_binned.REPLACES,
        "launches": totals["rollout_binned"],
        "launches_sharded_graph_replays": ws1_graph_launches.get(
            "terrain_rollout_costs_binned", 0),
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
        "bicycle_cases": len(bicycle_results["rollout_binned"]),
        "bicycle_max_rel_err": max(
            c["max_rel_err"] for c in bicycle_results["rollout_binned"]),
        "bicycle_ms_forest": bicycle_timed["rollout_binned"]["ms"],
        "bicycle_bound_ms_forest": bicycle_timed["rollout_binned"]["bound"][0],
        "scenario_cases": len(scenario_results["rollout_binned"]),
    }, {
        "name": "map_sample",
        "route": "cuda",
        "launches_phase7": phase7["map_sample"],
        "source": map_sample.KERNEL_SOURCE,
        "replaces": map_sample.REPLACES,
        "launches": totals["map_sample"],
        "launches_sharded_world_size_1": ws1_launches.get(
            "sample_and_pack_window", 0),
        "launches_sharded_graph_replays": sum(
            ws1_graph_launches.get(w, 0) for w in ("sample_and_pack_window",
                                                   "sample_and_pack_crop")),
        "max_abs_err": max(r["max_abs_err"]
                           for r in sample_results + fused_results),
        "ms": min(sample_runs["pack"]["graph"]),
        "plain_ms": min(fused_plain_ms),
        "bound_ms": sample_bound[0],
        "bound_by": sample_bound[1],
        "library_ms": None,
        "timed_at": "external_250x250: {}, {} payload".format(sample_shape,
                                                             layout),
        "launches_sample_and_pack": totals["map_sample_pack"],
        "launches_crop": totals["map_sample_crop"],
        "launches_bins": totals["map_sample_bins"],
        "bins_mode_ms": min(sample_runs["bins"]["graph"]),
        "bins_mode_bound_ms": bins_bound[0],
        "ms_at": fused_ms_at,
        "cases": len(sample_results),
        "fused_combinations": sum(r["combinations"] for r in fused_results),
        "scenario_combinations": sum(r["combinations"] for r in
                                     scenario_results["map_sample"]),
        "scenarios_b30": scenario_timed["map_sample"],
        "scenarios_b30_M1": scenario_timed["map_sample_M1"],
    }, {
        "name": "roi_window",
        "launches_phase7": phase7["map_sample_crop"],
        "kernel": "map_sample, crop mode (sample_and_pack_crop): the crop "
                  "is folded into the map draw; no launch of its own",
        "route": "cuda",
        "source": map_sample.KERNEL_SOURCE,
        "replaces": map_sample.CROP_REPLACES,
        "launches": totals["map_sample_crop"],
        "max_abs_err": max(r["max_abs_err"] for r in crop_results),
        "ms": min(crop_runs["graph"]),
        "plain_ms": min(crop_plain_ms),
        "bound_ms": crop_bound[0],
        "bound_by": crop_bound[1],
        "library_ms": None,
        "timed_at": BIGMAP + ": " + crop_shape + ", " + clayout + " payload",
        "window_mode_ms": fused_ms_at["main_path_85x85_of_250x250"],
        "cases": sum(r["combinations"] for r in crop_results),
    }, {
        "name": "gather_probe",
        "route": "cuda",
        "launches_phase7": phase7["gather_probe"],
        "source": gather_probe.KERNEL_SOURCE,
        "replaces": gather_probe.REPLACES,
        "launches": totals["gather_probe"],
        "max_abs_err": max(r["max_abs_err"] for r in probe_runs),
        "ms": probe_timed[PROBE_TIMED_AT]["ms"],
        "plain_ms": min(probe_plain_ms),
        "bound_ms": probe_timed[PROBE_TIMED_AT]["bound"][0],
        "bound_by": probe_timed[PROBE_TIMED_AT]["bound"][1],
        "library_ms": None,
        "latency_bound_ms": probe_latency_bound_ms,
        "latency_bound": "steps x one chain step on the {} KB table, the "
                         "smallest past L1: an L2 hit ({:.1f} ns, this "
                         "run)".format(l2_size * gather_probe.LANES * 4
                                       // 1024, l2_step_ns),
        "latency_bound_share": probe_latency_bound_ms / probe_at["ms"],
        "timed_at": PROBE_TIMED_AT + ", 512 steps",
        "ns_per_step_at": {k: v["ns_per_step"]
                           for k, v in probe_timed.items()},
        "cases": len(probe_runs),
    }, {
        "name": "cvar_costs",
        "route": "cuda",
        "launches_phase7": phase7["cvar_costs"],
        "source": cvar_costs.KERNEL_SOURCE,
        "replaces": cvar_costs.REPLACES,
        "launches": totals["cvar_costs"],
        "launches_sharded_world_size_1": ws1_launches.get("cvar_costs", 0),
        "launches_sharded_graph_replays": ws1_graph_launches.get(
            "cvar_costs", 0),
        "max_abs_err": max(r["max_abs_err"] for r in tail_results),
        "ms": tail_at["cvar_ms"],
        "plain_ms": tail_at["cvar_plain_ms"],
        "bound_ms": tail_at["cvar_bound"][0],
        "bound_by": tail_at["cvar_bound"][1],
        "library_ms": tail_at["library_ms"],
        "library": tail_at["library"],
        "bound_share": tail_at["cvar_bound_share"],
        "torch_ops_ms": tail_at["torch_ops_ms"],
        "empty_node_ms": tail_at["empty_node_ms"],
        "timed_at": "a_static_205: " + tail_at["shape"] + ", numel 205",
        "ms_at": {k: v["cvar_ms"] for k, v in tail_timed.items()},
        "library_ms_at": {k: v["library_ms"] for k, v in tail_timed.items()},
        "torch_ops_ms_at": {k: v["torch_ops_ms"]
                            for k, v in tail_timed.items()},
        "bound_ms_at": {k: v["cvar_bound"][0]
                        for k, v in tail_timed.items()},
        "bound_share_at": {k: v["cvar_bound_share"]
                           for k, v in tail_timed.items()},
        "cases": len(tail_results),
    }, {
        "name": "cvar_costs_wide",
        "route": "cuda",
        "kernel": "cvar_wide_kernel: the CVaR plus coupling past M = "
                  "16,384 (a block a row, one histogram of the row, rounds "
                  "of whole bins gathered and sorted in shared memory); "
                  "cvar_costs routes to it",
        "launches_phase7": phase7["cvar_costs_wide"],
        "source": cvar_costs.WIDE_KERNEL_SOURCE,
        "replaces": cvar_costs.REPLACES,
        "launches": totals["cvar_costs_wide"],
        "launches_lifted_solves": lifted_launches["cvar_costs_wide"],
        "max_abs_err": max(r["max_abs_err"] for r in tail_results
                           if r["cvar_path"][0] == "cvar_wide_kernel"),
        "ms": tail_wide["cvar_ms"],
        "plain_ms": tail_wide["cvar_plain_ms"],
        "bound_ms": tail_wide["cvar_bound"][0],
        "bound_by": tail_wide["cvar_bound"][1],
        "library_ms": tail_wide["library_ms"],
        "library": tail_wide["library"],
        "bound_share": tail_wide["cvar_bound_share"],
        "torch_ops_ms": tail_wide["torch_ops_ms"],
        "timed_at": "wide_M70000_numel: " + tail_wide["shape"]
                    + ", numel 14000",
        "ms_at": {k: v["cvar_ms"] for k, v in tail_wide_timed.items()},
        "bound_ms_at": {k: v["cvar_bound"][0]
                        for k, v in tail_wide_timed.items()},
        "torch_ops_ms_at": {k: v["torch_ops_ms"]
                            for k, v in tail_wide_timed.items()},
        "cases": sum(r["cvar_path"][0] == "cvar_wide_kernel"
                     for r in tail_results)
                 + sum(r["case"] == "solve_tail_wide_edge"
                       or r.get("M", 0) > cvar_costs.SORTED_M
                       for r in lifted_edge_results),
    }, {
        "name": "cvar_coupling",
        "route": "cuda",
        "kernel": "cvar_coupling_kernel: each row's coupling past T = "
                  "4,096 steps, a launch of its own before the CVaR's "
                  "(512 position classes a row, two rows a block); "
                  "cvar_costs launches it",
        "launches_phase7": phase7["cvar_coupling"],
        "source": cvar_costs.WIDE_KERNEL_SOURCE,
        "replaces": cvar_costs.REPLACES,
        "launches": totals["cvar_coupling"],
        "launches_lifted_solves": lifted_launches["cvar_coupling"],
        "max_abs_err": max(r["max_abs_err"] for r in lifted_edge_results
                           if r["case"] == "coupling_sums"),
        "ms": tail_coupled["coupling_ms"],
        "plain_ms": tail_coupled["coupling_plain_ms"],
        "bound_ms": tail_coupled["coupling_bound"][0],
        "bound_by": tail_coupled["coupling_bound"][1],
        "bound_share": tail_coupled["coupling_bound_share"],
        "library_ms": None,
        "torch_ops_ms": tail_coupled["coupling_torch_ops_ms"],
        "timed_at": "streamed_T20000: " + tail_coupled["shape"],
        "ms_at": {k: v["coupling_ms"] for k, v in tail_timed.items()
                  if "coupling_ms" in v},
        "cvar_call_ms_at": {k: v["cvar_ms"] for k, v in tail_timed.items()
                            if "coupling_ms" in v},
        "cvar_call_torch_ops_ms_at": {
            k: v["torch_ops_ms"] for k, v in tail_timed.items()
            if "coupling_ms" in v},
        "bound_ms_at": {k: v["coupling_bound"][0]
                        for k, v in tail_timed.items()
                        if "coupling_ms" in v},
        "cases": sum(r["case"] == "coupling_sums"
                     or r.get("T", 0) > cvar_costs.STAGED_T
                     for r in lifted_edge_results),
    }, {
        "name": "update_useq_wide",
        "route": "cuda",
        "kernel": "update_wide_min, _eta, _noise: the update past K = "
                  "32,768, three launches a call; update_useq_fused "
                  "routes to it",
        "launches_phase7": phase7["update_useq_wide"],
        "source": update_useq.WIDE_KERNEL_SOURCE,
        "replaces": update_useq.REPLACES,
        "launches": totals["update_useq_wide"],
        "launches_lifted_solves": lifted_launches["update_useq_wide"],
        "max_abs_err": max([r["max_abs_err"] for r in tail_results
                            if r["K"] > update_useq.FUSED_K]
                           + [r["max_abs_err"] for r in wide_update_results]),
        "ms": tail_big_k["update_ms"],
        "plain_ms": tail_big_k["update_plain_ms"],
        "bound_ms": tail_big_k["update_bound"][0],
        "bound_by": tail_big_k["update_bound"][1],
        "bound_share": tail_big_k["update_bound"][0] / tail_big_k["update_ms"],
        "library_ms": None,
        "timed_at": "wide_update_K1000000: " + tail_big_k["shape"],
        "ms_at": {k: tail_timed[k]["update_ms"] for k in tail_timed
                  if k.startswith("wide_update")},
        "bound_ms_at": {k: tail_timed[k]["update_bound"][0]
                        for k in tail_timed if k.startswith("wide_update")},
        "launch_us_at": {str(k): v for k, v in wide_launch_us.items()},
        "cases": sum(r["K"] > update_useq.FUSED_K for r in tail_results)
                 + len(wide_update_results),
    }, {
        "name": "barebone_rollout",
        "route": "cuda",
        "launches_phase7": phase7["barebone_rollout"],
        "source": barebone_rollout.KERNEL_SOURCE,
        "replaces": barebone_rollout.REPLACES,
        "launches": totals["barebone_rollout"],
        "launches_lifted_solves": sum(
            r["kernel_launches"]["barebone_rollout"]
            for name, r in lifted.items() if name.startswith("barebone")),
        "max_abs_err": max(r["max_abs_err"] for r in barebone_results),
        "ms": bb_at["ms"],
        "plain_ms": bb_at["plain_ms"],
        "bound_ms": bb_at["bound_ms"],
        "bound_by": bb_at["bound_by"],
        "library_ms": None,
        "timed_at": bb_at["shape"],
        "ms_at": {k: v["ms"] for k, v in barebone_timed.items()},
        "plain_ms_at": {k: v["plain_ms"] for k, v in barebone_timed.items()},
        "bound_ms_at": {k: v["bound_ms"] for k, v in barebone_timed.items()},
        "bound_share_at": {k: v["bound_share"]
                           for k, v in barebone_timed.items()},
        "barebone_kernels_per_replay": barebone["kernel_nodes"],
        "cases": len(barebone_results),
    }, *({
        "name": name,
        "route": "cuda",
        "kernel": kernel_desc,
        "launches_phase7": phase7[name],
        "source": vis_rollout.KERNEL_SOURCE,
        "replaces": vis_rollout.REPLACES,
        "launches": totals[name],
        "max_abs_err": max(r["max_abs_err"] for r in vis_results
                           if r["case"] == name),
        "ms": vis_timed[at]["kernel_in_graph_ms"],
        "plain_ms": vis_timed[at]["plain_ms"],
        "bound_ms": vis_timed[at]["bound_ms"],
        "bound_by": vis_timed[at]["bound_by"],
        "library_ms": None,
        "library": "none: no one PyTorch call computes the rollout",
        "latency_bound_ms": vis_timed[at]["latency_bound_ms"],
        "replay_ms": vis_timed[at]["ms"],
        "replay_device_ms": vis_timed[at]["replay_device_ms"],
        "launches_by_route": routes,
        "queue_250x250_T100": queue,
        "timed_at": "{}: V {} x T {}, 20 launches in one graph".format(
            at, vis_timed[at]["V"], vis_timed[at]["T"]),
        "kernels_per_replay": vis_timed[at]["kernels_per_replay"],
        "plain_kernels_per_replay": vis_timed[at][
            "plain_kernels_per_replay"],
        "ms_at": {w: r["kernel_in_graph_ms"] for w, r in worlds.items()},
        "replay_ms_at": {w: r["ms"] for w, r in worlds.items()},
        "replay_device_ms_at": {w: r["replay_device_ms"]
                                for w, r in worlds.items()},
        "other_route_ms_at": {w: [r["other_route"],
                                  r["other_route_kernel_ms"]]
                              for w, r in worlds.items()},
        "plain_ms_at": {w: r["plain_ms"] for w, r in worlds.items()},
        "bound_ms_at": {w: r["bound_ms"] for w, r in worlds.items()},
        "latency_bound_ms_at": {w: r["latency_bound_ms"]
                                for w, r in worlds.items()},
        "host_ms_at": {w: r["host_ms_median"] for w, r in worlds.items()},
        "cases": sum(r["case"] == name for r in vis_results),
    } for name, kernel_desc, at, worlds, routes, queue in (
        ("terrain_vis", "terrain_vis_kernel<unicycle | bicycle, shared | "
         "global>: the terrain planner's whole vis, a block a rollout, its "
         "grid (the shared route), controls and states staged in shared "
         "memory; get_terrain_vis launches it", "forest_140x84",
         {w: r for w, r in vis_timed.items() if w != "barebone"},
         vis_routes, {V: {k: r[k] for k in ("route", "shared_ms",
                                            "global_ms", "blocks_at_once",
                                            "waves")}
                      for V, r in vis_queue.items()}),
        ("barebone_vis", "barebone_vis_kernel: the barebone planner's "
         "whole vis, a warp a rollout, 32 steps at a time; "
         "get_barebone_vis launches it", "barebone",
         {"barebone": vis_timed["barebone"]}, None, None))), {
        "name": "update_useq",
        "route": "cuda",
        "launches_phase7": phase7["update_useq"],
        "source": update_useq.KERNEL_SOURCE,
        "replaces": update_useq.REPLACES,
        "launches": totals["update_useq"],
        "launches_sharded_world_size_1": ws1_launches.get(
            "update_useq_fused", 0),
        "launches_sharded_graph_replays": ws1_graph_launches.get(
            "update_useq_fused", 0),
        "max_abs_err": max(r["max_abs_err"] for r in tail_results),
        "ms": tail_at["update_ms"],
        "plain_ms": tail_at["update_plain_ms"],
        "bound_ms": tail_at["update_bound"][0],
        "bound_by": tail_at["update_bound"][1],
        "library_ms": None,
        "empty_node_ms": tail_at["empty_node_ms"],
        "timed_at": "a_static_205: " + tail_at["shape"],
        "ms_at": {k: v["update_ms"] for k, v in tail_timed.items()},
        "bound_ms_at": {k: v["update_bound"][0]
                        for k, v in tail_timed.items()},
        "cases": len(tail_results),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def make_sample_case(torch, dev, M, hw, window, B_lin, B_ang, alpha_dyn,
                     unnormalized, m_offset, seed):
    """Arguments of one map-sampling call: the (B, rH, rW) windows at
    ``window = (oy, ox, rH, rW)`` of random PMFs on an ``hw`` map, with
    columns summing below 100 inside the window where ``unnormalized`` is
    True, and of random int8 entries of any sign where it is "signed";
    bin values of any sign where "signed" or B > 101; rows
    ``[m_offset, m_offset + M)`` of the draw.  ``(args, kw)``."""
    rng = np.random.RandomState(seed)
    oy, ox, rH, rW = window
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731

    def pmf(B):
        if unnormalized == "signed":
            return t(rng.randint(-128, 128, size=(B, *hw)).astype(np.int8)[
                :, oy:oy + rH, ox:ox + rW])
        raw = rng.randint(0, 100, size=(B, *hw)).astype(float)
        raw[0] += 1.0
        p = (raw / raw.sum(0) * 100).astype(np.int8)
        p[-1] = 100 - p[:-1].sum(0)
        p = p[:, oy:oy + rH, ox:ox + rW]
        if unnormalized:
            p[:, :3, :7] = 0
            p[0, :3, :7] = rng.randint(0, 100, (3, 7))
        return t(p)

    def qbins(B):
        if unnormalized == "signed" or B > 101:
            return t(rng.randint(-128, 128, size=B).astype(np.int8))
        return t(np.sort(rng.choice(101, B, replace=False)).astype(np.int8))

    key = t(rng.randint(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.int64))
    args = (key, pmf(B_lin), pmf(B_ang), qbins(B_lin), qbins(B_ang),
            torch.tensor(alpha_dyn, dtype=torch.float32, device=dev), M)
    kw = dict(window=(hw, torch.tensor(oy, dtype=torch.int32, device=dev),
                      torch.tensor(ox, dtype=torch.int32, device=dev)),
              m_offset=m_offset,
              full_num_samples=M + m_offset if m_offset else None)
    return args, kw


def fused_case_maps(torch, args, seed):
    """``MapInputs`` of a fused map-sampling call: a sample case's PMF
    windows and bin values, and obstacle, unknown and risk windows of
    random int8 values of any sign (every bit of the shared words and of
    the byte words' high fields is exercised)."""
    from mppi_numba_tpu_torch.types import MapInputs

    key, lin, ang, lq, aq = args[:5]
    g = torch.Generator(device=lin.device).manual_seed(seed)
    planes = [torch.randint(-128, 128, tuple(lin.shape[1:]), generator=g,
                            device=lin.device, dtype=torch.int8)
              for _ in range(3)]
    return MapInputs(lin, ang, lq, aq, *planes)


FUSED_LAYOUTS = ("byte", "binned2", "binned", "binned8")


def check_fused_case(torch, fused, fplain, name, args, kw, maps):
    """``sample_and_pack_window`` against its plain version (the draw, then
    ``packing.pack_payload``: the parent's solve path), bit for bit, in
    every layout, with and without the risk plane and the ang plane.
    Prints the entries differing per output, and returns the record."""
    key, alpha, M = args[0], args[5], args[6]
    differing, err = {}, 0
    for layout in FUSED_LAYOUTS:
        for ang in (True, False):
            m = maps if ang else maps._replace(ang_pmf=None, ang_qbins=None)
            for risk in (False, True):
                got = fused(key, m, alpha, M, layout, risk=risk, **kw)
                want = fplain(key, m, alpha, M, layout, risk=risk, **kw)
                torch.cuda.synchronize()
                names = (["words"] if layout == "byte"
                         else ["cells", "mask", "risk_words"])
                outs = {}
                for out, g, w in zip(
                        names + ["lin_grids", "ang_grids"],
                        (list(got[0]) if layout != "byte" else [got[0]])
                        + [got[1], got[2]],
                        (list(want[0]) if layout != "byte" else [want[0]])
                        + [want[1], want[2]]):
                    if g is None or w is None:
                        check(g is None and w is None, "map_sample {} {}: "
                              "{} given by one version only".format(
                                  name, layout, out))
                        continue
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          "map_sample {} {}: {} {} {} against {} {}".format(
                              name, layout, out, g.dtype, tuple(g.shape),
                              w.dtype, tuple(w.shape)))
                    outs[out] = int((g != w).sum())
                    err = max(err, float((g.to(torch.int64)
                                          - w.to(torch.int64)).abs().max()))
                differing["{}_ang{}_risk{}".format(layout, int(ang),
                                                   int(risk))] = outs
                del got, want
    res = dict(case="map_sample_pack_" + name, M=M,
               window=list(maps.obstacle.shape), combinations=len(differing),
               entries_differing=differing, max_abs_err=err)
    print(json.dumps(res), flush=True)
    bad = {k: v for k, v in differing.items() if any(v.values())}
    check(not bad, "map_sample {}: the fused kernel differs from its plain "
          "version: {}".format(name, bad))
    return res


def check_known_uniforms(torch, dev, sampler):
    """``KNOWN_UNIFORMS`` on the card: the plain draw's bits, and the
    kernel's rank over 100 bins of 1% each, ``ceil(100 u) - 1``."""
    from mppi_numba_tpu_torch.ops.sampling import uniform_window

    M, H, W = KNOWN_UNIFORMS_SHAPE
    pmf = torch.ones((100, H, W), dtype=torch.int8, device=dev)
    q = torch.arange(100, dtype=torch.int8, device=dev)
    checked = 0
    for words, points in KNOWN_UNIFORMS:
        key = torch.tensor(words, dtype=torch.int64, device=dev)
        u = uniform_window(key, M, (H, W), 0, 0, (H, W)).reshape(M, H, W)
        bins = sampler(key, pmf, pmf, q, q,
                       torch.tensor(1.0, device=dev), M)[0]
        for (m, y, x), bits, rank in points:
            got = (int(u[m, y, x].view(torch.int32)), int(bins[m, y, x]))
            check(got == (bits, rank), "known answer at key {} {}: got "
                  "{}, expected {}".format(words, (m, y, x), got,
                                           (bits, rank)))
            checked += 1
    print(json.dumps(dict(check="map_sample_known_answers",
                          values=checked)), flush=True)


def crop_case_inputs(torch, dev, H, W, B_lin, B_ang, res, lim0, seed):
    """A crop-mode case's map and task: PMF columns summing to 100 (one
    summing below), bin values of any sign, obstacle, unknown and risk
    planes of random int8 of any sign, the padded origin at ``lim0``."""
    from mppi_numba_tpu_torch.types import MapInputs, TerrainTask

    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731

    def pmf(B):
        p = random_pmf(rng, B, H, W)
        p[:, 1, 2] = 0
        return t(p)

    plane = lambda: t(rng.randint(-128, 128, (H, W)).astype(np.int8))  # noqa: E731
    maps = MapInputs(pmf(B_lin), pmf(B_ang),
                     t(rng.randint(-128, 128, B_lin).astype(np.int8)),
                     t(rng.randint(-128, 128, B_ang).astype(np.int8)),
                     plane(), plane(), plane())
    f32 = np.float32
    task = TerrainTask(*[t(f32(0.0))] * 20)._replace(
        res=t(f32(res)), xlim0=t(f32(lim0)), ylim0=t(f32(lim0)),
        alpha_dyn=t(f32(1.0)))
    key = t(rng.randint(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.int64))
    return key, maps, task


def crop_positions(H, W, res, lim0, scan):
    """Robot positions (x, y) for the crop mode: with ``scan``, x at every
    cell edge of a row, a float32 ulp either side, and off the map (y
    along a row's edges too); else near each edge of the map, at its
    centre, on a cell edge by it, an ulp either side, and off the map."""
    f32 = np.float32
    if scan:
        edges = (lim0 + res * np.arange(-2, W + 2)).astype(f32)
        xs = np.concatenate([edges, np.nextafter(edges, f32(-np.inf)),
                             np.nextafter(edges, f32(np.inf)),
                             f32([-1e4, 1e4])])
        ys = np.roll(xs, 7)
        return list(zip(xs, ys))
    cx, cy = lim0 + res * W / 2, lim0 + res * H / 2
    edge = f32(lim0 + res * (W // 2 + 3))
    return [(f32(lim0 + 0.3 * res), f32(cy)),
            (f32(lim0 + (W - 0.3) * res), f32(cy)),
            (f32(cx), f32(lim0 + 0.3 * res)),
            (f32(cx), f32(lim0 + (H - 0.3) * res)),
            (f32(cx + 0.1 * res), f32(cy - 0.2 * res)),
            (edge, edge), (np.nextafter(edge, f32(-np.inf)), edge),
            (np.nextafter(edge, f32(np.inf)), edge),
            (f32(-1e4), f32(1e4))]


def check_crop_mode(torch, dev, cropper, cplain, name, H, W, rH, rW, B_lin,
                    B_ang, res, lim0, Ms, scan, seed):
    """The map-sampling kernel's crop mode against its plain version on an
    (H, W) map whose padded origin is ``lim0`` on both axes: payload,
    grids, offset and shifted limits bit for bit, in every payload layout
    (``Ms[layout]`` map samples, else 4), with and without the risk plane,
    at each of ``crop_positions``.  Returns the case's record, with the
    main path layout's arguments at the first position under
    ``timed_args``."""
    key, maps, task = crop_case_inputs(torch, dev, H, W, B_lin, B_ang, res,
                                       lim0, seed)
    differ, err, combos, offsets, timed = 0, 0.0, 0, set(), None
    positions = crop_positions(H, W, res, lim0, scan)
    for x, y in positions:
        pos = task._replace(x0=torch.tensor([x, y, 0.0], device=dev))
        for layout in FUSED_LAYOUTS:
            M = Ms.get(layout, 4)
            for risk in (False, True):
                got = cropper(key, maps, pos, M, layout, (rH, rW), risk=risk)
                want = cplain(key, maps, pos, M, layout, (rH, rW), risk=risk)
                pairs = [(g, w) for g, w in zip(
                    flat_payload(got), flat_payload(want))
                    if g is not None or w is not None]
                check(all(g is not None and w is not None
                          for g, w in pairs),
                      "crop mode {}: an output is missing".format(name))
                pairs += [(got[3].xlim0, want[3].xlim0),
                          (got[3].ylim0, want[3].ylim0), (got[4], want[4])]
                differ += sum(int((g.reshape(-1) != w.reshape(-1)).sum())
                              for g, w in pairs)
                err = max([err] + [float((g.double() - w.double()).abs()
                                         .max()) for g, w in pairs])
                combos += 1
                offsets.add(tuple(want[4].tolist()))
                if timed is None and layout in Ms:
                    timed = (key, maps, pos, M, layout, (rH, rW))
    res_crop = dict(case="map_sample_crop_" + name, map="{}x{}".format(H, W),
                    window=[rH, rW], bins=[B_lin, B_ang], res=res,
                    padded_origin=lim0, positions=len(positions),
                    combinations=combos, distinct_offsets=len(offsets),
                    entries_differing=differ, max_abs_err=err)
    print(json.dumps(res_crop), flush=True)
    check(differ == 0, "crop mode {}: {} entries differ from the plain "
          "version".format(name, differ))
    check(len(offsets) > 2, "crop mode {}: the window did not move: {}"
          .format(name, offsets))
    return dict(res_crop, timed_args=timed)


def check_crop_m_slices(torch, dev, cropper, cplain, name, H, W, rH, rW,
                        bins, res, lim0, M, a, b, seed):
    """The crop mode's rows [a, b) of an M-row draw (``m_offset = a``,
    ``full_num_samples = M``) against its plain version and against the
    same rows of the kernel's whole M-row draw: payload planes, grids,
    shared words, offset and limits bit for bit, every layout x risk."""
    key, maps, task = crop_case_inputs(torch, dev, H, W, bins, bins, res,
                                       lim0, seed)
    task = task._replace(x0=torch.tensor(
        [lim0 + 0.4 * W * res, lim0 + 0.55 * H * res, 0.0], device=dev))
    differ, err, combos = 0, 0.0, 0
    for layout in FUSED_LAYOUTS:
        for risk in (False, True):
            args = (key, maps, task)
            kw = dict(risk=risk, m_offset=a, full_num_samples=M)
            got = cropper(*args, b - a, layout, (rH, rW), **kw)
            want = cplain(*args, b - a, layout, (rH, rW), **kw)
            whole = cropper(*args, M, layout, (rH, rW), risk=risk)
            rows = flat_payload(whole)
            # The per-sample planes and the grids are rows of the whole
            # draw; the shared mask and risk words are the whole draw's.
            m_axis = -3 if layout == "byte" else -2
            rows[0] = rows[0].narrow(m_axis, a, b - a)
            rows[-2] = rows[-2].narrow(-3, a, b - a)
            rows[-1] = rows[-1].narrow(-3, a, b - a)
            for other in (want, None):
                ref = rows if other is None else flat_payload(other)
                pairs = [(g, w) for g, w in zip(flat_payload(got), ref)
                         if g is not None or w is not None]
                check(all(g is not None and w is not None
                          for g, w in pairs),
                      "crop m slice {}: an output is missing".format(name))
                o = whole if other is None else other
                pairs += [(got[3].xlim0, o[3].xlim0),
                          (got[3].ylim0, o[3].ylim0), (got[4], o[4])]
                differ += sum(int((g.reshape(-1) != w.reshape(-1)).sum())
                              for g, w in pairs)
                err = max([err] + [float((g.double() - w.double()).abs()
                                         .max()) for g, w in pairs])
            combos += 1
    rec = dict(case="map_sample_crop_" + name, map="{}x{}".format(H, W),
               window=[rH, rW], bins=bins, M=M, rows=[a, b],
               combinations=combos, entries_differing=differ,
               max_abs_err=err)
    print(json.dumps(rec), flush=True)
    check(differ == 0, "crop m slice {}: {} entries differ".format(
        name, differ))
    return rec


def flat_payload(out):
    """A fused call's ``(payload, lin_grids, ang_grids, ...)`` as a flat
    list of its payload tensors and grids (Nones kept)."""
    payload, lin, ang = out[:3]
    return [*(payload if isinstance(payload, tuple) else (payload,)), lin,
            ang]


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

    def plain_rollout(words, task, u, noise, skip=None):
        v_all, w_all = _clipped_controls_tk(u, noise, task.vrange,
                                            task.wrange)
        return plain(words, build_task_vec(task), v_all.contiguous(),
                     w_all.contiguous(), H=H, W=W, T=T, fast_trig=True,
                     skip=skip)

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


def sweep_problem(K=1024, M=1024):
    """The reference benchmark's world, Config and params
    (``scripts/run_full_benchmark.py::build_problem``), through the ported
    ``benchmark`` module; the world is built anew each call (its densities
    hold a stateful RandomState)."""
    from mppi_numba_tpu_torch import Config, benchmark

    world = benchmark.make_benchmark_world(num_bins=20,
                                           rng=np.random.RandomState(0))
    cfg = Config(T=10.0, dt=0.1, num_grid_samples=M, num_control_rollouts=K,
                 max_speed_padding=5.0, num_vis_state_rollouts=50,
                 max_map_dim=(15, 15), seed=1, use_tdm=True)
    params = benchmark.default_benchmark_params(cfg, SWEEP_GRID, SWEEP_MARGIN)
    params["u_std"] = np.array([2.0, 3.0])
    return world, cfg, params


def sweep_args(**kw):
    """The positional arguments of ``benchmark.run_trials_device_rows`` /
    ``run_trials_rows`` for the reference protocol at one alpha (world
    rebuilt), and its keyword defaults updated by ``kw``."""
    world, cfg, params = sweep_problem()
    args = (cfg, world, SWEEP_MAX_STEPS, SWEEP_GRID, SWEEP_MARGIN, SWEEP_RES,
            params, SWEEP_DENSITIES, SWEEP_ENVS, SWEEP_TRIALS, [SWEEP_ALPHA])
    return args, dict(dict(verbose=False, device="cuda"), **kw)


def sweep_chunk(method, B, K=1024, M=1024):
    """The first B episodes of the sweep at ``SWEEP_ALPHA``
    (``benchmark.DeviceSweep``): ``(static, maps, task, gt)``."""
    from mppi_numba_tpu_torch import benchmark

    world, cfg, params = sweep_problem(K, M)
    sweep = benchmark.DeviceSweep(
        cfg, world, SWEEP_GRID, SWEEP_MARGIN, SWEEP_RES, params,
        SWEEP_DENSITIES, SWEEP_ENVS, SWEEP_TRIALS, device="cuda")
    _, static, maps, task = sweep.inputs(method, SWEEP_ALPHA)

    def first(tree):
        return type(tree)(*(None if x is None else x[:B] for x in tree))

    return static, first(maps), first(task), tuple(g[:B] for g in sweep.gt)


def stack_scenarios(torch, parts):
    """Per-scenario arguments (tensors, NamedTuples, tuples) stacked on a
    new leading scenario axis; anything else (None, ints) the first's."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    if hasattr(first, "_replace"):
        return type(first)(*(stack_scenarios(torch, list(f))
                             for f in zip(*parts)))
    if isinstance(first, tuple):
        return tuple(stack_scenarios(torch, list(f)) for f in zip(*parts))
    return first


def bits_differing(torch, got, want):
    """Entries that differ between two results (tensors through tuples and
    NamedTuples; None must match None: a mismatch counts 1)."""
    if isinstance(got, tuple):
        return sum(bits_differing(torch, g, w) for g, w in zip(got, want))
    if got is None or want is None:
        return int((got is None) != (want is None))
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel(), 1)
    return int((got != want).sum())


def scenario_sample_cases(torch, dev, M, hw, rwin, bins, seed):
    """SCENARIOS map-sampling cases of one shape (windows of ``rwin``
    cells of an ``hw`` map), each with its own key, PMFs, bin values,
    alpha_dyn and window offset: ``[(args, kw)]``."""
    rH, rW = rwin
    out = []
    for s, alpha in zip(range(SCENARIOS), (1.0, 0.2, 0.6)):
        oy, ox = min(s * 3, hw[0] - rH), min(s * 5, hw[1] - rW)
        out.append(make_sample_case(torch, dev, M, hw, (oy, ox, rH, rW),
                                    bins, bins, alpha, s == 1, 0, seed + s))
    return out


def check_scenario_sampling(torch, dev, sampler, splain, fused, fplain,
                            name, cases, layouts):
    """Window mode with a scenario axis: the scenarios of ``cases`` in one
    launch against the single launches and against the batched plain
    version, bit for bit, in the bins mode and each payload layout of
    ``layouts`` with and without the risk plane.  Returns the record."""
    M = cases[0][0][6]
    kw0 = cases[0][1]
    keys = stack_scenarios(torch, [a for a, _ in cases])
    window = (kw0["window"][0],
              *(torch.stack([kw["window"][i] for _, kw in cases])
                for i in (1, 2)))
    maps_each = [fused_case_maps(torch, a, 7 + i)
                 for i, (a, _) in enumerate(cases)]
    maps = stack_scenarios(torch, maps_each)
    differ, combos = {}, 0
    for layout in ("bins",) + tuple(layouts):
        for risk in ((False,) if layout == "bins" else (False, True)):
            if layout == "bins":
                args = (*keys[:6], M)
                got = sampler(*args, window=window)
                want = splain(*args, window=window)
                single = stack_scenarios(torch, [
                    sampler(*a, window=kw["window"]) for a, kw in cases])
            else:
                got = fused(keys[0], maps, keys[5], M, layout, risk=risk,
                            window=window)
                want = fplain(keys[0], maps, keys[5], M, layout, risk=risk,
                              window=window)
                single = stack_scenarios(torch, [
                    fused(a[0], m, a[5], M, layout, risk=risk,
                          window=kw["window"])
                    for (a, kw), m in zip(cases, maps_each)])
            torch.cuda.synchronize()
            differ["{}_risk{}".format(layout, int(risk))] = [
                bits_differing(torch, got, want),
                bits_differing(torch, got, single)]
            combos += 1
    res = dict(case="map_sample_scenarios_" + name, scenarios=len(cases),
               M=M, window=list(cases[0][0][1].shape[1:]),
               combinations=combos, entries_differing_plain_single=differ)
    print(json.dumps(res), flush=True)
    bad = {k: v for k, v in differ.items() if any(v)}
    check(not bad, "map_sample scenarios {}: the batched launch differs "
          "(from the plain version, from the single launches): {}".format(
              name, bad))
    return res


def check_scenario_crop(torch, dev, cropper, cplain, name, H, W, rH, rW,
                        bins, res, lim0, M, seed):
    """Crop mode with a scenario axis: SCENARIOS robots (near an edge, at
    the centre, off the map), each with its own map, key and alpha_dyn, in
    one launch against the single launches and the batched plain version,
    bit for bit (payload, grids, offsets, limits), every payload layout
    with and without the risk plane.  Returns the record."""
    cases = []
    for s, ((x, y), alpha) in enumerate(zip(
            [(lim0 + 0.3 * res, lim0 + 0.6 * H * res),
             (lim0 + 0.55 * W * res, lim0 + 0.45 * H * res), (-1e4, 1e4)],
            (1.0, 0.4, 0.8))):
        key, maps, task = crop_case_inputs(torch, dev, H, W, bins, bins, res,
                                           lim0, seed + s)
        task = task._replace(
            x0=torch.tensor([x, y, 0.0], dtype=torch.float32, device=dev),
            alpha_dyn=torch.tensor(alpha, dtype=torch.float32, device=dev))
        cases.append((key, maps, task))
    key, maps, task = (stack_scenarios(torch, [c[i] for c in cases])
                       for i in range(3))
    differ, offsets = {}, None
    for layout in FUSED_LAYOUTS:
        for risk in (False, True):
            got = cropper(key, maps, task, M, layout, (rH, rW), risk=risk)
            want = cplain(key, maps, task, M, layout, (rH, rW), risk=risk)
            single = stack_scenarios(torch, [
                cropper(k, m, t, M, layout, (rH, rW), risk=risk)
                for k, m, t in cases])
            torch.cuda.synchronize()

            def parts(out):
                return (out[0], out[1], out[2], out[3].xlim0, out[3].ylim0,
                        out[4])

            differ["{}_risk{}".format(layout, int(risk))] = [
                bits_differing(torch, parts(got), parts(want)),
                bits_differing(torch, parts(got), parts(single))]
            offsets = [tuple(o) for o in got[4].tolist()]
    record = dict(case="map_sample_crop_scenarios_" + name,
                  scenarios=len(cases), M=M, map="{}x{}".format(H, W),
                  window=[rH, rW], offsets=offsets,
                  combinations=len(differ),
                  entries_differing_plain_single=differ)
    print(json.dumps(record), flush=True)
    bad = {k: v for k, v in differ.items() if any(v)}
    check(not bad, "crop scenarios {}: the batched launch differs (from "
          "the plain version, from the single launches): {}".format(
              name, bad))
    check(len(set(offsets)) == len(cases), "crop scenarios {}: offsets {}"
          .format(name, offsets))
    return record


def check_batched_solve_step(torch, dev, fused, scenario):
    """One batched solve of a sweep chunk (noisy_dyn, SWEEP_CHUNK episodes,
    M = K = 1024) against its solves made one at a time from the same map
    keys and noise: the map draw's payload and grids and the rollout's
    costs bit for bit, u within rtol 2e-4 / atol 2e-5 (the CVaR sort and
    the softmax's sums run batched).  Its launches are comparisons and are
    not counted.  Returns the record."""
    from mppi_numba_tpu_torch.graphs import counted_wrappers
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    static, maps, task, _ = sweep_chunk("noisy_dyn", SWEEP_CHUNK)
    counts = [(w, w.launches) for w in counted_wrappers()]
    solver = get_terrain_solver(static, dev)
    B, K, T = SWEEP_CHUNK, static.num_control_rollouts, static.num_steps
    M = static.num_grid_samples
    g = torch.Generator(device=dev).manual_seed(5)
    keys = torch.randint(0, 2 ** 32, (B, 2), generator=g, device=dev)
    eps = torch.randn((B, K, T, 2), generator=g, device=dev)
    u0 = torch.rand((B, T, 2), generator=g, device=dev) - 0.2
    u_b, aux_b = solver.solve_from_key(keys, [eps], maps, task, u0)
    words_b = fused(keys, maps, task.alpha_dyn, M, "byte")[0]
    noise = eps * task.u_std[:, None, None, :]
    costs_b = solver._rollout(words_b, task, u0, noise)
    worst = 0.0
    for b in range(B):
        mb, tb = scenario(maps, b), scenario(task, b)
        u_s, aux_s = solver.solve_from_key(keys[b], [eps[b]], mb, tb, u0[b])
        words_s = fused(keys[b], mb, tb.alpha_dyn, M, "byte")[0]
        costs_s = solver._rollout(words_s, tb, u0[b], noise[b])
        check(torch.equal(words_b[b], words_s)
              and torch.equal(aux_b.lin_grids[b], aux_s.lin_grids)
              and torch.equal(aux_b.ang_grids[b], aux_s.ang_grids)
              and torch.equal(costs_b[b], costs_s),
              "batched solve: scenario {}'s kernel outputs differ from its "
              "single solve's".format(b))
        check(bool(torch.allclose(u_b[b], u_s, rtol=2e-4, atol=2e-5)),
              "batched solve: scenario {}'s u differs from its single "
              "solve's by {}".format(b, float((u_b[b] - u_s).abs().max())))
        worst = max(worst, float((u_b[b] - u_s).abs().max()))
    for w, n in counts:
        w.launches = n
    res = dict(check="batched_solve_step", scenarios=B, K=K, M=M, T=T,
               kernel_outputs_bitwise=True, u_max_abs_diff=worst,
               rtol=2e-4, atol=2e-5)
    print(json.dumps(res), flush=True)
    return res


def skip_mask(torch, dev, B, n, seed=0):
    """A ``(B,)`` bool skip mask with ``n`` scenarios marked, picked by a
    seeded permutation."""
    mask = torch.zeros(B, dtype=torch.bool)
    mask[torch.randperm(B, generator=torch.Generator().manual_seed(seed))
         [:n]] = True
    return mask.to(dev)


def check_skip_masks(torch, dev, cases):
    """Phase 2's skip-mask cases: each ``(name, kernel, plain, args, kw)``
    launched with none, some and all of its scenarios marked, bit for bit
    against the masked plain version, its unmarked scenarios against the
    unmasked launch and its marked ones zeros.  Returns the records."""
    records = []
    for name, kernel, plain, args, kw in cases:
        B = args[0].shape[0]
        full = kernel(*args, **kw)
        for n in (0, B // 3, B):
            skip = skip_mask(torch, dev, B, n, seed=n)
            before = kernel.launches
            got = kernel(*args, skip=skip, **kw)
            want = plain(*args, skip=skip, **kw)
            torch.cuda.synchronize()
            rec = dict(case="skip_mask_" + name, scenarios=B, skipped=n,
                       launches=kernel.launches - before,
                       plain_differing=int((got != want).sum()),
                       unmasked_differing=int((got[~skip]
                                               != full[~skip]).sum()),
                       skipped_nonzero=int((got[skip] != 0).sum()))
            print(json.dumps(rec), flush=True)
            check(rec["launches"] == 1 and not rec["plain_differing"]
                  and not rec["unmasked_differing"]
                  and not rec["skipped_nonzero"],
                  "skip mask {}: {}".format(name, rec))
            records.append(rec)
            del got, want
        del full
    return records


def time_skip_masks(torch, dev, time_kernels, kernel, st, emit):
    """Phase 4: the sweep's B = 30 byte launch with ``SKIP_COUNTS`` of its
    scenarios skipped, and without a mask, in turns, each over launches
    captured in a CUDA graph; beside each, (30 - n) / 30 of the unmasked
    launch, and the excess over it.  Returns ``{n: ms}`` (``None``: no
    mask)."""
    B = st["words"].shape[0]
    masks = {n: skip_mask(torch, dev, B, n, seed=n) for n in SKIP_COUNTS}
    masks[None] = None
    fns = {n: (lambda m=m: kernel(st["words"], st["tv"], st["v"], st["w"],
                                  skip=m, **st["kw"]))
           for n, m in masks.items()}
    runs = time_kernels(fns, 3)
    full = min(runs[None]["graph"])
    out = {}
    for n in masks:
        ms = min(runs[n]["graph"])
        out[n] = ms
        share = None if n is None else full * (B - n) / B
        emit("rollout_skip_mask_ms", ms, "ms", scenarios=B, skipped=n,
             runs=runs[n]["graph"], eager_runs=runs[n]["eager"],
             unmasked_ms=full, active_share_ms=share,
             over_active_share_ms=None if n is None else ms - share)
    return out


def check_checkpoint_round_trip(torch):
    """``checkpoint.save_planner_state`` / ``load_planner_state`` on a
    planner whose solves replay a CUDA graph (world (g), tdm): saved after
    three closed-loop solves, the next solve bit for bit from the planner
    restored in place (after another solve) and from a fresh planner (its
    graph captured before the load)."""
    import os
    import tempfile
    from mppi_numba_tpu_torch import checkpoint

    planner, _, _ = setup_world("benchmark_9x9_tdm")
    x = np.array(planner.params["x0"], dtype=float)
    for _ in range(3):
        u = planner.solve()
        x = x + 0.1 * np.array([u[0, 0] * np.cos(x[2]),
                                u[0, 0] * np.sin(x[2]), u[0, 1]])
        planner.shift_and_update(x, u)
    fd, path = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    try:
        checkpoint.save_planner_state(planner, path)
        want = planner.solve()
        planner.solve()
        checkpoint.load_planner_state(planner, path)
        again = planner.solve()
        fresh, _, _ = setup_world("benchmark_9x9_tdm")
        fresh.solve()
        checkpoint.load_planner_state(fresh, path)
        other = fresh.solve()
    finally:
        os.remove(path)
    check(np.array_equal(again, want) and np.array_equal(other, want)
          and len(planner._solve_graphs) == len(fresh._solve_graphs) == 1,
          "checkpoint: the restored planners' next solves differ by {} / "
          "{}".format(float(np.abs(again - want).max()),
                      float(np.abs(other - want).max())))
    return dict(check="checkpoint_round_trip", solves_before_save=3,
                graphed=True, next_solve_bitwise=True)


def time_sweep_chunk(torch, device_sim, static, maps, task, gt):
    """One chunk of sweep episodes, in turns: the batch engine's first call
    (its capture and its run), its second call (replays only), and the
    in-turn engine (one ``make_device_trial`` a scenario, each capturing
    its graph on its first call) over the same episodes; host seconds,
    each ending in a synchronize, and the share of the batch's scenario
    solves whose rollouts the skip mask took off.  Returns the record."""
    from mppi_numba_tpu_torch.types import scenario

    B = task.x0.shape[0]
    dev = task.x0.device

    def batched():
        engine = device_sim.make_device_trial_batch(static,
                                                    SWEEP_MAX_STEPS)
        g = torch.Generator(device=dev)
        times = []
        for _ in range(2):
            g.manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine(g, maps, task, *gt)
            out.steps.cpu()
            times.append(time.perf_counter() - t0)
        return (times, engine.steps_run, int(out.success.sum()),
                engine.skipped_solves)

    def in_turn():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        for b in range(B):
            trial = device_sim.make_device_trial(static, SWEEP_MAX_STEPS)
            out = trial(torch.Generator(device=dev).manual_seed(1 + b),
                        scenario(maps, b), scenario(task, b),
                        *(x[b] for x in gt))
            steps += int(out.steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, steps

    b1, turn1, turn2, b2 = batched(), in_turn(), in_turn(), batched()
    first = [b1[0][0], b2[0][0]]
    replay = [b1[0][1], b2[0][1]]
    turns = [turn1[0], turn2[0]]
    return dict(batched_episodes_per_s=B / min(replay),
                batched_replay_s=replay, batched_first_call_s=first,
                capture_s=[f - r for f, r in zip(first, replay)],
                batched_steps=b1[1], batched_successes=b1[2],
                batched_skipped_solves=b1[3],
                batched_skip_share=b1[3] / (B * b1[1]),
                in_turn_episodes_per_s=B / min(turns), in_turn_s=turns,
                in_turn_steps=[turn1[1], turn2[1]],
                in_turn_captures=B, batched_captures=1)


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


def setup_world(world, crop=True, padded_origin=0.0, T=10.0, M=1024):
    """A planner set up on ``world`` through the public entry points, and
    the ground truth its closed loop runs on: ``(planner, truth, goal)``
    where ``truth(x, y) -> (lin, ang)`` tractions (for the big-map world a
    ``TractionGrid``, whose ``get`` is that).  ``crop=False`` turns the
    reachable-window crop off, as ``tests/test_roi.py`` does;
    ``padded_origin`` places the big map's padded lower limits.  ``T``
    (seconds of 0.1 s steps) and ``M`` (map samples, set on the Config
    after it is made where it passes the Config's 15,000, as its message
    invites) size the solve."""
    from mppi_numba_tpu_torch import Config, MPPIPlanner, TDM
    from mppi_numba_tpu_torch.terrain import sample_realization_from_pmf_grid

    mode = WORLDS[world][0]
    model = "bicycle" if world.endswith("_bicycle") else "unicycle"
    det_alpha = 0.2
    params = dict(dt=0.1, goal_tolerance=0.5, v_post_rollout=0.01,
                  cvar_alpha=0.2 if mode == "tdm" else 1.0,
                  alpha_dyn=1.0 if mode == "tdm" else det_alpha,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([2.0, 3.0]), vrange=np.array([0.0, 3.0]),
                  wrange=np.array([-3.14, 3.14]))
    if model == "bicycle":
        # (v, steering angle): a vehicle's steering range and spread.
        params.update(u_std=np.array([2.0, 0.5]),
                      wrange=np.array([-STEER, STEER]))
    flags = dict(use_tdm=mode == "tdm", use_det_dynamics=mode == "det_dyn",
                 use_nom_dynamics_with_speed_map=mode == "speed_map",
                 use_costmap=mode == "costmap")
    cfg = Config(T=T, dt=0.1, num_grid_samples=M,
                 num_control_rollouts=1024, max_speed_padding=5.0,
                 max_map_dim=(250, 250), seed=0, model=model, **flags)
    cfg.num_grid_samples = M
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
    elif world == BIGMAP:
        rows = 248                               # padded to 250 x 250
        pmf = random_pmf(np.random.RandomState(0), BIGMAP_BINS, rows, rows)
        bin_values = np.linspace(0.0, 1.0, BIGMAP_BINS)
        res = BIGMAP_RES
        # The padded map's origin at 0 by default, as
        # scripts/bigmap_bench.py's task has it: a rollout's x - xlim0 is
        # then exact in the full map's frame and in the window's (a
        # multiple of res less), so the two solves see the same cells and
        # the crop is exact.  At -res (limits from 0) it need not be.
        lim = (padded_origin + res, padded_origin + res + rows * res)
        lin.set_TDM_from_PMF_grid(pmf, dict(
            res=res, xlimits=lim, ylimits=lim, bin_values=bin_values,
            bin_values_bounds=np.array([0.0, 1.0]),
            det_dynamics_cvar_alpha=1.0))
        ang.set_TDM_from_PMF_grid(pmf, dict(
            res=res, xlimits=lim, ylimits=lim, bin_values=bin_values,
            bin_values_bounds=np.array([0.0, 1.0]),
            det_dynamics_cvar_alpha=1.0))
        params["vrange"] = np.array([0.0, BIGMAP_VMAX])
        mid = (lim[0] + lim[1]) / 2
        # The map's centre, 5 cm short of a cell edge on each axis, so that
        # the window moves within the first solves.
        x0 = np.array([mid + 0.45, mid + 0.45, 0.785])
        goal = np.array([lim[1] - 2.0, lim[1] - 2.0])
        truth = sample_realization_from_pmf_grid(
            pmf, pmf, bin_values, np.random.RandomState(1), res=res,
            xlimits=lim, ylimits=lim)
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
        from mppi_numba_tpu_torch.benchmark import (make_benchmark_world,
                                                    make_semantic_grid)
        rng = np.random.RandomState(1)
        bw = make_benchmark_world(num_bins=20, rng=rng)
        sg = make_semantic_grid((9, 9), 1, 0.4, rng)
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
    if not crop:
        planner._roi_shape = lambda hw: None
    planner.setup(params, lin, ang)
    if world == BIGMAP:
        return planner, truth, goal
    rows, cols = mean_lin.shape

    def truth(x, y):
        ci = int(np.clip(x // res, 0, cols - 1))
        ri = int(np.clip(y // res, 0, rows - 1))
        return mean_lin[ri, ci], mean_ang[ri, ci]

    return planner, truth, goal


def run_planner(world, solves=SOLVES, **shape):
    """``solves`` closed-loop solves of ``world`` through the planner's
    public entry points (the big-map world's through ``sim.trial``);
    ``shape``: ``setup_world``'s T and M."""
    planner, truth, goal = setup_world(world, **shape)
    static = planner._static()
    bicycle = static.model == "bicycle"
    check(static.fast_trig != bicycle, "{}: fast_trig {} for the {} model"
          .format(world, static.fast_trig, static.model))
    x = np.asarray(planner.params["x0"], dtype=float).copy()
    dist0 = float(np.hypot(*(goal - x[:2])))
    dt = planner.dt
    times = []
    trial_info = {}
    sample_grids_calls = 0
    mirror = EagerMirror(planner)
    if world == BIGMAP:
        x, trial_info = run_bigmap_trial(planner, truth, times, mirror)
        check_sample_grids(planner.lin_tdm)
        sample_grids_calls = 1
    for _ in range(solves if world != BIGMAP else 0):
        mirror.before_solve()
        t0 = time.perf_counter()
        u = planner.solve()
        times.append((time.perf_counter() - t0) * 1e3)
        mirror.after_solve(u, world)
        check(u is not None and u.shape == (planner.num_steps, 2)
              and np.isfinite(u).all(), "{}: bad controls".format(world))
        check(not planner.det_dyn or planner.u_prev is planner.u_cur,
              "{}: u_prev does not alias the solved controls".format(world))
        lin_tr, ang_tr = truth(x[0], x[1])
        v, w = float(u[0, 0]), float(u[0, 1])
        rate = v * np.tan(w) / WHEELBASE if bicycle else w
        x = x + dt * np.array([lin_tr * v * np.cos(x[2]),
                               lin_tr * v * np.sin(x[2]), ang_tr * rate])
        planner.shift_and_update(x, u, num_shifts=1)
    vis_shape = check_state_rollout(world, planner, x, mirror)
    check(mirror.solves == solves, "{}: {} solves held against eager ones"
          .format(world, mirror.solves))
    return dict(solves=solves, num_opt=static.num_opt, vis_shape=vis_shape,
                solve_ms_first=times[0],
                solve_ms_median=float(np.median(times[1:])),
                K=planner.num_control_rollouts, T=planner.num_steps,
                map="{}x{}".format(*static.map_shape),
                fast_trig=static.fast_trig, dist0=dist0,
                dist_end=float(np.hypot(*(goal - x[:2]))),
                planner=planner, static=static, trial=trial_info,
                sample_grids_calls=sample_grids_calls,
                kernel_nodes=max(g.kernel_nodes
                                 for g in planner._solve_graphs.values()))


def check_sample_grids(tdm):
    """``TDM.sample_grids`` on the card: one map draw through the sampling
    kernel under the key the TDM's own generator gives, equal bit for bit
    to the plain version under the same key."""
    import torch
    from mppi_numba_tpu_torch.ops.kernels.map_sample import (
        sample_traction_window_plain)
    from mppi_numba_tpu_torch.ops.sampling import draw_map_key

    g = torch.Generator(device=tdm.device)
    g.set_state(tdm._generator.get_state())
    grids = tdm.sample_grids(alpha_dyn=0.5)
    want = sample_traction_window_plain(
        draw_map_key(g, tdm.device), tdm.pmf_grid_device, None,
        tdm.qbin_values, None, torch.tensor(0.5, device=tdm.device),
        tdm.batch_size)[2]
    check(grids.shape == want.shape and torch.equal(grids, want),
          "TDM.sample_grids differs from the plain draw")
    print(json.dumps(dict(check="tdm_sample_grids", shape=list(grids.shape),
                          bitwise=True)), flush=True)


class EagerMirror:
    """Eager solves beside a planner's solves (replayed from its CUDA
    graphs on a card): the same solver, from a generator of the planner's
    seed, on copies of the planner's inputs taken before each solve, its
    controls shifted as the planner's device shift does.  Each solve's
    controls and every ``SolveAux`` field, and the vis rollouts, are held
    bit for bit.  Its own launches are comparisons and are not counted
    (the kernel wrappers' counts are put back after each)."""

    def __init__(self, planner):
        import torch

        self.torch, self.planner = torch, planner
        dev = planner.device
        self.gen = torch.Generator(device=dev).manual_seed(planner.seed)
        self.u = torch.zeros((planner.num_steps, 2), device=dev)
        self.u_prev = torch.zeros_like(self.u)
        self.solves = 0

    def _inputs(self):
        p = self.planner

        def clone(tup):
            return type(tup)(*(None if t is None else t.clone()
                               for t in tup))

        return clone(p._map_inputs()), clone(p._task_device)

    def before_solve(self):
        self.static = self.planner._static()
        self.maps, self.task = self._inputs()

    def _uncounted(self, fn):
        from mppi_numba_tpu_torch.graphs import counted_wrappers
        from mppi_numba_tpu_torch.ops.kernels import vis_rollout

        counts = [(w, w.launches) for w in counted_wrappers()]
        routes = dict(vis_rollout.terrain_vis_fused.route_launches)
        try:
            return fn()
        finally:
            for w, n in counts:
                w.launches = n
            vis_rollout.terrain_vis_fused.route_launches = routes

    def after_solve(self, u, world):
        from mppi_numba_tpu_torch.solver import get_terrain_solver

        torch, p = self.torch, self.planner
        solver = get_terrain_solver(self.static, p.device)
        want_u, self.aux = self._uncounted(lambda: solver(
            self.gen, self.maps, self.task, self.u))
        got = p._last_aux
        differ = [f for f in self.aux._fields
                  if not torch.equal(getattr(got, f), getattr(self.aux, f))]
        check(np.array_equal(u, want_u.cpu().numpy()) and not differ,
              "{}: solve {} replayed from its graph differs from the eager "
              "solve (u max diff {}, aux fields {})".format(
                  world, self.solves,
                  float(np.abs(u - want_u.cpu().numpy()).max()), differ))
        if p.det_dyn:
            self.u_prev = want_u
        self.u_solved = want_u
        self.u = torch.cat([want_u[1:], want_u[-1:]])
        self.solves += 1

    def vis(self, u=None, plain=False):
        """The eager vis rollouts on the planner's present inputs, of the
        shifted controls (``u``: of these, e.g. ``u_solved`` before the
        shift); ``plain``: the plain loop (``backend="eager"``), not the
        kernel."""
        from mppi_numba_tpu_torch.solver import get_terrain_vis

        maps, task = self._inputs()
        a = self.aux
        u = self.u if u is None else u
        static = (dataclasses.replace(self.static, backend="eager") if plain
                  else self.static)
        return self._uncounted(lambda: get_terrain_vis(static)(
            maps, task, u, self.u_prev, a.noise_vis, a.lin_grids,
            a.ang_grids, a.roi_offset)).cpu().numpy()


class _TimedPlanner:
    """A planner seen by ``sim.trial``: each ``solve()`` timed on the host
    clock, held against an ``EagerMirror``, and its window's offset
    kept."""

    def __init__(self, planner, times, mirror):
        self.planner, self.times, self.offsets = planner, times, []
        self.mirror = mirror

    def solve(self):
        self.mirror.before_solve()
        t0 = time.perf_counter()
        u = self.planner.solve()
        self.times.append((time.perf_counter() - t0) * 1e3)
        self.mirror.after_solve(u, BIGMAP)
        self.offsets.append(tuple(self.planner._last_aux.roi_offset.tolist()))
        return u

    def shift_and_update(self, new_x0, u_cur, num_shifts=1):
        self.planner.shift_and_update(new_x0, u_cur, num_shifts=num_shifts)


def run_bigmap_trial(planner, grid, times, mirror):
    """The big-map world's ``SOLVES`` closed-loop solves through
    ``sim.trial`` on its ``TractionGrid``.  Checks the window: (85, 85),
    its offset at each solve the robot's cell (float32, as the solver
    computes it) less half the window, clamped in the map, and moving.
    Returns the last state and the trial's figures."""
    from mppi_numba_tpu_torch import sim

    static = planner._static()
    check(static.roi_shape == BIGMAP_ROI, "big map: window {}, expected {}"
          .format(static.roi_shape, BIGMAP_ROI))
    timed = _TimedPlanner(planner, times, mirror)
    out = sim.trial(timed, grid, planner.dt, SOLVES, planner.params,
                    return_history=True)
    xhist = out["xhist"]
    check(len(times) == SOLVES and xhist.shape == (SOLVES + 1, 3)
          and np.isfinite(xhist).all() and np.isfinite(out["cum_obj"]),
          "big map: trial ran {} solves, states finite {}".format(
              len(times), bool(np.isfinite(xhist).all())))
    for t, off in enumerate(timed.offsets):
        want = robot_window(planner, static, xhist[t])
        check(off == want, "big map: solve {} window at {}, robot's "
              "window {}".format(t, off, want))
    check(len(set(timed.offsets)) > 1,
          "big map: the window did not move: {}".format(timed.offsets[0]))
    return xhist[-1], dict(
        trial_success=bool(out["success"]),
        trial_cum_obj=float(out["cum_obj"]),
        roi_offset_first=list(timed.offsets[0]),
        roi_offset_last=list(timed.offsets[-1]),
        roi_offsets_distinct=len(set(timed.offsets)))


def robot_window(planner, static, x):
    """The window's start for a robot at ``x``, recomputed on the host in
    float32 as the solver computes it: the robot's cell less half the
    window, clamped in the map."""
    f32 = np.float32
    H, W = static.map_shape
    rH, rW = static.roi_shape
    lim = (f32(planner.lin_tdm.padded_xlimits[0]),
           f32(planner.lin_tdm.padded_ylimits[0]))
    cx, cy = (int(np.floor((f32(x[i]) - lim[i]) / f32(planner.lin_tdm.res)))
              for i in (0, 1))
    return (int(np.clip(np.clip(cy, 0, H - 1) - rH // 2, 0, H - rH)),
            int(np.clip(np.clip(cx, 0, W - 1) - rW // 2, 0, W - rW)))


def bigmap_crop_at_default_origin(torch, n):
    """The big-map world with its padded origin at -res, cropped and
    uncropped, the same seed, ``n`` closed-loop solves, both planners fed
    the same state and the same nominal controls before each solve: the
    cropped grids the window of the uncropped ones and the window at the
    robot's, exactly; the controls within the whole-solve tolerance (rtol
    2e-4, atol 2e-5).  Reports how many final costs and controls differ."""
    from mppi_numba_tpu_torch.sim import simulate_step

    origin = -BIGMAP_RES
    p_roi, grid, _ = setup_world(BIGMAP, padded_origin=origin)
    p_full, _, _ = setup_world(BIGMAP, crop=False, padded_origin=origin)
    s_roi = p_roi._static()
    check(s_roi.roi_shape == BIGMAP_ROI and p_full._static().roi_shape is None
          and p_roi.lin_tdm.padded_xlimits[0] == origin,
          "big map at origin {}: window {}, limits {}".format(
              origin, s_roi.roi_shape, p_roi.lin_tdm.padded_xlimits))
    rH, rW = s_roi.roi_shape
    x = np.asarray(p_roi.params["x0"], dtype=float).copy()
    offsets, du, costs_differing, u_differing = [], 0.0, 0, 0
    for _ in range(n):
        u_roi, u_full = p_roi.solve(), p_full.solve()
        oy, ox = p_roi._last_aux.roi_offset.tolist()
        check((oy, ox) == robot_window(p_roi, s_roi, x),
              "big map at origin {}: window at {}, robot's {}".format(
                  origin, (oy, ox), robot_window(p_roi, s_roi, x)))
        offsets.append([oy, ox])
        for name in ("lin_grids", "ang_grids"):
            check(torch.equal(getattr(p_roi._last_aux, name),
                              getattr(p_full._last_aux, name)[
                                  :, oy:oy + rH, ox:ox + rW]),
                  "big map at origin {}: cropped {} differ from the window "
                  "of the uncropped".format(origin, name))
        du = max(du, float(np.abs(u_roi - u_full).max()))
        u_differing += int((u_roi != u_full).sum())
        costs_differing += int((p_roi._last_aux.costs
                                != p_full._last_aux.costs).sum())
        check(np.allclose(u_roi, u_full, rtol=2e-4, atol=2e-5),
              "big map at origin {}: cropped controls differ from uncropped "
              "by {}".format(origin, du))
        x = simulate_step(x, u_roi[0], *grid.get(x[0], x[1]), p_roi.dt)
        p_roi.shift_and_update(x, u_roi)
        p_full.shift_and_update(x, u_roi)
    check(len({tuple(o) for o in offsets}) > 1,
          "big map at origin {}: the window did not move".format(origin))
    return dict(check="bigmap_crop_at_origin_minus_res", solves=n,
                padded_origin=origin, roi_shape=[rH, rW], offsets=offsets,
                grids_bitwise=True, offsets_exact=True, u_max_abs_diff=du,
                u_entries_differing=u_differing,
                final_costs_differing=costs_differing)


def bigmap_crop_equals_full(torch, n):
    """The big-map world cropped and uncropped, the same seed, ``n``
    closed-loop solves over which the window moves: the same controls bit
    for bit, and the cropped lin and ang grids the window of the
    uncropped ones."""
    from mppi_numba_tpu_torch.sim import simulate_step
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    p_roi, grid, _ = setup_world(BIGMAP)
    p_full, _, _ = setup_world(BIGMAP, crop=False)
    s_roi, s_full = p_roi._static(), p_full._static()
    check(s_roi.roi_shape == BIGMAP_ROI and s_full.roi_shape is None,
          "big map: windows {} / {}".format(s_roi.roi_shape,
                                            s_full.roi_shape))
    rH, rW = s_roi.roi_shape
    x = np.asarray(p_roi.params["x0"], dtype=float).copy()
    offsets = []
    for _ in range(n):
        u_roi, u_full = p_roi.solve(), p_full.solve()
        check(np.array_equal(u_roi, u_full), "big map: cropped controls "
              "differ from uncropped by {}".format(
                  float(np.abs(u_roi - u_full).max())))
        oy, ox = p_roi._last_aux.roi_offset.tolist()
        offsets.append([oy, ox])
        for name in ("lin_grids", "ang_grids"):
            check(torch.equal(getattr(p_roi._last_aux, name),
                              getattr(p_full._last_aux, name)[
                                  :, oy:oy + rH, ox:ox + rW]),
                  "big map: cropped {} differ from the window of the "
                  "uncropped".format(name))
        x = simulate_step(x, u_roi[0], *grid.get(x[0], x[1]), p_roi.dt)
        p_roi.shift_and_update(x, u_roi)
        p_full.shift_and_update(x, u_full)
    check(len({tuple(o) for o in offsets}) > 1,
          "big map: the window did not move in the crop check")
    return dict(check="bigmap_crop_equals_full", solves=n,
                roi_shape=list(s_roi.roi_shape), offsets=offsets,
                backend_cropped=get_terrain_solver(s_roi, "cuda").backend,
                backend_uncropped=get_terrain_solver(s_full, "cuda").backend,
                controls_bitwise=True, grids_bitwise=True)


def check_state_rollout(world, planner, x, mirror=None):
    """``get_state_rollout()`` after the last solve: ``(V, T+1, 3)``, finite,
    every row 0 the current state ``x`` (float32), its vis graph at most
    ``VIS_MAX_NODES`` kernels a replay, and with an ``EagerMirror`` bit
    for bit its eager vis (the kernel) and the plain loop
    (``backend="eager"``) on the same inputs.  Returns the shape."""
    states = planner.get_state_rollout()
    if mirror is not None:
        for plain in (False, True):
            want = mirror.vis(plain=plain)
            check(np.array_equal(states, want), "{}: the vis replayed from "
                  "its graph differs from the eager vis ({}) by {}".format(
                      world, "plain loop" if plain else "kernel",
                      float(np.abs(states - want).max())))
    nodes = planner._vis_graphs[planner._last_static]._call.kernel_nodes
    check(nodes <= VIS_MAX_NODES, "{}: {} kernels a vis replay".format(
        world, nodes))
    V, T = planner.num_vis_state_rollouts, planner.num_steps
    check(isinstance(states, np.ndarray) and states.shape == (V, T + 1, 3)
          and np.isfinite(states).all(), "{}: state rollout {}".format(
              world, getattr(states, "shape", states)))
    check(np.array_equal(states[:, 0], np.broadcast_to(
        np.asarray(x, np.float32), (V, 3))),
        "{}: state rollouts do not start at x0".format(world))
    return list(states.shape)


def run_device_trial(torch, max_steps):
    """One episode of the big-map world through
    ``device_sim.make_device_trial`` on the card (a generator: one CUDA
    graph a step, ``reached`` read once a chunk), against the same episode
    through its eager loop (a callable making the same draws from a
    generator of the same seed; its launches not counted): every field bit
    for bit.  Returns the record, with the episode's arguments under
    ``timed_args``."""
    from mppi_numba_tpu_torch import device_sim
    from mppi_numba_tpu_torch.graphs import counted_wrappers
    from mppi_numba_tpu_torch.ops.sampling import draw_map_key

    planner, truth, _ = setup_world(BIGMAP)
    static, dev = planner._static(), planner.device
    maps, task = planner._map_inputs(), planner._task_device
    f32 = torch.float32
    gt = [torch.tensor(g, dtype=f32, device=dev) for g in truth.get_grids()]
    meta = torch.tensor([truth.xlimits[0], truth.ylimits[0], 1.0 / truth.res],
                        dtype=f32, device=dev)
    trial = device_sim.make_device_trial(static, max_steps)
    got = trial(torch.Generator(device=dev).manual_seed(7), maps, task, *gt,
                meta)
    torch.cuda.synchronize()
    g2 = torch.Generator(device=dev).manual_seed(7)

    def draws(t):
        return draw_map_key(g2, dev), [
            torch.randn((static.num_control_rollouts, static.num_steps, 2),
                        generator=g2, device=dev)
            for _ in range(static.num_opt)]

    counts = [(w, w.launches) for w in counted_wrappers()]
    want = trial(draws, maps, task, *gt, meta)
    for w, n in counts:
        w.launches = n
    differ = [f for f, a, b in zip(got._fields, got, want)
              if not torch.equal(a, b)]
    check(not differ, "device trial: the graph episode differs from the "
          "eager loop in {}: {} / {}".format(differ, got, want))
    res = {f: (v.item()) for f, v in got._asdict().items()}
    check(res["steps"] > 0 and np.isfinite(res["cum_obj"]),
          "device trial: {}".format(res))
    return dict(check="device_trial", world=BIGMAP, max_steps=max_steps,
                chunk_steps=device_sim.CHUNK_STEPS, num_opt=static.num_opt,
                graph_equals_eager=True, **res,
                timed_args=(trial, maps, task, gt, meta))


class BareboneMirror(EagerMirror):
    """``EagerMirror`` for ``BareboneMPPI``: eager barebone solves (no
    maps) beside the planner's graph replays, from a generator of the
    planner's seed, on copies of its task taken before each solve; the
    controls, every ``SolveAux`` field and the vis bit for bit."""

    def _inputs(self):
        task = self.planner._task_device
        return None, type(task)(*(t.clone() for t in task))

    def after_solve(self, u, world):
        from mppi_numba_tpu_torch.solver import get_barebone_solver

        torch, p = self.torch, self.planner
        solver = get_barebone_solver(self.static, p.device)
        want_u, self.aux = self._uncounted(lambda: solver(
            self.gen, self.task, self.u))
        got = p._last_aux
        differ = [f for f in self.aux._fields
                  if (getattr(got, f) is None) != (getattr(self.aux, f)
                                                   is None)
                  or (getattr(got, f) is not None and not torch.equal(
                      getattr(got, f), getattr(self.aux, f)))]
        check(np.array_equal(u, want_u.cpu().numpy()) and not differ,
              "{}: solve {} replayed from its graph differs from the eager "
              "solve (u max diff {}, aux fields {})".format(
                  world, self.solves,
                  float(np.abs(u - want_u.cpu().numpy()).max()), differ))
        self.u_prev = want_u
        self.u = torch.cat([want_u[1:], want_u[-1:]])
        self.solves += 1

    def vis(self, plain=False):
        from mppi_numba_tpu_torch.solver import get_barebone_vis

        _, task = self._inputs()
        static = (dataclasses.replace(self.static, backend="eager") if plain
                  else self.static)
        return self._uncounted(lambda: get_barebone_vis(static)(
            task, self.u, self.u_prev, self.aux.noise_vis)).cpu().numpy()


def run_barebone(K=1024, solves=SOLVES):
    """``solves`` closed-loop solves of ``examples/barebone_mppi.py``'s
    task (K = 1024, T = 50, two circle obstacles) through
    ``BareboneMPPI``'s public entry points, then ``get_state_rollout``:
    each solve (a graph replay) and the vis held bit for bit against eager
    calls from a generator of the same seed (``BareboneMirror``); one
    solve graph and one vis graph.  ``K``: the rollouts (the Config takes
    up to 1e6)."""
    from mppi_numba_tpu_torch import BareboneConfig, BareboneMPPI

    cfg = BareboneConfig(T=5.0, dt=0.1, num_control_rollouts=K,
                         num_vis_state_rollouts=20, seed=1)
    check(cfg.num_control_rollouts == K, "barebone: K {} clipped to {}"
          .format(K, cfg.num_control_rollouts))
    x = np.array([0.0, 0.0, np.pi / 4])
    goal = np.array([7.0, 5.0])
    params = dict(dt=cfg.dt, x0=x, xgoal=goal, goal_tolerance=0.5,
                  dist_weight=10, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([1.0, 1.0]), vrange=np.array([0.0, 2.0]),
                  wrange=np.array([-np.pi, np.pi]),
                  obstacle_positions=np.array([[5, 4.5], [2, 1]]),
                  obstacle_radius=np.array([1.5, 1]), obs_penalty=1e6)
    planner = BareboneMPPI(cfg, device="cuda")
    planner.setup(params)
    mirror = BareboneMirror(planner)
    dist0 = float(np.hypot(*(goal - x[:2])))
    times = []
    for _ in range(solves):
        mirror.before_solve()
        t0 = time.perf_counter()
        u = planner.solve()
        times.append((time.perf_counter() - t0) * 1e3)
        check(u is not None and u.shape == (cfg.num_steps, 2)
              and np.isfinite(u).all(), "barebone: bad controls")
        check(planner.u_prev is planner.u_cur,
              "barebone: u_prev does not alias the solved controls")
        mirror.after_solve(u, "barebone")
        v, w = float(u[0, 0]), float(u[0, 1])
        x = x + cfg.dt * np.array([v * np.cos(x[2]), v * np.sin(x[2]), w])
        planner.shift_and_update(x, u, num_shifts=1)
    vis_shape = check_state_rollout("barebone", planner, x, mirror)
    (graph,), (vis_graph,) = (planner._solve_graphs.values(),
                              planner._vis_graphs.values())
    return dict(solves=solves, num_opt=planner._static().num_opt,
                solve_ms_first=times[0],
                solve_ms_median=float(np.median(times[1:])),
                K=cfg.num_control_rollouts, T=cfg.num_steps, dist0=dist0,
                dist_end=float(np.hypot(*(goal - x[:2]))),
                vis_shape=vis_shape, graph_equals_eager=True,
                kernel_nodes=graph.kernel_nodes,
                vis_kernel_nodes=vis_graph._call.kernel_nodes,
                planner=planner)


def time_planner_solves(planner, n):
    """Median host ms of ``n`` planner ``solve()`` calls in a row."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        planner.solve()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_solves(chain, torch, n=5, top=8, require=True):
    """Device time by kernel over ``n`` chained solves (torch.profiler):
    the kernels' summed time per solve, the kernels launched per solve,
    and the ``top`` kernels (name, us and launches per solve).  None where
    the profiler saw no kernel and ``require`` is False (graph replays,
    whose kernels it may not see)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chain(n)
        torch.cuda.synchronize()
    # Kernel entries only: an operator's entry repeats its kernels' time.
    rows = [(e.key, float(e.device_time_total), e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    check(rows or not require, "torch.profiler recorded no kernel time")
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return dict(device_busy_us_per_solve=sum(r[1] for r in rows) / n,
                kernels_per_solve=sum(r[2] for r in rows) / n,
                top_us_per_solve=[[k[:60], us / n, c / n]
                                  for k, us, c in rows[:top]],
                sort_kernels=sorted({k[:60] for k, _, _ in rows
                                     if any(s in k.lower()
                                            for s in SORT_KERNELS)}))


# Names of torch.topk's and torch.sort's kernels (radixSortKVInPlace,
# mbtopk::*, gatherTopK, ...), matched without case: the solve's CVaR
# kernel replaced them, and no solve launches them.
SORT_KERNELS = ("sort", "topk")


def solve_chain(fn, gen, maps, task, u0):
    """``chain(k)``: k solves of ``fn`` (a solver or a ``SolveGraph``) on
    the device, each fed the last one's controls, no host sync inside."""

    def chain(k):
        u = u0
        for _ in range(k):
            u, _ = fn(gen, maps, task, u)
        return u

    return chain


def time_solve_chains(run, torch, n, reps):
    """A world's chained solves, ``n`` a chain, replayed from a CUDA graph
    (a ``SolveGraph`` captured on the planner's maps and task and a
    controls buffer of its own) and eager, in turns (graph, eager, eager,
    graph, ...) through ``profiling.chained_solve_time`` (device ms per
    solve and the host's enqueue ms), ``reps`` of each, with the planner's
    ``solve()`` timed between; then each profiled over 5 chained solves.
    Returns ``{"ms": {...}, "enqueue_ms": {...}, "solve_ms": [...],
    "profile": {"eager": ..., "graph": ... or None},
    "launches_per_replay": {...}}``."""
    from mppi_numba_tpu_torch.profiling import chained_solve_time
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    planner, static = run["planner"], run["static"]
    dev = planner.device
    solver = get_terrain_solver(static, dev)
    maps, task = planner._map_inputs(), planner._task_device
    u0 = torch.zeros((static.num_steps, 2), device=dev)
    gens = {name: torch.Generator(device=dev).manual_seed(1)
            for name in ("graph", "eager")}
    fns = {"eager": solver,
           "graph": solver.capture(gens["graph"], maps, task,
                                   torch.zeros_like(u0))}
    out = dict(ms={"graph": [], "eager": []},
               enqueue_ms={"graph": [], "eager": []}, solve_ms=[])
    for r in range(reps):
        for name in (("graph", "eager") if r % 2 == 0
                     else ("eager", "graph")):
            per, enq = chained_solve_time(fns[name], maps, task, u0,
                                          num_iters=n, generator=gens[name],
                                          with_enqueue=True)
            out["ms"][name].append(per * 1e3)
            out["enqueue_ms"][name].append(enq * 1e3)
        out["solve_ms"].append(time_planner_solves(planner, n))
    out["profile"] = {
        name: profile_solves(solve_chain(fn, gens[name], maps, task, u0),
                             torch, require=name == "eager")
        for name, fn in fns.items()}
    out["launches_per_replay"] = fns["graph"].captured_launches
    return out


# -- phase 5: the sharded solve -------------------------------------------------

# Ranks of the multi-rank cases: processes sharing the one card, gloo
# collectives on CUDA tensors (NCCL takes one rank a card).
SHARDED_RANKS = 4
# (case, world, mesh (scenario, k, m), scenarios, run-time alpha), each at
# the world's full width: (a) the flagship, (k) the big map cropped to its
# 85x85 window on 4-bit cells (the crop with an m offset), (d) det_dyn
# with M = 1 (replicated over m).
SHARDED_CASES = (
    ("a_k4", "flagship_11x11", (1, 4, 1), 4, False),
    ("a_k2_m2", "flagship_11x11", (1, 2, 2), 4, False),
    ("a_s2_k2", "flagship_11x11", (2, 2, 1), 4, False),
    ("a_dynamic_k2_m2", "flagship_11x11", (1, 2, 2), 4, True),
    ("k_k2_m2", BIGMAP, (1, 2, 2), 2, False),
    ("d_k4", "forest_140x84_det_dyn", (1, 4, 1), 2, False),
)
SHARDED_SOLVES = 5          # timed solves a case, after one untimed
WS1_SOLVES = 20             # world size 1: solves of each entry, in turns
SHARDED_SEED = 5
GRAPH_REPLAYS = 3           # replays of each case's captured sharded solve
# The sharded episode batch: noisy_dyn episodes of world (l).
SHARDED_TRIAL_EPISODES, SHARDED_TRIAL_STEPS = 8, 12
SHARDED_LABEL = "4 ranks sharing one card: not a scaling figure"
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather",
               "broadcast", "reduce_scatter_tensor", "all_to_all_single",
               "send", "recv")


class CountedCollectives:
    """Every ``torch.distributed`` collective made inside the block:
    ``calls`` of ``(name, group size, tensors' device types)``."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.calls = []

    def __enter__(self):
        dist = self.dist
        self.saved = {n: getattr(dist, n) for n in COLLECTIVES}

        def wrap(name, fn):
            def counted(*args, **kwargs):
                size = dist.get_world_size(kwargs.get("group"))
                kinds = sorted({a.device.type for a in args
                                if hasattr(a, "device")})
                self.calls.append((name, size, kinds))
                return fn(*args, **kwargs)
            return counted

        for name, fn in self.saved.items():
            setattr(dist, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)

    def summary(self):
        out = {}
        for name, size, _ in self.calls:
            key = "{}(group of {})".format(name, size)
            out[key] = out.get(key, 0) + 1
        return out

    def staged(self):
        """Collectives handed anything but CUDA tensors (none: the port
        stages nothing through the host)."""
        return sorted({name for name, _, kinds in self.calls
                       if kinds != ["cuda"]})


def sharded_case_inputs(torch, world, S, dynamic):
    """A world's full-width solve, batched over S scenarios (its maps;
    each scenario its own start): ``(static, maps, task, u0)`` on the
    card."""
    from mppi_numba_tpu_torch.solver import DYNAMIC_CVAR

    planner, _, _ = setup_world(world)
    static = planner._static()
    maps, task = planner._map_inputs(), planner._task_device
    if dynamic:
        static = dataclasses.replace(static, cvar_numel=DYNAMIC_CVAR)
        task = task._replace(cvar_alpha=torch.tensor(0.2, device="cuda"))

    def batch(t):
        return None if t is None else t.expand(
            (S,) + tuple(t.shape)).clone()

    maps = type(maps)(*(batch(t) for t in maps))
    task = type(task)(*(batch(t) for t in task))
    shift = torch.tensor([[0.2 * s, 0.1 * s, 0.0] for s in range(S)],
                         device="cuda")
    task = task._replace(x0=task.x0 + shift)
    u0 = torch.zeros((S, static.num_steps, 2), device="cuda")
    return static, maps, task, u0


def unsharded_payload(torch, static, maps, task, seed):
    """The per-sample payload planes of the single solve's map draw (one
    launch of all M rows) from a generator of ``seed``."""
    from mppi_numba_tpu_torch.ops.kernels import map_sample
    from mppi_numba_tpu_torch.solver import draw_solve, make_rollout_backend

    _, layout, _, _ = make_rollout_backend(static, "cuda")
    keys, _ = draw_solve(torch.Generator(device="cuda").manual_seed(seed),
                         static, "cuda", (task.x0.shape[0],))
    risk = static.mode == "speed_map"
    M = static.num_grid_samples
    if static.roi_shape:
        packed = map_sample.sample_and_pack_crop(
            keys, maps, task, M, layout, static.roi_shape, risk=risk)[0]
    else:
        packed = map_sample.sample_and_pack_window(
            keys, maps, task.alpha_dyn, M, layout, risk=risk)[0]
    return packed[0] if isinstance(packed, tuple) else packed


def cpu_tree(t):
    """A tensor, or a NamedTuple of tensors and Nones, copied to the host."""
    if hasattr(t, "_replace"):
        return type(t)(*(cpu_tree(f) for f in t))
    return None if t is None else t.cpu()


def cuda_tree(t):
    """A tensor, or a NamedTuple of tensors and Nones, copied to the card."""
    if hasattr(t, "_replace"):
        return type(t)(*(cuda_tree(f) for f in t))
    return None if t is None else t.cuda()


def time_host(torch, fn, n):
    """Host-clock ms of each of ``n`` calls of ``fn``, each ended by a
    synchronize."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def sharded_world_size_one(torch, emit):
    """NCCL at world size 1, in this process: world (a)'s solve on a (1,
    1, 1) mesh through the sharded entry point against the single
    ``TerrainSolver`` from the same generator state, bit for bit, eager;
    then the sharded solve of every ``SHARDED_CASES`` problem captured in
    a CUDA graph on that mesh (``sharded_graph_replays``), and world (a)'s
    eager sharded, replayed sharded and single solves timed in turns.
    Returns the launch counts of the eager sharded solve and of the
    replays."""
    import socket

    import torch.distributed as dist
    from mppi_numba_tpu_torch.graphs import counted_wrappers
    from mppi_numba_tpu_torch.parallel import multihost
    from mppi_numba_tpu_torch.parallel.mesh import make_mesh
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver)
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.initialize("tcp://localhost:{}".format(port), 1, 0)
    try:
        check(dist.get_backend() == "nccl", "world size 1: backend {}".format(
            dist.get_backend()))
        static, maps, task, u0 = sharded_case_inputs(
            torch, "flagship_11x11", 1, False)
        mesh = make_mesh(1, 1, num_map_shards=1)
        sharded = get_sharded_terrain_solver(static, mesh)
        single = get_terrain_solver(static, "cuda")
        gen = lambda: torch.Generator(device="cuda").manual_seed(  # noqa: E731
            SHARDED_SEED)
        wrappers = counted_wrappers()
        for w in wrappers:
            w.launches = 0
        with CountedCollectives() as coll:
            u_sh, costs_sh = sharded(gen(), maps, task, u0)
            torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        u_one, aux = single(gen(), maps, task, u0)
        torch.cuda.synchronize()
        same = torch.equal(u_sh, u_one) and torch.equal(costs_sh, aux.costs)
        check(same, "world size 1: the sharded solve differs from the single "
              "solve: max |du| {}".format(float((u_sh - u_one).abs().max())))
        check(launches.get("sample_and_pack_window") == 1
              and launches.get("terrain_rollout_costs_byte")
              == launches.get("cvar_costs")
              == launches.get("update_useq_fused")
              == static.num_opt, "world size 1 launches: {}".format(
                  launches))
        graph_launches = sharded_graph_replays(torch, mesh, emit)
        graph = sharded.capture(gen(), maps, task, u0.clone())
        times = {"sharded": [], "graph": [], "single": []}
        for _ in range(WS1_SOLVES):
            times["sharded"] += time_host(
                torch, lambda: sharded(gen(), maps, task, u0), 1)
            times["graph"] += time_host(
                torch, lambda: graph(graph.generator, maps, task, u0), 1)
            times["single"] += time_host(
                torch, lambda: single(gen(), maps, task, u0), 1)
        emit("sharded_world_size_1_solve_ms", min(times["sharded"]), "ms",
             single_solve_ms=min(times["single"]),
             graph_solve_ms=min(times["graph"]),
             sharded_median_ms=float(np.median(times["sharded"])),
             graph_median_ms=float(np.median(times["graph"])),
             single_median_ms=float(np.median(times["single"])),
             sharded_all_ms=times["sharded"], graph_all_ms=times["graph"],
             single_all_ms=times["single"],
             backend=dist.get_backend(), mesh=[1, 1, 1],
             world="flagship_11x11",
             bitwise_equal=same, collectives=coll.summary(),
             staged_through_host=coll.staged(), launches=launches,
             torch=torch.__version__,
             nccl=".".join(str(v) for v in torch.cuda.nccl.version()),
             timing="host clock, a solve ended by a synchronize, {} each of "
                    "eager sharded, replayed sharded and single (eager) in "
                    "turns".format(WS1_SOLVES))
        check(not coll.staged(), "world size 1: collectives on host "
              "tensors: {}".format(coll.staged()))
        return launches, graph_launches
    finally:
        dist.destroy_process_group()


def sharded_graph_replays(torch, mesh, emit):
    """On the one-rank NCCL ``mesh``: the sharded solve of every
    ``SHARDED_CASES`` problem (world, scenarios, run-time alpha) captured
    in a CUDA graph (``ShardedTerrainSolver.capture``) and replayed
    ``GRAPH_REPLAYS`` times, each fed the last one's controls and drawing
    on from the generator, against the eager sharded solve and the single
    solve of generators of the same seed in the same chain, bit for bit (u
    and costs); no collective from the host during the replays, one
    map_sample launch and one rollout launch an iteration.  Returns the
    replays' launch counts (counted from 0 just before, read just
    after)."""
    from mppi_numba_tpu_torch.graphs import counted_wrappers
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver)
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    wrappers = counted_wrappers()
    total = {}
    seen = set()
    for case, world, _, S, dynamic in SHARDED_CASES:
        if (world, S, dynamic) in seen:
            continue
        seen.add((world, S, dynamic))
        static, maps, task, u0 = sharded_case_inputs(torch, world, S,
                                                     dynamic)
        sharded = get_sharded_terrain_solver(static, mesh)
        single = get_terrain_solver(static, "cuda")
        gens = [torch.Generator(device="cuda").manual_seed(SHARDED_SEED)
                for _ in range(3)]
        graph = sharded.capture(gens[0], maps, task, u0.clone())
        u_e = u_s = u0
        for w in wrappers:
            w.launches = 0
        bitwise, host_calls = [], []
        for _ in range(GRAPH_REPLAYS):
            with CountedCollectives() as coll:
                u_g, c_g = graph(gens[0], maps, task, graph.u0)
                torch.cuda.synchronize()
            host_calls += coll.calls
            # The eager solves are comparisons: their launches uncounted.
            replayed = [w.launches for w in wrappers]
            u_e, c_e = sharded(gens[1], maps, task, u_e)
            u_s, aux = single(gens[2], maps, task, u_s)
            for w, n in zip(wrappers, replayed):
                w.launches = n
            bitwise.append([torch.equal(u_g, u_e), torch.equal(c_g, c_e),
                            torch.equal(u_g, u_s),
                            torch.equal(c_g, aux.costs)])
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        check(not host_calls, "{}: a replay made collectives from the host: "
              "{}".format(case, host_calls))
        sampled = sum(n for w, n in launches.items()
                      if w.startswith("sample_and_pack"))
        rolled = sum(n for w, n in launches.items()
                     if w.startswith("terrain_rollout"))
        check(all(all(b) for b in bitwise), "{}: the replayed sharded solve "
              "differs (u vs eager, costs vs eager, u vs single, costs vs "
              "single, a row a replay): {}".format(case, bitwise))
        check(sampled == GRAPH_REPLAYS
              and rolled == GRAPH_REPLAYS * static.num_opt
              == launches.get("cvar_costs")
              == launches.get("update_useq_fused"),
              "{}: replays launched {}".format(case, launches))
        emit("sharded_graph_world_size_1", True, "bit for bit",
             case=case, world=world, scenarios=S, run_time_alpha=dynamic,
             mesh=[1, 1, 1], replays=GRAPH_REPLAYS,
             against=["eager sharded solve", "single solve"],
             backend=sharded.backend, launches=launches,
             kernels_per_replay=graph.kernel_nodes,
             node_counts=graph._call.node_counts,
             host_collectives_per_replay=0)
    return total


def expected_collectives(static, mesh):
    """The collectives one sharded solve makes by the port's design,
    ``{"name(group of n)": count}`` (``parallel/sharded.py``)."""
    _, n_k, n_m = mesh
    M, it = static.num_grid_samples, static.num_opt
    n_m = n_m if M % n_m == 0 else 1
    want = {}

    def add(name, size, n):
        key = "{}(group of {})".format(name, size)
        want[key] = want.get(key, 0) + n

    if n_k > 1:
        # One k rank updates with the kernel: no collective over k.
        add("all_reduce", n_k, 3 * it)
        if (M // n_m) % n_k == 0:
            add("all_gather_into_tensor", n_k, 1)
    if n_m > 1:
        # The candidates, or at alpha 1 the ranks' sums (rank order).
        add("all_gather_into_tensor", n_m, it)
    return want


def sharded_multi_rank(torch, emit):
    """The multi-rank cases: ``SHARDED_RANKS`` gloo ranks spawned on the
    one card, the kernels already built by this process.  Each case's
    single-card solve (and the unsharded draw's payload) is computed here
    and every rank holds its shard against it; the sharded episode batch
    against ``make_device_trial_batch`` on the same episodes.  A rank that
    fails or hangs (the process group's timeout) fails the smoke."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    from mppi_numba_tpu_torch import device_sim
    from mppi_numba_tpu_torch.solver import get_terrain_solver

    jobs, inputs = [], {}
    for case, world, mesh, S, dynamic in SHARDED_CASES:
        key = (world, S, dynamic)
        if key not in inputs:
            inputs[key] = sharded_case_inputs(torch, world, S, dynamic)
        static, maps, task, u0 = inputs[key]
        u, aux = get_terrain_solver(static, "cuda")(
            torch.Generator(device="cuda").manual_seed(SHARDED_SEED), maps,
            task, u0)
        jobs.append(dict(
            kind="solve", case=case, world=world, mesh=mesh, static=static,
            maps=cpu_tree(maps), task=cpu_tree(task), u0=u0.cpu(),
            seed=SHARDED_SEED, u=u.cpu(), costs=aux.costs.cpu(),
            payload=unsharded_payload(torch, static, maps, task,
                                      SHARDED_SEED).cpu()))
    static, maps, task, gt = sweep_chunk("noisy_dyn", SHARDED_TRIAL_EPISODES)
    want = device_sim.make_device_trial_batch(static, SHARDED_TRIAL_STEPS)(
        torch.Generator(device="cuda").manual_seed(SHARDED_SEED), maps, task,
        *gt)
    jobs.append(dict(kind="trial", case="l_trial_batch", mesh=(2, 2, 1),
                     static=static, maps=cpu_tree(maps), task=cpu_tree(task),
                     gt=tuple(g.cpu() for g in gt),
                     steps=SHARDED_TRIAL_STEPS, seed=SHARDED_SEED,
                     want=cpu_tree(want)))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        jobs_path = tmp + "/jobs.pkl"
        with open(jobs_path, "wb") as f:
            pickle.dump(jobs, f)
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(SHARDED_RANKS, tmp + "/store",
                                     jobs_path, tmp),
                 nprocs=SHARDED_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        records = []
        for rank in range(SHARDED_RANKS):
            with open("{}/rank{}.pkl".format(tmp, rank), "rb") as f:
                records += pickle.load(f)
    by_case = {}
    for rec in records:
        by_case.setdefault(rec["case"], []).append(rec)
    for job in jobs:
        recs = by_case[job["case"]]
        check(len(recs) == SHARDED_RANKS, "{}: {} ranks reported".format(
            job["case"], len(recs)))
        staged = sorted({n for r in recs for n in r["staged"]})
        check(not staged, "{}: collectives staged through the host: "
              "{}".format(job["case"], staged))
        s = job["static"]
        rollout = sum(n for w, n in recs[0]["launches"].items()
                      if w.startswith("terrain_rollout"))
        sampled = sum(n for w, n in recs[0]["launches"].items()
                      if w.startswith("sample_and_pack"))
        if job["kind"] == "trial":
            for r in recs:
                check(r["steps_equal"] and r["success_equal"]
                      and r["cum_obj_rel_err"] <= 1e-4,
                      "sharded trial batch rank {}: steps {} success {} "
                      "cum_obj rel err {}".format(
                          r["rank"], r["steps_equal"], r["success_equal"],
                          r["cum_obj_rel_err"]))
                steps = r["steps_run"]
                ms_ = sum(n for w, n in r["launches"].items()
                          if w.startswith("sample_and_pack"))
                ro_ = sum(n for w, n in r["launches"].items()
                          if w.startswith("terrain_rollout"))
                check(steps > 0 and ms_ == steps
                      and ro_ == steps * s.num_opt,
                      "sharded trial batch rank {}: {} steps, launches "
                      "{}".format(r["rank"], steps, r["launches"]))
            emit("sharded_trial_batch_ms", max(r["ms"] for r in recs), "ms",
                 label=SHARDED_LABEL, mesh=list(job["mesh"]),
                 episodes=SHARDED_TRIAL_EPISODES,
                 max_steps=SHARDED_TRIAL_STEPS, world="l (noisy_dyn)",
                 steps_run=[r["steps_run"] for r in recs],
                 captures=[r["captures"] for r in recs],
                 launches=[r["launches"] for r in recs],
                 collectives=recs[0]["collectives"], staged_through_host=[],
                 steps_success_exact=True,
                 cum_obj_max_rel_err=max(r["cum_obj_rel_err"] for r in recs),
                 timing="host clock, the whole batch on every rank")
            continue
        want_coll = expected_collectives(s, job["mesh"])
        for r in recs:
            check(r["u_within_tol"], "{} rank {}: u off the single solve "
                  "by {}".format(job["case"], r["rank"], r["u_max_abs_err"]))
            check(r["payload_bitwise"], "{} rank {}: the gathered payload "
                  "differs from the unsharded draw".format(job["case"],
                                                           r["rank"]))
            check(r["collectives"] == want_coll, "{} rank {}: collectives "
                  "{}, expected {}".format(job["case"], r["rank"],
                                           r["collectives"], want_coll))
            check(r["launches"] == recs[0]["launches"],
                  "{}: launches differ between ranks".format(job["case"]))
            check(r["capture_refused"] is not None
                  and "NCCL" in r["capture_refused"],
                  "{} rank {}: capture on gloo did not refuse: {}".format(
                      job["case"], r["rank"], r["capture_refused"]))
        # Every rank's CVaR plus coupling is the kernel (on the m group's
        # pool); its update the torch ops around the collectives over k.
        tail = recs[0]["launches"]
        check(sampled == 1 and rollout == s.num_opt
              == tail.get("cvar_costs", 0)
              and tail.get("update_useq_fused", 0)
              == (s.num_opt if job["mesh"][1] == 1 else 0),
              "{}: launches {}".format(job["case"], recs[0]["launches"]))
        emit("sharded_solve_ms", min(recs[0]["ms"]), "ms",
             label=SHARDED_LABEL, case=job["case"], world=job["world"],
             mesh=list(job["mesh"]), scenarios=job["u0"].shape[0],
             K=s.num_control_rollouts, M=s.num_grid_samples, T=s.num_steps,
             backend=get_terrain_solver(s, "cuda").backend,
             ms_by_rank=[min(r["ms"]) for r in recs],
             median_ms_by_rank=[float(np.median(r["ms"])) for r in recs],
             u_max_abs_err=max(r["u_max_abs_err"] for r in recs),
             costs_max_abs_err=max(r["costs_max_abs_err"] for r in recs),
             payload_bitwise=True,
             payload_shape_by_rank=[r["payload_shape"] for r in recs],
             launches_per_rank=recs[0]["launches"],
             collectives_per_solve=recs[0]["collectives"],
             staged_through_host=[],
             capture_refused=recs[0]["capture_refused"],
             timing="host clock, eager solves (gloo: no graph), min of "
                    "{}".format(SHARDED_SOLVES))
    emit("sharded_phase_spawn_to_exit_s", spawn_s, "s", label=SHARDED_LABEL,
         ranks=SHARDED_RANKS, backend="gloo (CUDA tensors)")


def sharded_rank(rank, world, store, jobs_path, out_dir):
    """One rank of the multi-rank phase (spawned): every case's sharded
    solve and the sharded episode batch, each checked against the
    parent's single-card results; writes its records."""
    import pickle

    import torch
    import torch.distributed as dist
    from mppi_numba_tpu_torch.graphs import counted_wrappers
    from mppi_numba_tpu_torch.parallel import multihost
    from mppi_numba_tpu_torch.parallel.mesh import make_mesh
    from mppi_numba_tpu_torch.parallel.sharded import (
        get_sharded_terrain_solver, make_sharded_trial_batch)
    from mppi_numba_tpu_torch.solver import draw_solve

    torch.set_num_threads(1)
    multihost.initialize("file://" + store, world, rank, backend="gloo")
    try:
        with open(jobs_path, "rb") as f:
            jobs = pickle.load(f)
        meshes = {}
        wrappers = counted_wrappers()
        records = []
        for job in jobs:
            shape = job["mesh"]
            if shape not in meshes:
                meshes[shape] = make_mesh(shape[0], shape[1],
                                          num_map_shards=shape[2])
            mesh = meshes[shape]
            static = job["static"]
            for w in wrappers:
                w.launches = 0
            if job["kind"] == "trial":
                batch = make_sharded_trial_batch(static, job["steps"], mesh)
                with CountedCollectives() as coll:
                    t0 = time.perf_counter()
                    res = batch(torch.Generator(device="cuda").manual_seed(
                        job["seed"]), cuda_tree(job["maps"]),
                        cuda_tree(job["task"]),
                        *(g.cuda() for g in job["gt"]))
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                want = job["want"]
                records.append(dict(
                    case=job["case"], rank=rank, ms=ms,
                    steps_equal=torch.equal(res.steps.cpu(), want.steps),
                    success_equal=torch.equal(res.success.cpu(),
                                              want.success),
                    cum_obj_rel_err=float(((res.cum_obj.cpu() - want.cum_obj)
                                           / want.cum_obj).abs().max()),
                    steps_run=batch.engine.steps_run,
                    captures=batch.engine.captures,
                    launches={w.__name__: w.launches for w in wrappers
                              if w.launches},
                    collectives=coll.summary(), staged=coll.staged()))
                continue
            solver = get_sharded_terrain_solver(static, mesh)
            S = job["u0"].shape[0]
            s_local = S // shape[0]
            rows = slice(solver.my_s * s_local, (solver.my_s + 1) * s_local)
            maps, task = (cuda_tree(type(t)(*(
                None if f is None else f[rows] for f in t)))
                for t in (job["maps"], job["task"]))
            u0 = job["u0"][rows].cuda()
            gen = lambda: torch.Generator(device="cuda").manual_seed(  # noqa: E731
                job["seed"])
            # The main path: counts set to 0 just before, read just after.
            with CountedCollectives() as coll:
                u, costs = solver(gen(), maps, task, u0)
                torch.cuda.synchronize()
            launches = {w.__name__: w.launches for w in wrappers
                        if w.launches}
            keys, _ = draw_solve(gen(), static, "cuda", (S,))
            packed, _ = solver.sample_payload(keys, maps, task)
            planes = packed[0] if isinstance(packed, tuple) else packed
            want_planes = job["payload"][rows, solver.m_slice]
            ks = slice(solver.k0, solver.k0 + solver.k_local)
            u_err = (u.cpu() - job["u"][rows]).abs()
            u_ok = bool((u_err <= 2e-5 + 2e-4 * job["u"][rows].abs()).all())
            ms = time_host(torch, lambda: solver(gen(), maps, task, u0),
                           SHARDED_SOLVES)
            # Gloo runs collectives on the host: no graph, and capture
            # says so (every rank raises alike, before any collective).
            try:
                solver.capture(gen(), maps, task, u0)
                refused = None
            except RuntimeError as exc:
                refused = str(exc)
            records.append(dict(
                case=job["case"], rank=rank, mesh=list(shape),
                u_within_tol=u_ok, u_max_abs_err=float(u_err.max()),
                costs_max_abs_err=float((costs.cpu() - job["costs"][rows, ks])
                                        .abs().max()),
                payload_bitwise=torch.equal(planes.cpu(), want_planes),
                payload_shape=list(planes.shape),
                launches=launches, collectives=coll.summary(),
                staged=coll.staged(), ms=ms, capture_refused=refused))
        with open("{}/rank{}.pkl".format(out_dir, rank), "wb") as f:
            pickle.dump(records, f)
    finally:
        dist.destroy_process_group()


# -- phase 6: the drivers --------------------------------------------------------

DRIVERS = "mppi_numba_tpu_torch.drivers."
# Each driver's own run: a failure, a hang or a missing line fails phase 6.
DRIVER_TIMEOUT_S = 300
PR_SET_CHILD_SUBREAPER = 36     # prctl option, <linux/prctl.h>
STOP_GRACE_S = 5                # SIGTERM to SIGKILL for a process left running
MAP_SAMPLE_WRAPPERS = ("sample_traction_window", "sample_and_pack_window",
                       "sample_and_pack_crop")
ROLLOUT_WRAPPERS = ("terrain_rollout_costs_byte",
                    "terrain_rollout_costs_binned")


def driver_commands():
    """``(name, argv)`` of each driver at full width, in the order they
    run; ``scaling_bench`` under ``torchrun`` on one rank (NCCL) at world
    (a)'s shape."""
    py = [sys.executable, "-m"]
    return [(name, py + [DRIVERS + name])
            for name in ("bench", "bigmap_bench", "model_bench",
                         "serve_bench", "profile_flagship")] + [
        ("scaling_bench", py + [
            "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
            "-m", DRIVERS + "scaling_bench", "--rollouts", "1024",
            "--samples", "1024", "--horizon", "100", "--map-dim", "11"])]


def finite_numbers(value):
    """Whether every float in a parsed JSON value is finite."""
    if isinstance(value, float):
        return math.isfinite(value)
    if isinstance(value, dict):
        return all(finite_numbers(v) for v in value.values())
    if isinstance(value, list):
        return all(finite_numbers(v) for v in value)
    return True


def launched_kernels(record):
    """Whether a driver's line reports launches of the map-sampling kernel
    and of a rollout kernel."""
    launches = record.get("launches") or record.get(
        "launches_per_solve") or {}
    return (sum(launches.get(w, 0) for w in MAP_SAMPLE_WRAPPERS) > 0
            and sum(launches.get(w, 0) for w in ROLLOUT_WRAPPERS) > 0)


def become_subreaper():
    """Make this process the reaper of every process it starts: one whose
    parent ends before it comes back to this process, not to init
    (Linux's PR_SET_CHILD_SUBREAPER), so ``stop_started_processes`` finds
    and reaps it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def descendants(pid):
    """``{pid: command line}`` of the processes below ``pid``, from /proc
    (an exited one not yet reaped has an empty command line)."""
    import os

    children = {}
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open("/proc/{}/stat".format(entry)) as f:
                stat = f.read()
            with open("/proc/{}/cmdline".format(entry), "rb") as f:
                cmdline = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except OSError:
            continue
        # "pid (comm) state ppid ...": comm may hold spaces and parentheses.
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        children.setdefault(ppid, []).append((int(entry), cmdline))
    out, todo = {}, [pid]
    while todo:
        for child, cmdline in children.get(todo.pop(), ()):
            out[child] = cmdline
            todo.append(child)
    return out


def reap_children():
    """Reap every child of this process that has exited."""
    import os

    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_started_processes():
    """Stop and reap every process this run started that is still there.
    First multiprocessing's resource tracker, which ``mp.spawn`` starts and
    the interpreter leaves to end after it exits (its pipe closed, then
    waited for).  Then any other, named on stderr, sent SIGTERM and, if
    still there after ``STOP_GRACE_S``, SIGKILL.  Returns ``{pid: command
    line}`` of those others."""
    import os
    import signal
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    reap_children()
    left = descendants(os.getpid())
    for pid, cmdline in left.items():
        print("chip_smoke: stopping process {} left running: {}".format(
            pid, cmdline), file=sys.stderr)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in descendants(os.getpid()):
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + STOP_GRACE_S
        while descendants(os.getpid()) and time.monotonic() < deadline:
            time.sleep(0.05)
            reap_children()
    return left


def run_driver(name, argv, card, phase=6):
    """Run one driver from the repository's root; echo its output; check
    its exit code, its card line and that every number it printed is
    finite.  Returns ``(records, seconds)``."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    print("chip_smoke phase {}: {}: {}".format(phase, name,
                                               " ".join(argv[1:])),
          flush=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(argv, cwd=root, env=env, capture_output=True,
                              text=True, timeout=DRIVER_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure("driver {} ran past {} s".format(
            name, DRIVER_TIMEOUT_S)) from exc
    seconds = time.perf_counter() - t0
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0, "driver {} exited {}: {}".format(
        name, proc.returncode, proc.stderr[-3000:]))
    lines = proc.stdout.splitlines()
    check(bool(lines) and lines[0] == card,
          "driver {}: first line {!r}, not the card line".format(
              name, lines[0] if lines else None))
    records = [json.loads(line) for line in lines[1:]
               if line.startswith("{")]
    check(all(finite_numbers(r) for r in records),
          "driver {}: a number is not finite".format(name))
    return records, seconds


def run_drivers(card, emit):
    """Phase 6: every driver of ``mppi_numba_tpu_torch.drivers`` as a
    subprocess at full width on the card (kernels built by phase 1),
    each line echoed; fails on a non-zero exit, a missing line, a
    non-finite number, a failed check or a driver that did not launch
    the map-sampling and rollout kernels."""
    from mppi_numba_tpu_torch.drivers import bench, bigmap_bench

    out, seconds = {}, {}
    for name, argv in driver_commands():
        out[name], seconds[name] = run_driver(name, argv, card)

    recs = out["bench"]
    check(len(recs) == 1 and recs[0].get("metric") == bench.METRIC
          and recs[0].get("unit") == "ms" and launched_kernels(recs[0]),
          "driver bench: {}".format(recs))

    recs = out["bigmap_bench"]
    check([r.get("scenario") for r in recs]
          == [row[0] for row in bigmap_bench.SCENARIOS]
          and all("ms_per_solve" in r and launched_kernels(r) for r in recs),
          "driver bigmap_bench: rows {}".format(
              [(r.get("scenario"), r.get("launches")) for r in recs]))

    recs = out["model_bench"]
    names = [r.get("scenario") for r in recs]
    check(names == ["barebone_K1000_T50",
                    "terrain_K1024_M1024_T100_unicycle",
                    "terrain_K1024_M1024_T100_bicycle",
                    "scale_K1024_det_dyn", "scale_K10240_det_dyn",
                    "scale_K10240_tdm"]
          and all("ms_per_solve" in r for r in recs)
          and all(launched_kernels(r) for r in recs[1:])
          and recs[0].get("captured_launches", 0) > 0
          and recs[0].get("eager_ms_per_solve", 0) > 0,
          "driver model_bench: rows {}".format(names))

    recs = out["serve_bench"]
    check(len(recs) == 1 and recs[0].get("steps_run", 0) > 0
          and "success_rate" in recs[0] and launched_kernels(recs[0]),
          "driver serve_bench: {}".format(recs))

    recs = out["profile_flagship"]
    stages = {r["stage"]: r for r in recs if "stage" in r}
    head = [r for r in recs if "flagship" in r]
    check(len(head) == 1 and all(head[0]["checks"].values())
          and list(stages) == ["sample", "noise", "rollout", "cvar",
                               "update", "solve"]
          and stages["sample"]["launches"].get("sample_and_pack_window", 0)
          > 0
          and stages["rollout"]["launches"].get(
              "terrain_rollout_costs_byte", 0) > 0
          and stages["cvar"]["launches"].get("cvar_costs", 0) > 0
          and stages["update"]["launches"].get("update_useq_fused", 0) > 0
          and all(stages[k]["library_ms"] > 0 for k in ("cvar", "update"))
          and launched_kernels(stages["solve"]),
          "driver profile_flagship: {}".format(recs))

    recs = out["scaling_bench"]
    check(len(recs) >= 1 and all(
        r["check"]["within_tolerance"] and launched_kernels(r)
        and r["check"]["graph_bitwise_eager"]
        and r["check"]["graph_within_tolerance"]
        and r["kernel_nodes"] > 0 and r["eager_solves_per_s"] > 0
        for r in recs), "driver scaling_bench: {}".format(recs))

    emit("drivers_phase_s", sum(seconds.values()), "s", per_driver=seconds)


# -- phase 7: the examples and the sweep drivers --------------------------------

EXAMPLES = "mppi_numba_tpu_torch.examples."
# Where phase 7's runs write (git-ignored): one directory a run.
PHASE7_OUT = "build/smoke_phase7"
PAPER_METHODS = ("noisy_dyn", "risk_dyn", "nom_dyn_risk_cost", "baseline")
# The JAX script's experiment pickle keys (scripts/run_full_benchmark.py).
EXPERIMENT_KEYS = {
    "logger", "cfg", "max_speed", "max_steps", "grid_shape", "mud_margin",
    "res", "num_pmf_bins", "bin_values", "bin_values_bounds",
    "default_mppi_params", "grass_density_list", "envs_per_density",
    "trials_per_env", "alpha_list", "method_list", "pmf_bounds",
    "bush_weights", "bush_means", "bush_std", "dirt_weights", "dirt_means",
    "dirt_std", "wall_clock_s", "engine"}
# Solves of each new shape held bit for bit against eager ones, and the
# animation's frames.
NEW_SHAPE_SOLVES = 5
# Wrapper -> the kernels' names in the ``kernels`` line.
WRAPPER_KERNELS = {
    "terrain_rollout_costs_byte": ("rollout_byte",),
    "terrain_rollout_costs_binned": ("rollout_binned",),
    "sample_traction_window": ("map_sample",),
    "sample_and_pack_window": ("map_sample",),
    "sample_and_pack_crop": ("map_sample", "map_sample_crop"),
    "cvar_costs": ("cvar_costs",),
    "update_useq_fused": ("update_useq",),
    "cvar_costs_wide": ("cvar_costs_wide",),
    "update_useq_wide": ("update_useq_wide",),
    "coupling_sums": ("cvar_coupling",),
    "barebone_rollout_fused": ("barebone_rollout",),
    "terrain_vis_fused": ("terrain_vis",),
    "barebone_vis_fused": ("barebone_vis",),
}


def phase7_commands():
    """``(name, argv, terrain)`` of every example mode at full width, then
    ``full_benchmark`` (one environment and realization a density, the
    four paper methods: 80 trials) and ``engine_ab_check`` (one of each:
    8 trials an engine); ``terrain``: the run must launch the map-sampling
    and a rollout kernel."""
    def mod(name, *args):
        return [sys.executable, "-m", name, *args]

    ex = [("barebone_mppi", mod(EXAMPLES + "barebone_mppi"), False)]
    ex += [("terrain_planning_" + m, mod(EXAMPLES + "terrain_planning", m),
            True) for m in ("tdm", "det", "speed")]
    ex += [(n, mod(EXAMPLES + n), True) for n in (
        "external_pmf_planning", "costmap_planning", "confidence_planning")]
    ex += [("planner_animation_" + m,
            mod(EXAMPLES + "planner_animation", m), True)
           for m in ("tdm", "det", "speed", "example")]
    return ex + [
        ("full_benchmark", mod(DRIVERS + "full_benchmark", "--envs", "1",
                               "--trials", "1", "--methods",
                               ",".join(PAPER_METHODS)), True),
        ("engine_ab_check", mod(DRIVERS + "engine_ab_check", "--envs", "1",
                                "--trials", "1"), True)]


def own_log_files(root):
    """The files under ``root`` that this process's standard output and
    error are written to (a log of this run), relative to ``root``."""
    import os

    files = set()
    for fd in (1, 2):
        try:
            path = os.readlink("/proc/self/fd/{}".format(fd))
        except OSError:
            continue
        if path.startswith(root + os.sep):
            files.add(os.path.relpath(path, root))
    return files


def tree_state(root, skip):
    """``{path: (size, mtime)}`` of the files under ``root``, less the
    directories of ``skip`` (paths relative to ``root``) and every
    ``__pycache__``."""
    import os

    state = {}
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        dirs[:] = [x for x in dirs if x != "__pycache__"
                   and os.path.normpath(os.path.join(rel, x)) not in skip]
        for f in files:
            st = os.stat(os.path.join(d, f))
            state[os.path.normpath(os.path.join(rel, f))] = (
                st.st_size, st.st_mtime_ns)
    return state


def check_example(name, records, terrain):
    """An example's lines: one outcome line; a terrain map's run launched
    the map-sampling and a rollout kernel; its planner replayed a solve
    graph (and a vis graph).  Returns the outcome line."""
    outcome = [r for r in records if "outcome" in r]
    check(len(outcome) == 1, "example {}: {} outcome lines".format(
        name, len(outcome)))
    rec = outcome[0]
    check(not terrain or launched_kernels(rec),
          "example {}: launches {}".format(name, rec.get("launches")))
    check(rec["solve_graphs"] >= 1 and rec["vis_graphs"] >= 1
          and rec["kernel_nodes"] > 0
          and rec["solve_ms"]["clock"] == "host clock, CUDA-graph replays",
          "example {}: no graph replayed: {}".format(name, rec))
    return rec


def torch_card_name():
    """The card's name, as torch reports it."""
    import torch

    return torch.cuda.get_device_name(0)


def check_sweeps(out, dirs):
    """``full_benchmark``'s tables, trials and captures, its pickle (the
    JAX script's keys, loaded by ``checkpoint.load_experiment``) and
    launches; ``engine_ab_check``'s JSON and launches."""
    import os
    from mppi_numba_tpu_torch.checkpoint import load_experiment

    tables, saved = out["full_benchmark"]
    check(tables.get("trials") == 80
          and list(tables["success_by_method"]) == list(PAPER_METHODS)
          and all(tables["engine"][m]["captures"] == 1
                  for m in PAPER_METHODS)
          and launched_kernels(saved),
          "full_benchmark: {} / {}".format(tables, saved))
    check(os.path.dirname(saved["saved"]) == dirs["full_benchmark"],
          "full_benchmark saved {} outside its --out-dir".format(
              saved["saved"]))
    exp = load_experiment(saved["saved"])
    check(set(exp) == EXPERIMENT_KEYS and exp["engine"] == "device"
          and len(exp["logger"]["success"]) == 80,
          "full_benchmark's pickle: keys {}".format(sorted(exp)))
    # Its tables as summarize_benchmark renders them, naming this card.
    from mppi_numba_tpu_torch.drivers import summarize_benchmark
    summary = os.path.join(dirs["full_benchmark"], "summary.md")
    summarize_benchmark.main([saved["saved"], "--out", summary])
    with open(summary) as fh:
        text = fh.read()
    card = torch_card_name()
    check(card in text and "TPU" not in text and text.count("## ") == 3
          and all(m in text for m in PAPER_METHODS),
          "summarize_benchmark: {}".format(text[:400]))
    ab, times = out["engine_ab_check"]
    check(ab.get("n_trials_per_engine") == 8
          and set(ab) == {"n_trials_per_engine", "noisy_dyn", "risk_dyn"}
          and launched_kernels(times),
          "engine_ab_check: {} / {}".format(ab, times))


def new_shape_planners():
    """``(name, build, frames)`` of the examples' terrain planners that
    phase 7 holds in this process: every mode of terrain_planning, the
    shapes phase 3 does not drive (external PMF at K = 2048 / M = 512,
    the costmap's M = 1 route, the confidence map with its unknown mask)
    and every world of planner_animation.  ``build()`` makes the world on
    the card; ``frames``: each step's ``get_state_rollout()`` is checked,
    as the example draws one a step."""
    from mppi_numba_tpu_torch.examples import (confidence_planning,
                                               costmap_planning,
                                               external_pmf_planning,
                                               planner_animation,
                                               terrain_planning)

    return ([("terrain_planning_" + m,
              functools.partial(terrain_planning.build, m), False)
             for m in terrain_planning.MODES]
            + [("external_pmf_K2048_M512", external_pmf_planning.build,
                False),
               ("costmap_M1", costmap_planning.build, False),
               ("confidence_unknown_mask", confidence_planning.build, False)]
            + [("planner_animation_" + m,
                functools.partial(planner_animation.build, m), True)
               for m in planner_animation.MODES])


# The solver's kernel wrappers (names in ``solver``): their modules and
# plain versions.
SOLVER_KERNELS = {
    "sample_and_pack_window": ("map_sample", "sample_and_pack_window_plain"),
    "sample_and_pack_crop": ("map_sample", "sample_and_pack_crop_plain"),
    "terrain_rollout_costs_byte": ("rollout_byte",
                                   "terrain_rollout_costs_byte_plain"),
    "terrain_rollout_costs_binned": ("rollout_binned",
                                     "terrain_rollout_costs_binned_plain"),
    "cvar_costs": ("cvar_costs", "cvar_costs_plain"),
    "update_useq_fused": ("update_useq", "update_useq_plain")}


def flat_tensors(value):
    """The tensors and Nones of a nested tuple or list, in order."""
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in flat_tensors(v)]
    return [value]


@contextlib.contextmanager
def held_against_plain(held):
    """While open, each call the solver makes to a kernel wrapper also runs
    the wrapper's plain version on the same inputs, and the outputs are
    compared bit for bit: one record a call is appended to ``held``
    (``differing``: entries differing per output, -1 where the dtype,
    shape or presence differs)."""
    import importlib

    import torch
    from mppi_numba_tpu_torch import solver

    def holding(name, kernel, plain):
        def call(*args, **kw):
            got = kernel(*args, **kw)
            g, w = flat_tensors(got), flat_tensors(plain(*args, **kw))
            differing = [
                -1 if (a is None) != (b is None) else 0 if a is None
                else -1 if (a.dtype, a.shape) != (b.dtype, b.shape)
                else int((a != b).sum())
                for a, b in zip(g, w)] + [-1] * abs(len(g) - len(w))
            held.append(dict(kernel=name, differing=differing, shapes=[
                list(t.shape) for t in flat_tensors(args)
                if torch.is_tensor(t) and t.dim()]))
            return got
        return call

    saved = {n: getattr(solver, n) for n in SOLVER_KERNELS}
    for n, (mod, plain_name) in SOLVER_KERNELS.items():
        plain = getattr(importlib.import_module(
            "mppi_numba_tpu_torch.ops.kernels." + mod), plain_name)
        setattr(solver, n, holding(n, saved[n], plain))
    try:
        yield held
    finally:
        for n, f in saved.items():
            setattr(solver, n, f)


def check_new_shape(name, w, frames):
    """``NEW_SHAPE_SOLVES`` closed-loop solves of an example's planner,
    each (a graph replay) held bit for bit against an eager solve from a
    generator of the same seed (``EagerMirror``), each kernel call of the
    eager solve held bit for bit against its plain version on the same
    inputs (``held_against_plain``); with ``frames`` each step's frame
    rollouts (``get_state_rollout()`` before the shift), and in any case
    the last vis, bit for bit with eager ones."""
    from mppi_numba_tpu_torch.drivers._common import (launch_counts,
                                                      launched_since)
    from mppi_numba_tpu_torch.sim import simulate_step
    from mppi_numba_tpu_torch.solver import resolve_backend

    before = launch_counts()
    planner = w.planner
    static = planner._static()
    mirror = EagerMirror(planner)
    x = np.asarray(planner.params["x0"], dtype=float).copy()
    truth = getattr(w, "truth", None)
    held, checked_frames = [], 0
    for _ in range(NEW_SHAPE_SOLVES):
        mirror.before_solve()
        u = planner.solve()
        with held_against_plain(held):
            mirror.after_solve(u, name)
        if frames:
            states = planner.get_state_rollout()
            for plain in (False, True):
                want = mirror.vis(mirror.u_solved, plain=plain)
                check(np.array_equal(states, want), "{}: frame {} differs "
                      "from the eager vis ({}) by {}".format(
                          name, checked_frames,
                          "plain loop" if plain else "kernel",
                          float(np.abs(states - want).max())))
            checked_frames += 1
        if truth is not None:
            x = simulate_step(x, u[0], *truth.get(x[0], x[1]), planner.dt)
        planner.shift_and_update(x, u, num_shifts=1)
    vis_shape = check_state_rollout(name, planner, x, mirror)
    launches = launched_since(before)
    check(launched_kernels({"launches": launches}), "{}: launches {}".format(
        name, launches))
    bad = [h for h in held if any(h["differing"])]
    check(not bad, "{}: kernels differ from their plain versions: {}".format(
        name, bad[:4]))
    kernels = sorted({h["kernel"] for h in held})
    check(any("rollout" in k for k in kernels) and any(
        "sample" in k for k in kernels) and "cvar_costs" in kernels
        and "update_useq_fused" in kernels,
        "{}: the eager solves called {}".format(name, kernels))
    return dict(check="phase7_graph_equals_eager", world=name,
                solves=mirror.solves, frames=checked_frames,
                vis_shape=vis_shape, launches=launches,
                backend=resolve_backend(static, planner.device),
                K=static.num_control_rollouts,
                M=static.num_grid_samples, map=list(static.map_shape),
                roi=static.roi_shape, unknown_cells=int(
                    planner._map_inputs().unknown.sum()),
                kernels_held_against_plain={k: dict(
                    calls=sum(h["kernel"] == k for h in held),
                    shapes=next(h["shapes"] for h in held
                                if h["kernel"] == k)) for k in kernels},
                bitwise=True)


def run_phase7(card, emit):
    """Phase 7: every example mode and the two sweep drivers as
    subprocesses at full width on the card, each line echoed; fails on a
    non-zero exit, a first line that is not the card line, a non-finite
    number, a missing outcome line, a terrain run that did not launch the
    map-sampling and a rollout kernel, a planner that replayed no graph or
    a file written outside the run's ``--out-dir``.  Then each new shape's
    graph-replayed solves against eager ones, in this process.  Returns
    the launches by kernel of the subprocesses (those of this process are
    read by the caller)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    skip = {".git", os.path.normpath(PHASE7_OUT)}
    logs = own_log_files(root)
    launches = dict.fromkeys(("rollout_byte", "rollout_binned", "map_sample",
                              "map_sample_crop", "cvar_costs", "update_useq",
                              "cvar_costs_wide", "update_useq_wide",
                              "cvar_coupling", "barebone_rollout",
                              "terrain_vis", "barebone_vis",
                              "gather_probe"), 0)
    out, seconds, dirs, outcomes = {}, {}, {}, {}
    for name, argv, terrain in phase7_commands():
        if name != "engine_ab_check":
            dirs[name] = os.path.join(root, PHASE7_OUT, name)
            argv = argv + ["--out-dir", dirs[name]]
        before = tree_state(root, skip)
        records, seconds[name] = run_driver(name, argv, card, phase=7)
        after = tree_state(root, skip)
        written = sorted(p for p in set(after) | set(before)
                         if after.get(p) != before.get(p) and p not in logs)
        check(not written, "{} wrote outside its --out-dir: {}".format(
            name, written[:10]))
        for rec in records:
            for wrapper, n in (rec.get("launches") or {}).items():
                for k in WRAPPER_KERNELS.get(wrapper, ()):
                    launches[k] += n
        if name in ("full_benchmark", "engine_ab_check"):
            check(len(records) == 2, "{}: {} lines".format(name,
                                                           len(records)))
            out[name] = records
            continue
        rec = check_example(name, records, terrain)
        figures = rec.get("figures", [])
        check(all(os.path.dirname(f) == dirs[name] for f in figures),
              "{}: figures {}".format(name, figures))
        outcomes[name] = dict(
            {k: rec["outcome"].get(k) for k in ("success", "time_to_goal",
                                                "steps")},
            solve_ms=rec["solve_ms"], kernel_nodes=rec["kernel_nodes"],
            final_state=rec.get("final_state"),
            final_traction=rec.get("final_traction"))
        if "vis_ms" in rec:
            # planner_animation: each frame's get_state_rollout() beside
            # the solves, host clock.
            outcomes[name]["vis_ms"] = rec["vis_ms"]
        if name == "external_pmf_planning":
            outcomes[name]["first_controls"] = rec["outcome"][
                "first_controls"]
        desc = [r for r in records if "backend" in r]
        if desc:
            outcomes[name]["backend"] = desc[0]["backend"]
    check_sweeps(out, dirs)
    for name, o in outcomes.items():
        emit("example_outcome", o.get("success"), "success", example=name,
             **{k: v for k, v in o.items() if k != "success"})
    tables, _ = out["full_benchmark"]
    emit("full_benchmark_80_trials_s", tables["wall_clock_s"], "s",
         success_by_method=tables["success_by_method"])
    emit("engine_ab_check_8_trials", out["engine_ab_check"][0], "json")
    for name, build, frames in new_shape_planners():
        print(json.dumps(check_new_shape(name, build(), frames)),
              flush=True)
    emit("phase7_s", sum(seconds.values()), "s", per_run=seconds)
    return launches


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print("chip_smoke: FAIL: {}".format(exc), file=sys.stderr)
        sys.exit(1)
    finally:
        stop_started_processes()
