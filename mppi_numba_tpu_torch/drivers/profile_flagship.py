"""Stage-by-stage latency of the flagship stochastic solve; the port's
counterpart of ``scripts/profile_flagship.py``.

Each stage runs on fixed inputs of ``bench.build_flagship``'s problem (K =
M = 1024, T = 100, 11x11, 22 bins, CVaR alpha 0.2, fast trig), 50 calls
captured in one CUDA graph and replayed, timed with CUDA events
(``_card.time_cuda_graph``): the stage's device time without the host's
launches.  Stages:

  sample   one ``map_sample`` launch: the map key's draw, the threefry
           uniforms, the ranks, the decode and the packed byte words
  noise    the (K, T, 2) normal draw and the control clipping (torch ops)
  rollout  the byte rollout kernel (``csrc/rollout_byte.cu``)
  cvar     the CVaR over M plus the control coupling, one launch of
           ``csrc/cvar_costs.cu``
  update   the softmax update, one launch of ``csrc/update_useq.cu``
  solve    the whole solve (one map-sampling launch, then a rollout, a
           CVaR and an update launch an iteration)

Beside the cvar and update stages, ``library_ms`` times the torch ops
that computed them before the kernels, on the same inputs
(``tail_bench.torch_cvar_costs`` and ``torch_update``).  They are timed
here only; no path of the port runs them.

The fixed maps come from ``ops.sample_traction_grids`` (lin and ang, one
key) and ``pack_map_words``, as the JAX script builds them; on a card the
sampler is one launch of ``map_sample`` in its bins mode, held here bit
for bit against the same call on the CPU, and the words it packs against
the fused launch's.  The stages' sum exceeds the solve where the solve
overlaps nothing: every launch here runs in order on one stream.

    python -m mppi_numba_tpu_torch.drivers.profile_flagship [--device cpu]

Prints the card line, one JSON line of the problem and its checks, then
one JSON line a stage.  Left out of the JAX script: the liveness probe and
the fetch round trip subtracted from each chain.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import _card
from ..ops.kernels.cvar_costs import cvar_costs
from ..ops.kernels.map_sample import sample_and_pack_window
from ..ops.kernels.rollout_byte import (build_task_vec,
                                        terrain_rollout_costs_byte)
from ..ops.packing import pack_map_words
from ..ops.kernels.update_useq import update_useq_fused
from ..ops.rollout import _clipped_controls_tk
from ..ops.sampling import draw_map_key, sample_noise, sample_traction_grids
from ..solver import get_terrain_solver, resolve_backend
from ._common import (SMALL_CHAIN, add_device_arg, add_small_arg, clock,
                      emit, launch_counts, launched_since, resized, start)
from .bench import build_flagship
from .tail_bench import torch_cvar_costs, torch_update

N = 50


def time_stage(fn, generator, n, device):
    """Mean ms of ``fn()`` over ``n`` calls: replayed from one CUDA graph
    on a card (device clock), eager on the host clock on the CPU."""
    if device.type == "cuda":
        return _card.time_cuda_graph(fn, n, 2, generator)
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def stages(static, maps, task, device, seed=0):
    """``(checks, [(name, fn, generator, library)])``: the stage functions
    on fixed inputs drawn from generators of ``seed`` (``library``: the
    torch ops a kernel stage replaced, or None), and the checks of the
    fixed maps (``sample_traction_grids`` on the device against the CPU,
    bit for bit, and its packed words against the fused launch's)."""
    K, M, T = (static.num_control_rollouts, static.num_grid_samples,
               static.num_steps)
    H, W = static.map_shape
    gen = torch.Generator(device=device).manual_seed(seed)
    key0 = draw_map_key(gen, device)
    lin = sample_traction_grids(key0, maps.lin_pmf, maps.lin_qbins,
                                task.alpha_dyn, M)
    ang = sample_traction_grids(key0, maps.ang_pmf, maps.ang_qbins,
                                task.alpha_dyn, M)
    packed = pack_map_words(lin, ang, maps.obstacle, maps.unknown)
    on_cpu = [sample_traction_grids(key0.cpu(), pmf.cpu(), q.cpu(),
                                    task.alpha_dyn.cpu(), M)
              for pmf, q in ((maps.lin_pmf, maps.lin_qbins),
                             (maps.ang_pmf, maps.ang_qbins))]
    fused = sample_and_pack_window(key0, maps, task.alpha_dyn, M, "byte")[0]
    checks = {
        "grids_equal_cpu": all(torch.equal(a.cpu(), b) for a, b in
                               zip((lin, ang), on_cpu)),
        "packed_equal_fused": torch.equal(packed, fused),
    }
    noise = sample_noise(gen, task.u_std, K, T)
    u0 = torch.zeros((T, 2), device=device)
    v_all, w_all = (c.contiguous() for c in _clipped_controls_tk(
        u0, noise, task.vrange, task.wrange))
    tvec = build_task_vec(task)

    def rollout():
        return terrain_rollout_costs_byte(packed, tvec, v_all, w_all, H=H,
                                          W=W, T=T,
                                          fast_trig=static.fast_trig)

    costs_km = rollout()
    numel = static.cvar_numel

    def cvar():
        return cvar_costs(costs_km, noise, u0, task.u_std,
                          task.lambda_weight, numel=numel)

    costs_k = cvar()
    solver = get_terrain_solver(static, device)
    g = {name: torch.Generator(device=device).manual_seed(seed + 1)
         for name in ("sample", "noise", "solve")}

    def sample():
        key = draw_map_key(g["sample"], device)
        return sample_and_pack_window(key, maps, task.alpha_dyn, M, "byte")

    def noise_stage():
        n = sample_noise(g["noise"], task.u_std, K, T)
        return _clipped_controls_tk(u0, n, task.vrange, task.wrange)

    def update():
        return update_useq_fused(costs_k, noise, u0, task.lambda_weight,
                                 task.vrange, task.wrange)

    return checks, [
        ("sample", sample, g["sample"], None),
        ("noise", noise_stage, g["noise"], None),
        ("rollout", rollout, None, None),
        ("cvar", cvar, None,
         lambda: torch_cvar_costs(costs_km, noise, u0, task.u_std,
                                  task.lambda_weight, numel=numel)),
        ("update", update, None,
         lambda: torch_update(costs_k, noise, u0, task.lambda_weight,
                              task.vrange, task.wrange)),
        ("solve", lambda: solver(g["solve"], maps, task, u0), g["solve"],
         None),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    add_small_arg(ap)
    args = ap.parse_args(argv)
    device, card = start(args)
    static, maps, task = build_flagship(device=device)
    n = N
    if args.small:
        static, n = resized(static), SMALL_CHAIN
    checks, fns = stages(static, maps, task, device)
    H, W = static.map_shape
    emit({"flagship": dict(K=static.num_control_rollouts,
                           M=static.num_grid_samples, T=static.num_steps,
                           map="{}x{}".format(H, W),
                           cvar_numel=static.cvar_numel,
                           backend=resolve_backend(static, device)),
          "checks": checks, "card": card})
    if not all(checks.values()):
        raise RuntimeError("profile_flagship: the fixed maps' checks "
                           "failed: {}".format(checks))
    for name, fn, gen, library in fns:
        before = launch_counts()
        ms = time_stage(fn, gen, n, device)
        line = {"stage": name, "ms": ms, "card": card,
                "clock": clock(device).replace(
                    "CUDA-graph replays",
                    "{} calls in one CUDA graph".format(n)),
                "launches": launched_since(before)}
        if library is not None:
            line["library_ms"] = time_stage(library, None, n, device)
        emit(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
