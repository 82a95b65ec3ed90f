"""The planners' vis kernels timed where the planners call them: each of
``chip_smoke.py``'s ``VIS_TIMED_WORLDS`` set up as phase 4 sets it up
(``chip_smoke.py::setup_world``, one solve) and the barebone example's
planner, then the vis kernel alone (20 launches of the planner's vis
function in one CUDA graph, the least of 3 graphs; a terrain world's in
turns with the same call on the route its shape does not take, where the
package has routes and the grid fits: ``chip_smoke.py::other_route_call``)
and the planner's vis graph replayed (the median of 20 single replays on
the device clock, each behind a spin kernel:
``chip_smoke.py::time_single_calls``).

    python mppi_numba_tpu_torch/drivers/vis_kernels.py [--tree DIR]

``--tree`` names the checkout whose package is timed (default: this
file's own), so that an earlier commit unpacked with ``git archive`` is
timed by the same script on the same inputs: run the two in turns, each
in a process of its own (parent, change, change, parent).  The worlds
come from this file's own ``chip_smoke.py``.  Prints the card line, then
one JSON line a world.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

REPS, RUNS, SINGLES = 20, 3, 20


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its worlds)."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("vis_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def barebone_planner(torch):
    """``chip_smoke.py::run_barebone``'s planner after one solve."""
    import numpy as np

    from mppi_numba_tpu_torch import BareboneConfig, BareboneMPPI

    cfg = BareboneConfig(T=5.0, dt=0.1, num_control_rollouts=1024,
                         num_vis_state_rollouts=20, seed=1)
    planner = BareboneMPPI(cfg, device="cuda")
    planner.setup(dict(
        dt=cfg.dt, x0=np.array([0.0, 0.0, np.pi / 4]),
        xgoal=np.array([7.0, 5.0]), goal_tolerance=0.5, dist_weight=10,
        lambda_weight=1.0, num_opt=1, u_std=np.array([1.0, 1.0]),
        vrange=np.array([0.0, 2.0]), wrange=np.array([-np.pi, np.pi]),
        obstacle_positions=np.array([[5, 4.5], [2, 1]]),
        obstacle_radius=np.array([1.5, 1]), obs_penalty=1e6))
    planner.solve()
    return planner


def time_world(torch, cs, planner, time_cuda_graph):
    """The planner's vis kernel alone (and on its other route) and its vis
    graph's replay, ms."""
    from mppi_numba_tpu_torch.ops.kernels import vis_rollout
    from mppi_numba_tpu_torch.solver import get_barebone_vis, get_terrain_vis

    states = planner.get_state_rollout()
    static = planner._last_static
    aux = planner._last_aux
    if static.mode == "barebone":
        vis = get_barebone_vis(static)
        args = (planner._task_device, planner.u_cur, planner.u_prev,
                aux.noise_vis)
    else:
        vis = get_terrain_vis(static)
        args = (planner._map_inputs(), planner._task_device, planner.u_cur,
                planner.u_prev, aux.noise_vis, aux.lin_grids, aux.ang_grids,
                aux.roi_offset)
    other = None
    if static.mode != "barebone" and hasattr(vis_rollout, "route_on_card"):
        other = cs.other_route_call(vis_rollout, static, args)
    graph = planner._vis_graphs[static]._call
    kernel, other_runs = [], []
    for _ in range(RUNS):
        kernel.append(time_cuda_graph(lambda: vis(*args), REPS, 2))
        if other:
            other_runs.append(time_cuda_graph(other[1], REPS, 2))
    single = cs.time_single_calls(torch, graph.replay, SINGLES)
    single.sort()
    V, T1, _ = states.shape
    return dict(kernel_ms=min(kernel), kernel_runs=kernel,
                other_route=other and other[0],
                other_route_kernel_ms=min(other_runs, default=None),
                other_route_runs=other_runs,
                replay_device_ms=single[len(single) // 2],
                replay_device_min_ms=single[0],
                kernels_per_replay=graph.kernel_nodes, V=V, T=T1 - 1,
                mode=static.mode, model=getattr(static, "model", None))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="the checkout whose package is timed (run as a "
                         "file; default: this file's own)")
    args = ap.parse_args(argv)
    if __package__:
        if args.tree is not None:
            raise SystemExit("--tree needs the script run as a file")
    else:
        tree = args.tree or str(Path(__file__).resolve().parents[2])
        sys.path.insert(0, os.path.abspath(tree))
    import torch

    import mppi_numba_tpu_torch
    from mppi_numba_tpu_torch._card import card_line, time_cuda_graph

    if not torch.cuda.is_available():
        raise SystemExit("vis_kernels: no CUDA device")
    cs = _chip_smoke()
    card = card_line()
    print(card, flush=True)
    tag = dict(card=card, tree=str(Path(mppi_numba_tpu_torch.__file__)
                                   .resolve().parents[1]))
    for world in cs.VIS_TIMED_WORLDS + ("barebone",):
        if world == "barebone":
            planner = barebone_planner(torch)
        else:
            planner = cs.setup_world(world)[0]
            planner.solve()
        rec = time_world(torch, cs, planner, time_cuda_graph)
        print(json.dumps(dict(world=world, **rec, **tag)), flush=True)
        del planner
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
