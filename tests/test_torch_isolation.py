"""The port stands alone: no JAX, no JAX package, and no quiet CPU run."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import mppi_numba_tpu_torch as tpkg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CPU_SOLVE = textwrap.dedent("""
    import sys
    import numpy as np
    import mppi_numba_tpu_torch as port
    # Importing the package needs neither pandas nor matplotlib (the card's
    # machine has neither), and neither do the examples and drivers.
    assert "pandas" not in sys.modules and "matplotlib" not in sys.modules
    from mppi_numba_tpu_torch.examples import (
        barebone_mppi, confidence_planning, costmap_planning,
        external_pmf_planning, planner_animation, terrain_planning)
    from mppi_numba_tpu_torch.drivers import engine_ab_check, full_benchmark
    assert "pandas" not in sys.modules and "matplotlib" not in sys.modules

    cfg = port.Config(T=1.0, dt=0.1, num_grid_samples=4,
                      num_control_rollouts=100, max_map_dim=(20, 20),
                      use_tdm=True)
    pmf = np.zeros((3, 6, 6), np.int8)
    pmf[1], pmf[2] = 40, 60
    tdm_dict = dict(res=1.0, xlimits=(0.0, 6.0), ylimits=(0.0, 6.0),
                    bin_values=[0.0, 0.5, 1.0], bin_values_bounds=(0.0, 1.0),
                    det_dynamics_cvar_alpha=1.0)
    lin, ang = port.TDM(cfg, device="cpu"), port.TDM(cfg, device="cpu")
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = port.MPPIPlanner(cfg, device="cpu")
    planner.setup(dict(dt=0.1, x0=np.array([1.0, 1.0, 0.0]),
                       xgoal=np.array([5.0, 5.0]), goal_tolerance=0.5,
                       v_post_rollout=0.01, cvar_alpha=0.5,
                       lambda_weight=1.0, u_std=np.array([1.0, 1.0]),
                       vrange=np.array([0.0, 2.0]),
                       wrange=np.array([-1.0, 1.0])), lin, ang)
    u = planner.solve()
    assert u.shape == (10, 2) and np.isfinite(u).all()
    assert planner.get_state_rollout().shape == (4, 11, 3)
    # The barebone planner and the gather probe's plain chain.
    bb = port.BareboneMPPI(port.BareboneConfig(T=1.0, num_control_rollouts=100),
                           device="cpu")
    bb.setup(dict(dt=0.1, x0=np.zeros(3), xgoal=np.array([2.0, 1.0]),
                  goal_tolerance=0.3, lambda_weight=1.0,
                  u_std=np.array([1.0, 1.0]), vrange=np.array([0.0, 2.0]),
                  wrange=np.array([-1.0, 1.0])))
    assert bb.solve().shape == (10, 2)
    # The closed loop on a PMF realization, and the TDM's own map draw.
    from mppi_numba_tpu_torch import sim, terrain
    truth = terrain.sample_realization_from_pmf_grid(
        pmf, pmf, [0.0, 0.5, 1.0], np.random.RandomState(0))
    assert sim.trial(planner, truth, 0.1, 2, planner.params)["cum_obj"] > 0
    assert lin.sample_grids().shape == (4, 8, 8)
    # The device simulator and the profiling helpers.
    import torch
    from mppi_numba_tpu_torch import device_sim, profiling
    from mppi_numba_tpu_torch.solver import get_terrain_solver
    static = planner._static()
    maps, task = planner._map_inputs(), planner._task_device
    gt = torch.full((6, 6), 0.8)
    meta = torch.tensor([0.0, 0.0, 1.0])
    res = device_sim.make_device_trial(static, 2)(
        torch.Generator().manual_seed(0), maps, task, gt, gt, meta)
    assert int(res.steps) == 2 and np.isfinite(float(res.cum_obj))
    assert profiling.chained_solve_time(
        get_terrain_solver(static, "cpu"), maps, task,
        torch.zeros((10, 2)), num_iters=2) > 0
    from mppi_numba_tpu_torch.probes import gather_probe
    t, x, mod = gather_probe.make_inputs("flat", 8, 4, "cpu")
    assert gather_probe.flat_gather_chain(t, x, mod, 8).shape == (4, 128)
    # The benchmark sweep's row producer (no pandas), a planner checkpoint
    # and the JAX package's experiment pickle (its Config mapped to the
    # port's), and the angle helpers.
    from mppi_numba_tpu_torch import benchmark, checkpoint, utils
    world = benchmark.make_benchmark_world(num_bins=4,
                                           rng=np.random.RandomState(0))
    bcfg = port.Config(T=0.5, dt=0.1, num_grid_samples=4,
                       num_control_rollouts=100, max_speed_padding=1.0,
                       max_map_dim=(9, 9), use_tdm=True)
    bp = benchmark.default_benchmark_params(bcfg, (5, 5), 1)
    rows = benchmark.run_trials_device_rows(
        bcfg, world, 2, (5, 5), 1, 1.0, bp, [0.4], 1, 2, [0.6],
        method_list=benchmark.PAPER_METHODS, verbose=False, device="cpu")
    assert len(rows) == 8 and "pandas" not in sys.modules
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_planner_state(planner, os.path.join(d, "p.pkl"))
        checkpoint.load_planner_state(planner, os.path.join(d, "p.pkl"))
    exp = checkpoint.load_experiment(
        "mppi_benchmark/envs_10_trials_3_densities_4_device.pickle")
    assert isinstance(exp["cfg"], port.Config)
    assert abs(utils.normalize_angle(7.0) - (7.0 - 2 * np.pi)) < 1e-12
    # Every module of the port, and chip_smoke.py (its main() runs only
    # as a script).
    import importlib, pkgutil
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for name in ("mppi_numba_tpu_torch.density",
                 "mppi_numba_tpu_torch.ops.kernels.rollout_binned",
                 "mppi_numba_tpu_torch.ops.kernels.map_sample",
                 "mppi_numba_tpu_torch.ops.roi",
                 "mppi_numba_tpu_torch.sim",
                 "mppi_numba_tpu_torch.device_sim",
                 "mppi_numba_tpu_torch.profiling",
                 "mppi_numba_tpu_torch.graphs",
                 "mppi_numba_tpu_torch.barebone",
                 "mppi_numba_tpu_torch.probes.gather_probe",
                 "mppi_numba_tpu_torch.benchmark",
                 "mppi_numba_tpu_torch.benchmark_vis",
                 "mppi_numba_tpu_torch.visualization",
                 "mppi_numba_tpu_torch.checkpoint",
                 "mppi_numba_tpu_torch.utils",
                 "mppi_numba_tpu_torch.utils.angles",
                 "mppi_numba_tpu_torch.parallel",
                 "mppi_numba_tpu_torch.parallel.collectives",
                 "mppi_numba_tpu_torch.parallel.mesh",
                 "mppi_numba_tpu_torch.parallel.sharded",
                 "mppi_numba_tpu_torch.parallel.multihost",
                 "mppi_numba_tpu_torch.drivers",
                 "mppi_numba_tpu_torch.drivers.bench",
                 "mppi_numba_tpu_torch.drivers.bigmap_bench",
                 "mppi_numba_tpu_torch.drivers.model_bench",
                 "mppi_numba_tpu_torch.drivers.serve_bench",
                 "mppi_numba_tpu_torch.drivers.profile_flagship",
                 "mppi_numba_tpu_torch.drivers.scaling_bench",
                 "mppi_numba_tpu_torch.drivers.full_benchmark",
                 "mppi_numba_tpu_torch.drivers.engine_ab_check",
                 "mppi_numba_tpu_torch.examples",
                 "mppi_numba_tpu_torch.examples.barebone_mppi",
                 "mppi_numba_tpu_torch.examples.terrain_planning",
                 "mppi_numba_tpu_torch.examples.external_pmf_planning",
                 "mppi_numba_tpu_torch.examples.costmap_planning",
                 "mppi_numba_tpu_torch.examples.confidence_planning",
                 "mppi_numba_tpu_torch.examples.planner_animation"):
        assert name in names, name
    # The drivers, imported by name, one of them run on the CPU.
    from mppi_numba_tpu_torch.drivers import (bench, bigmap_bench,
                                              model_bench, profile_flagship,
                                              scaling_bench, serve_bench)
    assert bench.main(["--device", "cpu", "--k", "100", "--m", "4", "--t",
                       "5", "--iters", "1"]) == 0
    assert (bigmap_bench.build and model_bench.bench_scale
            and profile_flagship.stages and scaling_bench.build_case
            and serve_bench.episodes)
    # The parallel modules, imported by name as well as by the walk above.
    from mppi_numba_tpu_torch.parallel import mesh, multihost, sharded
    assert sharded.get_sharded_terrain_solver and multihost.initialize
    assert mesh.make_mesh
    import chip_smoke
    # The examples' and the sweep drivers' entry points and builders.
    assert (barebone_mppi.main and terrain_planning.build
            and external_pmf_planning.synth_pmf_grid
            and costmap_planning.make_costmap
            and confidence_planning.start_and_goal
            and planner_animation.reference_example_grid
            and full_benchmark.build_problem and engine_ab_check.compare)
    # Nothing of JAX, of the JAX package, of the root bench.py, of
    # scripts/ (whose modules import as top-level names: gather_probe,
    # _bench_common, ...) or of examples/.
    import os
    scripts = {f[:-3] for f in os.listdir("scripts") if f.endswith(".py")}
    scripts |= {f[:-3] for f in os.listdir("examples") if f.endswith(".py")}
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "mppi_numba_tpu" or m.startswith("mppi_numba_tpu.")
                    or m == "bench"
                    or m == "scripts" or m.startswith("scripts.")
                    or m == "examples" or m.startswith("examples.")
                    or m.split(".")[0] in scripts)
    assert not loaded, loaded
    print("isolated ok")
""")


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _CPU_SOLVE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "isolated ok" in proc.stdout


def test_default_device_is_cuda_or_raises():
    cfg = tpkg.Config(T=1.0, dt=0.1, use_tdm=True)
    if torch.cuda.is_available():
        assert tpkg.MPPIPlanner(cfg).device.type == "cuda"
        assert tpkg.TDM(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpkg.MPPIPlanner(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpkg.TDM(cfg)
