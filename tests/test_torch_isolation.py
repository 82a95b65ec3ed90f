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
    # Every module of the port, and chip_smoke.py (its main() runs only
    # as a script).
    import importlib, pkgutil
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for name in ("mppi_numba_tpu_torch.density",
                 "mppi_numba_tpu_torch.ops.kernels.rollout_binned"):
        assert name in names, name
    import chip_smoke
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "mppi_numba_tpu" or m.startswith("mppi_numba_tpu."))
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
