"""The port's checkpoint module (``mppi_numba_tpu_torch.checkpoint``) on the
CPU: a planner's state round trip gives the same next solve bit for bit,
experiment pickles round trip, the reference pickles' tolerant unpickler
refuses what it does not know, and the JAX package's own experiment
pickles load without importing it (a subprocess with it blocked)."""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

import mppi_numba_tpu_torch as port
from mppi_numba_tpu_torch import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PICKLE = os.path.join(REPO, "mppi_benchmark",
                          "envs_10_trials_3_densities_4_device.pickle")


def _planner(mode="tdm"):
    cfg = port.Config(T=1.0, dt=0.1, num_grid_samples=8,
                      num_control_rollouts=128, max_map_dim=(20, 20),
                      seed=4, use_tdm=mode == "tdm",
                      use_det_dynamics=mode == "det_dyn")
    rng = np.random.RandomState(0)
    raw = rng.randint(1, 50, size=(5, 8, 8))
    pmf = np.floor(100 * raw / raw.sum(0)).astype(np.int8)
    pmf[-1] += 100 - pmf.sum(0).astype(np.int8)
    tdm_dict = dict(res=1.0, xlimits=(0.0, 8.0), ylimits=(0.0, 8.0),
                    bin_values=np.linspace(0.0, 1.0, 5),
                    bin_values_bounds=(0.0, 1.0),
                    det_dynamics_cvar_alpha=0.5)
    lin, ang = port.TDM(cfg, device="cpu"), port.TDM(cfg, device="cpu")
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    planner = port.MPPIPlanner(cfg, device="cpu")
    planner.setup(dict(dt=0.1, x0=np.array([1.5, 1.5, 0.3]),
                       xgoal=np.array([6.5, 6.0]), goal_tolerance=0.5,
                       v_post_rollout=0.01, cvar_alpha=0.5,
                       lambda_weight=1.0, u_std=np.array([1.0, 1.5]),
                       vrange=np.array([0.0, 2.0]),
                       wrange=np.array([-2.0, 2.0])), lin, ang)
    return planner


def _advance(planner, n):
    x = np.array(planner.params["x0"], dtype=float)
    for _ in range(n):
        u = planner.solve()
        x = x + 0.1 * np.array([u[0, 0] * np.cos(x[2]),
                                u[0, 0] * np.sin(x[2]), u[0, 1]])
        planner.shift_and_update(x, u)


@pytest.mark.parametrize("mode", ["tdm", "det_dyn"])
def test_planner_round_trip_gives_the_same_next_solve(tmp_path, mode):
    """Saved after three closed-loop solves: the next solve of the planner
    restored in place (after more solves) and of a fresh planner equal the
    saved planner's own next solve, bit for bit, and so do the ones after
    (the generator's state restored)."""
    planner = _planner(mode)
    _advance(planner, 3)
    path = tmp_path / "planner.pkl"
    state = checkpoint.save_planner_state(planner, path)
    assert set(state) == {"u_cur", "u_prev", "generator_state", "params"}
    want = [planner.solve(), planner.solve()]
    _advance(planner, 2)
    checkpoint.load_planner_state(planner, path)
    assert planner.u_cur is planner._u_in
    got = [planner.solve(), planner.solve()]
    fresh = _planner(mode)
    fresh.solve()
    checkpoint.load_planner_state(fresh, path)
    other = [fresh.solve(), fresh.solve()]
    for a, b, c in zip(want, got, other):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with open(path, "rb") as fh:
        saved = pickle.load(fh)
    np.testing.assert_array_equal(saved["u_cur"], state["u_cur"])
    assert saved["generator_state"].dtype == np.uint8


def test_load_planner_state_needs_tdms(tmp_path):
    planner = _planner()
    path = tmp_path / "planner.pkl"
    checkpoint.save_planner_state(planner, path)
    bare = port.MPPIPlanner(planner.cfg, device="cpu")
    with pytest.raises(RuntimeError, match="attach TDMs"):
        checkpoint.load_planner_state(bare, path)


def test_experiment_round_trip(tmp_path):
    df = pd.DataFrame(dict(method=["noisy_dyn", "risk_dyn"],
                           success=[True, False], cum_obj=[1.5, 2.5]))
    cfg = port.Config(T=1.0, use_tdm=True)
    path = tmp_path / "exp.pickle"
    checkpoint.save_experiment(path, df, cfg=cfg, alpha_list=[1.0, 0.5])
    out = checkpoint.load_experiment(path)
    pd.testing.assert_frame_equal(out["logger"], df)
    assert isinstance(out["cfg"], port.Config) and out["cfg"].T == 1.0
    assert out["alpha_list"] == [1.0, 0.5]


def test_jax_experiment_pickle_loads_without_the_jax_package():
    """The repo's JAX benchmark pickle holds a JAX-package ``Config``:
    ``load_experiment`` maps it to the port's, in a process where
    importing the JAX package (or JAX) fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["mppi_numba_tpu"] = None
        sys.modules["jax"] = None
        from mppi_numba_tpu_torch.checkpoint import (
            load_experiment, load_reference_experiment)
        from mppi_numba_tpu_torch.config import Config
        for load in (load_experiment, load_reference_experiment):
            d = load(sys.argv[1])
            df = d["logger"]
            assert len(df) == 1800, len(df)
            rates = df.groupby("method").success.mean().round(3).to_dict()
            assert rates == {"noisy_dyn": 0.89, "risk_dyn": 0.777,
                             "nom_dyn_risk_cost": 0.512}, rates
            assert d["cfg"].T == 10.0 and d["cfg"].num_steps == 100
        assert type(load_experiment(sys.argv[1])["cfg"]) is Config
        loaded = [m for m in sys.modules if m == "jax"
                  or m.startswith("jax.") or m.startswith("mppi_numba_tpu.")]
        assert all(sys.modules[m] is None for m in loaded), loaded
        print("loaded ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, JAX_PICKLE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded ok" in proc.stdout


class _Payload:
    def __reduce__(self):
        return (os.system, ("true",))


def test_reference_unpickler_refuses_unknown_globals(tmp_path):
    path = tmp_path / "evil.pickle"
    with open(path, "wb") as fh:
        pickle.dump({"logger": _Payload()}, fh)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        checkpoint.load_reference_experiment(path)


def test_reference_unpickler_stubs_reference_classes(tmp_path):
    """A reference ``mppi_numba`` class loads as an attribute-holding stub,
    beside a DataFrame."""
    mod = type(sys)("mppi_numba.config")
    cls = type("Config", (), {"__module__": "mppi_numba.config"})
    mod.Config = cls
    sys.modules["mppi_numba"] = type(sys)("mppi_numba")
    sys.modules["mppi_numba.config"] = mod
    try:
        obj = cls()
        obj.T, obj.seed = 10.0, 3
        path = tmp_path / "ref.pickle"
        with open(path, "wb") as fh:
            pickle.dump(dict(cfg=obj, logger=pd.DataFrame({"a": [1, 2]})), fh)
    finally:
        del sys.modules["mppi_numba.config"], sys.modules["mppi_numba"]
    out = checkpoint.load_reference_experiment(path)
    assert isinstance(out["cfg"], checkpoint._StubState)
    assert (out["cfg"].T, out["cfg"].seed) == (10.0, 3)
    assert list(out["logger"]["a"]) == [1, 2]
    # The JAX package's checkpoint reads the same file the same way.
    from mppi_numba_tpu import checkpoint as jcheckpoint
    jout = jcheckpoint.load_reference_experiment(path)
    assert vars(jout["cfg"]) == vars(out["cfg"])
