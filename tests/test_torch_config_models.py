"""Port config, dynamics models and costs vs the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_numba_tpu.config as jcfg
import mppi_numba_tpu.models as jmodels
import mppi_numba_tpu.ops.costs as jcosts
import mppi_numba_tpu_torch.config as tcfg
import mppi_numba_tpu_torch.models as tmodels
import mppi_numba_tpu_torch.ops.costs as tcosts

CONFIG_ATTRS = ("T", "dt", "num_steps", "num_grid_samples",
                "num_control_rollouts", "max_speed_padding",
                "tdm_sample_thread_dim", "num_vis_state_rollouts",
                "max_map_dim", "seed", "model", "dynamic_cvar", "det_dyn",
                "mode")


@pytest.mark.parametrize("kwargs", [
    dict(use_tdm=True),
    dict(use_tdm=True, T=0.3, dt=0.1),
    dict(use_det_dynamics=True, num_grid_samples=0),
    dict(use_nom_dynamics_with_speed_map=True, num_grid_samples=20000,
         num_control_rollouts=20000),
    dict(use_costmap=True, num_control_rollouts=5, num_vis_state_rollouts=50),
    dict(use_tdm=True, num_grid_samples=3, num_vis_state_rollouts=0,
         model="bicycle", dynamic_cvar=True, max_map_dim=(40, 60)),
])
def test_config_clamps_match(kwargs):
    j = jcfg.Config(**kwargs)
    t = tcfg.Config(**kwargs)
    for attr in CONFIG_ATTRS:
        assert getattr(t, attr) == getattr(j, attr), attr


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(use_tdm=True, use_det_dynamics=True),
    dict(use_tdm=True, T=0.1, dt=0.1),
])
def test_config_flag_exclusivity(kwargs):
    for Config in (jcfg.Config, tcfg.Config):
        with pytest.raises(AssertionError):
            Config(**kwargs)


def test_config_unknown_model_raises():
    with pytest.raises(ValueError):
        tcfg.Config(use_tdm=True, model="tricycle")


def _random_state(seed, shape=(37, 5)):
    rng = np.random.RandomState(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)  # noqa: E731
    return dict(x=f(-5, 5), y=f(-5, 5), th=f(-4, 4), v=f(-1, 3),
                w=f(-1.2, 1.2), lin=f(0, 1), ang=f(0, 1))


@pytest.mark.parametrize("model", ["unicycle", "bicycle"])
def test_step_functions_match(model):
    s = _random_state(1)
    dt = np.float32(0.1)
    jout = jmodels.get_step_fn(model)(
        *(jnp.asarray(s[k]) for k in ("x", "y", "th", "v", "w", "lin", "ang")),
        jnp.float32(dt))
    tout = tmodels.get_step_fn(model)(
        *(torch.tensor(s[k]) for k in ("x", "y", "th", "v", "w", "lin", "ang")),
        torch.tensor(dt))
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_clip_controls_match():
    rng = np.random.RandomState(2)
    u = rng.uniform(-5, 5, (20, 2)).astype(np.float32)
    vr = np.array([0.0, 3.0], np.float32)
    wr = np.array([-2.5, 2.5], np.float32)
    jv, jw = jmodels.clip_controls(jnp.asarray(u), jnp.asarray(vr),
                                   jnp.asarray(wr))
    tv, tw = tmodels.clip_controls(torch.tensor(u), torch.tensor(vr),
                                   torch.tensor(wr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_model_registry():
    assert tmodels.has_displacement_bound("unicycle")
    tmodels.register_model("test_custom", tmodels.unicycle_step)
    try:
        assert tmodels.get_step_fn("test_custom") is tmodels.unicycle_step
        assert not tmodels.has_displacement_bound("test_custom")
    finally:
        tmodels._REGISTRY.pop("test_custom")


def test_costs_match():
    rng = np.random.RandomState(3)
    d2 = rng.uniform(0, 50, (16, 9)).astype(np.float32)
    reached = (rng.rand(16, 9) < 0.3).astype(np.float32)
    dt, w, vp = np.float32(0.1), np.float32(1.7), np.float32(0.5)
    np.testing.assert_allclose(
        tcosts.stage_cost(torch.tensor(d2), torch.tensor(dt),
                          torch.tensor(w)).numpy(),
        np.asarray(jcosts.stage_cost(jnp.asarray(d2), dt, w)), rtol=1e-6)
    np.testing.assert_allclose(
        tcosts.term_cost(torch.tensor(d2), torch.tensor(vp),
                         torch.tensor(reached)).numpy(),
        np.asarray(jcosts.term_cost(jnp.asarray(d2), vp,
                                    jnp.asarray(reached))), rtol=1e-6)
    for name in ("DEFAULT_UNKNOWN_COST", "DEFAULT_OBS_COST",
                 "DEFAULT_DIST_WEIGHT"):
        assert getattr(tcosts, name) == getattr(jcosts, name)
