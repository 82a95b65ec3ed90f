"""The port's spans (``profiling.span``): the planner's, the graphs' and the
device simulator's host steps are ``torch.profiler`` records while a
profiler runs, nested as the calls nest, and nothing at all while none
runs: ``record_function`` is never entered, and the results are the same
bit for bit.

Small sizes: a 30x40 map, K = 64, M = 8, T = 10 for the planner; an 11x11
map, K = 32, M = 4, T = 8 and 5 steps for the device simulator.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mppi_numba_tpu_torch import (TDM, Config, MapInputs, MPPIPlanner,
                                  SolverStatic, TerrainTask, profiling)
from mppi_numba_tpu_torch import device_sim

NUM_BINS, ROWS, COLS, RES = 12, 30, 40, 0.5
H = W = 11
MAX_STEPS = 5


def _pmf():
    """Mostly high traction, with a band of uncertain low traction."""
    bin_values = np.linspace(0.0, 1.0, NUM_BINS)
    pmf = np.zeros((NUM_BINS, ROWS, COLS), dtype=np.int8)
    pmf[NUM_BINS - 2], pmf[NUM_BINS - 1] = 70, 30
    band = slice(ROWS // 3, ROWS // 2)
    pmf[:, band, :] = 0
    pmf[1, band, :] = 50
    pmf[NUM_BINS - 2, band, :] = 50
    return pmf, bin_values


def _params():
    return dict(dt=0.1, x0=np.array([2.0, 2.0, np.pi / 4]),
                xgoal=np.array([18.0, 13.0]), goal_tolerance=0.5,
                v_post_rollout=0.01, cvar_alpha=0.3, alpha_dyn=0.7,
                dist_weight=1.0, lambda_weight=1.0, num_opt=2,
                u_std=np.array([2.0, 3.0]), vrange=np.array([0.0, 3.0]),
                wrange=np.array([-np.pi, np.pi]))


def _planner(device="cpu"):
    """A planner and its TDMs, not yet set up."""
    pmf, bin_values = _pmf()
    cfg = Config(T=1.0, dt=0.1, num_grid_samples=8, num_control_rollouts=64,
                 max_speed_padding=4.0, num_vis_state_rollouts=2,
                 max_map_dim=(80, 100), seed=0, use_tdm=True)
    tdm_dict = dict(res=RES, xlimits=(0.0, COLS * RES),
                    ylimits=(0.0, ROWS * RES), bin_values=bin_values,
                    bin_values_bounds=np.array([0.0, 1.0]),
                    det_dynamics_cvar_alpha=1.0)
    lin, ang = TDM(cfg, device=device), TDM(cfg, device=device)
    lin.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang.set_TDM_from_PMF_grid(pmf, tdm_dict)
    return MPPIPlanner(cfg, device=device), lin, ang


def _control_loop(planner, lin, ang, steps=2):
    """``setup``, then ``steps`` rounds of ``solve()`` and
    ``shift_and_update``; the controls of each solve."""
    planner.setup(_params(), lin, ang)
    x = np.array([2.0, 2.0, np.pi / 4])
    out = []
    for _ in range(steps):
        u = planner.solve()
        out.append(u)
        v, w = u[0]
        x = x + 0.1 * np.array([v * np.cos(x[2]), v * np.sin(x[2]), w])
        planner.shift_and_update(x, u, num_shifts=1)
    return out


def _batch_inputs(device="cpu"):
    """Two episodes on 11x11 maps: one reaches its goal, one does not."""
    rng = np.random.RandomState(0)
    B = 6
    raw = rng.randint(1, 100, size=(2, B, H, W)).astype(float)
    pmf = (raw / raw.sum(1, keepdims=True) * 100).astype(np.int8)
    pmf[:, -1] = 100 - pmf[:, :-1].sum(1)
    qbins = np.tile(np.linspace(40, 100, B).astype(np.int8), (2, 1))
    zeros = np.zeros((2, H, W), np.int8)

    def t(a, dtype=None):
        return torch.tensor(np.asarray(a, dtype=dtype), device=device)

    maps = MapInputs(t(pmf), t(pmf), t(qbins), t(qbins), t(zeros),
                     t(zeros), t(zeros))
    f32 = np.float32

    def each(v):
        return t(np.stack([np.asarray(v, f32)] * 2))

    task = TerrainTask(
        x0=each([2.0, 2.0, 0.8]),
        xgoal=t(np.array([[2.5, 2.4], [9.0, 9.5]], f32)),
        goal_tolerance=each(0.5), v_post_rollout=each(0.01),
        lambda_weight=each(10.0), u_std=each([1.5, 2.0]),
        vrange=each([0.0, 2.0]), wrange=each([-3.14, 3.14]), dt=each(0.1),
        dist_weight=each(1.0), obs_penalty=each(1e5),
        unknown_penalty=each(1e2), alpha_dyn=each(1.0), res=each(1.0),
        xlim0=each(0.0), ylim0=each(0.0), lin_lb=each(0.0),
        lin_ratio=each(0.01), ang_lb=each(0.0), ang_ratio=each(0.01),
        cvar_alpha=each(0.5))
    gt_lin = t((1.1 + 0.3 * rng.rand(2, H - 2, W - 2)).astype(f32))
    gt_ang = t((0.6 + 0.3 * rng.rand(2, H - 2, W - 2)).astype(f32))
    gt_meta = t(np.tile(np.array([0.0, 0.0, 1.0], f32), (2, 1)))
    return maps, task, gt_lin, gt_ang, gt_meta


def _static(backend="eager"):
    return SolverStatic(mode="tdm", num_steps=8, num_control_rollouts=32,
                        num_grid_samples=4, map_shape=(H, W),
                        num_obstacles=0, cvar_numel=2, num_opt=1,
                        num_vis_state_rollouts=1, backend=backend)


def _run_batch(device="cpu", backend="eager"):
    engine = device_sim.make_device_trial_batch(_static(backend), MAX_STEPS)
    g = torch.Generator(device=device).manual_seed(5)
    return engine, engine(g, *_batch_inputs(device))


def _records(prof, tmp_path):
    """``{name: [(start_us, end_us)]}`` of the trace's named host spans,
    read from its Chrome trace as the benchmark reads them."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            ts, dur = float(ev["ts"]), float(ev["dur"])
            out.setdefault(ev["name"], []).append((ts, ts + dur))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _each_inside(recs, child, parent):
    """Each record of ``child`` lies inside one record of ``parent``."""
    return all(any(_inside(c, p) for p in recs[parent]) for c in recs[child])


def test_span_is_one_shared_null_context_while_no_profiler_runs():
    a, b = profiling.span("mppi.solve"), profiling.span("graphs.replay")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        inside = profiling.span("mppi.solve")
    assert isinstance(inside, torch.profiler.record_function)
    assert profiling.span("mppi.solve") is a


def test_planner_spans_nest_under_the_profiler(tmp_path):
    planner, lin, ang = _planner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _control_loop(planner, lin, ang, steps=2)
    recs = _records(prof, tmp_path)
    for name in ("mppi.solve", "mppi.solve.prepare", "mppi.solve.fetch",
                 "mppi.update", "mppi.update.upload"):
        assert len(recs.get(name, [])) == 2, name
    assert len(recs["mppi.set_params"]) == 1
    assert _each_inside(recs, "mppi.solve.prepare", "mppi.solve")
    assert _each_inside(recs, "mppi.solve.fetch", "mppi.solve")
    assert _each_inside(recs, "mppi.update.upload", "mppi.update")
    # Preparation comes before the fetch in each solve, and neither
    # overlaps the other.
    for (p0, p1), (f0, f1) in zip(sorted(recs["mppi.solve.prepare"]),
                                  sorted(recs["mppi.solve.fetch"])):
        assert p1 <= f0
    # No graph on the CPU: the solve runs eagerly.
    assert "graphs.replay" not in recs and "graphs.capture" not in recs


def test_an_eager_batch_polls_each_step_and_reads_its_result_once(
        tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine, out = _run_batch()
    recs = _records(prof, tmp_path)
    assert engine.steps_run == MAX_STEPS       # one episode never arrives
    assert [bool(s) for s in out.success] == [True, False]
    assert len(recs["device_sim.poll"]) == engine.steps_run
    assert len(recs["device_sim.result"]) == 1
    assert "device_sim.load" not in recs       # no graph's buffers to load
    assert max(e for _, e in recs["device_sim.poll"]) <= \
        recs["device_sim.result"][0][0]


def test_an_episode_without_early_exit_never_polls(tmp_path):
    engine = device_sim.make_episode_fn(_static(), 3)
    inputs = [x[0] if isinstance(x, torch.Tensor)
              else type(x)(*(f[0] for f in x)) for x in _batch_inputs()]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = engine(torch.Generator().manual_seed(5), *inputs)
    recs = _records(prof, tmp_path)
    assert int(out.steps) == 3
    assert "device_sim.poll" not in recs
    assert len(recs["device_sim.result"]) == 1


def _refuse_record_function(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)


def test_no_record_function_while_no_profiler_runs_and_same_controls(
        monkeypatch):
    planner, lin, ang = _planner()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _control_loop(planner, lin, ang, steps=3)
        _, traced_batch = _run_batch()
    _refuse_record_function(monkeypatch)
    planner, lin, ang = _planner()
    plain = _control_loop(planner, lin, ang, steps=3)
    _, plain_batch = _run_batch()
    for a, b in zip(traced, plain):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(traced_batch, plain_batch):
        assert torch.equal(a, b)


def test_a_refused_solve_still_closes_its_spans(tmp_path, capsys):
    """A solve refused by its conditions returns from inside its spans:
    both records are there, and both end."""
    planner, lin, ang = _planner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert planner.solve() is None
    recs = _records(prof, tmp_path)
    assert "Cannot solve" in capsys.readouterr().out
    assert len(recs["mppi.solve"]) == 1
    assert _each_inside(recs, "mppi.solve.prepare", "mppi.solve")
    assert "mppi.solve.fetch" not in recs


@pytest.mark.gpu
def test_graph_capture_and_replay_spans_on_a_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    dev = torch.device("cuda")
    planner, lin, ang = _planner(dev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _control_loop(planner, lin, ang, steps=3)
    recs = _records(prof, tmp_path)
    # The first solve captures its graph inside its preparation; every
    # solve replays it once, after its preparation.
    assert len(recs["graphs.capture"]) == 1
    assert _each_inside(recs, "graphs.capture", "mppi.solve.prepare")
    assert len(recs["graphs.replay"]) == 3
    assert _each_inside(recs, "graphs.replay", "mppi.solve")
    assert not any(_inside(r, p) for r in recs["graphs.replay"]
                   for p in recs["mppi.solve.prepare"])

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine, _ = _run_batch(dev, backend="auto")
    recs = _records(prof, tmp_path)
    assert engine.captures == 1
    assert len(recs["graphs.capture"]) == 1
    assert len(recs["device_sim.load"]) == 1
    assert len(recs["graphs.replay"]) == engine.steps_run
    assert len(recs["device_sim.poll"]) == math.ceil(
        engine.steps_run / device_sim.CHUNK_STEPS)
    assert len(recs["device_sim.result"]) == 1
