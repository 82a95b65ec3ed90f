"""The port's measurement drivers (``mppi_numba_tpu_torch.drivers``)
against the JAX package's scripts: each problem builder field by field,
exactly; each driver's ``main`` on the CPU at a small size, its lines
parsing with the JAX script's keys; ``scaling_bench`` on two gloo ranks,
passing its own check; ``full_benchmark``'s experiment pickle with the
JAX script's keys, and ``engine_ab_check``'s JSON."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from mppi_numba_tpu_torch.checkpoint import load_experiment
from mppi_numba_tpu_torch.drivers import (bench, bigmap_bench,
                                          engine_ab_check, full_benchmark,
                                          model_bench, profile_flagship,
                                          scaling_bench, serve_bench,
                                          tail_bench)

from tests import torch_parallel_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX backend names the port's layouts stand for (solver.py).
BACKENDS = {"pallas_binned": "binned"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager solves: one torch thread a test, put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(relpath, name):
    """A JAX-side script loaded from the repository by path; ``sys.path``
    put back after (the scripts put their own directories on it)."""
    path = list(sys.path)
    try:
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, relpath))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def _assert_static(port, jax_static):
    want = dataclasses.asdict(jax_static)
    want["backend"] = BACKENDS.get(want["backend"], want["backend"])
    assert dataclasses.asdict(port) == want


def _assert_tree(port, jax_tree):
    """Two NamedTuples field by field: the same names, values, dtypes and
    shapes (None where JAX has None)."""
    assert port._fields == jax_tree._fields
    for name, p, j in zip(port._fields, port, jax_tree):
        if j is None:
            assert p is None, name
            continue
        j = np.asarray(j)
        p = p.cpu().numpy()
        assert p.dtype == j.dtype and p.shape == j.shape, name
        np.testing.assert_array_equal(p, j, err_msg=name)


def _lines(capsys):
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cpu: host run")
    return [json.loads(line) for line in out[1:]]


def test_bench_build_flagship_equals_jax():
    jbench = _load("bench.py", "jax_bench_driver")
    for kw in ({}, dict(K=64, M=16, T=10)):
        j_static, j_maps, j_task = jbench.build_flagship(**kw)
        static, maps, task = bench.build_flagship(device="cpu", **kw)
        _assert_static(static, j_static)
        _assert_tree(maps, j_maps)
        _assert_tree(task, j_task)


@pytest.fixture(scope="module")
def jax_bigmap():
    return _load("scripts/bigmap_bench.py", "jax_bigmap_bench")


def _jax_bigmap_rows(jbb, monkeypatch):
    """The JAX script's scenario list as its ``main`` runs it: each row's
    ``build`` arguments and chain length (``measure`` stubbed out)."""
    rows = []
    build = jbb.build

    def recording_build(H, W, roi, backend="auto", mode="tdm", B=jbb.B):
        rows.append([H, W, roi, backend, mode, B])
        return build(H, W, roi, backend, mode, B=B)

    def recording_measure(static, maps, task, n=30):
        rows[-1].append(n)
        return 1.0

    monkeypatch.setenv("MPPI_BENCH_PROBE_S", "0")
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jbb, "build", recording_build)
    monkeypatch.setattr(jbb, "measure", recording_measure)
    monkeypatch.setattr(sys, "argv", ["bigmap_bench.py"])
    path = list(sys.path)
    try:
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            jbb.main()
    finally:
        sys.path[:] = path
    return rows


def test_bigmap_rows_and_builder_equal_jax(jax_bigmap, monkeypatch):
    """The port's rows are the JAX script's, in its order, less the XLA
    and HBM-streaming rows, with 'pallas_binned' named 'binned'; each
    row's ``build`` equals JAX's field by field, and ``roi_for`` too."""
    jbb = jax_bigmap
    want = _jax_bigmap_rows(jbb, monkeypatch)
    assert len(want) == 24
    dropped = [r for r in want if r[3] in ("xla", "pallas_binned_stream")]
    assert len(dropped) == 4
    kept = [r for r in want if r not in dropped]
    got = []
    for label, H, W, roi, backend, mode, n in bigmap_bench.SCENARIOS:
        got.append([H, W, jbb.roi_for(H, W) if roi else None,
                    {"binned": "pallas_binned"}.get(backend, backend), mode,
                    bigmap_bench.row_bins(label), n])
        assert bigmap_bench.roi_for(H, W) == jbb.roi_for(H, W)
    assert got == kept
    for H, W, roi, backend, mode, B, _ in kept:
        j = jbb.build(H, W, roi, backend, mode, B=B)
        p = bigmap_bench.build(H, W, roi, BACKENDS.get(backend, backend),
                               mode, B=B, device="cpu")
        _assert_static(p[0], j[0])
        _assert_tree(p[1], j[1])
        _assert_tree(p[2], j[2])


class _Stop(Exception):
    pass


def test_serve_episodes_equal_jax(monkeypatch):
    """The batch of ``scripts/serve_bench.py``'s ``main`` (the trial engine
    stubbed to record its arguments): the port's static, starts, goals,
    ground truth and map meta are the same, and its maps and task the
    JAX batch's field by field."""
    jserve = _load("scripts/serve_bench.py", "jax_serve_bench")
    seen = {}

    def fake_batch(static, max_steps):
        seen["static"], seen["max_steps"] = static, max_steps

        def run(keys, maps, task, gt_lin, gt_ang, meta):
            seen.update(maps=maps, task=task, gt=(gt_lin, gt_ang, meta))
            raise _Stop

        return run

    monkeypatch.setenv("MPPI_BENCH_PROBE_S", "0")
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jserve, "make_device_trial_batch", fake_batch)
    path = list(sys.path)
    try:
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        with pytest.raises(_Stop):
            jserve.main()
    finally:
        sys.path[:] = path
    static, maps, task, gt_lin, gt_ang, meta = serve_bench.build_batch(
        torch.device("cpu"))
    assert seen["max_steps"] == serve_bench.MAX_STEPS
    _assert_static(static, seen["static"])
    _assert_tree(maps, seen["maps"])
    _assert_tree(task, seen["task"])
    for p, j in zip((gt_lin, gt_ang, meta), seen["gt"]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    x0, goal, gt = serve_bench.episodes()
    np.testing.assert_array_equal(x0, np.asarray(seen["task"].x0))
    np.testing.assert_array_equal(goal, np.asarray(seen["task"].xgoal))
    np.testing.assert_array_equal(gt, np.asarray(seen["gt"][0]))


@pytest.mark.parametrize("shape", [(8, 2048, 64, 50, 15, 15, 22),
                                   (4, 1024, 1024, 100, 11, 11, 22),
                                   (4, 64, 8, 10, 250, 250, 22)])
def test_scaling_build_case_equals_jax(shape):
    """``build_case`` at the JAX defaults and at the four-card run's (a)
    and (b) shapes (K and M cut at 250x250)."""
    jscale = _load("scripts/scaling_bench.py", "jax_scaling_bench")
    j_static, j_maps, j_task, j_u0, j_keys = jscale.build_case(*shape)
    static, maps, task, u0 = scaling_bench.build_case(*shape, device="cpu")
    assert j_keys.shape[0] == shape[0]
    _assert_static(static, j_static)
    _assert_tree(maps, j_maps)
    _assert_tree(task, j_task)
    np.testing.assert_array_equal(u0.numpy(), np.asarray(j_u0))


def test_bench_main_on_cpu(capsys):
    bench.main(["--device", "cpu", "--k", "64", "--m", "16", "--t", "10",
                "--iters", "2"])
    (line,) = _lines(capsys)
    assert line["metric"] == "stochastic_solve_latency_K1024_M1024_T100"
    assert line["unit"] == "ms" and np.isfinite(line["value"])
    assert line["launches"] == {}      # the plain versions count nothing


def test_bigmap_main_on_cpu(capsys):
    bigmap_bench.main(["forest_140x84_binned_roi", "max_250x250_det_4bin",
                       "--device", "cpu", "--small"])
    lines = _lines(capsys)
    assert [r["scenario"] for r in lines] == [
        "forest_140x84_binned_roi", "max_250x250_det_4bin_crumb",
        "max_250x250_det_4bin_nibble"]
    for r in lines:
        assert {"scenario", "backend", "mode", "roi", "ms_per_solve",
                "budget_50ms"} <= set(r)
        assert np.isfinite(r["ms_per_solve"])
    assert lines[0]["roi"] == [85, 84] and lines[2]["backend"] == "binned"


def test_model_main_on_cpu(capsys):
    model_bench.main(["--device", "cpu", "--small"])
    lines = _lines(capsys)
    assert [r["scenario"] for r in lines] == [
        "barebone_K1000_T50", "terrain_K1024_M1024_T100_unicycle",
        "terrain_K1024_M1024_T100_bicycle", "scale_K1024_det_dyn",
        "scale_K10240_det_dyn", "scale_K10240_tdm"]
    # The barebone row: graph replays on a card, with the eager chain and
    # the replay's kernels beside; the CPU has no graph.
    assert "eager" not in lines[0]
    assert lines[0]["clock"] == "host clock, eager (cpu)"
    assert np.isfinite(lines[0]["eager_ms_per_solve"])
    assert lines[0]["captured_launches"] is None
    assert all(np.isfinite(r["ms_per_solve"]) for r in lines)
    assert lines[1]["backend"] == "auto"


def test_serve_main_on_cpu(capsys):
    serve_bench.main(["--device", "cpu", "--small"])
    (line,) = _lines(capsys)
    assert {"scenario", "episodes", "steps_per_episode", "wall_s",
            "flagship_solves_per_s", "episode_throughput_per_s",
            "success_rate"} <= set(line)
    assert line["scenario"] == "forest_140x84_batched_episodes"
    assert line["steps_run"] == 2 and "host_driven_equiv_s" not in line


def test_profile_main_on_cpu(capsys):
    profile_flagship.main(["--device", "cpu", "--small"])
    head, *stages = _lines(capsys)
    assert head["checks"] == {"grids_equal_cpu": True,
                              "packed_equal_fused": True}
    assert head["flagship"]["cvar_numel"] == 2
    assert [s["stage"] for s in stages] == ["sample", "noise", "rollout",
                                            "cvar", "update", "solve"]
    assert all(np.isfinite(s["ms"]) for s in stages)


def test_tail_bench_main_on_cpu(capsys):
    """The solve tail's driver at ``--small``: a line a case, each kernel
    (its plain version on the CPU) bit for bit, every time finite."""
    tail_bench.main(["--device", "cpu", "--small"])
    lines = _lines(capsys)
    assert [r["case"] for r in lines] == [c[0] for c in
                                          tail_bench.TAIL_CASES[:3]]
    assert all(r["cvar_bitwise"] and r["update_bitwise"] for r in lines)
    assert all(np.isfinite(r[k]) for r in lines for k in (
        "cvar_ms", "cvar_torch_ops_ms", "update_ms", "update_torch_ops_ms"))


def test_tail_bench_torch_ops_match_the_kernels_plain_versions():
    """The torch ops the tail kernels replaced compute the same function
    as their plain versions, within float32 (another summation order)."""
    for case in tail_bench.TAIL_CASES[:3]:
        name, B, K, M, T, count = case
        small = (name, B, 64, min(M, 16), 7, count)
        a_args, kw, (lam, vr, wr) = tail_bench.tail_case_inputs(small,
                                                                 "cpu")
        want = tail_bench.kc.cvar_costs_plain(*a_args, **kw)
        torch.testing.assert_close(tail_bench.torch_cvar_costs(*a_args,
                                                               **kw),
                                   want, rtol=1e-5, atol=1e-6)
        b_args = (want, a_args[1], a_args[2], lam, vr, wr)
        for got, ref in zip(tail_bench.torch_update(*b_args),
                            tail_bench.ku.update_useq_plain(*b_args)):
            torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def test_drivers_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--k", "64"])


@pytest.fixture(scope="module")
def scaling_two_ranks(tmp_path_factory):
    argv = ["--device", "cpu", "--backend", "gloo", "--k", "64", "--m",
            "8", "--t", "10", "--map-dim", "11", "--iters", "2"]
    jobs = {
        "solve": dict(kind="scaling", argv=argv + [
            "--scenarios", "2", "--mesh", "2,1,1", "--mesh", "1,2,1",
            "--mesh", "1,1,2"]),
        "episodes": dict(kind="scaling", argv=argv + [
            "--episodes", "--small", "--mesh", "2,1,1"]),
    }
    return ranks.run_group(2, jobs, tmp_path_factory.mktemp("scaling"))


def test_scaling_two_gloo_ranks_pass_their_check(scaling_two_ranks):
    """Two spawned gloo ranks: every mesh's gathered u within rtol 2e-4 /
    atol 2e-5 of the single solve (bit for bit on the scenario-only mesh),
    solves/s and efficiency, rank 0 printing one line a mesh."""
    rank0, rank1 = scaling_two_ranks
    recs = rank0["solve"]["records"]
    assert [r["mesh"] for r in recs] == [
        {"scenario": 2, "k": 1, "m": 1}, {"scenario": 1, "k": 2, "m": 1},
        {"scenario": 1, "k": 1, "m": 2}]
    for r in recs:
        assert r["devices"] == 2 and r["check"]["within_tolerance"]
        assert r["solves_per_s"] > 0 and r["efficiency"] > 0
        assert r["collectives_share"] is None and r["draw_ms"] > 0
        # Gloo solves eagerly, and the line says so.
        assert r["clock"].startswith("host clock, eager (gloo")
        assert r["eager_solves_per_s"] is None and r["kernel_nodes"] is None
        assert r["check"]["graph_bitwise_eager"] is None
        assert len(r["rank_chain_ms"]) == 2 and r["rank_spread"] >= 1
    assert recs[0]["check"]["bitwise"] and recs[0]["check"]["slices_bitwise"]
    assert recs[1]["check"]["slices_bitwise"] is None
    assert [r["check"] for r in rank1["solve"]["records"]] == [
        r["check"] for r in recs]
    printed = rank0["solve"]["stdout"].splitlines()
    assert printed[0].startswith("cpu: host run") and len(printed) == 4
    assert rank1["solve"]["stdout"] == ""


def test_scaling_two_gloo_ranks_episodes(scaling_two_ranks):
    """The sharded episode batch on two ranks, at full length: against the
    single batch, and slice by slice."""
    (rec,) = scaling_two_ranks[0]["episodes"]["records"]
    check = rec["check"]
    assert check["steps_equal"] and check["success_equal"]
    assert check["cum_obj_max_rel_err"] <= check["cum_obj_rtol"] == 1e-5
    assert check["slices_bitwise"]
    assert rec["episodes"] == 4 and rec["steps_run"] == 2


# -- full_benchmark and engine_ab_check --------------------------------------

JAX_PICKLE = os.path.join(REPO, "mppi_benchmark",
                          "envs_10_trials_3_densities_4_device.pickle")
PAPER = ",".join(full_benchmark.PAPER_METHOD_LIST)


def _assert_problem(port, jax_problem):
    """``(world, cfg, params)`` of the port and of a JAX script: the
    world's bins and terrain PMFs, every attribute of the JAX ``Config``,
    and the params, equal."""
    (pw, pc, pp), (jw, jc, jp) = port, jax_problem
    assert pw["num_pmf_bins"] == jw["num_pmf_bins"]
    assert pw["id2name"] == jw["id2name"]
    np.testing.assert_array_equal(pw["bin_values"], jw["bin_values"])
    assert tuple(pw["bin_values_bounds"]) == tuple(jw["bin_values_bounds"])
    for key in ("lin_terrain2pmf", "ang_terrain2pmf"):
        got = {t.name: v for t, v in pw[key].items()}
        want = {t.name: v for t, v in jw[key].items()}
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    for attr, value in vars(jc).items():
        assert getattr(pc, attr) == value, attr
    assert set(pp) == set(jp)
    for key in jp:
        np.testing.assert_array_equal(pp[key], jp[key], err_msg=key)


@pytest.mark.parametrize("u_std_ang,dist_weight,methods", [
    (3.0, 1.0, None), (2.0, 1.0, PAPER), (2.0, 3.0, "risk_dyn,baseline")])
def test_full_benchmark_build_and_tag_equal_jax(u_std_ang, dist_weight,
                                                methods, monkeypatch):
    """``build_problem`` and the pickle's file tag against the JAX
    script's, at its defaults and at the paper's settings; the protocol's
    constants equal."""
    jfb = _load("scripts/run_full_benchmark.py", "jax_run_full_benchmark")
    for name in ("GRASS_DENSITY_LIST", "ENVS_PER_DENSITY", "TRIALS_PER_ENV",
                 "ALPHA_LIST", "METHOD_LIST", "PAPER_METHOD_LIST",
                 "GRID_SHAPE", "MUD_MARGIN", "RES", "MAX_STEPS", "U_STD_ANG",
                 "DIST_WEIGHT"):
        assert getattr(full_benchmark, name) == getattr(jfb, name), name
    monkeypatch.setattr(jfb, "U_STD_ANG", u_std_ang)
    monkeypatch.setattr(jfb, "DIST_WEIGHT", dist_weight)
    method_list = methods.split(",") if methods else jfb.METHOD_LIST
    monkeypatch.setattr(jfb, "METHOD_LIST", method_list)
    _assert_problem(full_benchmark.build_problem(u_std_ang, dist_weight),
                    jfb.build_problem())
    assert full_benchmark.file_tag(method_list, u_std_ang,
                                   dist_weight) == jfb._ustd_tag()


@pytest.fixture(scope="module")
def full_benchmark_run(tmp_path_factory):
    """``full_benchmark`` at ``--small``, one environment and realization
    a density, the four paper methods: (printed lines, pickle path)."""
    out = tmp_path_factory.mktemp("full_benchmark")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert full_benchmark.main([
            "--device", "cpu", "--small", "--envs", "1", "--trials", "1",
            "--methods", PAPER, "--out-dir", str(out)]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("cpu: host run")
    return [json.loads(line) for line in lines[1:]], out


def test_full_benchmark_main_on_cpu(full_benchmark_run):
    """The tables, the wall clock and the trial count (4 densities x 5
    alphas x 4 methods), and the pickle with the JAX script's keys (those
    of its committed pickle), loaded through ``load_experiment``: a
    DataFrame of the rows, the tables read back from it."""
    (run, saved), out = full_benchmark_run
    assert run["trials"] == 80 and run["wall_clock_s"] > 0
    assert run["max_steps"] == full_benchmark.SMALL_STEPS
    methods = full_benchmark.PAPER_METHOD_LIST
    assert list(run["success_by_method"]) == methods
    assert all(list(run["success_by_method_alpha"][m]) == [
        str(a) for a in full_benchmark.ALPHA_LIST] for m in methods)
    assert set(run["time_to_goal_on_success"]) == set(methods)
    assert set(run["engine"]) == set(methods)
    assert saved["launches"] == {}
    path = saved["saved"]
    assert os.path.dirname(path) == str(out) and os.path.basename(path) == (
        "envs_1_trials_1_densities_4_device.pickle")
    exp = load_experiment(path)
    assert set(exp) == set(load_experiment(JAX_PICKLE))
    assert exp["engine"] == "device" and exp["method_list"] == methods
    df = exp["logger"]
    assert len(df) == 80 and list(df.columns) == list(
        load_experiment(JAX_PICKLE)["logger"].columns)
    rows = full_benchmark.logger_rows(df)
    tables = full_benchmark.tables(rows, methods, full_benchmark.ALPHA_LIST)
    for name, table in tables.items():
        assert table == run[name], name


def test_full_benchmark_pickle_without_pandas(full_benchmark_run,
                                              monkeypatch):
    """Where pandas does not import, the pickle's ``logger`` is a dict of
    numpy columns, which ``load_experiment`` and the tables read."""
    (run, saved), _ = full_benchmark_run
    rows = full_benchmark.logger_rows(load_experiment(saved["saved"])
                                      ["logger"])
    monkeypatch.setitem(sys.modules, "pandas", None)
    logger = full_benchmark.logger_table(rows)
    assert isinstance(logger, dict) and len(logger["success"]) == 80
    path = os.path.join(os.path.dirname(saved["saved"]), "columns.pickle")
    with open(path, "wb") as fh:
        pickle.dump(dict(logger=logger), fh)
    back = full_benchmark.logger_rows(load_experiment(path)["logger"])
    methods = full_benchmark.PAPER_METHOD_LIST
    assert full_benchmark.tables(back, methods, full_benchmark.ALPHA_LIST)[
        "success_by_method"] == run["success_by_method"]


def test_full_benchmark_tables_of_the_jax_pickle():
    """``tables`` of the JAX package's committed 1,800-trial pickle, read
    by ``checkpoint.load_experiment``: its success rates and times to goal
    as pandas groups them."""
    exp = load_experiment(JAX_PICKLE)
    df = exp["logger"]
    line = full_benchmark.tables(full_benchmark.logger_rows(df),
                                 exp["method_list"], exp["alpha_list"])
    assert len(df) == 1800 and exp["engine"] == "device"
    want = df.groupby("method")["success"].mean()
    for method, rate in want.items():
        assert line["success_by_method"][method] == pytest.approx(rate,
                                                                  abs=1e-12)
    by_alpha = df.groupby(["method", "alpha"])["success"].mean()
    for (method, alpha), rate in by_alpha.items():
        assert line["success_by_method_alpha"][method][str(alpha)] == (
            pytest.approx(rate, abs=1e-12))
    ttg = df[df.success].groupby("method")["time_to_goal"].mean()
    for method, t in ttg.items():
        assert line["time_to_goal_on_success"][method] == pytest.approx(
            t, rel=1e-12)


def test_engine_ab_build_equals_jax(monkeypatch):
    """``engine_ab_check.build``'s call of each engine against the JAX
    script's (engines stubbed to record their arguments): the same world,
    config, params and sweep, at full and at ``--small`` size."""
    jab = _load("scripts/engine_ab_check.py", "jax_engine_ab_check")
    import mppi_numba_tpu.benchmark as jbenchmark

    def recorder(seen, name):
        def record(*args, **kwargs):
            seen[name] = (args, kwargs)
            return []
        return record

    want, got = {}, {}
    for name in ("run_trials", "run_trials_device"):
        monkeypatch.setattr(jbenchmark, name, recorder(want, name))
    for name in ("run_trials_rows", "run_trials_device_rows"):
        monkeypatch.setattr(engine_ab_check.benchmark, name,
                            recorder(got, name))
    for small in (False, True):
        for host in (True, False):
            args = (2, 1, ["noisy_dyn", "risk_dyn"], [1.0, 0.5], 7, host,
                    small)
            jab.build(*args)
            engine_ab_check.build(*args, device="cpu")
        for jname, pname in (("run_trials", "run_trials_rows"),
                             ("run_trials_device", "run_trials_device_rows")):
            (jargs, jkw), (pargs, pkw) = want[jname], got[pname]
            _assert_problem((pargs[1], pargs[0], pargs[6]),
                            (jargs[1], jargs[0], jargs[6]))
            assert pargs[2:6] == jargs[2:6]
            assert pkw.pop("device") == "cpu"
            assert pkw == jkw


def test_engine_ab_main_on_cpu(capsys):
    """The JAX script's JSON keys (one dict a method), each engine's
    seconds and no launch on the CPU."""
    assert engine_ab_check.main([
        "--cpu", "--small", "--envs", "1", "--trials", "1",
        "--max-steps", "2"]) == 0
    out, times = _lines(capsys)
    assert out["n_trials_per_engine"] == 8
    assert set(out) == {"n_trials_per_engine", "noisy_dyn", "risk_dyn"}
    for meth in ("noisy_dyn", "risk_dyn"):
        assert set(out[meth]) == {
            "success_host", "success_dev", "success_delta", "ttg_host_s",
            "ttg_dev_s", "ttg_delta_s", "paired_outcome_agreement"}
        assert 0 <= out[meth]["paired_outcome_agreement"] <= 1
    assert set(times["seconds"]) == {"host", "device"}
    assert times["launches"] == {}


def test_engine_ab_compare_joins_on_the_keys():
    """The join without pandas: rows paired on the five keys in any order,
    the statistics as the JAX script's pandas merge gives them."""
    import pandas as pd

    rng = np.random.RandomState(4)
    host, dev = [], []
    for meth in ("noisy_dyn", "risk_dyn"):
        for alpha in (1.0, 0.5):
            for e in range(3):
                for t in range(2):
                    key = dict(method=meth, alpha=alpha,
                               grass_density_index=e % 2, sem_map_index=e,
                               map_sample_index=t)
                    for rows in (host, dev):
                        ok = bool(rng.rand() < 0.6)
                        rows.append(dict(key, success=ok, time_to_goal=(
                            rng.uniform(5, 15) if ok else np.nan)))
    dev = dev[::-1]
    got = engine_ab_check.compare(host, dev, ["noisy_dyn", "risk_dyn"])
    merged = pd.DataFrame(host).merge(pd.DataFrame(dev),
                                      on=list(engine_ab_check.KEYS),
                                      suffixes=("_host", "_dev"))
    assert got["n_trials_per_engine"] == 24
    for meth in ("noisy_dyn", "risk_dyn"):
        sub = merged[merged.method == meth]
        assert got[meth]["success_host"] == round(sub.success_host.mean(), 4)
        assert got[meth]["success_dev"] == round(sub.success_dev.mean(), 4)
        assert got[meth]["ttg_host_s"] == round(
            sub[sub.success_host].time_to_goal_host.mean(), 3)
        assert got[meth]["paired_outcome_agreement"] == round(
            (sub.success_host == sub.success_dev).mean(), 4)
    with pytest.raises(RuntimeError, match="pair"):
        engine_ab_check.compare(host, dev[1:], ["noisy_dyn"])
