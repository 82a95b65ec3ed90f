"""The port's measurement drivers (``mppi_numba_tpu_torch.drivers``)
against the JAX package's scripts: each problem builder field by field,
exactly; each driver's ``main`` on the CPU at a small size, its lines
parsing with the JAX script's keys; ``scaling_bench`` on two gloo ranks,
passing its own check."""

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mppi_numba_tpu_torch.drivers import (bench, bigmap_bench, model_bench,
                                          profile_flagship, scaling_bench,
                                          serve_bench)

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
