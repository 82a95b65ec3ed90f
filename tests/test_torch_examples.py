"""The port's examples (``mppi_numba_tpu_torch.examples``) against the JAX
package's ``examples/*.py``: what each synthesises, equal; each example's
staged planner (maps, task, static but the backend) and ground truth bit
for bit with the JAX script's, run up to its first ``solve()`` or its
``trial``; each terrain example's first solve at small K and M within the
whole-solve tolerance of JAX's, JAX's map key and normals injected; and
each module's ``main`` at ``--small`` on the CPU, writing only into its
``--out-dir``."""

import dataclasses
import importlib.util
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.solver import get_terrain_solver as j_get_solver
from mppi_numba_tpu_torch.config import SolverStatic
from mppi_numba_tpu_torch.examples import (barebone_mppi, confidence_planning,
                                           costmap_planning,
                                           external_pmf_planning,
                                           planner_animation,
                                           terrain_planning)
from mppi_numba_tpu_torch.solver import get_terrain_solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5       # the JAX package's whole-solve tolerance
# The first solve's small sizes.
SOLVE_K, SOLVE_M = 64, 16
# (module, JAX script, mode): every example and mode.
CASES = [
    (barebone_mppi, "barebone_mppi", None),
    (terrain_planning, "terrain_planning", "tdm"),
    (terrain_planning, "terrain_planning", "det"),
    (terrain_planning, "terrain_planning", "speed"),
    (external_pmf_planning, "external_pmf_planning", None),
    (costmap_planning, "costmap_planning", None),
    (confidence_planning, "confidence_planning", None),
    (planner_animation, "planner_animation", "tdm"),
    (planner_animation, "planner_animation", "det"),
    (planner_animation, "planner_animation", "speed"),
    (planner_animation, "planner_animation", "example"),
]
TERRAIN = [c for c in CASES if c[0] is not barebone_mppi]


def _id(case):
    return case[1] + ("" if case[2] is None else "-" + case[2])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small eager solves: one torch thread a test, put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    """A JAX example loaded from ``examples/`` by path (its own module,
    matplotlib on Agg); ``sys.path`` put back after."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_example_" + name, os.path.join(REPO, "examples",
                                                name + ".py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


class _Stop(Exception):
    pass


def _run_jax(name, mode, monkeypatch, tmp_path, conf_thres=0.3):
    """The JAX example run up to its first ``solve()`` or its ``trial``
    (stubbed to record and raise): ``{"planner", "truth"}``."""
    module = _load(name)
    seen = {}
    if hasattr(module, "MPPIPlanner"):
        class Planner(module.MPPIPlanner):
            def solve(self):
                seen["planner"] = self
                raise _Stop

        monkeypatch.setattr(module, "MPPIPlanner", Planner)

        class RecordingTDM(module.TDM):
            def sample_grids_true_dist(self, rng=None):
                seen["truth"] = super().sample_grids_true_dist(rng)
                return seen["truth"]

        monkeypatch.setattr(module, "TDM", RecordingTDM)
    else:
        class Barebone(module.BareboneMPPI):
            def solve(self):
                seen["planner"] = self
                raise _Stop

        monkeypatch.setattr(module, "BareboneMPPI", Barebone)
    if hasattr(module, "trial"):
        def trial(planner, grid, *args, **kwargs):
            seen.update(planner=planner, truth=grid)
            raise _Stop

        monkeypatch.setattr(module, "trial", trial)
    # The synthetic map of confidence_planning: no tdm_models tree.
    monkeypatch.setattr(sys, "argv", [name, str(conf_thres),
                                      str(tmp_path / "no_tdm_models")])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(_Stop):
        if mode == "example":
            module.main_example_vis()
        elif mode is None:
            module.main()
        else:
            module.main(mode)
    return seen


def _build(module, mode):
    """The port example's world on the CPU at full size."""
    if module is terrain_planning:
        return module.build(mode, device="cpu")
    if module is planner_animation:
        return module.build(mode, device="cpu")
    return module.build(device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree(port, jax_tree, what):
    assert port._fields == jax_tree._fields, what
    for name, p, j in zip(port._fields, port, jax_tree):
        if j is None:
            assert p is None, (what, name)
            continue
        p, j = _np(p), _np(j)
        assert p.dtype == j.dtype and p.shape == j.shape, (what, name)
        np.testing.assert_array_equal(p, j, err_msg="{} {}".format(what,
                                                                   name))


def _assert_static(port, jax_static):
    want = dataclasses.asdict(jax_static)
    got = dataclasses.asdict(port)
    assert set(got) == set(want)
    for name in set(want) - {"backend"}:
        assert got[name] == want[name], name


# -- what the examples synthesise ------------------------------------------


def test_synth_pmf_grid_equals_jax():
    jex = _load("external_pmf_planning")
    for args in ((), (12, 30, 40), (5, 9, 7, 3)):
        for got, want in zip(external_pmf_planning.synth_pmf_grid(*args),
                             jex.synth_pmf_grid(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_synth_tdm_equals_jax():
    jex = _load("confidence_planning")
    for args in ((), (20, 15, 6, 4)):
        for got, want in zip(confidence_planning.synth_tdm(*args),
                             jex.synth_tdm(*args)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_make_costmap_equals_jax():
    jex = _load("costmap_planning")
    for args in ((), (16, 40)):
        got, want = costmap_planning.make_costmap(*args), jex.make_costmap(
            *args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_animation_grids_equal_jax():
    jex = _load("planner_animation")
    for fn in ("fixed_semantic_map", "reference_example_grid"):
        got, want = getattr(planner_animation, fn)(), getattr(jex, fn)()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conf_thres", [-1.0, 0.3, 0.6])
def test_start_and_goal_equal_jax(conf_thres, monkeypatch, tmp_path):
    """The BFS start and goal of ``confidence_planning.main``: the JAX
    script's x0 and goal (its planner's params) against the port's pick on
    the same map and mask."""
    seen = _run_jax("confidence_planning", None, monkeypatch, tmp_path,
                    conf_thres)
    jp = seen["planner"]
    w = confidence_planning.build(conf_thres, device="cpu")
    np.testing.assert_array_equal(w.params["x0"], jp.params["x0"])
    np.testing.assert_array_equal(w.params["xgoal"], jp.params["xgoal"])
    start, goal = confidence_planning.start_and_goal(w.gt, w.unknown, 0.5)
    assert start != goal
    assert w.params["xgoal"][0] == 0.5 * goal[1] + 0.25


# -- staging, bit for bit ------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_staging_equals_jax(case, monkeypatch, tmp_path):
    """The example's planner as staged for its first solve, and its ground
    truth, bit for bit with the JAX script's."""
    module, name, mode = case
    seen = _run_jax(name, mode, monkeypatch, tmp_path)
    jp = seen["planner"]
    w = _build(module, mode)
    tp = w.planner
    if module is barebone_mppi:
        _assert_tree(tp._task_device, jp._task_device, "task")
        _assert_static(tp._static(), jp._static())
        return
    _assert_tree(tp._map_inputs(), jp._map_inputs(), "maps")
    _assert_tree(tp._build_task(), jp._build_task(), "task")
    _assert_static(tp._static(), jp._static())
    if module is external_pmf_planning:
        return
    truth = seen["truth"]
    for attr in ("lin_traction", "ang_traction"):
        got, want = getattr(w.truth, attr), getattr(truth, attr)
        assert got.dtype == want.dtype, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)
    for attr in ("res", "xlimits", "ylimits"):
        assert np.all(np.asarray(getattr(w.truth, attr))
                      == np.asarray(getattr(truth, attr))), attr


# -- the first solve -------------------------------------------------------------


def _small(static, lambda_alpha):
    """``static`` at the first solve's small K and M (M kept at 1 where
    the solve rolls one map), the CVaR at the example's alpha."""
    M = SOLVE_M if static.num_grid_samples > 1 else 1
    cvar = math.ceil(M * lambda_alpha) if M > 1 else 1
    return dict(num_control_rollouts=SOLVE_K, num_grid_samples=M,
                cvar_numel=cvar,
                num_vis_state_rollouts=min(static.num_vis_state_rollouts, M))


@pytest.mark.parametrize("case", TERRAIN, ids=_id)
def test_first_solve_matches_jax(case, monkeypatch, tmp_path):
    """The example's first solve at K = 64, M = 16 (1 where the solve rolls
    one map), its own T, window and lambda (1), JAX's planner key and
    draws injected through ``solve_from_key``: the grids exact, u within
    rtol 2e-4 / atol 2e-5 of JAX's XLA solve."""
    module, name, mode = case
    seen = _run_jax(name, mode, monkeypatch, tmp_path)
    jp = seen["planner"]
    tp = _build(module, mode).planner
    assert float(tp.params["lambda_weight"]) == 1.0
    js = jp._static()
    small = _small(js, float(jp.params.get("cvar_alpha", 1.0)))
    jstatic = dataclasses.replace(js, backend="xla", **small)
    _, key = jax.random.split(jp._key)
    j_u, j_aux = j_get_solver(jstatic)(key, jp._map_inputs(),
                                       jp._task_device, jp.u_cur)

    kmap, knoise = jax.random.split(key)
    eps = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(knoise, i),
        (SOLVE_K, jstatic.num_steps, 2), dtype=jnp.float32)))
        for i in range(jstatic.num_opt)]
    map_key = torch.tensor(np.asarray(jax.random.key_data(kmap))
                           .astype(np.int64))
    tstatic = dataclasses.replace(tp._static(), backend="eager", **small)
    _assert_static(tstatic, jstatic)
    u, aux = get_terrain_solver(tstatic, "cpu").solve_from_key(
        map_key, eps, tp._map_inputs(), tp._task_device, tp.u_cur)
    np.testing.assert_array_equal(aux.lin_grids.numpy(),
                                  np.asarray(j_aux.lin_grids))
    np.testing.assert_array_equal(aux.ang_grids.numpy(),
                                  np.asarray(j_aux.ang_grids))
    np.testing.assert_allclose(u.numpy(), np.asarray(j_u), rtol=RTOL,
                               atol=ATOL)


# -- each module's main ---------------------------------------------------------


def _argv(case):
    return [] if case[2] is None else [case[2]]


def _files(path):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, fs in os.walk(path) for f in fs}


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_main_small_on_cpu(case, capsys, monkeypatch, tmp_path):
    """``main(["--small", "--device", "cpu", "--out-dir", out])``: the card
    line, then JSON lines with the outcome; its figure in ``out`` and
    nothing written in the working directory or in the repository's
    ``examples/`` and ``mppi_benchmark/``."""
    module = case[0]
    cwd, out = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    watched = [os.path.join(REPO, d) for d in ("examples", "mppi_benchmark")]
    before = [_files(d) for d in watched]
    assert module.main(["--small", "--device", "cpu", "--out-dir", str(out)]
                       + _argv(case)) == 0
    assert [_files(d) for d in watched] == before
    assert os.listdir(cwd) == []
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu: host run")
    records = [json.loads(line) for line in lines[1:]]
    (rec,) = [r for r in records if "outcome" in r]
    assert rec["example"] == module.EXAMPLE
    assert rec["solve_ms"]["clock"] == "host clock, eager (cpu)"
    assert rec["launches"] == {} and rec["solve_graphs"] == 0
    if module is external_pmf_planning:
        assert np.shape(rec["outcome"]["first_controls"]) == (5, 2)
        assert np.shape(rec["outcome"]["rollout_endpoints"]) == (5, 2)
        assert rec["figures"] == []
    else:
        assert rec["outcome"]["steps"] == 2
        assert rec["outcome"]["success"] in (True, False)
        assert rec["solve_ms"]["solves"] == 2
        (figure,) = rec["figures"]
        assert os.path.dirname(figure) == str(out)
        assert sorted(os.listdir(out)) == [os.path.basename(figure)]
    if module is not barebone_mppi:
        (desc,) = [r for r in records if "backend" in r]
        assert desc["backend"] == "eager"


@pytest.mark.parametrize("case", [c for c in CASES if c[2] in (None, "tdm")],
                         ids=_id)
def test_main_needs_a_card_by_default(case, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        case[0].main(["--small"] + _argv(case))
    assert capsys.readouterr().out == ""
