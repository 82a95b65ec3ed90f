"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: a sound run comes out correct; the control (the plain
reference in bfloat16 in the program's place) and each fault that a cell
can have, planted in the program underneath, come out not correct.  One
card a cell, so no exchange between cards can be left out."""

import time

import pytest
import torch

from perfbench import harness

CELLS = ["map_250x250.closed_loop", "protocol_9x9.noisy_dyn_b30",
         "protocol_9x9.m1_b30", "map_250x250.fleet_b16"]
BATCH = CELLS[1:]
SMALL = {"config": {"planner": {"num_control_rollouts": 100,
                                "num_grid_samples": 8, "T": 2.0},
                    "protocol": {"envs_per_density": 1, "alphas": [0.4]}},
         "traffic": {"warmup_steps": 3, "check_every": 5, "chunk": 6,
                     "start_sets": 2, "margin_m": 8.0}}
# The 250 x 250 map's cells on a 60 x 60 grid.
SMALL_MAP = {"grid": {"shape": [60, 60]}}
# A window long enough to run the first chunk of each (method, alpha).
SECONDS = {"protocol_9x9.m1_b30": "20"}


def run(cell, control=False, traffic=None):
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 3),
                          "--seconds", SECONDS.get(cell, "1"),
                          "--trace", "0"])
    over = dict(SMALL, control=control)
    if cell.startswith("map_250x250"):
        over["config"] = harness.merge(SMALL["config"], SMALL_MAP)
    if traffic:
        over["traffic"] = harness.merge(SMALL["traffic"], traffic)
    line, notes = harness.run_cell(args, time.perf_counter(),
                                   torch.device("cpu"), over)
    return line, notes


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line, notes = run(cell)
    assert line["correct"], str(line["checks"])
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert notes.get("solves_checked", notes.get("steps_checked")) > 0


@pytest.mark.parametrize("method", ["risk_dyn", "nom_dyn_risk_cost"])
def test_a_closed_loop_in_another_mode_is_correct(method):
    """A mix names the planner's method: the loop and its check follow
    it (the M = 1 modes' maps, draws and costs)."""
    line, notes = run(CELLS[0], traffic={"method": method})
    assert line["correct"], str(line["checks"])
    assert notes["solves_checked"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    line, _ = run(cell, control=True)
    assert not line["correct"], line["checks"]


@pytest.fixture
def planner_fault(monkeypatch):
    from mppi_numba_tpu_torch.mppi import MPPIPlanner

    solve = MPPIPlanner.solve

    def plant(kind):
        def faulty(self):
            u_in = self._u_in.cpu().numpy().copy()
            out = solve(self)
            if kind == "unchanged":
                return u_in
            out[0, 0] += 0.3
            return out

        monkeypatch.setattr(MPPIPlanner, "solve", faulty)

    return plant


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_faulty_planner_is_caught(planner_fault, kind):
    planner_fault(kind)
    line, _ = run(CELLS[0])
    assert not line["correct"], line["checks"]


@pytest.fixture
def episode_fault(monkeypatch):
    from mppi_numba_tpu_torch import device_sim

    step = device_sim._Episodes.step

    def plant(kind):
        def faulty(self, *a):
            before = [t.clone() for t in self.tensors()]
            if kind != "unchanged":
                step(self, *a)
            if kind == "half":
                half = len(self.x) // 2
                for t, b in zip(self.tensors(), before):
                    t[half:] = b[half:]
            if kind == "altered":
                self.u[0] += 0.3
            if kind == "reached_early":
                # The goal's tolerance counted twice.
                self.reached.logical_or_(self.dist <= 0.5)
            if kind == "two_steps":
                step(self, *a)

        monkeypatch.setattr(device_sim._Episodes, "step", faulty)

    return plant


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "reached_early", "two_steps"])
@pytest.mark.parametrize("cell", BATCH)
def test_a_faulty_episode_step_is_caught(episode_fault, cell, kind):
    episode_fault(kind)
    line, _ = run(cell)
    assert not line["correct"], line["checks"]

