"""The frozen yardstick at hand-counted shapes, the seeded inputs'
determinism, and the per-layer readers on an empty slice."""

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import inputs, readings, yardstick
from perfbench.trace import Slice, Spans, short_name

HBM, FP32 = 3.35e12, 67e12
ALU, SCHED = 132 * 64 * 1.98e9, 132 * 128 * 1.98e9


def test_rollout_bound_flagship_shape_is_operations():
    # K = M = 1024, T = 100, 11 x 11, fast trig: 55 operations a
    # lane-step (59 less the decode's 4), 6 + 2 a lane.
    ops = 1024 * 1024 * (100 * 55 + 6 + 2)
    assert yardstick.rollout_least_s(1024, 1024, 100, 11, 11, True,
                                     False) == pytest.approx(ops / FP32)


def test_rollout_bound_m1_speed_map_is_bytes():
    # M = 1: 2-bit cells 16 words + mask 8 + risk 31 + table 32 = 87 map
    # words, the task 19, the controls 2 T K, the costs K.
    nbytes = 4 * (87 + 19 + 2 * 100 * 1024 + 1024)
    ops = 1024 * (100 * 42 + 6) + 4 * 256
    assert nbytes / HBM > ops / FP32
    assert yardstick.rollout_least_s(1024, 1, 100, 11, 11, False,
                                     True) == pytest.approx(nbytes / HBM)


def test_map_sample_bound_window_shape():
    n = 1024 * 65 * 65
    alu = n * 43 / ALU
    every = (n * 79 + 65 * 65 * (2 * 44 + 2 * 101)) / SCHED
    nbytes = 44 * (65 * 65 + 1) + 16 + 2.5 * n
    assert alu > every and alu > nbytes / HBM
    assert yardstick.map_sample_least_s(1024, 65, 65, 44) == \
        pytest.approx(alu)


def test_map_sample_bound_small_map():
    n = 1 * 11 * 11
    every = (n * 79 + 121 * (2 * 44 + 2 * 101)) / SCHED
    nbytes = 44 * 122 + 16 + 2.5 * n
    assert yardstick.map_sample_least_s(1, 11, 11, 44) == pytest.approx(
        max(n * 43 / ALU, every, nbytes / HBM))


def test_solve_bound_sums_its_stages():
    s = dict(K=1024, M=1024, T=100, rH=11, rW=11, bins=44, numel=205,
             fast_trig=True, speed_map=False)
    total = (yardstick.map_sample_ops_s(1024, 11, 11, 44)
             + yardstick.rollout_ops_s(1024, 1024, 100, True, False)
             + yardstick.tail_ops_s(1024, 1024, 100, 205))
    assert yardstick.solve_least_s(s) == pytest.approx(total)
    comps = 1024 * (1024 + 205 * np.log2(205))
    flops = 1024 * (205 + 1 + 600 + 2) + 1024 * 7 + 1024 * 400 + 600
    assert yardstick.tail_ops_s(1024, 1024, 100, 205) == pytest.approx(
        comps / ALU + flops / FP32)


CFG = dict(world=dict(bounds=[0.0, 1.0], num_bins=20, pmf_samples=200,
                      terrains=[dict(name="Dirt", id=0,
                                     lin=dict(weights=[1.0], means=[0.65],
                                              stds=[0.1]),
                                     ang=dict(weights=[1.0], means=[0.65],
                                              stds=[0.1])),
                                dict(name="Veg", id=1,
                                     lin=dict(weights=[0.6, 0.4],
                                              means=[0.0, 0.8],
                                              stds=[0.15, 0.1]),
                                     ang=dict(weights=[0.6, 0.4],
                                              means=[0.0, 0.8],
                                              stds=[0.15, 0.1]))]),
           grid=dict(shape=[9, 9], mud_margin=1, res=1.0, grass_density=0.4),
           protocol=dict(densities=[1.0, 0.1], envs_per_density=2,
                         trials_per_env=2))


@pytest.mark.parametrize("make", ["protocol", "one_map"])
def test_inputs_follow_the_seed(make):
    def draw(seed):
        if make == "protocol":
            w, grids, rows = inputs.protocol(CFG, seed)
            return ([w["terrains"]["Veg"]["lin"][1]] + list(grids.values())
                    + [r["gt"][0] for r in rows])
        w, sg, truths = inputs.one_map(CFG, seed, 2)
        return [w["terrains"]["Dirt"]["ang"][1], sg] + [t[1] for t in truths]

    a, b, c = draw(2 ** 31 + 17), draw(2 ** 31 + 17), draw(5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_start_goal_distance_and_bounds():
    rng = np.random.RandomState(3)
    for _ in range(50):
        x0, goal = inputs.start_goal(rng, (248, 248), 1.0, 16.0, (8, 13))
        assert 16 <= x0[0] <= 232 and 16 <= x0[1] <= 232
        assert 2 <= goal[0] <= 246 and 2 <= goal[1] <= 246
        assert np.hypot(*(goal - x0[:2])) <= 13 + 1e-9


def test_world_pmfs_are_distributions():
    w = inputs.make_world(CFG["world"], 11)
    assert w["num_pmf_bins"] == 22 and w["bin_values"][0] == 0
    for t in w["terrains"].values():
        for plane in ("lin", "ang"):
            assert t[plane][1].sum() == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["solver.roofline.loop",
                                  "kernels.rollout_roofline.batch",
                                  "device.idle_share.loop",
                                  "graphs.kernels_per_solve.loop",
                                  "planner.solve_host_ms.loop",
                                  "sim.solves_per_s.batch"])
def test_readers_return_nothing_without_readings(name):
    from perfbench import harness

    ctx = SimpleNamespace(spans=Spans(), slice=None, slice_work=[],
                          slice_calls=0, batch_calls=[])
    assert harness.read_metric(name, ctx) is None


def test_slice_readings_from_records():
    sl = Slice(Spans())
    sl.window = (0.0, 100.0)
    sl.device = [("void ns::rollout_byte_kernel<1>(int)", 10.0, 30.0),
                 ("map_sample_kernel", 35.0, 10.0),
                 ("Memcpy DtoH", 60.0, 10.0)]
    sl.kernel_ops = sl.device[:2]
    sl.host = [("planner.solve", 0.0, 50.0), ("sim.step", 80.0, 20.0)]
    assert sl.busy_s() == pytest.approx(45e-6)
    gaps = dict(sl.idle_gaps())
    assert gaps["planner.solve"] == pytest.approx(10e-6)
    assert gaps["harness"] == pytest.approx(15e-6)
    assert gaps["sim.step"] == pytest.approx(30e-6)
    ctx = SimpleNamespace(slice=sl, slice_work=[(1, dict(
        K=1, M=1, T=1, rH=1, rW=1, bins=2, numel=1, fast_trig=False,
        speed_map=False))], slice_calls=2)
    assert readings.kernels_per_call(ctx) == 1.0
    assert readings.idle_share(ctx) == pytest.approx(55.0)
    assert readings.kernel_seconds(ctx, readings.ROLLOUT_KERNELS) == \
        pytest.approx(30e-6)
    assert short_name(sl.device[0][0]) == "rollout_byte_kernel"
