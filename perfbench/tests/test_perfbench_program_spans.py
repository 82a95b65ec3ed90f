"""The readers of the program's own spans, on synthetic slices: each
returns the mean of its span's records in milliseconds, ignores the
harness's spans of the same layer, and reads nothing where its span is
absent (a program that names no such step)."""

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.trace import Slice, Spans

# Each new metric, the program's span it reads, and the harness's span of
# the same layer that encloses it.
METRICS = [
    ("planner.solve_prepare_ms.loop", "mppi.solve.prepare", "planner.solve"),
    ("planner.solve_fetch_ms.loop", "mppi.solve.fetch", "planner.solve"),
    ("graphs.replay_launch_ms.loop", "graphs.replay", "planner.solve"),
    ("graphs.replay_launch_ms.batch", "graphs.replay", "batch.replay"),
    ("graphs.replay_launch_ms.m1", "graphs.replay", "batch.replay"),
    ("sim.poll_ms.batch", "device_sim.poll", "batch.engine"),
    ("sim.poll_ms.m1", "device_sim.poll", "batch.engine"),
]
OTHER_SPANS = ("mppi.solve", "mppi.solve.prepare", "mppi.solve.fetch",
               "mppi.update", "graphs.replay", "device_sim.poll",
               "device_sim.result")


def _ctx(host):
    sl = Slice(Spans())
    sl.window = (0.0, 1000.0)
    sl.host = list(host)
    return SimpleNamespace(spans=Spans(), slice=sl, slice_work=[],
                           slice_calls=0, batch_calls=[])


@pytest.mark.parametrize("metric, span, harness_span", METRICS,
                         ids=[m for m, _, _ in METRICS])
def test_reads_the_mean_of_its_spans_records(metric, span, harness_span):
    # Durations in microseconds, as the trace gives them.
    host = [(harness_span, 0.0, 900.0), (span, 10.0, 20.0),
            (harness_span, 300.0, 500.0), (span, 310.0, 40.0),
            (span, 400.0, 90.0)]
    host += [(o, 600.0, 7.0) for o in OTHER_SPANS if o != span]
    assert harness.read_metric(metric, _ctx(host)) == pytest.approx(0.05)


@pytest.mark.parametrize("metric, span, harness_span", METRICS,
                         ids=[m for m, _, _ in METRICS])
def test_reads_nothing_without_its_span(metric, span, harness_span):
    host = [(harness_span, 0.0, 900.0)]
    host += [(o, 10.0, 7.0) for o in OTHER_SPANS if o != span]
    assert harness.read_metric(metric, _ctx(host)) is None
    assert harness.read_metric(metric, _ctx([])) is None


@pytest.mark.parametrize("metric", [m for m, _, _ in METRICS])
def test_reads_nothing_without_a_slice(metric):
    ctx = SimpleNamespace(spans=Spans(), slice=None, slice_work=[],
                          slice_calls=0, batch_calls=[])
    assert harness.read_metric(metric, ctx) is None


@pytest.mark.parametrize("metric, reader", [
    ("planner.solve_prepare_ms.loop", "planner.solve_prepare_ms"),
    ("planner.solve_fetch_ms.loop", "planner.solve_fetch_ms"),
    ("graphs.replay_launch_ms.m1", "graphs.replay_launch_ms"),
    ("sim.poll_ms.batch", "sim.poll_ms"),
])
def test_each_metric_has_its_own_reader(metric, reader):
    assert harness.reader_path(metric).stem == reader


def test_the_new_metrics_are_in_the_manifest():
    per_layer = {m["name"]: m for m in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["per_layer"]}
    for metric, _, _ in METRICS:
        m = per_layer[metric]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["better"] == "lower"


def test_program_spans_are_named_apart_from_the_harness_spans():
    """The innermost-record rule of ``Slice.idle_gaps`` hands a gap to the
    program's span only where it has a name of its own."""
    sl = Slice(Spans())
    sl.window = (0.0, 100.0)
    sl.device = [("k", 60.0, 40.0)]
    sl.host = [("planner.solve", 0.0, 100.0), ("mppi.solve", 2.0, 96.0),
               ("mppi.solve.prepare", 4.0, 50.0)]
    assert dict(sl.idle_gaps()) == pytest.approx(
        {"mppi.solve.prepare": 60e-6})
