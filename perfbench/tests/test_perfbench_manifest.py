"""BENCHMARK.json against the benchmark's contract, and the files it
names: names and units of the allowed characters, every metric's
``moves`` an end-to-end metric that each of its cells reports, a reader
for every per-layer metric, a configuration, traffic mix and limits for
every cell."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    for word in MANIFEST["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys_and_names(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and section in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


def test_names_are_unique_across_metrics():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_by_each_of_its_cells(metric):
    for cell in metric.get("workloads",
                           [w["name"] for w in MANIFEST["workloads"]]):
        _, e2e, _ = harness.cell_spec(MANIFEST, cell)
        assert metric["moves"] in {m["name"] for m in e2e}, (metric, cell)


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(metric):
    path = harness.reader_path(metric["name"])
    assert path.parent == ROOT / "perfbench" / "metrics"
    assert metric["name"].startswith(path.stem)
    assert "def read(ctx)" in path.read_text()


@pytest.mark.parametrize("name, reader", [
    ("solver.roofline.loop", "solver.roofline"),
    ("solver.roofline", "solver.roofline"),
    ("graphs.kernels_per_step.m1", "graphs.kernels_per_step"),
    ("device.idle_share.a.b", "device.idle_share"),
])
def test_a_reader_serves_the_names_below_it(name, reader):
    assert harness.reader_path(name).stem == reader


def test_a_metric_without_a_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        harness.reader_path("nothing.here")


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_every_mix_names_a_driver(cell):
    from perfbench import drive

    mix = json.loads((ROOT / "perfbench" / "traffic" /
                      (cell["traffic"] + ".json")).read_text())
    mod = drive.driver(mix["driver"])
    assert callable(mod.drive) and callable(mod.numbers)
    limits = json.loads((ROOT / "perfbench" / "limits" /
                         (cell["name"] + ".json")).read_text())
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("name", ["../harness", "a.b", "batch/x", ""])
def test_a_driver_is_found_by_a_plain_name_only(name):
    from perfbench import drive

    with pytest.raises(ValueError):
        drive.driver(name)


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    assert cell["chips"] == 1
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    assert (ROOT / "perfbench" / "traffic" /
            (cell["traffic"] + ".json")).is_file()
    assert (ROOT / "perfbench" / "limits" /
            (cell["name"] + ".json")).is_file()
    _, e2e, per_layer = harness.cell_spec(MANIFEST, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("perfbench/")
    body = json.loads(path.read_text())
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"]
               for w in MANIFEST["workloads"])


def test_layers_are_spelled_alike():
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("modules, found", [
    (["mppi_numba_tpu_torch", "mppi_numba_tpu_torch.solver", "numpy"], []),
    (["mppi_numba_tpu", "mppi_numba_tpu_torch"], ["mppi_numba_tpu"]),
    (["jax.numpy", "torch"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["jaxtyping", "mppi_numba_tpu_torchx"], []),
])
def test_import_check_compares_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found
