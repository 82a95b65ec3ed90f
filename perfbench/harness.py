"""One run of one cell: set-up, a window of ``--seconds``, the check
against the plain reference, and the result's line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``perfbench/configs/<config>.json``, its traffic
``perfbench/traffic/<traffic>.json`` (parameters, and the ``driver``
that runs them: ``perfbench/drivers/<driver>.py``), its limits
``perfbench/limits/<cell>.json``.  With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
read by ``perfbench/metrics/<metric>.py`` (or, where a metric has no file
of its own, by the reader of its name without the last ``.`` part:
``solver.roofline.py`` reads ``solver.roofline.loop``) from a profiled
slice of the window and the host spans.  Each number that decides
``correct`` is printed beside its limit, as the last lines of standard
error and under ``checks``, the line's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "mppi_numba_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: the
    loaded modules), compared whole: the part before the first dot."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def merge(base, extra):
    """``base`` with ``extra``'s keys laid over it, nested dicts merged."""
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def cell_spec(manifest, name):
    """The workload entry, and the metrics it reports: ``(cell,
    end_to_end, per_layer)``; a metric belongs to a cell that its
    ``workloads`` names or, without that key, to every cell."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit("unknown workload {!r}; the cells are {}".format(
            name, sorted(cells)))

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return (cells[name], mine(manifest["end_to_end"]),
            mine(manifest["per_layer"]))


def reader_path(name):
    """The file that reads metric ``name``: ``metrics/<name>.py``, else
    that of the name without its last ``.`` part, and so on."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError("no reader for metric {!r} under {}".format(
        name, HERE / "metrics"))


def read_metric(name, ctx):
    """The reading of metric ``name``, or None."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("perfbench_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def drive_cell(args, t_start, device, overrides=None):
    """Set up and drive one run's window: ``(cell, metrics, run,
    result)``, ``metrics`` the cell's ``(end_to_end, per_layer)``.
    ``overrides``: ``{"config": ..., "traffic": ...}`` laid over the
    cell's files (the tests' small sizes)."""
    from . import drive
    from .trace import Spans

    overrides = overrides or {}
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, e2e, per_layer = cell_spec(manifest, args.workload)
    cfg = merge(load_json(HERE / "configs" / (cell["config"] + ".json")),
                overrides.get("config"))
    mix = merge(load_json(HERE / "traffic" / (cell["traffic"] + ".json")),
                overrides.get("traffic"))
    run = SimpleNamespace(cfg=cfg, mix=mix, seed=args.seed,
                          seconds=args.seconds, trace=args.trace,
                          device=device, t_start=t_start, spans=Spans())
    result = drive.driver(mix["driver"]).drive(run)
    return cell, (e2e, per_layer), run, result


def judge(cell, run, result, control=False):
    """The check's numbers, each beside its limit, and whether all hold:
    ``(checks, correct, numbers)``."""
    from . import drive

    limits = load_json(HERE / "limits" / (cell["name"] + ".json"))
    numbers = drive.driver(run.mix["driver"]).numbers(run, result,
                                                      control=control)
    checks = {k: dict(value=numbers[k], limit=v) for k, v in limits.items()}
    return (checks, all(c["value"] <= c["limit"] for c in checks.values()),
            numbers)


def run_cell(args, t_start, device, overrides=None):
    """One run: ``(result line dict, notes)``."""
    cell, (e2e, per_layer), run, result = drive_cell(args, t_start, device,
                                                     overrides)
    t0 = time.perf_counter()
    checks, correct, numbers = judge(cell, run, result,
                                     bool((overrides or {}).get("control")))
    result.info["reference_s"] = time.perf_counter() - t0
    if args.trace:
        ctx = SimpleNamespace(spans=run.spans, slice=result.slice,
                              slice_work=result.slice_work,
                              slice_calls=result.slice_calls,
                              batch_calls=result.batch_calls)
        metrics = {}
        for m in per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(result.e2e, setup_s=result.setup_s)
        metrics = {m["name"]: dict(value=float(values[m["name"]]),
                                   unit=m["unit"]) for m in e2e}
    line = dict(correct=correct, attempted=result.attempted,
                failed=result.failed, metrics=metrics,
                device=device_info(device, cell["chips"],
                                   result.memory_peak_bytes))
    if args.trace:
        sl = result.slice
        if sl is None or sl.window is None:
            raise RuntimeError("the traced run profiled no slice")
        line["device"].update(busy_s=sl.busy_s(), window_s=sl.window_s())
        line["breakdown"] = dict(device_ops=sl.top_ops(),
                                 idle_gaps=sl.idle_gaps())
    line["checks"] = checks
    return line, dict(numbers, **result.info)


def device_info(device, chips, peak):
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips, memory_peak_bytes=peak)


def parse(argv):
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    import torch

    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, _, _ = cell_spec(manifest, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print("the cell needs {} CUDA devices; {} present".format(
            cell["chips"], torch.cuda.device_count()), file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, notes = run_cell(args, t_start, device)
    bad = forbidden_modules()
    if bad:
        print("loaded modules that no run may load: {}".format(
            ", ".join(bad)), file=sys.stderr)
        return 3
    print(json.dumps(dict(notes=notes)), file=sys.stderr)
    for name, c in line["checks"].items():
        print("check {}: {!r} limit {!r}".format(name, c["value"],
                                                 c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
