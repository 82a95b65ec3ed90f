"""On the card only (marker ``gpu``; each test skips itself where no
CUDA device is present): one short run of each cell as the benchmark's
command runs it, its last line read back."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# A window that runs the first chunk of each (method, alpha): the five
# alphas' noisy_dyn chunks take about 1.6 s each.
SECONDS = {"protocol_9x9.noisy_dyn_b30": "12"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", SECONDS.get(cell, "2"),
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
