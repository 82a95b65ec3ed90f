"""The control, and the program's own readings beside it, for setting a
cell's limits (``limits/<cell>.json``).

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed: one run of the cell's window (set-up as in a benchmark
run), then the check's numbers twice: the program's (the lower readings)
and those of the control, the plain reference computed in bfloat16 put in
the program's place (the upper readings).  One JSON line a seed.  The
benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        a = harness.parse(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"])
        cell, _, run, result = harness.drive_cell(a, time.perf_counter(),
                                                  device)
        _, ok, program = harness.judge(cell, run, result)
        _, bad, control = harness.judge(cell, run, result, control=True)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              program=program, program_correct=ok,
                              control=control, control_correct=bad)),
              flush=True)
        del run, result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
