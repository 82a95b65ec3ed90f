"""The full benchmark's tables as Markdown, from the port's experiment
pickle; the counterpart of ``scripts/summarize_benchmark.py``.

    python -m mppi_numba_tpu_torch.drivers.summarize_benchmark [PICKLE] [--dir DIR] [--out PATH]

Reads ``PICKLE``, or the newest of ``drivers.full_benchmark``'s pickles
under ``--dir`` (default ``build/mppi_benchmark_torch/``): the largest
sweep, the newest on ties, as the JAX script picks.  Renders the three
tables of ``full_benchmark.tables`` (success by method beside the
reference paper run's, by method x alpha, and the mean time to goal on
successes) with the sweep's size, wall clock and card into ``--out``
(default ``build/benchmark_summary_torch.md``) and prints the path.  The
card is the line ``full_benchmark`` wrote beside its pickle
(``<pickle>.card``); a pickle without one says so.  It never writes
``BENCHMARK_RESULTS.md``, which holds the TPU rounds' results, and needs
neither pandas nor a card.
"""

from __future__ import annotations

import argparse
import glob
import os
import re

from ..checkpoint import load_experiment
from .full_benchmark import OUT_DIR, logger_rows, tables

OUT = os.path.join("build", "benchmark_summary_torch.md")
# The reference paper run's success rates (BASELINE.md, 16,000 trials).
PAPER = {"noisy_dyn": 0.893, "risk_dyn": 0.736, "nom_dyn_risk_cost": 0.536,
         "baseline": 0.530}
RESERVED = "BENCHMARK_RESULTS.md"


def card_path(pickle_path):
    """Where ``full_benchmark`` writes the card line of a pickle's run."""
    return pickle_path + ".card"


def newest_pickle(directory=OUT_DIR):
    """The largest sweep's pickle under ``directory`` (environments x
    realizations), the newest on ties."""
    cands = glob.glob(os.path.join(directory, "envs_*_device*.pickle"))
    if not cands:
        raise SystemExit("no benchmark pickles under {}".format(directory))

    def scale(p):
        m = re.search(r"envs_(\d+)_trials_(\d+)", os.path.basename(p))
        return int(m.group(1)) * int(m.group(2)) if m else 0

    return max(cands, key=lambda p: (scale(p), os.path.getmtime(p)))


def fmt(value, spec="{:.3f}"):
    return "n/a" if value is None else spec.format(value)


def render(path):
    """The Markdown of the pickle at ``path``."""
    data = load_experiment(path)
    rows = logger_rows(data["logger"])
    methods, alphas = data["method_list"], data["alpha_list"]
    t = tables(rows, methods, alphas)
    try:
        with open(card_path(path)) as fh:
            card = fh.read().strip()
    except FileNotFoundError:
        card = "not recorded beside this pickle"
    u_std = [float(x) for x in data["default_mppi_params"]["u_std"]]
    lines = [
        "# Full benchmark: the PyTorch/CUDA port",
        "",
        "{} closed-loop trials ({} methods x {} densities x {} environments"
        " x {} alphas x {} realizations), the device-batched engine, at "
        "most {} steps, u_std {}.".format(
            len(rows), len(methods), len(data["grass_density_list"]),
            data["envs_per_density"], len(alphas), data["trials_per_env"],
            data["max_steps"], u_std),
        "",
        "Card: {}.".format(card),
        "",
        "Wall clock: {} s (host clock, ended by a synchronize).".format(
            fmt(data["wall_clock_s"], "{:.1f}")),
        "",
        "## Success rate by method (mean over all alphas)",
        "",
        "| method | success | reference paper run (16,000 trials) |",
        "|---|---|---|",
    ]
    lines += ["| {} | {} | {} |".format(m, fmt(t["success_by_method"][m]),
                                        fmt(PAPER.get(m)))
              for m in methods]
    lines += ["", "## Success rate by method x alpha", "",
              "| method | " + " | ".join(str(a) for a in alphas) + " |",
              "|---|" + "---|" * len(alphas)]
    lines += ["| {} | ".format(m) + " | ".join(
        fmt(t["success_by_method_alpha"][m][str(a)]) for a in alphas) + " |"
        for m in methods]
    lines += ["", "## Mean time to goal on successes (s)", "",
              "| method | time to goal |", "|---|---|"]
    lines += ["| {} | {} |".format(m, fmt(t["time_to_goal_on_success"][m],
                                          "{:.2f}"))
              for m in methods]
    lines += ["", "Pickle: `{}`".format(path), ""]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pickle", nargs="?", default=None,
                    help="experiment pickle (default: the newest under "
                         "--dir)")
    ap.add_argument("--dir", default=OUT_DIR,
                    help="where full_benchmark wrote its pickles "
                         "(default: %(default)s)")
    ap.add_argument("--out", default=OUT,
                    help="Markdown file to write (default: %(default)s)")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == RESERVED:
        raise SystemExit("{} holds the TPU rounds' results; write the "
                         "port's summary elsewhere".format(RESERVED))
    path = args.pickle or newest_pickle(args.dir)
    text = render(path)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(text)
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
