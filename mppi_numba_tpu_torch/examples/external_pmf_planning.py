"""Planning from an externally supplied PMF grid (the learned-model path);
the port's counterpart of ``examples/external_pmf_planning.py``.

A perception stack hands the planner an int8 ``(num_bins, H, W)`` PMF over
traction per cell (here the script's synthetic one: high traction with an
uncertain swamp band, 12 bins on 30x40 cells of 0.5 m), and the TDMs are
set from it (``set_TDM_from_PMF_grid``).  One solve at K = 2048, M = 512,
T = 80 on the whole 32x42 padded map (the reachable window of an 8 s
horizon covers it), and the visualisation rollouts of that solve.  As in the script, there is
no closed loop.

    python -m mppi_numba_tpu_torch.examples.external_pmf_planning [--device cpu] [--small]

Prints the card line, then JSON lines: the solver's shape and layout, and
the outcome: what the script prints (the first five optimized controls
and the first five rollouts' end points), with the solve's time, its
kernel launches and the graphs.  ``--out-dir`` is accepted; this example
draws no figure.
"""

from __future__ import annotations

import types

import numpy as np

from .. import Config, MPPIPlanner, TDM
from ..drivers._common import launch_counts, start
from . import _common as ex

EXAMPLE = "external_pmf_planning"


def synth_pmf_grid(num_bins=12, rows=30, cols=40, seed=0):
    """A synthetic 'learned' PMF: easy terrain with a low-traction swamp
    (fixed: ``seed`` is taken, and unused, as in the script)."""
    bin_values = np.linspace(0.0, 1.0, num_bins)
    pmf = np.zeros((num_bins, rows, cols), dtype=np.int8)
    # Mostly confident high traction...
    hi = num_bins - 2
    pmf[hi] = 70
    pmf[hi + 1] = 30
    # ...with an uncertain swamp band.
    band = slice(rows // 3, rows // 2)
    pmf[:, band, :] = 0
    pmf[1, band, :] = 50
    pmf[hi, band, :] = 50
    if not (pmf.sum(0) == 100).all():
        raise AssertionError("a cell's PMF does not sum to 100")
    return pmf, bin_values


def build(device=None, small=False):
    """The script's config, params, TDMs and planner (set up) on
    ``device`` (default: the card)."""
    num_bins, rows, cols, res = 12, 30, 40, 0.5
    pmf, bin_values = synth_pmf_grid(num_bins, rows, cols)

    K, M, T, _ = ex.sizes(small, 2048, 512, 8.0, 0.1, 1)
    cfg = Config(T=T, dt=0.1, num_grid_samples=M,
                 num_control_rollouts=K, max_speed_padding=4.0,
                 num_vis_state_rollouts=20, max_map_dim=(80, 100), seed=0,
                 use_tdm=True)
    tdm_dict = dict(res=res, xlimits=(0.0, cols * res),
                    ylimits=(0.0, rows * res), bin_values=bin_values,
                    bin_values_bounds=np.array([0.0, 1.0]),
                    det_dynamics_cvar_alpha=1.0)
    lin_tdm, ang_tdm = TDM(cfg, device=device), TDM(cfg, device=device)
    lin_tdm.set_TDM_from_PMF_grid(pmf, tdm_dict)
    ang_tdm.set_TDM_from_PMF_grid(pmf, tdm_dict)

    params = dict(dt=cfg.dt, x0=np.array([2.0, 2.0, np.pi / 4]),
                  xgoal=np.array([18.0, 13.0]), goal_tolerance=0.5,
                  v_post_rollout=0.01, cvar_alpha=0.3, alpha_dyn=1.0,
                  dist_weight=1.0, lambda_weight=1.0, num_opt=1,
                  u_std=np.array([2.0, 3.0]), vrange=np.array([0.0, 3.0]),
                  wrange=np.array([-np.pi, np.pi]))
    planner = MPPIPlanner(cfg, device=device)
    planner.setup(params, lin_tdm, ang_tdm)
    return types.SimpleNamespace(cfg=cfg, params=params, planner=planner,
                                 lin_tdm=lin_tdm, ang_tdm=ang_tdm)


def main(argv=None):
    args = ex.parser(__doc__).parse_args(argv)
    device, _ = start(args)
    w = build(device, args.small)
    planner = w.planner
    ex.describe(EXAMPLE, None, planner)
    before = launch_counts()
    timed = ex.TimedPlanner(planner)
    useq = timed.solve()
    states = planner.get_state_rollout()
    outcome = dict(first_controls=useq[:5],
                   rollout_endpoints=states[:5, -1, :2])
    ex.report(EXAMPLE, None, planner, timed, outcome, before, device,
              vis_shape=list(states.shape), figures=[])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
