"""Run configuration for the PyTorch/CUDA MPPI engine.

Same constructor keywords, value clamps and mutually exclusive algorithm
flags as ``mppi_numba_tpu.config.Config``.  ``SolverStatic`` is the
structural signature of one solve (shapes, mode, backend); the PyTorch
solver caches one solver object per signature, as the JAX package caches
one executable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Recommended rollout-count bounds (reference: mppi_numba/config.py:13-14).
rec_max_control_rollouts = 15000
rec_min_control_rollouts = 100

# Kept for API compatibility with code written against the reference.
max_threads_per_block = 1024


class Config:
    """Configuration that is typically fixed throughout execution.

    Exactly one of ``use_tdm``, ``use_det_dynamics``,
    ``use_nom_dynamics_with_speed_map``, ``use_costmap`` must be set.
    """

    def __init__(self,
                 T=10.0,                      # Horizon (s)
                 dt=0.1,                      # Length of each step (s)
                 num_grid_samples=1024,       # Sampled traction maps (M)
                 num_control_rollouts=1024,   # Control sequences (K)
                 max_speed_padding=5.0,       # Max assumed speed for padding the grid perimeter
                 tdm_sample_thread_dim=(16, 16),  # Accepted for API compat; unused
                 num_vis_state_rollouts=20,   # Visualization rollouts
                 max_map_dim=(250, 250),      # Largest padded map dim (cells); larger maps are cropped
                 seed=1,
                 use_tdm=False,
                 use_det_dynamics=False,
                 use_nom_dynamics_with_speed_map=False,
                 use_costmap=False,
                 model="unicycle",          # dynamics model (models registry)
                 dynamic_cvar=False):
        from .models import get_step_fn
        get_step_fn(model)                  # fail fast on unknown names
        self.model = model
        self.dynamic_cvar = bool(dynamic_cvar)
        self.seed = seed
        self.use_tdm = use_tdm
        self.use_det_dynamics = use_det_dynamics
        self.use_nom_dynamics_with_speed_map = use_nom_dynamics_with_speed_map
        self.use_costmap = use_costmap
        num_true = sum([use_tdm, use_det_dynamics,
                        use_nom_dynamics_with_speed_map, use_costmap])

        assert T > 0
        assert dt > 0
        assert T > dt
        assert not (num_true == 0 or num_true > 1), (
            "MPPI Config Error: Only one of the use_tdm, use_det_dynamics, "
            "use_nom_dynamics_with_speed_map, use_costmap can be true.")

        self.T = T
        self.dt = dt
        # Epsilon before truncating: bare int(T/dt) loses a step to float
        # error (0.3/0.1 -> 2.999... -> 2).
        self.num_steps = int(T / dt + 1e-6)
        assert self.num_steps > 0

        self.max_threads_per_block = max_threads_per_block

        self.num_grid_samples = int(num_grid_samples)
        if self.num_grid_samples > rec_max_control_rollouts:
            self.num_grid_samples = rec_max_control_rollouts
            print("MPPI Config: Limit num_grid_samples by recommended max "
                  "(<={}). This can be overwritten if needed.".format(rec_max_control_rollouts))
        elif self.num_grid_samples < 1:
            self.num_grid_samples = 1
            print("MPPI Config: Set num_grid_samples from {} -> 1. "
                  "Need at least 1 map to work with".format(num_grid_samples))

        self.num_control_rollouts = int(num_control_rollouts)
        if self.num_control_rollouts > rec_max_control_rollouts:
            self.num_control_rollouts = rec_max_control_rollouts
            print("MPPI Config: Clip num_control_rollouts to recommended max "
                  "of {}.".format(rec_max_control_rollouts))
        elif self.num_control_rollouts < rec_min_control_rollouts:
            self.num_control_rollouts = rec_min_control_rollouts
            print("MPPI Config: Clip num_control_rollouts to recommended min "
                  "of {}.".format(rec_min_control_rollouts))

        self.max_speed_padding = max_speed_padding

        self.tdm_sample_thread_dim = tuple(tdm_sample_thread_dim)
        assert len(self.tdm_sample_thread_dim) == 2
        assert self.tdm_sample_thread_dim[0] > 0
        assert self.tdm_sample_thread_dim[1] > 0

        self.num_vis_state_rollouts = int(num_vis_state_rollouts)
        self.num_vis_state_rollouts = min([self.num_vis_state_rollouts,
                                           self.num_control_rollouts,
                                           self.num_grid_samples])
        self.num_vis_state_rollouts = max([1, self.num_vis_state_rollouts])

        self.max_map_dim = tuple(max_map_dim)

    @property
    def det_dyn(self) -> bool:
        return (self.use_det_dynamics or self.use_nom_dynamics_with_speed_map
                or self.use_costmap)

    @property
    def mode(self) -> str:
        if self.use_tdm:
            return "tdm"
        if self.use_det_dynamics:
            return "det_dyn"
        if self.use_nom_dynamics_with_speed_map:
            return "speed_map"
        return "costmap"


@dataclasses.dataclass(frozen=True)
class SolverStatic:
    """The structural signature of one solve; one cached solver per value."""
    mode: str                  # 'tdm' | 'det_dyn' | 'speed_map'
    num_steps: int             # T
    num_control_rollouts: int  # K
    num_grid_samples: int      # M
    map_shape: Tuple[int, int]  # padded (H, W)
    num_obstacles: int         # analytic circle obstacles (barebone only)
    cvar_numel: int            # ceil(M * cvar_alpha); M for alpha == 1;
                               # -1 (solver.DYNAMIC_CVAR): alpha at run time
    num_opt: int               # optimization iterations per solve
    num_vis_state_rollouts: int
    # The rollout layout: 'byte' (one word per cell) | 'binned2' |
    # 'binned' | 'binned8' (2-, 4- and 8-bit cell planes), each a
    # hand-written CUDA kernel; 'eager' (plain PyTorch ops, exact trig);
    # 'auto' (solver.resolve_backend: by map size and bin count on a CUDA
    # device, 'eager' on the CPU); 'cuda', an alias of 'byte'.
    backend: str = "auto"
    # Maclaurin rotation instead of per-step sin/cos in the rollout kernel;
    # the planner enables it when dt * max|wrange| * max_ang_traction <= 0.6.
    fast_trig: bool = False
    model: str = "unicycle"
    # Reachable-window crop; always None in this port (the crop is a pure
    # optimisation of the JAX package that changes no result).
    roi_shape: Tuple[int, int] | None = None
    # Number of PMF bins of the TDMs this solver serves (support-compacted).
    num_pmf_bins: int = 0
