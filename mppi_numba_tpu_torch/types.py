"""NamedTuples of tensors exchanged between the planner and the solver.

Field names and order match ``mppi_numba_tpu.types`` so that
``convert.py`` can carry state across by name.
"""

from __future__ import annotations

from typing import NamedTuple


class TerrainTask(NamedTuple):
    """Per-solve task parameters (float32 tensors; scalars are 0-d)."""
    x0: object            # (3,) start state [x, y, theta]
    xgoal: object         # (2,) goal position
    goal_tolerance: object
    v_post_rollout: object
    lambda_weight: object
    u_std: object         # (2,)
    vrange: object        # (2,)
    wrange: object        # (2,)
    dt: object
    dist_weight: object
    obs_penalty: object
    unknown_penalty: object
    alpha_dyn: object     # quantile restriction for map sampling
    res: object           # map cell resolution
    xlim0: object         # padded x lower limit
    ylim0: object         # padded y lower limit
    lin_lb: object        # linear traction decode: lb + ratio * int8
    lin_ratio: object
    ang_lb: object
    ang_ratio: object
    cvar_alpha: object = None


class MapInputs(NamedTuple):
    """Per-map-update tensors (int8)."""
    lin_pmf: object       # (B, H, W) int8, bins sum to 100
    ang_pmf: object       # (B, H, W) int8
    lin_qbins: object     # (B,) int8 quantized bin values
    ang_qbins: object     # (B,) int8
    obstacle: object      # (H, W) int8 indicator
    unknown: object       # (H, W) int8 indicator
    risk: object          # (H, W) int8 CVaR speed map (zeros unless speed-map mode)


class SolveAux(NamedTuple):
    """Auxiliary outputs of one solve."""
    costs: object         # (K,) final rollout costs (incl. coupling)
    weights: object       # (K,) softmax weights
    noise_vis: object     # (V, T, 2) first V noise rows of the last iteration
    lin_grids: object     # (M, H, W) int8 sampled linear traction grids
    ang_grids: object     # (M, H, W) int8 sampled angular traction grids
    roi_offset: object = None  # (2,) int32 window start (oy, ox); zeros uncropped


class BareboneTask(NamedTuple):
    """Task parameters of the terrain-free barebone engine (float32
    tensors; scalars are 0-d)."""
    x0: object
    xgoal: object
    goal_tolerance: object
    lambda_weight: object
    u_std: object
    vrange: object
    wrange: object
    dt: object
    dist_weight: object
    obs_penalty: object
    obs_pos: object       # (N, 2) circle obstacle centers
    obs_r: object         # (N,) circle obstacle radii
