"""Stage and terminal cost functions of the terrain engine.

``stage = dt_eff + dist_weight * sqrt(dist2)`` and
``term = (1 - reached) * sqrt(dist2) / (v_post + 1e-6)``, with the
reference's default penalty constants.
"""

from __future__ import annotations

import torch

DEFAULT_UNKNOWN_COST = 1e2
DEFAULT_OBS_COST = 1e5
DEFAULT_DIST_WEIGHT = 1.0


def stage_cost(dist2, dt_eff, dist_weight):
    """Min-time + distance-shaping stage cost."""
    return dt_eff + dist_weight * torch.sqrt(dist2)


def term_cost(dist2, v_post_rollout, goal_reached):
    """Residual distance converted to time at an assumed post-rollout speed."""
    return (1.0 - goal_reached) * torch.sqrt(dist2) / (v_post_rollout + 1e-6)
