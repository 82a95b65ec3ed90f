"""Bit-packed per-cell map words: one load per rollout step.

    bits  0-7   linear traction     (0..100)
    bits  8-15  angular traction    (0..100)
    bit   16    obstacle indicator
    bit   17    unknown indicator
    bits 18-25  risk traction/speed (0..100, speed-map mode; else 0)

The int8 inputs are sign-extended to int32 before the shifts, as in the
JAX package, so a -128 byte sets every bit above its own.
"""

from __future__ import annotations

import torch

LIN_SHIFT = 0
ANG_SHIFT = 8
OBS_SHIFT = 16
UNK_SHIFT = 17
RISK_SHIFT = 18


def pack_map_words(lin_grids, ang_grids, obstacle_map, unknown_map,
                   risk_map=None):
    """Pack sampled traction grids + static masks into int32 words.

    Args:
      lin_grids / ang_grids: int8 ``(M, H, W)`` sampled traction (0..100).
      obstacle_map / unknown_map: int8 ``(H, W)`` indicator masks.
      risk_map: optional int8 ``(H, W)`` CVaR speed map (0..100).

    Returns:
      int32 ``(M, H, W)``.
    """
    i32 = torch.int32
    w = lin_grids.to(i32) | (ang_grids.to(i32) << ANG_SHIFT)
    masks = (obstacle_map.to(i32) << OBS_SHIFT) | \
            (unknown_map.to(i32) << UNK_SHIFT)
    if risk_map is not None:
        masks = masks | (risk_map.to(i32) << RISK_SHIFT)
    return w | masks[None]
