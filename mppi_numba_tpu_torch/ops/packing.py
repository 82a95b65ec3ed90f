"""Bit-packed map planes: what each rollout step loads.

The byte layout (``pack_map_words``) holds one int32 word per cell:

    bits  0-7   linear traction     (0..100)
    bits  8-15  angular traction    (0..100)
    bit   16    obstacle indicator
    bit   17    unknown indicator
    bits 18-25  risk traction/speed (0..100, speed-map mode; else 0)

The binned layouts split that word into a per-sample cell plane and shared
per-cell planes, several cells per int32 word:

    pack_bin_crumbs   2-bit bin indices, lin | ang << 2, 8 cells/word
    pack_bin_nibbles  4-bit bin indices, lin | ang << 4, 4 cells/word
    pack_byte_pairs   8-bit decoded values, lin | ang << 8, 2 cells/word
    pack_mask_nibbles obstacle | unknown << 1, 16 cells/word (shared)
    pack_risk_bytes   risk byte, 4 cells/word (shared, speed-map mode)

A ragged last word is zero-padded.  Inputs are widened to int32 before the
shifts and the OR, as in the JAX package, so bit patterns carry over as
they stand there: a -128 value byte sign-extends over every bit above its
own, and a bin index one past the last (a draw past a column summing below
100) spills its top bit into the neighbouring field.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _or_fields(codes, cells_per_word, bits):
    """OR ``cells_per_word`` consecutive int32 codes along the last axis
    into one word each, code q shifted by ``q * bits``; a ragged tail is
    zero-padded first."""
    pad = (-codes.shape[-1]) % cells_per_word
    if pad:
        codes = F.pad(codes, (0, pad))
    c = codes.reshape(*codes.shape[:-1], -1, cells_per_word)
    word = c[..., 0]
    for q in range(1, cells_per_word):
        word = word | (c[..., q] << (bits * q))
    return word


def pack_bin_crumbs(lin_bins, ang_bins):
    """PMF bin indices (at most 4 bins) 8 cells per word.

    Args:
      lin_bins / ang_bins: int32 ``(M, H, W)`` bin indices (0..3).

    Returns:
      int32 ``(M, ceil(H*W/8))``.
    """
    M = lin_bins.shape[0]
    code = (lin_bins.to(torch.int32) | (ang_bins.to(torch.int32) << 2))
    return _or_fields(code.reshape(M, -1), 8, 4)


def pack_bin_nibbles(lin_bins, ang_bins):
    """PMF bin indices (at most 16 bins) 4 cells per word.

    Args:
      lin_bins / ang_bins: int32 ``(M, H, W)`` bin indices (0..15).

    Returns:
      int32 ``(M, ceil(H*W/4))``.
    """
    M = lin_bins.shape[0]
    byte = (lin_bins.to(torch.int32) | (ang_bins.to(torch.int32) << 4))
    return _or_fields(byte.reshape(M, -1), 4, 8)


def pack_byte_pairs(lin_grids, ang_grids):
    """Decoded int8 traction values (any bin count) 2 cells per word.

    Args:
      lin_grids / ang_grids: int8 ``(M, H, W)`` decoded traction (0..100).

    Returns:
      int32 ``(M, ceil(H*W/2))``.
    """
    M = lin_grids.shape[0]
    half = (lin_grids.to(torch.int32) | (ang_grids.to(torch.int32) << 8))
    return _or_fields(half.reshape(M, -1), 2, 16)


def pack_mask_nibbles(obstacle_map, unknown_map):
    """The shared obstacle/unknown indicators 16 cells per word.

    Args:
      obstacle_map / unknown_map: int8 ``(H, W)`` indicators.

    Returns:
      int32 ``(ceil(H*W/16),)``.
    """
    code = (obstacle_map.to(torch.int32) | (unknown_map.to(torch.int32) << 1))
    return _or_fields(code.reshape(-1), 16, 2)


def pack_risk_bytes(risk_map):
    """The shared CVaR risk/speed byte map 4 cells per word.

    Args:
      risk_map: int8 ``(H, W)`` speed map (0..100).

    Returns:
      int32 ``(ceil(H*W/4),)``.
    """
    return _or_fields(risk_map.to(torch.int32).reshape(-1), 4, 8)
