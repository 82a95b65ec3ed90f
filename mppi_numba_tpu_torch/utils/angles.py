"""Angle normalization helpers (reference: mppi_numba/utils.py:5-31).

Dead code in the reference but part of its public surface; provided here in
scalar/NumPy and tensor forms (the JAX package's ``normalize_angle_jnp`` is
``normalize_angle_torch`` here).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def normalize_angle(th):
    """Normalize a scalar angle to (-pi, pi]."""
    two_pi = 2 * np.pi
    th = th % two_pi
    th = (th + two_pi) % two_pi
    if th > np.pi:
        th -= two_pi
    return th


def normalize_angle_np(th):
    """Vectorized NumPy angle normalization to (-pi, pi]."""
    two_pi = 2 * np.pi
    th = np.asarray(th) % two_pi
    th = (th + two_pi) % two_pi
    return np.where(th > np.pi, th - two_pi, th)


def normalize_angle_torch(th):
    """Tensor angle normalization to (-pi, pi], on the tensor's device and
    in its dtype (``%`` is floored, as ``jnp``'s)."""
    two_pi = 2 * math.pi
    th = th % two_pi
    th = (th + two_pi) % two_pi
    return torch.where(th > math.pi, th - two_pi, th)
