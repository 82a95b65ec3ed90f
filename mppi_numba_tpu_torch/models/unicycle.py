"""Unicycle dynamics as pure functions on tensors."""

from __future__ import annotations

import torch


def unicycle_step(x, y, th, v, w, lin_traction, ang_traction, dt):
    """One traction-scaled Euler step of the unicycle model:

        x += dt * lin_traction * v * cos(th)
        y += dt * lin_traction * v * sin(th)
        th += dt * ang_traction * w
    """
    x_new = x + dt * lin_traction * v * torch.cos(th)
    y_new = y + dt * lin_traction * v * torch.sin(th)
    th_new = th + dt * ang_traction * w
    return x_new, y_new, th_new


def clip_controls(u_nom, vrange, wrange):
    """Clamp nominal (v, w) controls ``(..., 2)`` to their actuation ranges."""
    v = torch.clamp(u_nom[..., 0], vrange[0], vrange[1])
    w = torch.clamp(u_nom[..., 1], wrange[0], wrange[1])
    return v, w
