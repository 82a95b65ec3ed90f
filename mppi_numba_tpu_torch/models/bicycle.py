"""Kinematic bicycle dynamics: controls are (v, steering angle delta)."""

from __future__ import annotations

import torch


def make_bicycle_step(wheelbase=0.5):
    """Build a bicycle step function with a fixed wheelbase."""

    def bicycle_step(x, y, th, v, delta, lin_traction, ang_traction, dt):
        v_eff = lin_traction * v
        x_new = x + dt * v_eff * torch.cos(th)
        y_new = y + dt * v_eff * torch.sin(th)
        th_new = th + dt * ang_traction * v * torch.tan(delta) / wheelbase
        return x_new, y_new, th_new

    return bicycle_step


bicycle_step = make_bicycle_step()
