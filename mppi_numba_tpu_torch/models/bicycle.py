"""Kinematic bicycle dynamics: controls are (v, steering angle delta)."""

from __future__ import annotations

import torch


def make_bicycle_step(wheelbase=0.5):
    """Build a bicycle step function with a fixed wheelbase.

    The function carries ``kernel_model = ("bicycle", wheelbase)``: the
    CUDA rollout kernels run it with the same float32 operations, in the
    same order.  On CUDA tensors PyTorch divides by the Python-scalar
    ``wheelbase`` as a multiply by its float32 reciprocal, where the kernels
    divide, so the two agree bit for bit only where that reciprocal is
    exact (the default 0.5), and to float32 rounding otherwise.
    """

    def bicycle_step(x, y, th, v, delta, lin_traction, ang_traction, dt):
        v_eff = lin_traction * v
        x_new = x + dt * v_eff * torch.cos(th)
        y_new = y + dt * v_eff * torch.sin(th)
        th_new = th + dt * ang_traction * v * torch.tan(delta) / wheelbase
        return x_new, y_new, th_new

    bicycle_step.kernel_model = ("bicycle", float(wheelbase))
    return bicycle_step


bicycle_step = make_bicycle_step()
