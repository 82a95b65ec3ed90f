"""How ``correct`` is decided: what the timed path produced, held against
the plain reference (``reference/mppi.py``) run after the window, number
by number against the limits of ``limits/<cell>.json``.  Each driver
(``drivers/<driver>.py``) works its numbers out in ``numbers()``; what
they share is here.  ``control=True`` puts the reference computed in
bfloat16 in the program's place: its numbers must fail the limits.
"""

from __future__ import annotations

import numpy as np
import torch

# Lanes (scenarios x K x M) the reference steps at once.
LANES = 1 << 22


def widths(cfg):
    """Each control's range: the scale of a control gap."""
    p = cfg["params"]
    return np.array([p["vrange"][1] - p["vrange"][0],
                     p["wrange"][1] - p["wrange"][0]], np.float32)


def u_gap(u_prog, u_ref, scale):
    """The largest control gap, each control over its range's width."""
    d = (u_prog.float().cpu() - u_ref.float().cpu()).abs()
    return float((d / torch.from_numpy(scale)).max()) if d.numel() else 0.0


def cost_gap(c_prog, c_ref):
    """The largest cost gap, over the larger of the reference's cost and
    its median magnitude."""
    c_prog, c_ref = c_prog.float().cpu(), c_ref.float().cpu()
    scale = torch.maximum(c_ref.abs(), c_ref.abs().median())
    return float(((c_prog - c_ref).abs() / scale).max())


def on_card(planes, device):
    return torch.tensor(np.stack(planes), device=device)

