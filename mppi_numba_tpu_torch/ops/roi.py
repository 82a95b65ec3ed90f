"""The reachable-window (ROI) crop in plain PyTorch ops: the window's start
around the robot, the map planes' window and the task's shifted limits
(``mppi_numba_tpu/solver.py::_roi_start, _crop_maps, _shift_task_limits``).

Offsets stay 0-d int32 tensors on the device: nothing reads them on the
host.  ``crop_window_plain`` is the three together: on the card the
map-sampling kernel's crop mode does them in its own launch
(``ops/kernels/map_sample.py::sample_and_pack_crop``), and this is its
plain version's first half.
"""

from __future__ import annotations

import torch


def roi_start(task, full_hw, roi_hw):
    """The reachable window's first (row, col): int32 0-d tensors on the
    task's device, the window centred on the robot's cell and clamped
    inside the map.  The cell is ``floor((x0 - lim0) / res)`` in float32,
    a true division by the ``res`` tensor, as the JAX package computes it.
    """
    H, W = full_hw
    rH, rW = roi_hw
    cx = torch.floor((task.x0[0] - task.xlim0) / task.res).to(torch.int32)
    cy = torch.floor((task.x0[1] - task.ylim0) / task.res).to(torch.int32)
    oy = torch.clamp(torch.clamp(cy, 0, H - 1) - rH // 2, 0, H - rH)
    ox = torch.clamp(torch.clamp(cx, 0, W - 1) - rW // 2, 0, W - rW)
    return oy, ox


def crop_plane(plane, oy, ox, rH, rW):
    """The ``(rH, rW)`` window of ``plane``'s last two axes at ``(oy, ox)``
    (0-d tensors or ints), gathered through index tensors (no host read)."""
    dev = plane.device
    rows = (oy + torch.arange(rH, device=dev))[:, None]
    cols = ox + torch.arange(rW, device=dev)
    return plane[..., rows, cols]


def crop_maps(maps, oy, ox, rH, rW):
    """The (rH, rW) window of every map plane at the offsets ``(oy, ox)``."""
    return maps._replace(**{
        name: crop_plane(getattr(maps, name), oy, ox, rH, rW)
        for name in ("lin_pmf", "ang_pmf", "obstacle", "unknown", "risk")})


def shift_task_limits(task, oy, ox):
    """The task with its map origin moved to the window's corner."""
    f32 = torch.float32
    return task._replace(xlim0=task.xlim0 + ox.to(f32) * task.res,
                         ylim0=task.ylim0 + oy.to(f32) * task.res)


def crop_window_plain(maps, task, map_shape, roi_shape):
    """The reachable window of the maps and the task, around the robot.

    Args:
      maps: ``MapInputs`` of the full ``map_shape`` map.
      task: ``TerrainTask`` on the same device (x0, xlim0, ylim0, res read).
      map_shape / roi_shape: ``(H, W)`` and the window's ``(rH, rW)``.

    Returns:
      ``(maps, task, offset)``: every plane cropped to the window, the task
      with ``xlim0`` / ``ylim0`` moved to the window's corner, and the
      window's start ``(oy, ox)`` as an int32 ``(2,)`` tensor.
    """
    oy, ox = roi_start(task, map_shape, roi_shape)
    return (crop_maps(maps, oy, ox, *roi_shape),
            shift_task_limits(task, oy, ox), torch.stack([oy, ox]))
