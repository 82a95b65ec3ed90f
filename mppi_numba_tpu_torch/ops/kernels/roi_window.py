"""The reachable-window crop: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

``crop_window`` launches ``csrc/roi_window.cu`` for CUDA tensors and runs
``crop_window_plain`` for CPU tensors.  It replaces the JAX package's
XLA-fused ``_roi_start`` + ``_crop_maps`` + ``_shift_task_limits``
(``mppi_numba_tpu/solver.py:127,144,158``), which has no Pallas kernel: in
plain torch ops the crop is some thirty small launches a solve, whose
host time outweighs what the window saves on the device.  The kernel is
one launch, bound by its latency (see the source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..roi import crop_maps, roi_start, shift_task_limits

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/roi_window.cu"
REPLACES = ("mppi_numba_tpu/solver.py:127,144,158 (_roi_start + _crop_maps "
            "+ _shift_task_limits, XLA-fused; no Pallas kernel)")
PLANES = ("lin_pmf", "ang_pmf", "obstacle", "unknown", "risk")


def crop_window_plain(maps, task, map_shape, roi_shape):
    """Plain PyTorch version of the kernel.  Arguments and result as for
    ``crop_window``."""
    oy, ox = roi_start(task, map_shape, roi_shape)
    return (crop_maps(maps, oy, ox, *roi_shape),
            shift_task_limits(task, oy, ox), torch.stack([oy, ox]))


@functools.lru_cache(maxsize=None)
def _entry_point():
    """The library's launch entry point, built and loaded on first use, its
    ctypes signature set once."""
    from ._build import load

    fn = load("roi_window").roi_window_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(maps, task, map_shape, roi_shape):
    H, W = map_shape
    rH, rW = roi_shape
    dev = maps.obstacle.device
    scalars = (task.xlim0, task.ylim0, task.res)
    checks = [
        (all(p.dtype == torch.int8 and p.is_contiguous()
             and tuple(p.shape[-2:]) == (H, W) and p.device == dev
             for p in (getattr(maps, name) for name in PLANES))
         and maps.lin_pmf.dim() == maps.ang_pmf.dim() == 3
         and maps.obstacle.dim() == maps.unknown.dim() == maps.risk.dim() == 2,
         "the map planes must be contiguous int8 (B, H, W) PMFs and (H, W) "
         "grids of the map shape, on one device"),
        (task.x0.dtype == torch.float32 and task.x0.numel() == 3
         and task.x0.is_contiguous() and task.x0.device == dev
         and all(s.dtype == torch.float32 and s.numel() == 1
                 and s.device == dev for s in scalars),
         "x0 must be float32 (3,) and xlim0 / ylim0 / res float32 scalars "
         "on the maps' device"),
        (1 <= rH <= H and 1 <= rW <= W, "the window must fit in the map"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("crop_window: " + msg)


def crop_window(maps, task, map_shape, roi_shape):
    """The reachable window of the maps and the task, around the robot.

    Args:
      maps: ``MapInputs`` of the full ``map_shape`` map, on the device.
      task: ``TerrainTask`` on the same device (x0, xlim0, ylim0, res read).
      map_shape / roi_shape: ``(H, W)`` and the window's ``(rH, rW)``.

    Returns:
      ``(maps, task, offset)``: every plane cropped to the window, the task
      with ``xlim0`` / ``ylim0`` moved to the window's corner, and the
      window's start ``(oy, ox)`` as an int32 ``(2,)`` tensor.  Nothing is
      read on the host.

    On CUDA tensors this launches the kernel and adds one to
    ``crop_window.launches``; on CPU tensors it runs ``crop_window_plain``.
    """
    if not maps.obstacle.is_cuda:
        return crop_window_plain(maps, task, map_shape, roi_shape)
    _check_cuda_args(maps, task, map_shape, roi_shape)
    dev = maps.obstacle.device
    H, W = map_shape
    rH, rW = roi_shape
    i8 = torch.int8
    out = {name: torch.empty(tuple(getattr(maps, name).shape[:-2]) + (rH, rW),
                             dtype=i8, device=dev) for name in PLANES}
    offset = torch.empty(2, dtype=torch.int32, device=dev)
    lims = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry_point()(
        task.x0.data_ptr(), task.xlim0.data_ptr(), task.ylim0.data_ptr(),
        task.res.data_ptr(), *(getattr(maps, name).data_ptr()
                               for name in PLANES),
        *(out[name].data_ptr() for name in PLANES), offset.data_ptr(),
        lims.data_ptr(), H, W, rH, rW, maps.lin_pmf.shape[0],
        maps.ang_pmf.shape[0], stream)
    if err != 0:
        raise RuntimeError("roi_window kernel launch failed: CUDA error "
                           "{}".format(err))
    crop_window.launches += 1
    return (maps._replace(**out), task._replace(xlim0=lims[0], ylim0=lims[1]),
            offset)


crop_window.launches = 0
