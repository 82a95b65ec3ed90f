"""The planners' visualisation rollouts: the hand-written CUDA kernels and
their wrappers; the plain PyTorch versions are ``ops/rollout.py::
terrain_vis_fused_plain`` and ``barebone_vis_fused_plain``.

``terrain_vis_fused`` and ``barebone_vis_fused`` launch
``csrc/vis_rollout.cu`` for CUDA tensors and run the plain versions for
CPU tensors.  Each kernel is a planner's whole vis function (the JAX
package's ``solver.get_terrain_vis`` / ``get_barebone_vis``, which XLA
compiles around the ``lax.scan``s ``terrain_vis_states`` /
``barebone_vis_states``; no Pallas kernel): the controls, the crop's
shifted limits, the packed word's two bytes and the T-step loop, one
thread a rollout, in the plain versions' order of operations, so the
kernels equal them bit for bit (the bicycle at a wheelbase whose float32
reciprocal is inexact to rounding: PyTorch multiplies by the reciprocal
where the kernel divides).  A vis graph replays one kernel node where the
torch loop replayed thousands.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models import kernel_model, unicycle_step
from ..rollout import barebone_vis_fused_plain, terrain_vis_fused_plain
from .cvar_costs import H100_SMS, check_tensor

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/vis_rollout.cu"
REPLACES = ("mppi_numba_tpu/ops/rollout.py:133-176,232-249 "
            "(terrain_vis_states, barebone_vis_states) in "
            "mppi_numba_tpu/solver.py:327-362,392-400 (get_terrain_vis, "
            "get_barebone_vis), XLA-compiled lax.scans; no Pallas kernel")
# The source's kMaxThreads: rollouts a block at most.
MAX_THREADS = 32
# Blocks an SM holds at once (Hopper).
BLOCKS_PER_SM = 32
# Rollouts and steps a launch: the kernel indexes them with 32-bit ints.
MAX_ROLLOUTS = 2 ** 31 - 1
# The terrain task's fields the kernel reads, in the launch's order, with
# their shapes.
TERRAIN_FIELDS = (("x0", (3,)), ("dt", ()), ("res", ()), ("xlim0", ()),
                  ("ylim0", ()), ("lin_lb", ()), ("lin_ratio", ()),
                  ("ang_lb", ()), ("ang_ratio", ()), ("vrange", (2,)),
                  ("wrange", (2,)))
BAREBONE_FIELDS = (("x0", (3,)), ("dt", ()), ("vrange", (2,)),
                   ("wrange", (2,)))


def launch_shape(V, sms=H100_SMS):
    """``(threads a block, blocks)`` for V rollouts, a thread a rollout: a
    rollout a block while the V blocks fit ``sms`` SMs at once
    (``BLOCKS_PER_SM`` each), so that no rollout waits on the slowest of a
    warp's loads (faster on an H100 at the planners' V = 20 than a warp
    a block); past that a warp a block."""
    threads = 1 if V <= BLOCKS_PER_SM * sms else MAX_THREADS
    return threads, -(-V // threads)


def vis_rows(V, det, lin_grids, noise_vis):
    """The rollouts a vis draws: tdm ``min(V, M)`` (grids ``[:V]``), the
    det modes and the barebone engine ``max(1, N)`` of ``N`` noise rows
    (``u_cur``, then a noisy row for each noise row past the first)."""
    if det:
        return max(1, noise_vis.shape[0])
    return min(V, lin_grids.shape[0])


@functools.lru_cache(maxsize=None)
def _sms(index):
    """Card ``index``'s SM count."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry_point(name):
    """The library's launch entry point ``<name>_launch``, built and
    loaded on first use."""
    from ._build import load

    fn = getattr(load("vis_rollout"), name + "_launch")
    if name == "terrain_vis":
        fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_controls(what, u_cur, u_prev, noise_vis, det, dev):
    """The controls' shapes; returns T."""
    if not (isinstance(u_cur, torch.Tensor) and u_cur.dim() == 2):
        raise ValueError("{}: u_cur must be a float32 (T, 2) tensor, got "
                         "{}".format(what, getattr(u_cur, "shape", u_cur)))
    T = u_cur.shape[0]
    check_tensor(what + ": u_cur", u_cur, (T, 2), dev)
    check_tensor(what + ": u_prev", u_prev, (T, 2), dev)
    if det:
        if not (isinstance(noise_vis, torch.Tensor)
                and noise_vis.dim() == 3):
            raise ValueError("{}: noise_vis must be a float32 (N, T, 2) "
                             "tensor".format(what))
        check_tensor(what + ": noise_vis", noise_vis,
                     (noise_vis.shape[0], T, 2), dev)
    return T


def _check_task(what, task, fields, dev):
    for name, shape in fields:
        check_tensor("{}: task.{}".format(what, name), getattr(task, name),
                     shape, dev)


def _launch(name, args, ints, dev):
    """Launch ``<name>_launch`` on ``dev``'s current stream; raise on a
    failed launch."""
    with torch.cuda.device(dev):
        err = _entry_point(name)(*args, *ints,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(
            name, err))


def terrain_vis_fused(lin_grids, ang_grids, u_cur, u_prev, noise_vis,
                      roi_offset, task, *, V, det, crop=False,
                      step_fn=unicycle_step):
    """The terrain planner's vis rollouts: the semantics (and the
    arguments) of ``ops/rollout.py::terrain_vis_fused_plain``.

    Returns float32 ``(V', T+1, 3)`` states (V' = ``vis_rows``).  On CUDA
    tensors this launches ``terrain_vis_kernel`` once and adds one to
    ``terrain_vis_fused.launches``; a model with no kernel form raises
    ``NotImplementedError`` (``backend = "eager"`` runs it) before any
    build or launch, and a failed build or launch raises.  On CPU tensors
    it runs the plain version.
    """
    dev = u_cur.device
    if dev.type != "cuda":
        return terrain_vis_fused_plain(lin_grids, ang_grids, u_cur, u_prev,
                                       noise_vis, roi_offset, task, V=V,
                                       det=det, crop=crop, step_fn=step_fn)
    model, wheelbase = kernel_model(step_fn)
    what = "terrain_vis"
    T = _check_controls(what, u_cur, u_prev, noise_vis, det, dev)
    for g, label in ((lin_grids, "lin_grids"), (ang_grids, "ang_grids")):
        if not (isinstance(g, torch.Tensor) and g.dtype == torch.int8
                and g.dim() == 3 and g.device == dev
                and g.shape == lin_grids.shape and g.shape[0] >= 1):
            raise ValueError("{}: {} must be int8 (M, H, W) grids on {} "
                             "like lin_grids, got {}".format(
                                 what, label, dev,
                                 getattr(g, "shape", g)))
    _, H, W = lin_grids.shape
    if H < 1 or W < 1 or H * W >= 2 ** 31:
        raise ValueError("{}: grids of {} x {} cells out of range".format(
            what, H, W))
    _check_task(what, task, TERRAIN_FIELDS, dev)
    if crop and not (isinstance(roi_offset, torch.Tensor)
                     and roi_offset.dtype == torch.int32
                     and tuple(roi_offset.shape) == (2,)
                     and roi_offset.device == dev):
        raise ValueError("{}: a cropped vis reads roi_offset, an int32 (2,) "
                         "tensor on {}; got {}".format(what, dev, roi_offset))
    rows = vis_rows(V, det, lin_grids, noise_vis)
    if not 1 <= rows <= MAX_ROLLOUTS:
        raise ValueError("{}: {} rollouts out of range".format(what, rows))
    out = torch.empty((rows, T + 1, 3), dtype=torch.float32, device=dev)
    ins = [lin_grids.contiguous(), ang_grids.contiguous(),
           u_cur.contiguous(), u_prev.contiguous(),
           noise_vis.contiguous() if det else u_cur,
           roi_offset.contiguous() if crop else lin_grids] + [
        getattr(task, name).contiguous() for name, _ in TERRAIN_FIELDS]
    threads = launch_shape(rows, _sms(dev.index))[0]
    _launch("terrain_vis", [t.data_ptr() for t in ins] + [out.data_ptr()],
            [rows, T, H, W, int(det), int(crop), model, wheelbase, threads],
            dev)
    terrain_vis_fused.launches += 1
    return out


terrain_vis_fused.launches = 0


def barebone_vis_fused(task, u_cur, u_prev, noise_vis):
    """The barebone planner's vis rollouts: the semantics of
    ``ops/rollout.py::barebone_vis_fused_plain``, float32 ``(max(1, N),
    T+1, 3)`` from ``N`` noise rows ``(N, T, 2)``.

    On CUDA tensors this launches ``barebone_vis_kernel`` once and adds
    one to ``barebone_vis_fused.launches``; a failed build or launch
    raises.  On CPU tensors it runs the plain version.
    """
    dev = u_cur.device
    if dev.type != "cuda":
        return barebone_vis_fused_plain(task, u_cur, u_prev, noise_vis)
    what = "barebone_vis"
    T = _check_controls(what, u_cur, u_prev, noise_vis, True, dev)
    _check_task(what, task, BAREBONE_FIELDS, dev)
    rows = vis_rows(None, True, None, noise_vis)
    if rows > MAX_ROLLOUTS:
        raise ValueError("{}: {} rollouts out of range".format(what, rows))
    out = torch.empty((rows, T + 1, 3), dtype=torch.float32, device=dev)
    ins = [u_cur.contiguous(), u_prev.contiguous(),
           noise_vis.contiguous()] + [
        getattr(task, name).contiguous() for name, _ in BAREBONE_FIELDS]
    _launch("barebone_vis", [t.data_ptr() for t in ins] + [out.data_ptr()],
            [rows, T, launch_shape(rows, _sms(dev.index))[0]], dev)
    barebone_vis_fused.launches += 1
    return out


barebone_vis_fused.launches = 0
