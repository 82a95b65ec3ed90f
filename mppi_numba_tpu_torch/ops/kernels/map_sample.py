"""Traction-map sampling and the rollout's map payload: the hand-written
CUDA kernel, its wrappers and their plain PyTorch versions.

``sample_and_pack_window`` (the solve's entry), ``sample_and_pack_crop``
(the same on the reachable window around the robot: the cropped solve's
entry) and ``sample_traction_window`` (bins and grids; ``TDM.sample_grids``)
launch ``csrc/map_sample.cu`` for CUDA tensors and run their plain versions
for CPU tensors.  The kernel replaces the JAX package's XLA-fused map draw,
``uniform_window`` + ``sample_traction_bins`` + ``decode_bins``
(``mppi_numba_tpu/ops/sampling.py:156,219,246``), and the pack that follows
it in the jitted solve (``mppi_numba_tpu/solver.py:200-215``), none of
which has a Pallas kernel: in plain torch ops the threefry hash is some
150 elementwise passes over the (M, H*W) draw and the pack some 10-45
more, so on the card the draw, the ranks, the decode and the pack are one
pass.  In crop mode the same launch also does the JAX package's XLA-fused
crop, ``_roi_start`` + ``_crop_maps`` + ``_shift_task_limits``
(``mppi_numba_tpu/solver.py:127,144,158``): it reads the map's planes at
the window it works out from the task, so the cropped solve makes no
launch of its own for the crop.  The kernel is bound by integer operations
(see the source).

A leading scenario axis B on the key ``(B, 2)`` and on every map plane,
bin table, alpha_dyn and (cropping) task field samples B scenarios in one
launch, each under its own key: the JAX package's draw under
``jax.vmap``.  The outputs then carry the same leading axis.  Without it
the call is one scenario, B = 1 of the same launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..packing import pack_payload
from ..roi import crop_window_plain
from ..sampling import decode_bins, traction_bins_from_uniforms, uniform_window
from ...types import per_scenario

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/map_sample.cu"
REPLACES = ("mppi_numba_tpu/ops/sampling.py:156,219,246 (uniform_window + "
            "sample_traction_bins + decode_bins) and "
            "mppi_numba_tpu/solver.py:200-215 (the pack), XLA-fused; no "
            "Pallas kernel")
# What the crop mode adds to the launch.
CROP_REPLACES = ("mppi_numba_tpu/solver.py:127,144,158 (_roi_start + "
                 "_crop_maps + _shift_task_limits, XLA-fused; no Pallas "
                 "kernel)")
# The kernel's output layouts: 'bins' is sample_traction_window's; the
# others are the solver's payload layouts (packing.pack_payload).
LAYOUTS = {"bins": 0, "byte": 1, "binned2": 2, "binned": 3, "binned8": 4}
CELLS_PER_WORD = {"binned2": 8, "binned": 4, "binned8": 2}
# A plane's ranks are bytes in the kernel's tables.
MAX_PLANE_BINS = 255


def sample_traction_window_plain(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins,
                                 alpha_dyn, num_samples, window=None,
                                 m_offset=0, full_num_samples=None):
    """Plain PyTorch version of the kernel's 'bins' layout:
    ``uniform_window``, the ranks and the decode.  Arguments as for
    ``sample_traction_window``."""
    if key.dim() == 2:
        return per_scenario(
            sample_traction_window_plain,
            (key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, alpha_dyn,
             num_samples),
            dict(window=window, m_offset=m_offset,
                 full_num_samples=full_num_samples))
    _, rH, rW = lin_pmf.shape
    full_hw, oy, ox = window if window is not None else ((rH, rW), 0, 0)
    u = uniform_window(key, num_samples, full_hw, oy, ox, (rH, rW),
                       m_offset=m_offset, full_num_samples=full_num_samples)
    lin_bins = traction_bins_from_uniforms(u, lin_pmf, alpha_dyn)
    if ang_pmf is None:
        return lin_bins, None, decode_bins(lin_qbins, lin_bins), None
    ang_bins = traction_bins_from_uniforms(u, ang_pmf, alpha_dyn)
    return (lin_bins, ang_bins, decode_bins(lin_qbins, lin_bins),
            decode_bins(ang_qbins, ang_bins))


def sample_and_pack_window_plain(key, maps, alpha_dyn, num_samples, layout,
                                 window=None, risk=False, m_offset=0,
                                 full_num_samples=None):
    """Plain PyTorch version of the kernel's payload layouts: the draw as
    ``sample_traction_window_plain``, then ``packing.pack_payload``, the
    composition the solve runs on the CPU.  Arguments and result as for
    ``sample_and_pack_window``."""
    if key.dim() == 2:
        return per_scenario(
            sample_and_pack_window_plain,
            (key, maps, alpha_dyn, num_samples, layout),
            dict(window=window, risk=risk, m_offset=m_offset,
                 full_num_samples=full_num_samples))
    lin_bins, ang_bins, lin_grids, ang_grids = sample_traction_window_plain(
        key, maps.lin_pmf, maps.ang_pmf, maps.lin_qbins, maps.ang_qbins,
        alpha_dyn, num_samples, window=window, m_offset=m_offset,
        full_num_samples=full_num_samples)
    payload = pack_payload(layout, lin_bins, ang_bins, lin_grids, ang_grids,
                           maps, risk=risk)
    return payload, lin_grids, ang_grids


def sample_and_pack_crop_plain(key, maps, task, num_samples, layout,
                               roi_shape, risk=False, m_offset=0,
                               full_num_samples=None):
    """Plain PyTorch version of the kernel's crop mode:
    ``roi.crop_window_plain``, then ``sample_and_pack_window_plain`` at
    the window.  Arguments and result as for ``sample_and_pack_crop``."""
    if key.dim() == 2:
        return per_scenario(sample_and_pack_crop_plain,
                            (key, maps, task, num_samples, layout,
                             roi_shape),
                            dict(risk=risk, m_offset=m_offset,
                                 full_num_samples=full_num_samples))
    map_shape = tuple(maps.obstacle.shape)
    cmaps, ctask, offset = crop_window_plain(maps, task, map_shape,
                                             roi_shape)
    payload, lin_grids, ang_grids = sample_and_pack_window_plain(
        key, cmaps, task.alpha_dyn, num_samples, layout,
        window=(map_shape, offset[0], offset[1]), risk=risk,
        m_offset=m_offset, full_num_samples=full_num_samples)
    return payload, lin_grids, ang_grids, ctask, offset


@functools.lru_cache(maxsize=None)
def _entry_point():
    """The library's launch entry point, built and loaded on first use, its
    ctypes signature set once."""
    from ._build import load

    fn = load("map_sample").map_sample_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 24
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_scalar(value, dtype, device, lead=()):
    """A scalar the kernel reads on the card: a ``dtype`` tensor of shape
    ``lead`` (one value a scenario; 0-d or one element without a scenario
    axis) on ``device``, passed as it is (no copy to the host)."""
    if not (isinstance(value, torch.Tensor) and value.dtype == dtype
            and value.device == device and value.is_contiguous()
            and (tuple(value.shape) == lead if lead
                 else value.numel() == 1)):
        raise ValueError("map_sample: expected a {} {} tensor on {}, "
                         "got {!r}".format(dtype, "scalar" if not lead
                                           else "{} per-scenario".format(
                                               lead), device, value))
    return value


def _check_cuda_args(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, M, H, W,
                     grids=(), window_hw=None):
    """The kernel's inputs: the key, the PMF planes, their bin values and
    any int8 ``grids`` (the masks and risk plane) of the planes' (pH, pW);
    the window is the planes' unless ``window_hw`` (crop mode) gives it.
    With a scenario axis (key ``(B, 2)``) every one has a leading B."""
    dev = lin_pmf.device
    lead = tuple(key.shape[:-1])
    nd = 3 + len(lead)
    rH, rW = lin_pmf.shape[-2:] if lin_pmf.dim() == nd else (-1, -1)
    wH, wW = (rH, rW) if window_hw is None else window_hw
    if (ang_pmf is None) != (ang_qbins is None):
        raise ValueError("map_sample: ang_pmf and ang_qbins must both be "
                         "given or both be None")
    if ang_pmf is None:
        ang_pmf, ang_qbins = lin_pmf, lin_qbins
    checks = [
        (key.dtype == torch.int64 and key.dim() in (1, 2)
         and key.shape[-1] == 2 and key.is_contiguous()
         and 1 <= (lead[0] if lead else 1) <= 65535,
         "key must be contiguous int64 (2,), or (B, 2) for B <= 65535 "
         "scenarios"),
        (all(p.dtype == torch.int8 and p.dim() == nd
             and tuple(p.shape[:-3]) == lead
             and tuple(p.shape[-2:]) == (rH, rW) and p.is_contiguous()
             and p.shape[-3] <= MAX_PLANE_BINS
             for p in (lin_pmf, ang_pmf)),
         "lin_pmf / ang_pmf must be contiguous int8 (B, pH, pW) planes of "
         "one shape, B <= {}, with the key's scenarios".format(
             MAX_PLANE_BINS)),
        (all(q.dtype == torch.int8
             and tuple(q.shape) == lead + (p.shape[-3],)
             and q.is_contiguous()
             for q, p in ((lin_qbins, lin_pmf), (ang_qbins, ang_pmf))),
         "lin_qbins / ang_qbins must be contiguous int8 (B,) of their PMF's "
         "bins, with the key's scenarios"),
        (all(g.dtype == torch.int8 and tuple(g.shape) == lead + (rH, rW)
             and g.is_contiguous() for g in grids),
         "obstacle / unknown / risk must be contiguous int8 (pH, pW) "
         "planes of the PMFs' shape, with the key's scenarios"),
        (all(a.device == dev
             for a in (key, ang_pmf, lin_qbins, ang_qbins, *grids)),
         "all inputs must be on one device"),
        (M >= 1 and 1 <= wH <= H and 1 <= wW <= W,
         "need M >= 1 and a non-empty window inside the map"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("map_sample: " + msg)


def _launch(layout, key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, alpha_dyn,
            M, window, m_offset, full_num_samples, masks=None, risk_map=None,
            crop=None):
    """Check the inputs, allocate the outputs of ``layout`` and launch the
    kernel once.  ``masks``: the (obstacle, unknown) planes of a payload
    layout.  ``crop``: ``(task, roi_shape)`` for the crop mode, the planes
    the map's.  Returns ``{name: tensor or None}``: lin_grid, ang_grid
    and, by layout, lin_bins / ang_bins, payload, mask_words, risk_words;
    cropping, offset and lims."""
    dev = lin_pmf.device
    lead = tuple(key.shape[:-1])            # (B,) or () for one scenario
    rH, rW = lin_pmf.shape[-2:] if lin_pmf.dim() >= 3 else (-1, -1)
    if crop is not None:
        task, (rH, rW) = crop
        full_hw, oy, ox = (tuple(lin_pmf.shape[-2:]), None, None)
    else:
        task = None
        full_hw, oy, ox = (window if window is not None
                           else ((rH, rW), None, None))
    H, W = full_hw
    full_m = M if full_num_samples is None else full_num_samples
    grids = [g for g in (*(masks or ()), risk_map) if g is not None]
    _check_cuda_args(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, M, H, W,
                     grids, window_hw=(rH, rW))
    if not 0 <= m_offset <= full_m - M:
        raise ValueError("map_sample: rows [{}, {}) outside the {}-row "
                         "draw".format(m_offset, m_offset + M, full_m))
    if full_m * H * W >= 2 ** 32:
        raise NotImplementedError(
            "counter-addressed draws support M*H*W < 2**32 (got {})".format(
                full_m * H * W))
    if (lead[0] if lead else 1) * M >= 2 ** 31:
        raise ValueError("map_sample: scenarios x M must stay below 2**31")
    offsets = [None if o is None else _check_scalar(o, torch.int32, dev,
                                                     lead)
               for o in (oy, ox)]
    alpha = _check_scalar(alpha_dyn, torch.float32, dev, lead)
    crop_in = [None] * 4
    if task is not None:
        if not (task.x0.dtype == torch.float32
                and tuple(task.x0.shape) == lead + (3,)
                and task.x0.is_contiguous() and task.x0.device == dev):
            raise ValueError("map_sample: x0 must be a contiguous float32 "
                             "(3,) tensor on {}, (B, 3) with the key's "
                             "scenarios".format(dev))
        crop_in = [task.x0] + [_check_scalar(v, torch.float32, dev, lead)
                               for v in (task.xlim0, task.ylim0, task.res)]
    has_ang = ang_pmf is not None
    n = rH * rW

    def empty(shape, dtype, want=True):
        return (torch.empty(lead + shape, dtype=dtype, device=dev) if want
                else None)

    i32, i8 = torch.int32, torch.int8
    out = dict(lin_bins=None, ang_bins=None, payload=None, mask_words=None,
               risk_words=None,
               offset=empty((2,), torch.int32, task is not None),
               lims=empty((2,), torch.float32, task is not None),
               lin_grid=empty((M, rH, rW), i8),
               ang_grid=empty((M, rH, rW), i8, has_ang))
    if layout == "bins":
        out.update(lin_bins=empty((M, rH, rW), i32),
                   ang_bins=empty((M, rH, rW), i32, has_ang))
    elif layout == "byte":
        out["payload"] = empty((M, rH, rW), i32)
    else:
        out.update(payload=empty((M, -(-n // CELLS_PER_WORD[layout])), i32),
                   mask_words=empty((-(-n // 16),), i32),
                   risk_words=empty((-(-n // 4),), i32,
                                    risk_map is not None))
    obstacle, unknown = masks if masks is not None else (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_point()(
            LAYOUTS[layout], key.data_ptr(), *(ptr(o) for o in offsets),
            alpha.data_ptr(),
            *(ptr(t) for t in (lin_pmf, ang_pmf, lin_qbins, ang_qbins,
                               obstacle, unknown, risk_map)),
            *(ptr(out[k]) for k in ("lin_bins", "ang_bins", "lin_grid",
                                    "ang_grid", "payload", "mask_words",
                                    "risk_words")),
            *(ptr(t) for t in crop_in), ptr(out["offset"]),
            ptr(out["lims"]), M, rH, rW, lin_pmf.shape[-3],
            ang_pmf.shape[-3] if has_ang else 0, H, W, m_offset,
            lead[0] if lead else 1, stream)
    if err != 0:
        raise RuntimeError("map_sample kernel launch failed: CUDA error "
                           "{}".format(err))
    return out


def sample_traction_window(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins,
                           alpha_dyn, num_samples, window=None, m_offset=0,
                           full_num_samples=None):
    """Sample ``num_samples`` lin and ang traction maps of a window, from
    one counter-addressed draw of uniforms.

    Args:
      key: int64 ``(2,)`` tensor of uint32 key words (``draw_map_key``).
      lin_pmf / ang_pmf: int8 ``(B, rH, rW)`` PMF windows.
      lin_qbins / ang_qbins: int8 ``(B,)`` quantized bin values.  With
        ``ang_pmf`` and ``ang_qbins`` None only the lin plane is sampled
        and its ang outputs are None.
      alpha_dyn: float32 0-d tensor: the quantile restriction.
      num_samples: M.
      window: ``(full_hw, oy, ox)`` when the PMFs are a window of a
        ``full_hw`` map starting at ``(oy, ox)`` (0-d int32 tensors on the
        device; the plain version also takes ints): each cell's uniform
        is drawn at its global index, so a window realizes the full
        draw's maps.  None: the PMFs are the whole map.
      m_offset / full_num_samples: rows ``[m_offset, m_offset + M)`` of a
        ``full_num_samples``-row draw.

    Scenarios: a key ``(S, 2)`` samples S scenarios in one launch; every
    other tensor argument then has a leading S (the offsets and alpha_dyn
    ``(S,)``), and so has every output.

    Returns:
      ``(lin_bins, ang_bins, lin_grids, ang_grids)``: int32 and int8
      ``(M, rH, rW)``; a bin index B (a draw past a column summing below
      100) decodes to -128.

    On CUDA tensors this launches the kernel and adds one to
    ``sample_traction_window.launches``; on CPU tensors it runs
    ``sample_traction_window_plain``.
    """
    if not lin_pmf.is_cuda:
        return sample_traction_window_plain(
            key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, alpha_dyn,
            num_samples, window=window, m_offset=m_offset,
            full_num_samples=full_num_samples)
    out = _launch("bins", key, lin_pmf, ang_pmf, lin_qbins, ang_qbins,
                  alpha_dyn, num_samples, window, m_offset, full_num_samples)
    sample_traction_window.launches += 1
    return out["lin_bins"], out["ang_bins"], out["lin_grid"], out["ang_grid"]


sample_traction_window.launches = 0


def sample_and_pack_window(key, maps, alpha_dyn, num_samples, layout,
                           window=None, risk=False, m_offset=0,
                           full_num_samples=None):
    """Sample ``num_samples`` maps of a window and write the rollout's map
    payload in ``layout``, from one counter-addressed draw of uniforms.

    Args:
      key, alpha_dyn, num_samples, window, m_offset, full_num_samples: as
        for ``sample_traction_window``.
      maps: ``MapInputs`` of the window: the PMFs and bin values as
        ``sample_traction_window`` takes them (``ang_pmf`` and
        ``ang_qbins`` None: no ang plane, the payload's ang fields 0), and
        the int8 ``(rH, rW)`` obstacle, unknown and risk planes.
      layout: 'byte', 'binned2', 'binned' or 'binned8' (the solver's
        layouts, ``packing.pack_payload``).
      risk: write the risk plane (speed-map mode).

    Scenarios: as for ``sample_traction_window``, every field of ``maps``
    with the key's leading axis.

    Returns:
      ``(payload, lin_grids, ang_grids)``: the payload as
      ``packing.pack_payload`` gives it (int32 ``(M, rH, rW)`` words for
      'byte'; ``(cells, mask, risk_words or None)`` for the binned
      layouts), and the decoded int8 ``(M, rH, rW)`` grids (ang None with
      no ang plane).

    On CUDA tensors this launches the kernel once and adds one to
    ``sample_and_pack_window.launches``; on CPU tensors it runs
    ``sample_and_pack_window_plain``.
    """
    if layout not in CELLS_PER_WORD and layout != "byte":
        raise ValueError("map_sample: unknown payload layout {!r}".format(
            layout))
    if not maps.lin_pmf.is_cuda:
        return sample_and_pack_window_plain(
            key, maps, alpha_dyn, num_samples, layout, window=window,
            risk=risk, m_offset=m_offset, full_num_samples=full_num_samples)
    out = _launch(layout, key, maps.lin_pmf, maps.ang_pmf, maps.lin_qbins,
                  maps.ang_qbins, alpha_dyn, num_samples, window, m_offset,
                  full_num_samples, masks=(maps.obstacle, maps.unknown),
                  risk_map=maps.risk if risk else None)
    sample_and_pack_window.launches += 1
    payload = (out["payload"] if layout == "byte" else
               (out["payload"], out["mask_words"], out["risk_words"]))
    return payload, out["lin_grid"], out["ang_grid"]


sample_and_pack_window.launches = 0


def sample_and_pack_crop(key, maps, task, num_samples, layout, roi_shape,
                         risk=False, m_offset=0, full_num_samples=None):
    """``sample_and_pack_window`` on the reachable window around the robot,
    the crop done in the same launch.

    Args:
      key, num_samples, layout, risk, m_offset, full_num_samples: as for
        ``sample_and_pack_window`` (rows ``[m_offset, m_offset +
        num_samples)`` of a ``full_num_samples``-row draw).
      maps: ``MapInputs`` of the whole (H, W) map.
      task: ``TerrainTask`` on the maps' device: its x0, xlim0, ylim0 and
        res place the window (``roi.roi_start``), alpha_dyn the draw.
      roi_shape: the window's ``(rH, rW)``.

    Scenarios: as for ``sample_traction_window``, every field of ``maps``
    and the task's x0 ``(S, 3)``, xlim0, ylim0, res and alpha_dyn ``(S,)``
    with the key's leading axis; the window is worked out per scenario,
    and the task's limits and the offsets come back ``(S,)`` and ``(S,
    2)``.

    Returns:
      ``(payload, lin_grids, ang_grids, task, offset)``: the window's
      payload and grids as ``sample_and_pack_window`` gives them, the task
      with ``xlim0`` / ``ylim0`` moved to the window's corner and the
      window's start ``(oy, ox)`` as an int32 ``(2,)`` tensor.  Nothing is
      read on the host.

    On CUDA tensors this launches the kernel once, in its crop mode, and
    adds one to ``sample_and_pack_crop.launches``; on CPU tensors it runs
    ``sample_and_pack_crop_plain``.
    """
    if layout not in CELLS_PER_WORD and layout != "byte":
        raise ValueError("map_sample: unknown payload layout {!r}".format(
            layout))
    if not maps.lin_pmf.is_cuda:
        return sample_and_pack_crop_plain(
            key, maps, task, num_samples, layout, roi_shape, risk=risk,
            m_offset=m_offset, full_num_samples=full_num_samples)
    out = _launch(layout, key, maps.lin_pmf, maps.ang_pmf, maps.lin_qbins,
                  maps.ang_qbins, task.alpha_dyn, num_samples, None,
                  m_offset, full_num_samples,
                  masks=(maps.obstacle, maps.unknown),
                  risk_map=maps.risk if risk else None,
                  crop=(task, tuple(roi_shape)))
    sample_and_pack_crop.launches += 1
    payload = (out["payload"] if layout == "byte" else
               (out["payload"], out["mask_words"], out["risk_words"]))
    lims = out["lims"]
    return (payload, out["lin_grid"], out["ang_grid"],
            task._replace(xlim0=lims[..., 0], ylim0=lims[..., 1]),
            out["offset"])


sample_and_pack_crop.launches = 0
