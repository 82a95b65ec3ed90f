"""Traction-map sampling and the rollout's map payload: the hand-written
CUDA kernel, its wrappers and their plain PyTorch versions.

``sample_and_pack_window`` (the solve's entry) and
``sample_traction_window`` (bins and grids; ``TDM.sample_grids``) launch
``csrc/map_sample.cu`` for CUDA tensors and run their plain versions for
CPU tensors.  The kernel replaces the JAX package's XLA-fused map draw,
``uniform_window`` + ``sample_traction_bins`` + ``decode_bins``
(``mppi_numba_tpu/ops/sampling.py:156,219,246``), and the pack that follows
it in the jitted solve (``mppi_numba_tpu/solver.py:200-215``), none of
which has a Pallas kernel: in plain torch ops the threefry hash is some
150 elementwise passes over the (M, H*W) draw and the pack some 10-45
more, so on the card the draw, the ranks, the decode and the pack are one
pass.  The kernel is bound by integer operations (see the source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..packing import pack_payload
from ..sampling import decode_bins, traction_bins_from_uniforms, uniform_window

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/map_sample.cu"
REPLACES = ("mppi_numba_tpu/ops/sampling.py:156,219,246 (uniform_window + "
            "sample_traction_bins + decode_bins) and "
            "mppi_numba_tpu/solver.py:200-215 (the pack), XLA-fused; no "
            "Pallas kernel")
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
    lin_bins, ang_bins, lin_grids, ang_grids = sample_traction_window_plain(
        key, maps.lin_pmf, maps.ang_pmf, maps.lin_qbins, maps.ang_qbins,
        alpha_dyn, num_samples, window=window, m_offset=m_offset,
        full_num_samples=full_num_samples)
    payload = pack_payload(layout, lin_bins, ang_bins, lin_grids, ang_grids,
                           maps, risk=risk)
    return payload, lin_grids, ang_grids


@functools.lru_cache(maxsize=None)
def _entry_point():
    """The library's launch entry point, built and loaded on first use, its
    ctypes signature set once."""
    from ._build import load

    fn = load("map_sample").map_sample_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_scalar(value, dtype, device):
    """A scalar the kernel reads on the card: a one-element ``dtype``
    tensor on ``device``, passed as it is (no copy to the host)."""
    if not (isinstance(value, torch.Tensor) and value.dtype == dtype
            and value.numel() == 1 and value.device == device):
        raise ValueError("map_sample: expected a {} scalar tensor on {}, "
                         "got {!r}".format(dtype, device, value))
    return value


def _check_cuda_args(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, M, H, W,
                     grids=()):
    """The kernel's inputs: the key, the PMF windows, their bin values and
    any (rH, rW) int8 ``grids`` (the masks and risk plane)."""
    dev = lin_pmf.device
    rH, rW = lin_pmf.shape[1:] if lin_pmf.dim() == 3 else (-1, -1)
    if (ang_pmf is None) != (ang_qbins is None):
        raise ValueError("map_sample: ang_pmf and ang_qbins must both be "
                         "given or both be None")
    if ang_pmf is None:
        ang_pmf, ang_qbins = lin_pmf, lin_qbins
    checks = [
        (key.dtype == torch.int64 and tuple(key.shape) == (2,)
         and key.is_contiguous(), "key must be contiguous int64 (2,)"),
        (all(p.dtype == torch.int8 and p.dim() == 3
             and tuple(p.shape[1:]) == (rH, rW) and p.is_contiguous()
             and p.shape[0] <= MAX_PLANE_BINS
             for p in (lin_pmf, ang_pmf)),
         "lin_pmf / ang_pmf must be contiguous int8 (B, rH, rW) of one "
         "window, B <= {}".format(MAX_PLANE_BINS)),
        (all(q.dtype == torch.int8 and tuple(q.shape) == (p.shape[0],)
             and q.is_contiguous()
             for q, p in ((lin_qbins, lin_pmf), (ang_qbins, ang_pmf))),
         "lin_qbins / ang_qbins must be contiguous int8 (B,) of their PMF's "
         "bins"),
        (all(g.dtype == torch.int8 and tuple(g.shape) == (rH, rW)
             and g.is_contiguous() for g in grids),
         "obstacle / unknown / risk must be contiguous int8 (rH, rW) "
         "windows"),
        (all(a.device == dev
             for a in (key, ang_pmf, lin_qbins, ang_qbins, *grids)),
         "all inputs must be on one device"),
        (M >= 1 and 1 <= rH <= H and 1 <= rW <= W,
         "need M >= 1 and a non-empty window inside the map"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("map_sample: " + msg)


def _launch(layout, key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, alpha_dyn,
            M, window, m_offset, full_num_samples, masks=None, risk_map=None):
    """Check the inputs, allocate the outputs of ``layout`` and launch the
    kernel once.  ``masks``: the (obstacle, unknown) windows of a payload
    layout.  Returns ``{name: tensor or None}``: lin_grid, ang_grid and,
    by layout, lin_bins / ang_bins, payload, mask_words, risk_words."""
    dev = lin_pmf.device
    rH, rW = lin_pmf.shape[1:] if lin_pmf.dim() == 3 else (-1, -1)
    full_hw, oy, ox = window if window is not None else ((rH, rW), None, None)
    H, W = full_hw
    full_m = M if full_num_samples is None else full_num_samples
    grids = [g for g in (*(masks or ()), risk_map) if g is not None]
    _check_cuda_args(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, M, H, W,
                     grids)
    if not 0 <= m_offset <= full_m - M:
        raise ValueError("map_sample: rows [{}, {}) outside the {}-row "
                         "draw".format(m_offset, m_offset + M, full_m))
    if full_m * H * W >= 2 ** 32:
        raise NotImplementedError(
            "counter-addressed draws support M*H*W < 2**32 (got {})".format(
                full_m * H * W))
    offsets = [None if o is None else _check_scalar(o, torch.int32, dev)
               for o in (oy, ox)]
    alpha = _check_scalar(alpha_dyn, torch.float32, dev)
    has_ang = ang_pmf is not None
    n = rH * rW

    def empty(shape, dtype, want=True):
        return torch.empty(shape, dtype=dtype, device=dev) if want else None

    i32, i8 = torch.int32, torch.int8
    out = dict(lin_bins=None, ang_bins=None, payload=None, mask_words=None,
               risk_words=None,
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

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry_point()(
        LAYOUTS[layout], key.data_ptr(), *(ptr(o) for o in offsets),
        alpha.data_ptr(),
        *(ptr(t) for t in (lin_pmf, ang_pmf, lin_qbins, ang_qbins, obstacle,
                           unknown, risk_map)),
        *(ptr(out[k]) for k in ("lin_bins", "ang_bins", "lin_grid",
                                "ang_grid", "payload", "mask_words",
                                "risk_words")),
        M, rH, rW, lin_pmf.shape[0], ang_pmf.shape[0] if has_ang else 0, H,
        W, m_offset, stream)
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
