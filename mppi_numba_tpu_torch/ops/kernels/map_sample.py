"""Traction-map sampling: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

``sample_traction_window`` launches ``csrc/map_sample.cu`` for CUDA tensors
and runs ``sample_traction_window_plain`` for CPU tensors.  It replaces the
JAX package's XLA-fused map draw, ``uniform_window`` + ``sample_traction_bins``
+ ``decode_bins`` (``mppi_numba_tpu/ops/sampling.py:156,219,246``), which
has no Pallas kernel: in plain torch ops the threefry hash is some 150
elementwise passes over the (M, H*W) draw, so on the card the whole draw is
one pass.  The kernel is bound by integer operations (see the source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sampling import decode_bins, traction_bins_from_uniforms, uniform_window

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/map_sample.cu"
REPLACES = ("mppi_numba_tpu/ops/sampling.py:156,219,246 (uniform_window + "
            "sample_traction_bins + decode_bins, XLA-fused; no Pallas kernel)")


def sample_traction_window_plain(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins,
                                 alpha_dyn, num_samples, window=None,
                                 m_offset=0, full_num_samples=None):
    """Plain PyTorch version of the kernel: ``uniform_window``, the ranks
    and the decode.  Arguments as for ``sample_traction_window``."""
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


@functools.lru_cache(maxsize=None)
def _entry_point():
    """The library's launch entry point, built and loaded on first use, its
    ctypes signature set once."""
    from ._build import load

    fn = load("map_sample").map_sample_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_scalar(value, dtype, device):
    """A scalar the kernel reads on the card: a one-element ``dtype``
    tensor on ``device``, passed as it is (no copy to the host)."""
    if not (isinstance(value, torch.Tensor) and value.dtype == dtype
            and value.numel() == 1 and value.device == device):
        raise ValueError("sample_traction_window: expected a {} scalar "
                         "tensor on {}, got {!r}".format(dtype, device, value))
    return value


def _check_cuda_args(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, M, H, W):
    dev = lin_pmf.device
    rH, rW = lin_pmf.shape[1:] if lin_pmf.dim() == 3 else (-1, -1)
    if (ang_pmf is None) != (ang_qbins is None):
        raise ValueError("sample_traction_window: ang_pmf and ang_qbins "
                         "must both be given or both be None")
    if ang_pmf is None:
        ang_pmf, ang_qbins = lin_pmf, lin_qbins
    checks = [
        (key.dtype == torch.int64 and tuple(key.shape) == (2,)
         and key.is_contiguous(), "key must be contiguous int64 (2,)"),
        (all(p.dtype == torch.int8 and p.dim() == 3
             and tuple(p.shape[1:]) == (rH, rW) and p.is_contiguous()
             for p in (lin_pmf, ang_pmf)),
         "lin_pmf / ang_pmf must be contiguous int8 (B, rH, rW) of one "
         "window"),
        (all(q.dtype == torch.int8 and tuple(q.shape) == (p.shape[0],)
             and q.is_contiguous()
             for q, p in ((lin_qbins, lin_pmf), (ang_qbins, ang_pmf))),
         "lin_qbins / ang_qbins must be contiguous int8 (B,) of their PMF's "
         "bins"),
        (all(a.device == dev for a in (key, ang_pmf, lin_qbins, ang_qbins)),
         "all inputs must be on one device"),
        (M >= 1 and 1 <= rH <= H and 1 <= rW <= W,
         "need M >= 1 and a non-empty window inside the map"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("sample_traction_window: " + msg)


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
    dev = lin_pmf.device
    rH, rW = lin_pmf.shape[1:] if lin_pmf.dim() == 3 else (-1, -1)
    full_hw, oy, ox = window if window is not None else ((rH, rW), None, None)
    H, W = full_hw
    M = num_samples
    full_m = M if full_num_samples is None else full_num_samples
    _check_cuda_args(key, lin_pmf, ang_pmf, lin_qbins, ang_qbins, M, H, W)
    if not 0 <= m_offset <= full_m - M:
        raise ValueError("sample_traction_window: rows [{}, {}) outside the "
                         "{}-row draw".format(m_offset, m_offset + M, full_m))
    if full_m * H * W >= 2 ** 32:
        raise NotImplementedError(
            "counter-addressed draws support M*H*W < 2**32 (got {})".format(
                full_m * H * W))
    offsets = [None if o is None else _check_scalar(o, torch.int32, dev)
               for o in (oy, ox)]
    alpha = _check_scalar(alpha_dyn, torch.float32, dev)
    def out(dtype, plane):
        return (None if plane is None
                else torch.empty((M, rH, rW), dtype=dtype, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    outs = (out(torch.int32, lin_pmf), out(torch.int32, ang_pmf),
            out(torch.int8, lin_pmf), out(torch.int8, ang_pmf))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry_point()(
        key.data_ptr(), *(ptr(o) for o in offsets), alpha.data_ptr(),
        *(ptr(t) for t in (lin_pmf, ang_pmf, lin_qbins, ang_qbins, *outs)),
        M, rH, rW, lin_pmf.shape[0],
        0 if ang_pmf is None else ang_pmf.shape[0], H, W, m_offset, stream)
    if err != 0:
        raise RuntimeError("map_sample kernel launch failed: CUDA error "
                           "{}".format(err))
    sample_traction_window.launches += 1
    return outs


sample_traction_window.launches = 0
