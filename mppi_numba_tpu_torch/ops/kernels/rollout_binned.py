"""Binned fused rollout: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

``terrain_rollout_costs_binned`` launches ``csrc/rollout_binned.cu`` for
CUDA tensors and runs ``terrain_rollout_costs_binned_plain`` for CPU
tensors.  It replaces
``mppi_numba_tpu/ops/pallas/rollout_kernel.py::_rollout_kernel_binned``
(wrapper ``terrain_rollout_costs_pallas_binned``): the same costs as the
byte kernel, read from a packed per-sample cell plane (``cell_bits`` 2, 4
or 8; see ``ops/packing.py``) plus the shared mask plane and, in speed-map
mode, the shared risk-byte plane.  2- and 4-bit cells hold bin indices
decoded through ``build_bin_luts``; 8-bit cells hold decoded values,
decoded inline as ``lb + ratio * value``.  Like the byte kernel it is
bound by instruction issue; see ``csrc/rollout_step.cuh``.  Every plane,
the LUT, the task vector and the controls may carry a leading scenario
axis B, as the byte kernel's arguments do: one launch, costs ``(B, K,
M)``; ``skip`` zeroes the costs of the scenarios it marks and skips their
rollouts, as the byte kernel's does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models import kernel_model
from ...types import per_scenario
from .rollout_byte import (bind, check_fast_trig, check_scenario_args,
                           chunked_launches, plain_rollout, read_tiling)

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/rollout_binned.cu"
REPLACES = "mppi_numba_tpu/ops/pallas/rollout_kernel.py:387"

# LUT entries per row: the widest bin index a 4-bit cell holds.
LUT_BINS = 16
CELLS_PER_WORD = {2: 8, 4: 4, 8: 2}
# Most PMF bins a cell plane can index (None: it holds values, not bins).
MAX_BINS = {2: 4, 4: 16, 8: None}


def build_bin_luts(task, lin_qbins, ang_qbins):
    """Per-bin effective traction: float32 ``(2, LUT_BINS)``, row 0 linear,
    row 1 angular, ``lb + ratio * float(qbin)`` (two rounded operations,
    as the byte decode), entries past each table's bins zero.  Rows 0/1 of
    the JAX package's ``(8, 128)`` LUT tile.  With a leading scenario axis
    (qbins ``(B, bins)``, the task's scalars ``(B,)``): ``(B, 2,
    LUT_BINS)``, one LUT a scenario."""
    f32 = torch.float32
    for q in (lin_qbins, ang_qbins):
        if q.shape[-1] > LUT_BINS:
            raise ValueError("build_bin_luts: {} bins exceed the {}-entry "
                             "LUT".format(q.shape[-1], LUT_BINS))
    lead = tuple(lin_qbins.shape[:-1])
    lut = torch.zeros(lead + (2, LUT_BINS), dtype=f32,
                      device=lin_qbins.device)
    for row, q, lb, ratio in ((0, lin_qbins, task.lin_lb, task.lin_ratio),
                              (1, ang_qbins, task.ang_lb, task.ang_ratio)):
        lut[..., row, :q.shape[-1]] = (lb[..., None]
                                       + ratio[..., None] * q.to(f32))
    return lut


def terrain_rollout_costs_binned_plain(cells, mask, lut, task_vec, v_all,
                                       w_all, risk=None, *, H, W, T,
                                       cell_bits, fast_trig=False,
                                       step_fn=None, skip=None):
    """Plain PyTorch version of the kernel: the same interface and the same
    float32 arithmetic, step by step, over ``(K, M)`` planes.

    Args:
      cells: int32 ``(M, ceil(H*W / CELLS_PER_WORD[cell_bits]))`` cell
        plane from ``pack_bin_crumbs`` (``cell_bits=2``: 2-bit lin and ang
        fields), ``pack_bin_nibbles`` (4) or ``pack_byte_pairs`` (8).
      mask: int32 ``(ceil(H*W/16),)`` from ``pack_mask_nibbles``.
      lut: float32 ``(2, LUT_BINS)`` from ``build_bin_luts``; unused (may
        be None) for ``cell_bits=8``.
      task_vec / v_all / w_all: as for the byte kernel.
      risk: int32 ``(ceil(H*W/4),)`` from ``pack_risk_bytes`` in speed-map
        mode, else None.
      skip: None, or a bool of the scenarios' shape: True gives zeros.

      With a leading scenario axis on every given argument (``cells (B,
      M, words)``, ``mask (B, words)``, ``lut (B, 2, LUT_BINS)``, the
      byte kernel's) each scenario is rolled out in turn.

    Returns:
      float32 ``(K, M)`` rollout costs incl. terminal, excl. coupling
      (``(B, K, M)`` with the scenario axis).
    """
    if cells.dim() == 3:
        return per_scenario(terrain_rollout_costs_binned_plain,
                            (cells, mask, lut, task_vec, v_all, w_all, risk),
                            dict(H=H, W=W, T=T, cell_bits=cell_bits,
                                 fast_trig=fast_trig, step_fn=step_fn,
                                 skip=skip))
    f32, i32 = torch.float32, torch.int32
    M, n_words = cells.shape
    flat = cells.reshape(-1)
    m_off = (torch.arange(M, device=cells.device, dtype=torch.int64)
             * n_words)[None, :]
    cpw = CELLS_PER_WORD[cell_bits]
    word_shift = cpw.bit_length() - 1
    lin_lb, lin_ratio = task_vec[14], task_vec[15]
    ang_lb, ang_ratio = task_vec[16], task_vec[17]

    low = (1 << cell_bits) - 1

    def decode(cell):
        # A cell holds lin | ang << cell_bits.  Shifts act on signed int32,
        # so >> is arithmetic as in jnp.
        words = flat[(cell >> word_shift) + m_off]
        code = words >> ((cell & (cpw - 1)) * (2 * cell_bits)).to(i32)
        lin_f, ang_f = code & low, (code >> cell_bits) & low
        if cell_bits == 8:
            lin_tr = lin_lb + lin_ratio * lin_f.to(f32)
            ang_tr = ang_lb + ang_ratio * ang_f.to(f32)
        else:
            lin_tr = lut[0][lin_f.long()]
            ang_tr = lut[1][ang_f.long()]
        mcode = mask[cell >> 4] >> ((cell & 15) << 1).to(i32)
        obs = (mcode & 1).to(f32)
        unk = ((mcode >> 1) & 1).to(f32)
        rbyte = None
        if risk is not None:
            rbyte = ((risk[cell >> 2] >> ((cell & 3) << 3).to(i32))
                     & 0xFF).to(f32)
        return lin_tr, ang_tr, obs, unk, rbyte

    return plain_rollout(decode, task_vec, v_all, w_all, M=M, H=H, W=W,
                         T=T, fast_trig=fast_trig, step_fn=step_fn,
                         skip=skip)


@functools.lru_cache(maxsize=None)
def _entry_points():
    """The library's ``(launch, info)`` entry points, built and loaded on
    first use, their ctypes signatures set once."""
    from ._build import load

    lib = load("rollout_binned")
    return bind(lib.rollout_binned_launch,
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                + [ctypes.c_float, ctypes.c_void_p],
                lib.rollout_binned_info, 4)


def kernel_tiling(*, cell_bits, speed_map=False, fast_trig=False,
                  step_fn=None, device=None):
    """The tiling (block width, map samples per thread) and resources of
    the instantiation that a launch with these options runs, read from the
    built library on ``device`` (default: the current card; needs nvcc and
    a card)."""
    model, _ = kernel_model(step_fn)
    check_fast_trig(fast_trig, step_fn)
    with torch.cuda.device(device):
        return read_tiling(_entry_points()[1], cell_bits, int(speed_map),
                           int(fast_trig), model)


def _launch(cells, mask, lut, task_vec, v_all, w_all, risk, H, W, T,
            cell_bits, fast_trig, model, wheelbase, skip):
    fn = _entry_points()[0]
    M, n_words = cells.shape[-2:]
    K = v_all.shape[-1]
    lead = tuple(cells.shape[:-2])          # (B,) or () for one scenario
    out = torch.empty(lead + (K, M), dtype=torch.float32, device=cells.device)

    def launch(scen, samples, out_part, n, m):
        mask_p, lut_p, risk_p, tv, v, w, skip_p = scen
        err = fn(samples[0].data_ptr(), mask_p.data_ptr(),
                 0 if lut is None else lut_p.data_ptr(),
                 0 if risk is None else risk_p.data_ptr(),
                 tv.data_ptr(), v.data_ptr(), w.data_ptr(),
                 out_part.data_ptr(),
                 0 if skip is None else skip_p.data_ptr(),
                 K, m, H, W, T, n_words, n,
                 task_vec.shape[-1], cell_bits, int(risk is not None),
                 int(fast_trig), model, wheelbase, stream)
        if err != 0:
            raise RuntimeError("rollout_binned kernel launch failed: CUDA "
                               "error {}".format(err))
        terrain_rollout_costs_binned.launches += 1

    def one(t):
        if t is None:   # an absent plane or mask: `mask` stands in, unread
            t = mask
        return t if lead else t[None]

    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        chunked_launches(launch, [one(t) for t in (mask, lut, risk, task_vec,
                                                   v_all, w_all, skip)],
                         [one(cells)], one(out))
    return out


def _check_cuda_args(cells, mask, lut, task_vec, v_all, w_all, risk, H, W,
                     T, cell_bits, skip):
    dev = cells.device
    hw = H * W
    lead = tuple(cells.shape[:-2])
    M = cells.shape[-2] if cells.dim() in (2, 3) else -1
    K = v_all.shape[-1] if v_all.dim() >= 2 else -1

    def words(dtype, shape, a):
        return (a is not None and a.dtype == dtype and a.is_contiguous()
                and tuple(a.shape) == lead + shape and a.device == dev)

    checks = [
        (cell_bits in CELLS_PER_WORD, "cell_bits must be 2, 4 or 8"),
        (words(torch.int32, (M, -(-hw // CELLS_PER_WORD.get(cell_bits, 1))),
               cells),
         "cells must be contiguous int32 (M, ceil(H*W / cells per word)), "
         "or with a leading scenario axis B"),
        (words(torch.int32, (-(-hw // 16),), mask),
         "mask must be contiguous int32 (ceil(H*W/16),), with the cells' "
         "scenarios"),
        (cell_bits == 8 or words(torch.float32, (2, LUT_BINS), lut),
         "lut must be contiguous float32 (2, {}), with the cells' "
         "scenarios".format(LUT_BINS)),
        (risk is None or words(torch.int32, (-(-hw // 4),), risk),
         "risk must be contiguous int32 (ceil(H*W/4),), with the cells' "
         "scenarios"),
        *check_scenario_args(lead, task_vec, v_all, w_all, T, K, skip),
        (all(a.device == dev for a in (task_vec, v_all, w_all)),
         "all inputs must be on one device"),
        (M >= 1 and K >= 1 and hw >= 1,
         "need K >= 1, M >= 1 and a non-empty map"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("terrain_rollout_costs_binned: " + msg)


def terrain_rollout_costs_binned(cells, mask, lut, task_vec, v_all, w_all,
                                 risk=None, *, H, W, T, cell_bits,
                                 fast_trig=False, step_fn=None, skip=None):
    """Rollout costs ``(K, M)`` over a binned cell plane (``(B, K, M)``
    for B scenarios in one launch: every argument with a leading B).

    On CUDA tensors this launches the hand-written kernel and adds one to
    ``terrain_rollout_costs_binned.launches``; the kernel runs the built-in
    models (``models.kernel_model``), and a custom registered step function
    raises ``NotImplementedError``.  On CPU tensors it runs
    ``terrain_rollout_costs_binned_plain``.  Arguments as for the plain
    version; speed-map mode is on when ``risk`` is given.
    """
    if not cells.is_cuda:
        return terrain_rollout_costs_binned_plain(
            cells, mask, lut, task_vec, v_all, w_all, risk, H=H, W=W, T=T,
            cell_bits=cell_bits, fast_trig=fast_trig, step_fn=step_fn,
            skip=skip)
    model, wheelbase = kernel_model(step_fn)
    check_fast_trig(fast_trig, step_fn)
    _check_cuda_args(cells, mask, lut, task_vec, v_all, w_all, risk, H, W, T,
                     cell_bits, skip)
    return _launch(cells, mask, lut, task_vec, v_all, w_all, risk, H, W, T,
                   cell_bits, fast_trig, model, wheelbase, skip)


terrain_rollout_costs_binned.launches = 0
