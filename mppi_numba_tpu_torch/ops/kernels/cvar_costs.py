"""The solve's per-rollout cost: CVaR over the M map samples plus the
control-coupling term.  The hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

``cvar_costs`` launches ``csrc/cvar_costs.cu`` for CUDA tensors and runs
``cvar_costs_plain`` for CPU tensors.  The kernel replaces the JAX
package's XLA-fused ``cvar_from_costs`` / ``cvar_from_costs_dynamic``
(``mppi_numba_tpu/ops/cvar.py:17-33,79-91``) and ``control_coupling``
(``mppi_numba_tpu/ops/rollout.py:123-131``), none of which has a Pallas
kernel: in torch ops they were a top-k (or a full sort) and some five
elementwise and reduce launches an iteration.  Both versions sort each
row descending (NaN largest), fold the worst costs largest first and sum
the coupling in the halving tree (``ops/tree.py``), so the kernel equals
the plain version bit for bit.
The kernel reads the run-time alpha on the card, so a solve with it
captures into a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import rec_max_control_rollouts
from ..cvar import cvar_from_costs, cvar_from_costs_dynamic
from ..rollout import control_coupling
from ..tree import padded_length

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/cvar_costs.cu"
REPLACES = ("mppi_numba_tpu/ops/cvar.py:17-33,79-91 (cvar_from_costs, "
            "cvar_from_costs_dynamic) + mppi_numba_tpu/ops/rollout.py:"
            "123-131 (control_coupling), XLA-fused; no Pallas kernel")
# The Config's largest M: a block of 512 threads sorts a row of up to
# 16,384 keys, 32 a thread.
MAX_M = rec_max_control_rollouts
# The coupling's 2T terms are summed in the team's shared memory.
MAX_T = 4096
# A card's resident threads an SM (H100: 2,048 on each of 132 SMs).
THREADS_PER_SM = 2048
H100_SMS = 132


def threads_per_row(B, K, M, sms=H100_SMS):
    """The kernel's team a (scenario, rollout) row, from the shapes: a
    block past M = 1024 (512 threads, 1,024 past M = 8192: at most 16 keys
    a thread), 128 threads where the B * K rows of 128 take at most half
    the card's ``sms`` SMs' threads (world (a): a warp a row would leave
    most of the card idle), else a warp (the rows fill the card, and a
    warp needs no block barrier)."""
    L = padded_length(M)
    if L > 8192:
        return 1024
    if L > 1024:
        return 512
    if L >= 128 and B * K * 128 <= sms * THREADS_PER_SM // 2:
        return 128
    return 32


def cvar_costs_plain(costs_km, noise, u, u_std, lambda_weight, numel=None,
                     alpha=None):
    """Plain PyTorch version: ``cvar_from_costs`` (static ``numel``) or
    ``cvar_from_costs_dynamic`` (``alpha``) plus ``control_coupling``.
    Arguments and result as for ``cvar_costs``."""
    cvar = (cvar_from_costs(costs_km, numel) if alpha is None
            else cvar_from_costs_dynamic(costs_km, alpha))
    return cvar + control_coupling(u, noise, u_std, lambda_weight)


@functools.lru_cache(maxsize=None)
def _entry_points():
    """The library's launch entry points, built and loaded on first use,
    their ctypes signatures set once."""
    from ._build import load

    lib = load("cvar_costs")
    fn = lib.cvar_costs_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    empty = lib.empty_launch
    empty.argtypes = [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    lib.cvar_costs_prepare.restype = ctypes.c_int
    return fn, empty, lib.cvar_costs_prepare


@functools.lru_cache(maxsize=None)
def _prepared(index):
    """Sets the kernels' shared-memory opt-in on card ``index`` once
    (outside any capture: the first call on a card is an eager one);
    returns the card's SM count."""
    with torch.cuda.device(index):
        err = _entry_points()[2]()
    if err != 0:
        raise RuntimeError("cvar_costs: setting the kernels' shared memory "
                           "failed: CUDA error {}".format(err))
    return torch.cuda.get_device_properties(index).multi_processor_count


def _describe(t):
    if not isinstance(t, torch.Tensor):
        return repr(t)
    return "{} {} on {}".format(t.dtype, tuple(t.shape), t.device)


def check_tensor(what, t, shape, dev):
    """Raise ValueError unless ``t`` is a float32 tensor of ``shape`` on
    ``dev``; a ``shape`` of () also takes one element of any shape (a
    scenario's scalar)."""
    ok = (isinstance(t, torch.Tensor) and t.dtype == torch.float32
          and t.device == dev
          and (tuple(t.shape) == tuple(shape)
               or (shape == () and t.numel() == 1)))
    if not ok:
        raise ValueError("{} must be a float32 {} tensor on {}, got "
                         "{}".format(what, tuple(shape) if shape
                                     else "scalar", dev, _describe(t)))


def check_args(costs_km, noise, u, u_std, lambda_weight, numel, alpha):
    """The kernel's inputs, as ``cvar_costs`` documents them; raises
    ValueError on anything else.  Returns ``(B, K, M, T)``."""
    if (numel is None) == (alpha is None):
        raise ValueError("cvar_costs: give one of numel and alpha")
    dev = costs_km.device
    if costs_km.dtype != torch.float32 or costs_km.dim() not in (2, 3):
        raise ValueError("cvar_costs: costs_km must be float32 (K, M) or "
                         "(B, K, M), got {} {}".format(costs_km.dtype,
                                                       tuple(costs_km.shape)))
    lead = tuple(costs_km.shape[:-2])
    K, M = costs_km.shape[-2:]
    T = u.shape[-2] if isinstance(u, torch.Tensor) and u.dim() >= 2 else -1
    for what, t, shape in (
            ("noise", noise, lead + (K, T, 2)), ("u", u, lead + (T, 2)),
            ("u_std", u_std, lead + (2,)),
            ("lambda_weight", lambda_weight, lead),
            ("alpha", alpha, lead)):
        if t is not None or what != "alpha":
            check_tensor("cvar_costs: " + what, t, shape, dev)
    if not 1 <= M <= MAX_M:
        raise ValueError("cvar_costs: M = {} map samples; the kernel sorts "
                         "at most {} a row".format(M, MAX_M))
    if not 1 <= T <= MAX_T:
        raise ValueError("cvar_costs: T = {} steps; the kernel sums the "
                         "coupling of at most {}".format(T, MAX_T))
    B = lead[0] if lead else 1
    if K < 1 or B < 1 or B * K >= 2 ** 31:
        raise ValueError("cvar_costs: {} scenarios x {} rollouts out of "
                         "range".format(B, K))
    if numel is not None and numel < 1:
        raise ValueError("cvar_costs: numel must be >= 1, got {}".format(
            numel))
    return B, K, M, T


def cvar_costs(costs_km, noise, u, u_std, lambda_weight, numel=None,
               alpha=None):
    """Each rollout's cost: the CVaR of its M map-sample costs plus the
    control-coupling term, ``cvar + lambda * sum_{t,c} eps * u / sigma^2``.

    Args:
      costs_km: float32 ``(K, M)`` rollout costs, M <= ``MAX_M``.
      noise: float32 ``(K, T, 2)`` control perturbations.
      u: float32 ``(T, 2)`` nominal controls.
      u_std: float32 ``(2,)`` noise scales.
      lambda_weight: float32 0-d temperature.
      numel: the static count ``ceil(M * alpha)`` (``>= M``: the mean of
        all M), or None with
      alpha: a float32 0-d tensor, the count ``int(ceil(float32(M) *
        alpha))`` worked out on the device (``cvar_from_costs_dynamic``).

    Scenarios: a leading axis B on every tensor (``lambda_weight`` and
    ``alpha`` ``(B,)``, ``u_std`` ``(B, 2)``) reduces each scenario with
    its own values in the same launch.

    Returns:
      float32 ``(K,)`` (``(B, K)``).

    On CUDA tensors this launches the kernel once and adds one to
    ``cvar_costs.launches``; on CPU tensors it runs ``cvar_costs_plain``.
    """
    if not costs_km.is_cuda:
        return cvar_costs_plain(costs_km, noise, u, u_std, lambda_weight,
                                numel=numel, alpha=alpha)
    B, K, M, T = check_args(costs_km, noise, u, u_std, lambda_weight, numel,
                            alpha)
    dev = costs_km.device
    ins = [t.contiguous() for t in (costs_km, noise, u, u_std,
                                    lambda_weight)]
    alpha = None if alpha is None else alpha.contiguous()
    out = torch.empty(tuple(costs_km.shape[:-1]), dtype=torch.float32,
                      device=dev)
    tpr = threads_per_row(B, K, M, _prepared(dev.index))
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_points()[0](
            *(t.data_ptr() for t in ins),
            None if alpha is None else alpha.data_ptr(), out.data_ptr(),
            B, K, M, T, 0 if numel is None else min(numel, M), tpr,
            stream)
    if err != 0:
        raise RuntimeError("cvar_costs kernel launch failed: CUDA error "
                           "{}".format(err))
    cvar_costs.launches += 1
    return out


cvar_costs.launches = 0


def empty_launch(device):
    """One launch of an empty kernel (one block of 32 threads) on
    ``device``'s current stream: the floor a graph node costs, beside the
    solve-tail kernels' bounds.  Not counted: no path of the solve makes
    it."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        err = _entry_points()[1](torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("empty kernel launch failed: CUDA error "
                           "{}".format(err))
