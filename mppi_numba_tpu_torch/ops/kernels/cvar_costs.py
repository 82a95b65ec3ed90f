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
row descending (NaN largest), sum the worst costs in XLA's CPU order
(``ops/tree.py::window_sum``, windows of 32 over the static count, or
over M for a run-time alpha's masked row and a static count of M, whose
row is summed as stored) and the coupling in the halving tree, so the
kernel equals the plain version bit for bit, and the CVaR equals the
JAX package's on the CPU given the same costs.
The kernel reads the run-time alpha on the card, so a solve with it
captures into a CUDA graph.

Every shape the JAX package solves launches: past ``SORTED_M`` map
samples the wide kernel (``cvar_wide_kernel``, a block a row: one
histogram of the row, then rounds of whole bins gathered and sorted in
shared memory); past ``STAGED_T`` steps the coupling is a launch of its
own before the CVaR's (``coupling_sums``, ``cvar_coupling_kernel``: each
row spread over 512 position classes, its noise staged through shared
memory), whose sums the CVaR kernel (the team kernel's twin, or the wide
kernel) reads back.  All three are built from ``csrc/cvar_wide.cu`` into
a library of their own.  The launcher picks them from the shapes
(``kernel_path``); the shapes below them launch ``csrc/cvar_costs.cu``'s
library as before.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..cvar import cvar_from_costs, cvar_from_costs_dynamic
from ..rollout import control_coupling
from ..tree import padded_length

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/cvar_costs.cu"
WIDE_KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/cvar_wide.cu"
REPLACES = ("mppi_numba_tpu/ops/cvar.py:17-33,79-91 (cvar_from_costs, "
            "cvar_from_costs_dynamic) + mppi_numba_tpu/ops/rollout.py:"
            "123-131 (control_coupling), XLA-fused; no Pallas kernel")
# The longest row a team sorts in registers (1,024 threads x 16 keys);
# past it the wide kernel (the source's kSortedM).
SORTED_M = 16384
# The longest horizon whose coupling terms a team stages in shared memory
# (2T padded to 8,192 words); past it the coupling is a launch of its own
# (kStagedT).
STAGED_T = 4096
# The wide kernel's threads a row (kWideTPR).
WIDE_THREADS = 1024
# The coupling kernel's block: threads, rows of one scenario, position
# classes a row, step indices a thread's group (kCoupleThreads,
# kCoupleRows, kCoupleH, kCoupleLeaves).
COUPLING_THREADS = 256
COUPLING_ROWS = 2
COUPLING_CLASSES = 2 * COUPLING_THREADS
COUPLING_LEAVES = 4
# Rows a launch: the kernel indexes them with 32-bit ints.
MAX_ROWS = 2 ** 31 - 1
# A card's resident threads an SM (H100: 2,048 on each of 132 SMs).
THREADS_PER_SM = 2048
H100_SMS = 132


def threads_per_row(B, K, M, sms=H100_SMS):
    """The kernel's team a (scenario, rollout) row, from the shapes: past
    ``SORTED_M`` the wide kernel's block (``WIDE_THREADS``), a block past
    M = 1024 (512 threads, 1,024 past M = 8192: at most 16 keys a thread),
    128 threads where the B * K rows of 128 take at most half the card's
    ``sms`` SMs' threads (world (a): a warp a row would leave most of the
    card idle), else a warp (the rows fill the card, and a warp needs no
    block barrier)."""
    if M > SORTED_M:
        return WIDE_THREADS
    L = padded_length(M)
    if L > 8192:
        return 1024
    if L > 1024:
        return 512
    if L >= 128 and B * K * 128 <= sms * THREADS_PER_SM // 2:
        return 128
    return 32


def kernel_path(B, K, M, T, sms=H100_SMS):
    """The kernel and instantiation a launch at these shapes runs, and
    whether the coupling is a launch of its own before it (past
    ``STAGED_T`` steps): ``("cvar_wide_kernel", 1024, None, coupled)``
    past ``SORTED_M``, else ``("cvar_costs_kernel", threads a row, keys a
    thread, coupled)``."""
    tpr = threads_per_row(B, K, M, sms)
    if M > SORTED_M:
        return "cvar_wide_kernel", tpr, None, T > STAGED_T
    return ("cvar_costs_kernel", tpr, max(padded_length(M), tpr) // tpr,
            T > STAGED_T)


def uses_wide_library(M, T):
    """Whether a launch at these shapes goes to ``csrc/cvar_wide.cu``'s
    library (past either cap) rather than ``csrc/cvar_costs.cu``'s."""
    return M > SORTED_M or T > STAGED_T


def coupling_launch_shape(B, K, T):
    """``cvar_coupling_kernel``'s launch: ``(blocks, threads, groups)``, a
    block of 256 threads a pair of rows of one scenario, and the groups
    of 4 step indices each thread sums (a power of two: 4 x groups x 256 >=
    T), as the source's ``coupling_log_groups``."""
    groups = 1
    while COUPLING_LEAVES * groups * COUPLING_THREADS < T:
        groups *= 2
    return B * -(-K // COUPLING_ROWS), COUPLING_THREADS, groups


def coupling_sums_plain(noise, u, u_std):
    """Plain PyTorch version of ``coupling_sums``: ``control_coupling`` at
    lambda 1 (the halving tree of ``noise * (u / u_std^2)`` over the (t,
    c) terms; times 1.0, which changes no float)."""
    return control_coupling(u, noise, u_std,
                            u_std.new_ones(u_std.shape[:-1]))


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
def _wide_entry_points():
    """``csrc/cvar_wide.cu``'s launch, prepare and coupling-launch entry
    points (the twins past ``STAGED_T``, the wide kernel and the coupling
    kernel, a library of their own), built and loaded on first use."""
    from ._build import load

    lib = load("cvar_wide")
    fn = lib.cvar_wide_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    coupling = lib.cvar_coupling_launch
    coupling.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    coupling.restype = ctypes.c_int
    lib.cvar_wide_prepare.restype = ctypes.c_int
    return fn, lib.cvar_wide_prepare, coupling


@functools.lru_cache(maxsize=None)
def _prepared(index, staged=True):
    """Sets the shared-memory opt-in of the staged kernels' library (or,
    ``staged=False``, of ``cvar_wide.cu``'s) on card ``index`` once
    (outside any capture: the first call on a card is an eager one);
    returns the card's SM count."""
    prepare = (_entry_points()[2] if staged else _wide_entry_points()[1])
    with torch.cuda.device(index):
        err = prepare()
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
    B = lead[0] if lead else 1
    if M < 1 or T < 1 or K < 1 or B < 1 or K > MAX_ROWS:
        raise ValueError("cvar_costs: {} scenarios x {} rollouts x {} map "
                         "samples x {} steps out of range".format(B, K, M,
                                                                  T))
    if numel is not None and numel < 1:
        raise ValueError("cvar_costs: numel must be >= 1, got {}".format(
            numel))
    return B, K, M, T


def cvar_costs(costs_km, noise, u, u_std, lambda_weight, numel=None,
               alpha=None):
    """Each rollout's cost: the CVaR of its M map-sample costs plus the
    control-coupling term, ``cvar + lambda * sum_{t,c} eps * u / sigma^2``.

    Args:
      costs_km: float32 ``(K, M)`` rollout costs.
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

    On CUDA tensors this launches the kernel once (once for every
    ``MAX_ROWS`` scenario rows) and adds one to ``cvar_costs.launches`` a
    launch; past ``SORTED_M`` map samples it is ``cvar_costs_wide``; past
    ``STAGED_T`` steps the coupling kernel launches before it (counted in
    ``coupling_sums.launches``).  On CPU tensors it runs
    ``cvar_costs_plain``.
    """
    if not costs_km.is_cuda:
        return cvar_costs_plain(costs_km, noise, u, u_std, lambda_weight,
                                numel=numel, alpha=alpha)
    if costs_km.shape[-1] > SORTED_M:
        return cvar_costs_wide(costs_km, noise, u, u_std, lambda_weight,
                               numel=numel, alpha=alpha)
    return _launch(cvar_costs, costs_km, noise, u, u_std, lambda_weight,
                   numel, alpha)


cvar_costs.launches = 0


def cvar_costs_wide(costs_km, noise, u, u_std, lambda_weight, numel=None,
                    alpha=None):
    """``cvar_costs`` past ``SORTED_M`` map samples: the wide kernel
    (``cvar_wide_kernel``), a block of 1,024 threads a row, the worst
    costs in rounds of at most ``SORTED_M``: whole bins of the row's key
    histogram, gathered from global memory and sorted in shared memory
    (a radix sort past 8,192 keys, the bitonic network below).  Arguments
    and result as for ``cvar_costs``, M > ``SORTED_M``.

    On CUDA tensors this launches the kernel once (once for every
    ``MAX_ROWS`` scenario rows) and adds one to
    ``cvar_costs_wide.launches`` a launch (past ``STAGED_T`` steps after
    the coupling kernel, counted in ``coupling_sums.launches``); on CPU
    tensors it runs ``cvar_costs_plain``.
    """
    if not costs_km.is_cuda:
        return cvar_costs_plain(costs_km, noise, u, u_std, lambda_weight,
                                numel=numel, alpha=alpha)
    if costs_km.shape[-1] <= SORTED_M:
        raise ValueError("cvar_costs_wide: M = {} map samples; the wide "
                         "kernel takes M > {} (cvar_costs the rest)".format(
                             costs_km.shape[-1], SORTED_M))
    return _launch(cvar_costs_wide, costs_km, noise, u, u_std,
                   lambda_weight, numel, alpha)


cvar_costs_wide.launches = 0


def _launch(counted, costs_km, noise, u, u_std, lambda_weight, numel,
            alpha):
    """Check the inputs and launch the kernel ``kernel_path`` picks, once
    for every ``MAX_ROWS`` rows of scenarios, adding one to
    ``counted.launches`` a launch."""
    B, K, M, T = check_args(costs_km, noise, u, u_std, lambda_weight, numel,
                            alpha)
    dev = costs_km.device
    lead = tuple(costs_km.shape[:-2])
    ins = [t.contiguous() for t in (costs_km, noise, u, u_std,
                                    lambda_weight)]
    alpha = None if alpha is None else alpha.contiguous()
    out = torch.empty(lead + (K,), dtype=torch.float32, device=dev)
    _, tpr, _, coupled = kernel_path(B, K, M, T, _prepared(dev.index))
    wide = uses_wide_library(M, T)
    if wide:
        _prepared(dev.index, staged=False)
    launch = _wide_entry_points()[0] if wide else _entry_points()[0]
    if not lead:
        ins = [t.reshape((1,) + tuple(t.shape)) for t in ins]
        alpha = None if alpha is None else alpha.reshape(1)
    rows = out.view(B, K)
    if coupled:
        # Each row's coupling first, into out, where the CVaR kernel reads
        # it back.
        _coupling_launch(ins[1], ins[2], ins[3], rows)
    step = max(1, MAX_ROWS // K)
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, step):
            part = slice(b0, min(B, b0 + step))
            err = launch(
                *(t[part].data_ptr() for t in ins),
                None if alpha is None else alpha[part].data_ptr(),
                rows[part].data_ptr(), part.stop - b0, K, M, T,
                0 if numel is None else min(numel, M), tpr, stream)
            if err != 0:
                raise RuntimeError("{} kernel launch failed: CUDA error "
                                   "{}".format(counted.__name__, err))
            counted.launches += 1
    return out


def coupling_sums(noise, u, u_std):
    """Each rollout's coupling sum before lambda, ``sum_{t,c} eps * u /
    sigma^2`` in the halving tree's order: the kernel that ``cvar_costs``
    launches before the CVaR past ``STAGED_T`` steps
    (``cvar_coupling_kernel``), callable on its own.

    Args:
      noise: float32 ``(K, T, 2)`` (or ``(B, K, T, 2)``).
      u: float32 ``(T, 2)`` (``(B, T, 2)``).
      u_std: float32 ``(2,)`` (``(B, 2)``).

    Returns float32 ``(K,)`` (``(B, K)``).  On CUDA tensors this launches
    the kernel once (once for every ``MAX_ROWS`` scenario rows) and adds
    one to ``coupling_sums.launches`` a launch; on CPU tensors it runs
    ``coupling_sums_plain``.
    """
    if not noise.is_cuda:
        return coupling_sums_plain(noise, u, u_std)
    dev = noise.device
    if noise.dim() not in (3, 4):
        raise ValueError("coupling_sums: noise must be float32 (K, T, 2) or "
                         "(B, K, T, 2), got {}".format(_describe(noise)))
    lead = tuple(noise.shape[:-3])
    K, T = noise.shape[-3], noise.shape[-2]
    check_tensor("coupling_sums: noise", noise, lead + (K, T, 2), dev)
    check_tensor("coupling_sums: u", u, lead + (T, 2), dev)
    check_tensor("coupling_sums: u_std", u_std, lead + (2,), dev)
    if K < 1 or T < 1 or K > MAX_ROWS:
        raise ValueError("coupling_sums: {} rollouts x {} steps out of "
                         "range".format(K, T))
    _prepared(dev.index, staged=False)
    ins = [t.contiguous() for t in (noise, u, u_std)]
    if not lead:
        ins = [t.reshape((1,) + tuple(t.shape)) for t in ins]
    out = torch.empty(lead + (K,), dtype=torch.float32, device=dev)
    B = ins[0].shape[0]
    _coupling_launch(*ins, out.view(B, K))
    return out


coupling_sums.launches = 0


def _coupling_launch(noise, u, u_std, rows):
    """``cvar_coupling_kernel`` into ``rows`` (B, K), once for every
    ``MAX_ROWS`` scenario rows, adding one to ``coupling_sums.launches`` a
    launch; the inputs contiguous with a scenario axis, on ``rows``'s
    device."""
    B, K = rows.shape
    T = u.shape[-2]
    dev = rows.device
    step = max(1, MAX_ROWS // K)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, step):
            part = slice(b0, min(B, b0 + step))
            err = _wide_entry_points()[2](
                noise[part].data_ptr(), u[part].data_ptr(),
                u_std[part].data_ptr(), rows[part].data_ptr(),
                part.stop - b0, K, T, stream)
            if err != 0:
                raise RuntimeError("coupling_sums kernel launch failed: CUDA "
                                   "error {}".format(err))
            coupling_sums.launches += 1


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
