"""The MPPI control update: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

``update_useq_fused`` launches ``csrc/update_useq.cu`` for CUDA tensors
and runs ``update_useq_plain`` for CPU tensors.  The kernel replaces the
JAX package's XLA-fused ``update_useq`` (``mppi_numba_tpu/ops/update.py:
23-55``; no Pallas kernel), some dozen torch launches an iteration
before: the minimum, the softmax weights, their normalizer, the weighted
noise sum, the add and the clamps in one launch.  Both versions sum in the
halving tree's order (``ops/tree.py``), so the kernel equals the plain
version bit for bit.

Past ``FUSED_K`` rollouts the update takes the wide path, four launches
of ``csrc/update_wide.cu`` (``update_wide_min``, ``_eta``, ``_noise``,
``_finish``), a library of its own: the padded K positions split over
blocks by their low bits, the halving tree's last levels summed across
them in order, so it too equals the plain version bit for bit.
Scenarios past 65,535 launch in chunks (the grid's y).

The plain version also takes the process group a K axis is split over
(the sharded solve's k-split update): its three reductions then run
across the group between the all-reduces, in the same tree order, so at
one rank it equals the kernel bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from ...models import clip_controls
from ..tree import padded_length, tree_sum
from .cvar_costs import H100_SMS, check_tensor

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/update_useq.cu"
WIDE_KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/update_wide.cu"
REPLACES = ("mppi_numba_tpu/ops/update.py:23-55 (update_useq), XLA-fused; "
            "no Pallas kernel")
# The one-launch kernel's largest K: a block of up to 512 threads holds
# at most 64 tree positions a thread (the source's kFusedK); past it the
# wide path.
FUSED_K = 32768
STEPS_PER_BLOCK = 4   # the kernel's kSteps
WIDE_POSITIONS = 4096  # the wide path's positions a block (kWidePer)
# Scenarios a launch: the grid's y.
MAX_SCENARIOS = 65535


def wide_blocks(K):
    """The wide path's G, blocks a scenario (and the tree's last levels):
    the padded K over ``WIDE_POSITIONS``."""
    return max(padded_length(K), WIDE_POSITIONS) // WIDE_POSITIONS


def launch_shape(B, K, T, sms=H100_SMS):
    """The kernel's ``(threads a block, blocks a cluster)`` from the
    shapes: blocks of a quarter of the padded K (32 to 512 threads), and
    clusters that split each chunk of steps' K rows (at most 8 rows a
    thread, 8 blocks a cluster) until the blocks number three quarters of
    the card's ``sms`` SMs, or each thread holds one row: a cluster's
    barriers cost more than they save once the chunks alone come near a
    block an SM (the sweep's B = 30, the pools' B = 4)."""
    L = max(padded_length(K), 32)
    width = min(512, max(32, L // 4))
    positions = L // width
    cluster = max(1, positions // 8)
    blocks = -(-T // STEPS_PER_BLOCK) * B
    while cluster < min(positions, 8) and blocks * cluster < sms * 3 // 4:
        cluster *= 2
    return width, cluster


def update_useq_plain(costs, noise, u_cur, lambda_weight, vrange, wrange,
                      group=None):
    """Plain PyTorch version of ``update_useq_fused``; with ``group``, the
    process group the K axis is split over (costs and noise this rank's
    ``K_local`` rows): ``beta`` an all-reduce MIN, the normalizer and the
    weighted noise sum all-reduce SUMs of the local tree sums, as the JAX
    update's ``pmin`` / ``psum`` (``mppi_numba_tpu/ops/update.py:44-53``).
    The weights are then this rank's rows."""
    beta = torch.min(costs, dim=-1, keepdim=True).values
    if group is not None:
        dist.all_reduce(beta, op=dist.ReduceOp.MIN, group=group)
    w = torch.exp(-(costs - beta) / lambda_weight[..., None])
    eta = tree_sum(w)[..., None]
    if group is not None:
        dist.all_reduce(eta, op=dist.ReduceOp.SUM, group=group)
    w = w / eta
    du = tree_sum(w[..., None, None] * noise, dim=-3)
    if group is not None:
        dist.all_reduce(du, op=dist.ReduceOp.SUM, group=group)
    u_new = u_cur + du
    v, om = clip_controls(u_new, vrange[..., None, :], wrange[..., None, :])
    return torch.stack([v, om], dim=-1), w


@functools.lru_cache(maxsize=None)
def _entry_point():
    """The one-launch kernel's library's entry points, built and loaded on
    first use, their ctypes signatures set once."""
    from ._build import load

    lib = load("update_useq")
    fn = lib.update_useq_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.update_useq_prepare.restype = ctypes.c_int
    return fn, lib.update_useq_prepare


@functools.lru_cache(maxsize=None)
def _wide_entry_point():
    """The wide path's library (``csrc/update_wide.cu``), built and loaded
    on first use, its launch's ctypes signature set once."""
    from ._build import load

    fn = load("update_wide").update_useq_wide_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _prepared(index):
    """Sets the kernel's shared-memory opt-in on card ``index`` once;
    returns the card's SM count."""
    with torch.cuda.device(index):
        err = _entry_point()[1]()
    if err != 0:
        raise RuntimeError("update_useq: setting the kernel's shared memory "
                           "failed: CUDA error {}".format(err))
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_args(costs, noise, u_cur, lambda_weight, vrange, wrange):
    """The kernel's inputs, as ``update_useq_fused`` documents them; raises
    ValueError on anything else.  Returns ``(B, K, T)``."""
    dev = costs.device
    if costs.dtype != torch.float32 or costs.dim() not in (1, 2):
        raise ValueError("update_useq: costs must be float32 (K,) or (B, K), "
                         "got {} {}".format(costs.dtype, tuple(costs.shape)))
    lead = tuple(costs.shape[:-1])
    K = costs.shape[-1]
    T = (u_cur.shape[-2] if isinstance(u_cur, torch.Tensor)
         and u_cur.dim() >= 2 else -1)
    for what, t, shape in (
            ("noise", noise, lead + (K, T, 2)), ("u", u_cur, lead + (T, 2)),
            ("lambda_weight", lambda_weight, lead),
            ("vrange", vrange, lead + (2,)), ("wrange", wrange, lead + (2,))):
        check_tensor("update_useq: " + what, t, shape, dev)
    B = lead[0] if lead else 1
    if not (1 <= K < 2 ** 31 and B >= 1 and T >= 1):
        raise ValueError("update_useq: K = {} rollouts, {} scenarios, T = "
                         "{} out of range".format(K, B, T))
    return B, K, T


def update_useq_fused(costs, noise, u_cur, lambda_weight, vrange, wrange):
    """One MPPI control update.

    Args:
      costs: float32 ``(K,)`` rollout costs.
      noise: float32 ``(K, T, 2)`` control perturbations.
      u_cur: float32 ``(T, 2)`` nominal controls.
      lambda_weight: float32 0-d temperature.
      vrange, wrange: float32 ``(2,)`` actuation bounds.

    Scenarios: a leading axis B on every tensor (``lambda_weight`` ``(B,)``,
    the ranges ``(B, 2)``) updates each scenario in the same launch.

    Returns:
      ``(u_new (T, 2), weights (K,))``, with the arguments' leading axis.

    On CUDA tensors this launches the kernel once (once for every
    ``MAX_SCENARIOS`` scenarios) and adds one to
    ``update_useq_fused.launches`` a launch; past ``FUSED_K`` rollouts it
    is ``update_useq_wide``.  On CPU tensors it runs ``update_useq_plain``.
    """
    if not costs.is_cuda:
        return update_useq_plain(costs, noise, u_cur, lambda_weight, vrange,
                                 wrange)
    if costs.shape[-1] > FUSED_K:
        return update_useq_wide(costs, noise, u_cur, lambda_weight, vrange,
                                wrange)
    return _launch(update_useq_fused, costs, noise, u_cur, lambda_weight,
                   vrange, wrange)


update_useq_fused.launches = 0


def update_useq_wide(costs, noise, u_cur, lambda_weight, vrange, wrange):
    """``update_useq_fused`` past ``FUSED_K`` rollouts: the wide path's
    four launches (``update_wide_min``, ``_eta``, ``_noise``, ``_finish``),
    the padded K positions split over ``wide_blocks(K)`` blocks a scenario
    by their low bits.  Arguments and result as for ``update_useq_fused``,
    K > ``FUSED_K``.

    On CUDA tensors this makes the four launches (again for every
    ``MAX_SCENARIOS`` scenarios) and adds one to
    ``update_useq_wide.launches`` each time; on CPU tensors it runs
    ``update_useq_plain``.
    """
    if not costs.is_cuda:
        return update_useq_plain(costs, noise, u_cur, lambda_weight, vrange,
                                 wrange)
    if costs.shape[-1] <= FUSED_K:
        raise ValueError("update_useq_wide: K = {} rollouts; the wide path "
                         "takes K > {} (update_useq_fused the rest)".format(
                             costs.shape[-1], FUSED_K))
    return _launch(update_useq_wide, costs, noise, u_cur, lambda_weight,
                   vrange, wrange)


update_useq_wide.launches = 0


def _launch(counted, costs, noise, u_cur, lambda_weight, vrange, wrange):
    """Check the inputs and launch the one-launch kernel, or past
    ``FUSED_K`` the wide path, once for every ``MAX_SCENARIOS``
    scenarios, adding one to ``counted.launches`` each time."""
    B, K, T = check_args(costs, noise, u_cur, lambda_weight, vrange, wrange)
    dev = costs.device
    lead = tuple(costs.shape[:-1])
    ins = [t.contiguous() for t in (costs, noise, u_cur, lambda_weight,
                                    vrange, wrange)]
    if ins[1].data_ptr() % 8:   # the kernel copies the noise 8 bytes a time
        ins[1] = ins[1].clone()
    u_new = torch.empty(lead + (T, 2), dtype=torch.float32, device=dev)
    weights = torch.empty(lead + (K,), dtype=torch.float32, device=dev)
    sms = _prepared(dev.index)
    if not lead:
        ins = [t.reshape((1,) + tuple(t.shape)) for t in ins]
    outs = (u_new.view(B, T, 2), weights.view(B, K))
    wide = K > FUSED_K
    if wide:
        G, chunks = wide_blocks(K), -(-T // STEPS_PER_BLOCK)
        scratch = (torch.empty((B, G), dtype=torch.int32, device=dev),
                   torch.empty((B, G), dtype=torch.float32, device=dev),
                   torch.empty((B, chunks, 2 * STEPS_PER_BLOCK, G),
                               dtype=torch.float32, device=dev))
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, MAX_SCENARIOS):
            part = slice(b0, min(B, b0 + MAX_SCENARIOS))
            n = part.stop - b0
            ptrs = [t[part].data_ptr() for t in (*ins, *outs)]
            if wide:
                err = _wide_entry_point()(
                    *ptrs, *(t[part].data_ptr() for t in scratch), n, K, T,
                    stream)
            else:
                width, cluster = launch_shape(n, K, T, sms)
                err = _entry_point()[0](*ptrs, n, K, T, width, cluster,
                                        stream)
            if err != 0:
                raise RuntimeError("{} kernel launch failed: CUDA error "
                                   "{}".format(counted.__name__, err))
            counted.launches += 1
    return u_new, weights
