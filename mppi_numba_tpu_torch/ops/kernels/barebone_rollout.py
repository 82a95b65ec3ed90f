"""The barebone engine's rollout costs: the hand-written CUDA kernel and its
wrapper; the plain PyTorch version is ``ops/rollout.py::
barebone_rollout_costs``.

``barebone_rollout_fused`` launches ``csrc/barebone_rollout.cu`` for CUDA
tensors and runs the plain version for CPU tensors.  The kernel replaces
the JAX package's XLA-compiled ``lax.scan`` ``barebone_rollout_costs``
(``mppi_numba_tpu/ops/rollout.py:181-229``; no Pallas kernel), which the
plain version runs as a T-step loop of some 34 torch launches a step: one
thread a rollout, the T steps in registers, the pre-clip of the noisy
controls done on load, in the plain loop's order of operations, so the
kernel equals the plain version bit for bit.  A block stages its rows'
noise through shared memory in tiles of ``TILE_STEPS`` steps (cp.async,
double-buffered); ``launch_shape`` picks its rollouts a block from K.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..rollout import barebone_rollout_costs
from .cvar_costs import H100_SMS, check_tensor

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/barebone_rollout.cu"
REPLACES = ("mppi_numba_tpu/ops/rollout.py:181-229 (barebone_rollout_costs),"
            " an XLA-compiled lax.scan; no Pallas kernel")
# Rollouts a launch: the kernel indexes them with 32-bit ints.
MAX_ROLLOUTS = 2 ** 31 - 1
# The source's kMaxThreads and kTileSteps: rollouts a block at most, steps
# a staged tile.
MAX_THREADS = 128
TILE_STEPS = 8
# The obstacle counts with an instantiation of their own, the obstacles in
# registers (the engine's); any other count runs the generic one.
REGISTER_OBSTACLE_COUNTS = (1, 2)


def shared_bytes(threads):
    """The kernel's shared memory at ``threads`` rollouts a block: two
    noise tiles of ``threads`` rows at an odd stride of float2s and two
    tiles of u."""
    return 8 * (2 * threads * (TILE_STEPS | 1) + 2 * TILE_STEPS)


def launch_shape(K, T, N, sms=H100_SMS):
    """The kernel's launch from the shapes: ``(threads a block, blocks,
    tiles, shared bytes)``.  128 rollouts a block, halved (down to a warp)
    while the blocks number fewer than two an SM of ``sms``: at K = 1,000
    the rollouts run one warp each on 32 SMs.  ``tiles``: the staged tiles
    of ``TILE_STEPS`` steps, the last one partial where T is no multiple."""
    threads = MAX_THREADS
    while threads > 32 and -(-K // threads) < 2 * sms:
        threads //= 2
    return (threads, -(-K // threads), -(-T // TILE_STEPS),
            shared_bytes(threads))


@functools.lru_cache(maxsize=None)
def _sms(index):
    """Card ``index``'s SM count."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry_point():
    """The library's launch entry point, built and loaded on first use."""
    from ._build import load

    fn = load("barebone_rollout").barebone_rollout_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# The task's fields the kernel reads, in the launch's order, with their
# shapes (N: the obstacles).
TASK_FIELDS = (("x0", (3,)), ("xgoal", (2,)), ("goal_tolerance", ()),
               ("dt", ()), ("dist_weight", ()), ("obs_penalty", ()),
               ("vrange", (2,)), ("wrange", (2,)), ("obs_pos", ("N", 2)),
               ("obs_r", ("N",)))


def check_args(task, u_cur, noise):
    """The kernel's inputs, as ``barebone_rollout_fused`` documents them;
    raises ValueError on anything else.  Returns ``(K, T, N)``."""
    dev = noise.device
    if (noise.dtype != torch.float32 or noise.dim() != 3
            or noise.shape[-1] != 2):
        raise ValueError("barebone_rollout: noise must be float32 (K, T, "
                         "2), got {} {}".format(noise.dtype,
                                                tuple(noise.shape)))
    K, T, _ = noise.shape
    N = task.obs_r.shape[0] if isinstance(task.obs_r, torch.Tensor) else -1
    if K < 1 or T < 1 or K > MAX_ROLLOUTS or N < 0:
        raise ValueError("barebone_rollout: {} rollouts x {} steps x {} "
                         "obstacles out of range".format(K, T, N))
    check_tensor("barebone_rollout: u_cur", u_cur, (T, 2), dev)
    for name, shape in TASK_FIELDS:
        check_tensor("barebone_rollout: task." + name, getattr(task, name),
                     tuple(N if d == "N" else d for d in shape), dev)
    return K, T, N


def barebone_rollout_fused(task, u_cur, noise):
    """Terrain-free rollout costs against circle obstacles: the semantics
    of ``ops/rollout.py::barebone_rollout_costs``.

    Args:
      task: ``BareboneTask`` (float32 tensors, scalars 0-d, ``obs_pos``
        ``(N, 2)``, ``obs_r`` ``(N,)``).
      u_cur: float32 ``(T, 2)`` nominal controls.
      noise: float32 ``(K, T, 2)`` control perturbations.

    Returns:
      float32 ``(K,)`` costs excluding the coupling term.

    On CUDA tensors this launches the kernel once and adds one to
    ``barebone_rollout_fused.launches``; a failed build or launch raises.
    On CPU tensors it runs the plain version.
    """
    if not noise.is_cuda:
        return barebone_rollout_costs(task, u_cur, noise)
    K, T, N = check_args(task, u_cur, noise)
    dev = noise.device
    ins = [t.contiguous() for t in (u_cur, noise)] + [
        getattr(task, name).contiguous() for name, _ in TASK_FIELDS]
    for i in (0, 1):   # the kernel copies u and the noise 8 bytes a time
        if ins[i].data_ptr() % 8:
            ins[i] = ins[i].clone()
    out = torch.empty(K, dtype=torch.float32, device=dev)
    launch = _entry_point()
    threads = launch_shape(K, T, N, _sms(dev.index))[0]
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(dev):
        err = launch(*(t.data_ptr() for t in ins), out.data_ptr(), K, T, N,
                     threads, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("barebone_rollout kernel launch failed: CUDA "
                           "error {}".format(err))
    barebone_rollout_fused.launches += 1
    return out


barebone_rollout_fused.launches = 0
