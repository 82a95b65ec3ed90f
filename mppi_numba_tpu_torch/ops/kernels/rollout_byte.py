"""Byte-packed fused rollout: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

``terrain_rollout_costs_byte`` launches ``csrc/rollout_byte.cu`` for CUDA
tensors and runs ``terrain_rollout_costs_byte_plain`` for CPU tensors.  It
replaces ``mppi_numba_tpu/ops/pallas/rollout_kernel.py::_rollout_kernel``
(wrapper ``terrain_rollout_costs_pallas``).  The kernel is bound by float32
operations (one sqrtf per lane-step, plus sinf/cosf in exact mode), not by
bytes; see the source's header note.
"""

from __future__ import annotations

import ctypes

import torch

from ...models import unicycle_step

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/rollout_byte.cu"
REPLACES = "mppi_numba_tpu/ops/pallas/rollout_kernel.py:99"

# Scalars the kernel reads, in this order (indices 0-17; 18 is kept for
# layout parity with the JAX package's task tile).
TASK_VEC_LEN = 19


def build_task_vec(task):
    """Pack the TerrainTask scalars the kernel needs into a float32 (19,)
    tensor: row 0 of the JAX package's (8, 128) task tile."""
    vmax = torch.maximum(torch.abs(task.vrange[0]), torch.abs(task.vrange[1]))
    tr_ub = torch.maximum(task.lin_lb, task.lin_lb + task.lin_ratio * 127.0)
    max_cells_per_step = vmax * tr_ub * task.dt / task.res
    return torch.stack([
        task.x0[0], task.x0[1], task.x0[2],
        task.xgoal[0], task.xgoal[1],
        task.goal_tolerance, task.v_post_rollout, task.dt,
        task.dist_weight, task.obs_penalty, task.unknown_penalty,
        1.0 / task.res, task.xlim0, task.ylim0,
        task.lin_lb, task.lin_ratio, task.ang_lb, task.ang_ratio,
        max_cells_per_step,
    ]).to(torch.float32)


def terrain_rollout_costs_byte_plain(words, task_vec, v_all, w_all, *, H, W,
                                     T, speed_map=False, fast_trig=False,
                                     step_fn=None):
    """Plain PyTorch version of the kernel: the same interface and the same
    float32 arithmetic, step by step, over ``(K, M)`` planes.

    Args:
      words: int32 ``(M, H, W)`` packed map words.
      task_vec: float32 ``(19,)`` from ``build_task_vec``.
      v_all / w_all: float32 ``(T, K)`` pre-clipped noisy controls.
      step_fn: dynamics for exact mode (default the unicycle); fast_trig
        hard-codes the unicycle rotation.

    Returns:
      float32 ``(K, M)`` rollout costs incl. terminal, excl. coupling.
    """
    step_fn = unicycle_step if step_fn is None else step_fn
    assert not (fast_trig and step_fn is not unicycle_step), \
        "fast_trig hard-codes the unicycle rotation update"
    f32 = torch.float32
    M = words.shape[0]
    K = v_all.shape[1]
    dev = words.device
    tv = task_vec
    x0x, x0y, x0th = tv[0], tv[1], tv[2]
    gx, gy = tv[3], tv[4]
    tol = tv[5]
    v_post = tv[6]
    dt = tv[7]
    dist_w = tv[8]
    obs_pen, unk_pen = tv[9], tv[10]
    inv_res = tv[11]
    xlim0, ylim0 = tv[12], tv[13]
    lin_lb, lin_ratio = tv[14], tv[15]
    ang_lb, ang_ratio = tv[16], tv[17]
    tol2 = tol * tol

    flat = words.reshape(-1)
    m_off = (torch.arange(M, device=dev, dtype=torch.int64) * (H * W))[None, :]
    km = (K, M)
    x = x0x.expand(km)
    y = x0y.expand(km)
    if fast_trig:
        hd = (torch.cos(x0th).expand(km), torch.sin(x0th).expand(km))
    else:
        hd = x0th.expand(km)
    cost = torch.zeros(km, dtype=f32, device=dev)
    dist2 = torch.full(km, 1e9, dtype=f32, device=dev)
    reachedf = torch.zeros(km, dtype=f32, device=dev)
    for t in range(T):
        v_t = v_all[t][:, None]
        w_t = w_all[t][:, None]
        xi = torch.floor((x - xlim0) * inv_res).clamp(0, W - 1).to(torch.int64)
        yi = torch.floor((y - ylim0) * inv_res).clamp(0, H - 1).to(torch.int64)
        wd = flat[yi * W + xi + m_off]

        lin_tr = lin_lb + lin_ratio * (wd & 0xFF).to(f32)
        ang_tr = ang_lb + ang_ratio * ((wd >> 8) & 0xFF).to(f32)
        obs = ((wd >> 16) & 1).to(f32)
        unk = ((wd >> 17) & 1).to(f32)

        if fast_trig:
            dth = dt * ang_tr * w_t
            cth, sth = hd
            z2 = dth * dth
            cd = 1.0 - z2 * (0.5 - z2 * (1.0 / 24.0))
            sd = dth * (1.0 - z2 * ((1.0 / 6.0) - z2 * (1.0 / 120.0)))
            hd_new = (cth * cd - sth * sd, sth * cd + cth * sd)
            x_new = x + dt * lin_tr * v_t * cth
            y_new = y + dt * lin_tr * v_t * sth
        else:
            x_new, y_new, hd_new = step_fn(x, y, hd, v_t, w_t, lin_tr,
                                           ang_tr, dt)

        dx, dy = gx - x_new, gy - y_new
        dist2_new = dx * dx + dy * dy
        if speed_map:
            eff = lin_lb + lin_ratio * ((wd >> 18) & 0xFF).to(f32)
            dt_eff = dt / (eff + 1e-6)
        else:
            dt_eff = dt
        step_cost = (dt_eff + dist_w * torch.sqrt(dist2_new)
                     + obs * obs_pen + unk * unk_pen)

        active = 1.0 - reachedf
        cost = cost + active * step_cost
        dist2 = dist2 + active * (dist2_new - dist2)
        reachedf = torch.maximum(reachedf,
                                 active * (dist2_new <= tol2).to(f32))
        x, y, hd = x_new, y_new, hd_new
    return cost + (1.0 - reachedf) * torch.sqrt(dist2) / (v_post + 1e-6)


def _launch(words, task_vec, v_all, w_all, H, W, T, speed_map, fast_trig):
    from ._build import load

    lib = load("rollout_byte")
    fn = lib.rollout_byte_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    M = words.shape[0]
    K = v_all.shape[1]
    out = torch.empty((K, M), dtype=torch.float32, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = fn(words.data_ptr(), task_vec.data_ptr(), v_all.data_ptr(),
             w_all.data_ptr(), out.data_ptr(), K, M, H, W, T,
             int(speed_map), int(fast_trig), stream)
    if err != 0:
        raise RuntimeError("rollout_byte kernel launch failed: CUDA error "
                           "{}".format(err))
    terrain_rollout_costs_byte.launches += 1
    return out


def _check_cuda_args(words, task_vec, v_all, w_all, H, W, T):
    dev = words.device
    M = words.shape[0] if words.dim() == 3 else -1
    K = v_all.shape[1] if v_all.dim() == 2 else -1
    checks = [
        (words.dtype == torch.int32 and tuple(words.shape) == (M, H, W)
         and words.is_contiguous(), "words must be contiguous int32 (M, H, W)"),
        (task_vec.dtype == torch.float32 and task_vec.dim() == 1
         and task_vec.numel() >= 18 and task_vec.is_contiguous(),
         "task_vec must be contiguous float32 (19,)"),
        (all(a.dtype == torch.float32 and tuple(a.shape) == (T, K)
             and a.is_contiguous() for a in (v_all, w_all)),
         "v_all / w_all must be contiguous float32 (T, K)"),
        (all(a.device == dev for a in (task_vec, v_all, w_all)),
         "all inputs must be on one device"),
        (M >= 1 and K >= 1 and H >= 1 and W >= 1 and M < 65536,
         "need K >= 1, 1 <= M < 65536 and a non-empty map"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("terrain_rollout_costs_byte: " + msg)


def terrain_rollout_costs_byte(words, task_vec, v_all, w_all, *, H, W, T,
                               speed_map=False, fast_trig=False, step_fn=None):
    """Rollout costs ``(K, M)`` over byte-packed map words.

    On CUDA tensors this launches the hand-written kernel (unicycle only;
    any other model raises ``NotImplementedError``) and adds one to
    ``terrain_rollout_costs_byte.launches``.  On CPU tensors it runs
    ``terrain_rollout_costs_byte_plain``.  Arguments as for the plain
    version.
    """
    if not words.is_cuda:
        return terrain_rollout_costs_byte_plain(
            words, task_vec, v_all, w_all, H=H, W=W, T=T,
            speed_map=speed_map, fast_trig=fast_trig, step_fn=step_fn)
    if step_fn is not None and step_fn is not unicycle_step:
        raise NotImplementedError(
            "the CUDA rollout kernel serves the unicycle model only; other "
            "models in the kernel are a later slice of the port")
    _check_cuda_args(words, task_vec, v_all, w_all, H, W, T)
    return _launch(words, task_vec, v_all, w_all, H, W, T, speed_map,
                   fast_trig)


terrain_rollout_costs_byte.launches = 0
