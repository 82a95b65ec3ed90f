"""Byte-packed fused rollout: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

``terrain_rollout_costs_byte`` launches ``csrc/rollout_byte.cu`` for CUDA
tensors and runs ``terrain_rollout_costs_byte_plain`` for CPU tensors.  It
replaces ``mppi_numba_tpu/ops/pallas/rollout_kernel.py::_rollout_kernel``
(wrapper ``terrain_rollout_costs_pallas``).  The kernel is bound by
instruction issue, not by bytes; its tiling is a compile-time property of
each instantiation, which ``kernel_tiling`` reads back from the library.
See ``csrc/rollout_step.cuh``.

Every argument may carry a leading scenario axis B (words ``(B, M, H,
W)``, the task vector ``(B, 19)``, the controls ``(B, T, K)``; costs
``(B, K, M)``): the JAX kernel under ``jax.vmap``, one launch for all B
scenarios.  Without it the call is the single scenario, B = 1 of the same
launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models import kernel_model, unicycle_step
from ...types import per_scenario

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/rollout_byte.cu"
REPLACES = "mppi_numba_tpu/ops/pallas/rollout_kernel.py:99"

# Scalars the kernel reads, in this order (indices 0-17; 18 is kept for
# layout parity with the JAX package's task tile).
TASK_VEC_LEN = 19
# What one launch's grid holds: scenarios (its z) and map samples (its y,
# blocks of one or more samples).  Past them the wrappers launch in
# chunks (``chunked_launches``).
MAX_SCENARIOS = 65535
MAX_SAMPLES = 65535


def build_task_vec(task):
    """Pack the TerrainTask scalars the kernel needs into a float32 (19,)
    tensor: row 0 of the JAX package's (8, 128) task tile.  A task whose
    fields carry a leading scenario axis (x0 ``(B, 3)``, scalars ``(B,)``)
    gives ``(B, 19)``, row b scenario b's vector."""
    vmax = torch.maximum(torch.abs(task.vrange[..., 0]),
                         torch.abs(task.vrange[..., 1]))
    tr_ub = torch.maximum(task.lin_lb, task.lin_lb + task.lin_ratio * 127.0)
    max_cells_per_step = vmax * tr_ub * task.dt / task.res
    return torch.stack([
        task.x0[..., 0], task.x0[..., 1], task.x0[..., 2],
        task.xgoal[..., 0], task.xgoal[..., 1],
        task.goal_tolerance, task.v_post_rollout, task.dt,
        task.dist_weight, task.obs_penalty, task.unknown_penalty,
        1.0 / task.res, task.xlim0, task.ylim0,
        task.lin_lb, task.lin_ratio, task.ang_lb, task.ang_ratio,
        max_cells_per_step,
    ], dim=-1).to(torch.float32)



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
      With a leading scenario axis on all four (``(B, M, H, W)``, ``(B,
      19)``, ``(B, T, K)``) each scenario is rolled out in turn.

    Returns:
      float32 ``(K, M)`` rollout costs incl. terminal, excl. coupling
      (``(B, K, M)`` with the scenario axis).
    """
    if words.dim() == 4:
        return per_scenario(terrain_rollout_costs_byte_plain,
                            (words, task_vec, v_all, w_all),
                            dict(H=H, W=W, T=T, speed_map=speed_map,
                                 fast_trig=fast_trig, step_fn=step_fn))
    f32 = torch.float32
    M = words.shape[0]
    flat = words.reshape(-1)
    m_off = (torch.arange(M, device=words.device, dtype=torch.int64)
             * (H * W))[None, :]
    tv = task_vec
    lin_lb, lin_ratio = tv[14], tv[15]
    ang_lb, ang_ratio = tv[16], tv[17]

    def decode(cell):
        wd = flat[cell + m_off]
        lin_tr = lin_lb + lin_ratio * (wd & 0xFF).to(f32)
        ang_tr = ang_lb + ang_ratio * ((wd >> 8) & 0xFF).to(f32)
        obs = ((wd >> 16) & 1).to(f32)
        unk = ((wd >> 17) & 1).to(f32)
        risk = ((wd >> 18) & 0xFF).to(f32) if speed_map else None
        return lin_tr, ang_tr, obs, unk, risk

    return plain_rollout(decode, task_vec, v_all, w_all, M=M, H=H, W=W,
                         T=T, fast_trig=fast_trig, step_fn=step_fn)


def plain_rollout(decode, task_vec, v_all, w_all, *, M, H, W, T,
                  fast_trig=False, step_fn=None):
    """The rollout kernels' shared step loop in plain PyTorch, over
    ``(K, M)`` planes.

    ``decode(cell)`` maps the int64 ``(K, M)`` flat cell indices of the
    pre-update state to ``(lin_tr, ang_tr, obs, unk, risk)`` float32
    planes, ``risk`` being the raw risk byte in speed-map mode and None
    otherwise.  Returns float32 ``(K, M)`` costs incl. terminal, excl.
    coupling.
    """
    step_fn = unicycle_step if step_fn is None else step_fn
    check_fast_trig(fast_trig, step_fn)
    f32 = torch.float32
    K = v_all.shape[1]
    dev = v_all.device
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
    tol2 = tol * tol

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
        lin_tr, ang_tr, obs, unk, risk = decode(yi * W + xi)

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
        if risk is not None:
            eff = lin_lb + lin_ratio * risk
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


def check_fast_trig(fast_trig, step_fn):
    """Fast trig hard-codes the unicycle's rotation update."""
    if fast_trig and step_fn not in (None, unicycle_step):
        raise ValueError("fast_trig hard-codes the unicycle rotation "
                         "update; other models take the exact path")


def bind(launch, launch_args, info, n_info_args):
    """Set the ctypes signatures of a kernel library's launch and info
    entry points (the info point takes ``n_info_args`` ints, then an int
    array of ``len(TILING_KEYS)`` to fill)."""
    launch.argtypes = launch_args
    launch.restype = ctypes.c_int
    info.argtypes = ([ctypes.c_int] * n_info_args
                     + [ctypes.POINTER(ctypes.c_int)])
    info.restype = ctypes.c_int
    return launch, info


TILING_KEYS = ("block", "samples_per_thread", "static_shared_bytes",
               "registers", "local_bytes")


def read_tiling(info, *args):
    """An instantiation's tiling and resources, as the library reports
    them: a dict over ``TILING_KEYS``."""
    out = (ctypes.c_int * len(TILING_KEYS))()
    err = info(*args, out)
    if err != 0:
        raise RuntimeError("kernel info failed: CUDA error {}".format(err))
    return dict(zip(TILING_KEYS, out))


@functools.lru_cache(maxsize=None)
def _entry_points():
    """The library's ``(launch, info)`` entry points, built and loaded on
    first use, their ctypes signatures set once."""
    from ._build import load

    lib = load("rollout_byte")
    return bind(lib.rollout_byte_launch,
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                + [ctypes.c_float, ctypes.c_void_p],
                lib.rollout_byte_info, 3)


def kernel_tiling(*, speed_map=False, fast_trig=False, step_fn=None,
                  device=None):
    """The tiling (block width, map samples per thread) and resources of
    the instantiation that a launch with these options runs, read from the
    built library on ``device`` (default: the current card; needs nvcc and
    a card)."""
    model, _ = kernel_model(step_fn)
    check_fast_trig(fast_trig, step_fn)
    with torch.cuda.device(device):
        return read_tiling(_entry_points()[1], int(speed_map),
                           int(fast_trig), model)


def chunked_launches(launch, per_scenario, per_sample, out):
    """Launch a rollout kernel over scenario-leading tensors in as many
    launches as its grid needs: ``launch(scenario_parts, sample_parts,
    out_part, scenarios, samples)`` launches once.  ``per_scenario``:
    tensors ``(B, ...)``; ``per_sample``: ``(B, M, ...)``; ``out``: ``(B,
    K, M)``.  Up to ``MAX_SAMPLES`` samples, chunks of ``MAX_SCENARIOS``
    scenarios (slices of every tensor); past it, a scenario and a run of
    ``MAX_SAMPLES`` samples a launch, written to a buffer and copied into
    ``out``'s columns.  Every (rollout, sample) cost is computed alone, so
    the chunks give the same bits as one launch."""
    B, K, M = out.shape
    if M <= MAX_SAMPLES:
        for b0 in range(0, B, MAX_SCENARIOS):
            p = slice(b0, min(B, b0 + MAX_SCENARIOS))
            launch([t[p] for t in per_scenario], [t[p] for t in per_sample],
                   out[p], p.stop - b0, M)
        return
    for b in range(B):
        p = slice(b, b + 1)
        for m0 in range(0, M, MAX_SAMPLES):
            q = slice(m0, min(M, m0 + MAX_SAMPLES))
            part = out.new_empty((1, K, q.stop - m0))
            launch([t[p] for t in per_scenario],
                   [t[p, q] for t in per_sample], part, 1, q.stop - m0)
            out[p, :, q].copy_(part)


def _launch(words, task_vec, v_all, w_all, H, W, T, speed_map, fast_trig,
            model, wheelbase):
    fn = _entry_points()[0]
    M = words.shape[-3]
    K = v_all.shape[-1]
    lead = tuple(words.shape[:-3])          # (B,) or () for one scenario
    out = torch.empty(lead + (K, M), dtype=torch.float32, device=words.device)

    def launch(scen, samples, out_part, n, m):
        tv, v, w = scen
        err = fn(samples[0].data_ptr(), tv.data_ptr(), v.data_ptr(),
                 w.data_ptr(), out_part.data_ptr(), K, m, H, W, T, n,
                 task_vec.shape[-1], int(speed_map), int(fast_trig), model,
                 wheelbase, stream)
        if err != 0:
            raise RuntimeError("rollout_byte kernel launch failed: CUDA "
                               "error {}".format(err))
        terrain_rollout_costs_byte.launches += 1

    one = (lambda t: t) if lead else (lambda t: t[None])
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        chunked_launches(launch, [one(task_vec), one(v_all), one(w_all)],
                         [one(words)], one(out))
    return out


def scenarios(lead):
    """The scenario count of a leading axis ``lead`` (``()``: one)."""
    return lead[0] if lead else 1


def check_scenario_args(lead, task_vec, v_all, w_all, T, K):
    """Checks shared by both rollout kernels: the task vector ``lead +
    (>= 18,)`` and the controls ``lead + (T, K)``, with ``lead`` the
    map's leading scenario axis (``()`` or ``(B,)``, B >= 1)."""
    return [
        (len(lead) <= 1 and 1 <= scenarios(lead),
         "need one scenario axis of B >= 1"),
        (task_vec.dtype == torch.float32
         and tuple(task_vec.shape[:-1]) == lead
         and task_vec.shape[-1] >= 18 and task_vec.is_contiguous(),
         "task_vec must be contiguous float32 (19,), or (B, 19) with "
         "the maps' scenarios"),
        (all(a.dtype == torch.float32 and tuple(a.shape) == lead + (T, K)
             and a.is_contiguous() for a in (v_all, w_all)),
         "v_all / w_all must be contiguous float32 (T, K), or (B, T, K) "
         "with the maps' scenarios"),
    ]


def _check_cuda_args(words, task_vec, v_all, w_all, H, W, T):
    dev = words.device
    lead = tuple(words.shape[:-3])
    M = words.shape[-3] if words.dim() in (3, 4) else -1
    K = v_all.shape[-1] if v_all.dim() >= 2 else -1
    checks = [
        (words.dtype == torch.int32 and tuple(words.shape) == lead + (M, H, W)
         and words.is_contiguous(),
         "words must be contiguous int32 (M, H, W) or (B, M, H, W)"),
        *check_scenario_args(lead, task_vec, v_all, w_all, T, K),
        (all(a.device == dev for a in (task_vec, v_all, w_all)),
         "all inputs must be on one device"),
        (M >= 1 and K >= 1 and H >= 1 and W >= 1,
         "need K >= 1, M >= 1 and a non-empty map"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("terrain_rollout_costs_byte: " + msg)


def terrain_rollout_costs_byte(words, task_vec, v_all, w_all, *, H, W, T,
                               speed_map=False, fast_trig=False, step_fn=None):
    """Rollout costs ``(K, M)`` over byte-packed map words (``(B, K, M)``
    for B scenarios in one launch: every argument with a leading B).

    On CUDA tensors this launches the hand-written kernel and adds one to
    ``terrain_rollout_costs_byte.launches``; the kernel runs the built-in
    models (``models.kernel_model``), and a custom registered step function
    raises ``NotImplementedError``.  On CPU tensors it runs
    ``terrain_rollout_costs_byte_plain``.  Arguments as for the plain
    version.
    """
    if not words.is_cuda:
        return terrain_rollout_costs_byte_plain(
            words, task_vec, v_all, w_all, H=H, W=W, T=T,
            speed_map=speed_map, fast_trig=fast_trig, step_fn=step_fn)
    model, wheelbase = kernel_model(step_fn)
    check_fast_trig(fast_trig, step_fn)
    _check_cuda_args(words, task_vec, v_all, w_all, H, W, T)
    return _launch(words, task_vec, v_all, w_all, H, W, T, speed_map,
                   fast_trig, model, wheelbase)


terrain_rollout_costs_byte.launches = 0
