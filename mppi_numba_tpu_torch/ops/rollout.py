"""Eager rollout core: the port's semantics oracle.

K control sequences x M sampled traction maps, stepped T times as
``(K, M)`` state planes with one packed-word gather per (k, m) and step.
Semantics match ``mppi_numba_tpu.ops.rollout`` exactly:

* cell indices come from the PRE-update state and serve both the traction
  decode and the obstacle/unknown penalty;
* the step that reaches the goal still accrues its stage cost and map
  penalties, later steps accrue nothing, and the terminal cost reads the
  distance frozen at that step;
* the control-coupling term sums over all T steps and is added per k by
  the solver.

The CUDA kernel (``ops/kernels/rollout_byte.py``) is held against this
module in the tests.
"""

from __future__ import annotations

import torch

from ..models import unicycle_step
from .costs import stage_cost, term_cost


def _clipped_controls_tk(u_cur, noise, vrange, wrange):
    """Pre-clip noisy controls for all steps: returns (T, K) v and w."""
    v = torch.clamp(u_cur[:, 0][:, None] + noise[:, :, 0].T, vrange[0], vrange[1])
    w = torch.clamp(u_cur[:, 1][:, None] + noise[:, :, 1].T, wrange[0], wrange[1])
    return v, w


def cell_index(x, y, xlim0, ylim0, inv_res, H, W):
    """Flat map cell of each position, clamped to the map.

    ``floor((x - xlim0) * inv_res)`` is clamped in float before the integer
    cast, which equals XLA's saturating cast followed by a clip.
    """
    xi = torch.floor((x - xlim0) * inv_res).clamp(0, W - 1).to(torch.int64)
    yi = torch.floor((y - ylim0) * inv_res).clamp(0, H - 1).to(torch.int64)
    return yi * W + xi


def terrain_rollout_costs(packed_words, task, u_cur, noise, *, speed_map=False,
                          step_fn=unicycle_step):
    """Roll out K noisy control sequences over M sampled traction maps.

    Args:
      packed_words: int32 ``(M, H, W)`` packed map words.
      task: ``TerrainTask``.
      u_cur: float32 ``(T, 2)`` nominal control sequence.
      noise: float32 ``(K, T, 2)`` control perturbations.
      speed_map: scale the time cost by the CVaR speed map.
      step_fn: dynamics step ``(x, y, th, v, w, lin_tr, ang_tr, dt)``.

    Returns:
      float32 ``(K, M)`` rollout costs including the terminal cost but
      excluding the control-coupling term.
    """
    M, H, W = packed_words.shape
    K = noise.shape[0]
    f32 = torch.float32
    dev = packed_words.device
    packed_flat = packed_words.reshape(-1)

    inv_res = 1.0 / task.res
    xlim0, ylim0 = task.xlim0, task.ylim0
    gx, gy = task.xgoal[0], task.xgoal[1]
    tol2 = task.goal_tolerance * task.goal_tolerance
    dt = task.dt
    lin_lb, lin_ratio = task.lin_lb, task.lin_ratio
    ang_lb, ang_ratio = task.ang_lb, task.ang_ratio
    m_off = (torch.arange(M, device=dev, dtype=torch.int64) * (H * W))[None, :]

    v_all, w_all = _clipped_controls_tk(u_cur, noise, task.vrange, task.wrange)

    km = (K, M)
    x = task.x0[0].to(f32).expand(km)
    y = task.x0[1].to(f32).expand(km)
    th = task.x0[2].to(f32).expand(km)
    cost = torch.zeros(km, dtype=f32, device=dev)
    reached = torch.zeros(km, dtype=torch.bool, device=dev)
    dist2 = torch.full(km, 1e9, dtype=f32, device=dev)
    for t in range(v_all.shape[0]):
        v_t, w_t = v_all[t][:, None], w_all[t][:, None]
        words = packed_flat[cell_index(x, y, xlim0, ylim0, inv_res, H, W)
                            + m_off]

        lin_tr = lin_lb + lin_ratio * (words & 0xFF).to(f32)
        ang_tr = ang_lb + ang_ratio * ((words >> 8) & 0xFF).to(f32)
        obs = ((words >> 16) & 1).to(f32)
        unk = ((words >> 17) & 1).to(f32)

        x, y, th = step_fn(x, y, th, v_t, w_t, lin_tr, ang_tr, dt)

        dx, dy = gx - x, gy - y
        dist2_new = dx * dx + dy * dy
        if speed_map:
            eff = lin_lb + lin_ratio * ((words >> 18) & 0xFF).to(f32)
            dt_eff = dt / (eff + 1e-6)
        else:
            dt_eff = dt
        step_cost = (stage_cost(dist2_new, dt_eff, task.dist_weight)
                     + obs * task.obs_penalty + unk * task.unknown_penalty)

        # x/y/th need no post-reach freeze: all their consumers are masked by
        # ``active`` and the terminal cost reads the frozen dist2 only.
        active = ~reached
        cost = cost + torch.where(active, step_cost, 0.0)
        dist2 = torch.where(active, dist2_new, dist2)
        reached = reached | (active & (dist2_new <= tol2))
    return cost + term_cost(dist2, task.v_post_rollout, reached.to(f32))


def control_coupling(u_cur, noise, u_std, lambda_weight):
    """MPPI information-theoretic coupling: lambda * sum_t (u/sigma^2) . eps.

    Summed over all T steps regardless of early goal reach.  Returns ``(K,)``.
    """
    scaled = u_cur / (u_std * u_std)                              # (T, 2)
    return lambda_weight * torch.sum(noise * scaled[None], dim=(1, 2))
