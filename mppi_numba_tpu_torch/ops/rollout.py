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
module in the tests.  The module also holds the visualisation rollouts and
the barebone (terrain-free, circle-obstacle) engine's rollout, plain
PyTorch ops on the device as the JAX package has them in XLA.
"""

from __future__ import annotations

import torch

from ..models import unicycle_step
from .costs import (barebone_stage_cost, barebone_term_cost, stage_cost,
                    term_cost)


def _clipped_controls_tk(u_cur, noise, vrange, wrange):
    """Pre-clip noisy controls for all steps: returns (T, K) v and w
    (``(B, T, K)`` with a leading scenario axis on every argument)."""
    def clip(i, rng):
        return torch.clamp(u_cur[..., i, None]
                           + noise[..., i].transpose(-1, -2),
                           rng[..., 0, None, None], rng[..., 1, None, None])

    return clip(0, vrange), clip(1, wrange)


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

    Summed over all T steps regardless of early goal reach.  Returns ``(K,)``
    (``(B, K)`` with a leading scenario axis on every argument).
    """
    scaled = u_cur / (u_std * u_std)[..., None, :]                # (T, 2)
    return lambda_weight[..., None] * torch.sum(noise * scaled[..., None, :, :],
                                                dim=(-2, -1))


def _start_states(x0, V):
    """The start state ``x0`` (3,) broadcast to ``V`` rollouts."""
    return x0[0].expand(V), x0[1].expand(V), x0[2].expand(V)


def terrain_vis_states(packed_words, task, controls, *,
                       step_fn=unicycle_step):
    """State rollouts for visualisation: no noise, no goal break (the
    reference's vis kernels roll the whole horizon).

    Args:
      packed_words: int32 ``(V, H, W)``, one packed map per rollout.
      task: ``TerrainTask``.
      controls: float32 ``(V, T, 2)`` per-rollout controls, noise added
        and clipped by the caller.
      step_fn: dynamics step ``(x, y, th, v, w, lin_tr, ang_tr, dt)``.

    Returns:
      float32 ``(V, T+1, 3)`` states, row 0 the start state.
    """
    V, H, W = packed_words.shape
    f32 = torch.float32
    flat = packed_words.reshape(-1)
    v_off = torch.arange(V, device=flat.device, dtype=torch.int64) * (H * W)
    inv_res = 1.0 / task.res
    x, y, th = _start_states(task.x0, V)
    states = [torch.stack([x, y, th], dim=-1)]
    for t in range(controls.shape[1]):
        words = flat[cell_index(x, y, task.xlim0, task.ylim0, inv_res, H, W)
                     + v_off]
        lin_tr = task.lin_lb + task.lin_ratio * (words & 0xFF).to(f32)
        ang_tr = task.ang_lb + task.ang_ratio * ((words >> 8) & 0xFF).to(f32)
        x, y, th = step_fn(x, y, th, controls[:, t, 0], controls[:, t, 1],
                           lin_tr, ang_tr, task.dt)
        states.append(torch.stack([x, y, th], dim=-1))
    return torch.stack(states, dim=1)


def barebone_rollout_costs(task, u_cur, noise):
    """Terrain-free rollouts with analytic circle obstacles.

    Nominal unicycle dynamics; ``stage = dist_weight * dist2`` (squared: no
    dt term, no sqrt); each obstacle the POST-update state lies in (``d2 <=
    r^2``) adds ``obs_penalty``; terminal ``(1 - reached) * dist2``.
    Semantics of ``mppi_numba_tpu.ops.rollout.barebone_rollout_costs``.

    Args:
      task: ``BareboneTask``.
      u_cur: float32 ``(T, 2)`` nominal controls.
      noise: float32 ``(K, T, 2)`` control perturbations.

    Returns:
      float32 ``(K,)`` costs excluding the coupling term.
    """
    K = noise.shape[0]
    dev = noise.device
    gx, gy = task.xgoal[0], task.xgoal[1]
    tol2 = task.goal_tolerance * task.goal_tolerance
    dt = task.dt
    ox = task.obs_pos[:, 0][None]                                 # (1, N)
    oy = task.obs_pos[:, 1][None]
    r2 = (task.obs_r * task.obs_r)[None]

    v_all, w_all = _clipped_controls_tk(u_cur, noise, task.vrange, task.wrange)
    x, y, th = _start_states(task.x0, K)
    cost = torch.zeros(K, dtype=torch.float32, device=dev)
    reached = torch.zeros(K, dtype=torch.bool, device=dev)
    dist2 = torch.full((K,), 1e9, dtype=torch.float32, device=dev)
    for v_t, w_t in zip(v_all, w_all):
        x_new = x + dt * v_t * torch.cos(th)
        y_new = y + dt * v_t * torch.sin(th)
        th = th + dt * w_t
        dx, dy = gx - x_new, gy - y_new
        dist2_new = dx * dx + dy * dy
        ex, ey = x_new[:, None] - ox, y_new[:, None] - oy
        n_hit = ((ex * ex + ey * ey) <= r2).to(torch.float32).sum(dim=1)
        step_cost = (barebone_stage_cost(dist2_new, task.dist_weight)
                     + n_hit * task.obs_penalty)

        active = ~reached
        cost = cost + torch.where(active, step_cost, 0.0)
        dist2 = torch.where(active, dist2_new, dist2)
        reached = reached | (active & (dist2_new <= tol2))
        x, y = x_new, y_new
    return cost + barebone_term_cost(dist2, reached.to(torch.float32))


def barebone_vis_states(task, controls):
    """Nominal-dynamics visualisation rollouts of the barebone engine:
    float32 ``(V, T+1, 3)`` from ``(V, T, 2)`` controls."""
    V = controls.shape[0]
    dt = task.dt
    x, y, th = _start_states(task.x0, V)
    states = [torch.stack([x, y, th], dim=-1)]
    for t in range(controls.shape[1]):
        v, w = controls[:, t, 0], controls[:, t, 1]
        x = x + dt * v * torch.cos(th)
        y = y + dt * v * torch.sin(th)
        th = th + dt * w
        states.append(torch.stack([x, y, th], dim=-1))
    return torch.stack(states, dim=1)
