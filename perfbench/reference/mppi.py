"""The plain reference: what one MPPI terrain solve and one closed-loop
episode step compute, in plain PyTorch and NumPy, from the inputs the
benchmark makes (``perfbench/inputs.py``) and the draws of a
``torch.Generator`` seeded as the program's.

It imports nothing of the program.  It works out again everything the
program derives: the quantized PMF planes and their padding, each mode's
condensed maps and risk map, the reachable window, the map draw
(threefry2x32 of ``jax.random.uniform`` at global counters, the inverse
CDF and the decode), the rollout costs, the CVaR over the maps, the
control coupling, the softmax-weighted update, and the episode's
ground-truth Euler step and masked bookkeeping.

``dtype`` is the precision of every float step (float32, as the
configuration states; bfloat16 for the control).  The sums run in
PyTorch's own order, not the program's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# -- maps -------------------------------------------------------------------


def quantize_pmf(pmf):
    """int8 percentages, the last bin taking the rounding residue."""
    q = (np.asarray(pmf, float) * 100).astype(np.int8)
    q[-1] = np.int8(100) - np.sum(q[:-1])
    return q


def cvar_mean(values, pmf, alpha, eps=0.0):
    """The mean traction of a PMF's worst ``alpha`` prefix (the plain mean
    at alpha 1)."""
    values = np.asarray(values, float)
    pmf = np.asarray(pmf, float)
    if alpha == 1.0:
        return float(np.sum(pmf * values))
    cum = np.cumsum(pmf)
    L = int(np.argmax(cum >= alpha))
    den = cum[L] + eps
    num = float(np.sum((pmf * values)[:L + 1]))
    return num / den if den > 0 else num


class Planes(NamedTuple):
    """One environment's padded map planes as the solve reads them."""
    lin: np.ndarray      # int8 (B, H, W) PMF percentages
    ang: np.ndarray
    lin_q: np.ndarray    # int8 (B,) quantized bin values
    ang_q: np.ndarray
    risk: np.ndarray     # int8 (H, W) speed map (zeros unless speed_map)


def planes(world, grid, mode, det_alpha, pad_cells):
    """The padded planes of ``grid`` (terrain ids) in ``mode`` ('tdm',
    'det_dyn' or 'speed_map'): the PMF quantized per terrain, or one-hot
    at the bin of the worst-``det_alpha`` mean (det_dyn), or all mass at
    full traction with the worst-``det_alpha`` mean as a risk byte
    (speed_map); a ring of ``pad_cells`` at zero traction around it."""
    values = np.asarray(world["bin_values"], np.float32)
    lb, ub = (np.float32(b) for b in world["bin_values_bounds"])
    B = len(values)
    R, C = grid.shape
    out = {}
    for plane in ("lin", "ang"):
        pmf = np.zeros((B, R, C), np.int8)
        risk = np.zeros((R, C), np.int8)
        for t in world["terrains"].values():
            mask = grid == t["id"]
            v, p = t[plane]
            if mode == "tdm":
                pmf[:, mask] = quantize_pmf(p).reshape(-1, 1)
            elif mode == "det_dyn":
                target = cvar_mean(v, p, det_alpha)
                pmf[int(np.argmax(target <= np.asarray(v, float))), mask] = 100
            else:
                pmf[-1] = 100
                cv = cvar_mean(t["lin"][0], t["lin"][1], det_alpha)
                risk[mask] = np.int8(100 * (cv - float(lb))
                                     / (float(ub) - float(lb)))
        padded = np.zeros((B, R + 2 * pad_cells, C + 2 * pad_cells), np.int8)
        padded[0] = 100
        padded[:, pad_cells:pad_cells + R, pad_cells:pad_cells + C] = pmf
        out[plane] = padded
        if plane == "lin":
            out["risk"] = np.zeros(padded.shape[1:], np.int8)
            out["risk"][pad_cells:pad_cells + R,
                        pad_cells:pad_cells + C] = risk
    q = (np.float32(100.0) * (values - lb) / (ub - lb)).astype(np.int8)
    return Planes(out["lin"], out["ang"], q, q.copy(), out["risk"])


# -- draws ------------------------------------------------------------------


def replay_draws(seed, rounds, lead, K, T, device):
    """The draws of rounds ``rounds`` (a set of ints) of a generator
    seeded ``seed`` that every solve draws from: a map key of two uint32
    words ``lead + (2,)`` and standard normals ``lead + (K, T, 2)`` a
    round.  Returns {round: (key int64, normals float32)}."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = {}
    for r in range(max(rounds) + 1):
        key = torch.randint(0, 2 ** 32, tuple(lead) + (2,), generator=g,
                            device=device, dtype=torch.int64)
        eps = torch.randn(tuple(lead) + (K, T, 2), generator=g,
                          device=device, dtype=torch.float32)
        if r in rounds:
            out[r] = (key, eps)
    return out


# -- the map draw ---------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def uniforms(k1, k2, idx):
    """float32 uniforms in [0, 1) at int64 counters ``idx`` under the key
    words ``k1``, ``k2`` (int64 tensors broadcast against ``idx``):
    threefry2x32 of the counter pair ``(0, idx)``, 20 rounds, the two
    words' xor, 23 bits of mantissa."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (torch.zeros_like(idx) + ks[0]) & _M32
    x2 = (idx + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) & _M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    bits = ((x1 ^ x2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def window_start(x0, xlim0, ylim0, res, full_hw, roi):
    """The reachable window's first row and column, int64 ``(S,)`` each:
    the robot's cell less half the window, inside the map."""
    H, W = full_hw
    rH, rW = roi
    cx = torch.floor((x0[:, 0] - xlim0) / res).long()
    cy = torch.floor((x0[:, 1] - ylim0) / res).long()
    oy = (cy.clamp(0, H - 1) - rH // 2).clamp(0, H - rH)
    ox = (cx.clamp(0, W - 1) - rW // 2).clamp(0, W - rW)
    return oy, ox


def draw_maps(keys, pmf, qbins, alpha_dyn, M, oy, ox, roi, dtype):
    """The M sampled maps of each scenario on its window: int8 ``(S, M,
    rH, rW)`` decoded traction values.  ``pmf`` int8 ``(S, B, H, W)``;
    ``keys`` int64 ``(S, 2)``; ``alpha_dyn`` ``(S,)``."""
    S, B, H, W = pmf.shape
    rH, rW = roi
    dev = pmf.device
    rows = oy[:, None] + torch.arange(rH, device=dev)                 # (S, rH)
    cols = ox[:, None] + torch.arange(rW, device=dev)                 # (S, rW)
    cell = (rows[:, :, None] * W + cols[:, None, :]).reshape(S, 1, -1)
    idx = torch.arange(M, device=dev)[None, :, None] * (H * W) + cell
    u = uniforms(keys[:, 0, None, None], keys[:, 1, None, None], idx)
    scale = (100.0 * alpha_dyn.to(dtype))[:, None, None]
    sampled = torch.ceil(u.to(dtype) * scale).to(torch.int32)        # (S,M,n)
    flat = pmf.reshape(S, B, H * W).to(torch.int32)
    cum = torch.cumsum(torch.gather(
        flat, 2, cell.reshape(S, 1, -1).expand(S, B, -1)), dim=1)    # (S,B,n)
    rank = torch.zeros_like(sampled)
    for b in range(B):
        rank += (cum[:, b, None, :] < sampled).to(torch.int32)
    vals = qbins.to(dev)[rank.clamp(max=B - 1).long()]
    vals = torch.where(rank < B, vals, torch.full_like(vals, -128))
    return vals.reshape(S, M, rH, rW)


# -- the solve ------------------------------------------------------------


class Task(NamedTuple):
    """Per-scenario task values, float tensors ``(S,)`` or ``(S, n)``."""
    x0: torch.Tensor
    goal: torch.Tensor
    tol: torch.Tensor
    v_post: torch.Tensor
    lam: torch.Tensor
    u_std: torch.Tensor
    vrange: torch.Tensor
    wrange: torch.Tensor
    dt: torch.Tensor
    xlim0: torch.Tensor
    ylim0: torch.Tensor
    res: torch.Tensor
    lin_lb: torch.Tensor
    lin_ratio: torch.Tensor
    ang_lb: torch.Tensor
    ang_ratio: torch.Tensor
    alpha_dyn: torch.Tensor
    cvar_alpha: torch.Tensor


def rollout_costs(lin_v, ang_v, risk_v, tk, v_all, w_all, fast_trig,
                  speed_map, dtype):
    """Each (scenario, k, m)'s cost ``(S, K, M)``: T unicycle steps on the
    m-th sampled map from x0, each step's traction read at the cell of
    the state before it; stage cost dt (or dt over the risk speed) plus
    the goal distance until the goal is within tolerance, then the
    terminal distance over v_post.  ``fast_trig``: the heading carried as
    (cos, sin) and turned by a degree-4/5 Maclaurin rotation; else exact
    sines and cosines.  ``lin_v`` / ``ang_v`` ``(S, M, rH, rW)`` decoded
    values; ``risk_v`` ``(S, rH, rW)`` risk bytes or None; ``v_all`` /
    ``w_all`` ``(S, T, K)`` clipped controls."""
    S, M, rH, rW = lin_v.shape
    K = v_all.shape[2]
    n = rH * rW
    dev = lin_v.device

    def col(t):
        return t.to(dtype)[:, None, None]

    xlim0, ylim0, dt = col(tk.xlim0), col(tk.ylim0), col(tk.dt)
    inv_res = 1.0 / col(tk.res)
    lin_lb, lin_ratio = col(tk.lin_lb), col(tk.lin_ratio)
    ang_lb, ang_ratio = col(tk.ang_lb), col(tk.ang_ratio)
    gx, gy = col(tk.goal[:, 0]), col(tk.goal[:, 1])
    tol = col(tk.tol)
    tol2 = tol * tol
    v_post = col(tk.v_post)
    base = (torch.arange(S, device=dev)[:, None, None] * (M * n)
            + torch.arange(M, device=dev)[None, None, :] * n)
    lin_f = lin_v.reshape(-1)
    ang_f = ang_v.reshape(-1)
    risk_f = None if risk_v is None else risk_v.reshape(S, n)
    shape = (S, K, M)
    x = col(tk.x0[:, 0]).expand(shape)
    y = col(tk.x0[:, 1]).expand(shape)
    th0 = col(tk.x0[:, 2])
    hd = ((torch.cos(th0).expand(shape), torch.sin(th0).expand(shape))
          if fast_trig else th0.expand(shape))
    cost = torch.zeros(shape, dtype=dtype, device=dev)
    dist2 = torch.full(shape, 1e9, dtype=dtype, device=dev)
    reached = torch.zeros(shape, dtype=dtype, device=dev)
    for t in range(v_all.shape[1]):
        v_t = v_all[:, t, :, None].to(dtype)
        w_t = w_all[:, t, :, None].to(dtype)
        xi = torch.floor((x - xlim0) * inv_res).clamp(0, rW - 1).long()
        yi = torch.floor((y - ylim0) * inv_res).clamp(0, rH - 1).long()
        cell = yi * rW + xi
        lin_tr = lin_lb + lin_ratio * lin_f[cell + base].to(dtype)
        ang_tr = ang_lb + ang_ratio * ang_f[cell + base].to(dtype)
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
            x_new = x + dt * lin_tr * v_t * torch.cos(hd)
            y_new = y + dt * lin_tr * v_t * torch.sin(hd)
            hd_new = hd + dt * ang_tr * w_t
        dx, dy = gx - x_new, gy - y_new
        d2 = dx * dx + dy * dy
        if speed_map:
            risk = torch.gather(risk_f, 1, cell.reshape(S, -1)).reshape(shape)
            dt_eff = dt / (lin_lb + lin_ratio * risk.to(dtype) + 1e-6)
        else:
            dt_eff = dt
        step = dt_eff + torch.sqrt(d2)
        if fast_trig:
            active = 1.0 - reached
            cost = cost + active * step
            dist2 = dist2 + active * (d2 - dist2)
            reached = torch.maximum(reached, active * (d2 <= tol2).to(dtype))
        else:
            active = reached == 0
            cost = cost + torch.where(active, step, 0.0)
            dist2 = torch.where(active, d2, dist2)
            reached = torch.where(active & (d2 <= tol2), 1.0, reached)
        x, y, hd = x_new, y_new, hd_new
    return cost + (1.0 - reached) * torch.sqrt(dist2) / (v_post + 1e-6)


def cvar_count(M, alpha):
    """``ceil(M * alpha)`` in float32: the number of worst costs the CVaR
    averages."""
    return int(math.ceil(np.float32(M) * np.float32(alpha)))


def solve(pmf_lin, pmf_ang, qb_lin, qb_ang, risk, tk, u, keys, eps, *, M,
          roi, fast_trig, speed_map, numel=None, dtype=torch.float32):
    """One solve of S scenarios.  ``pmf_*`` int8 ``(S, B, H, W)``,
    ``risk`` int8 ``(S, H, W)``, ``u`` ``(S, T, 2)``, ``keys`` ``(S, 2)``,
    ``eps`` ``(S, K, T, 2)``; ``roi`` the window ``(rH, rW)`` or None;
    ``numel`` the static count of worst costs, or None to take it from
    ``tk.cvar_alpha``.  Returns a dict of the new controls ``u (S, T, 2)``,
    the costs and weights ``(S, K)``, the window's offsets ``(S, 2)`` and
    the sampled maps ``lin`` / ``ang`` ``(S, M, rH, rW)``."""
    S, _, H, W = pmf_lin.shape
    dev = pmf_lin.device
    f = dtype
    if roi:
        oy, ox = window_start(tk.x0, tk.xlim0, tk.ylim0, tk.res, (H, W), roi)
    else:
        roi = (H, W)
        oy = ox = torch.zeros(S, dtype=torch.int64, device=dev)
    lin = draw_maps(keys, pmf_lin, qb_lin, tk.alpha_dyn, M, oy, ox, roi, f)
    ang = draw_maps(keys, pmf_ang, qb_ang, tk.alpha_dyn, M, oy, ox, roi, f)
    rows = oy[:, None, None] + torch.arange(roi[0], device=dev)[None, :, None]
    cols = ox[:, None, None] + torch.arange(roi[1], device=dev)[None, None, :]
    risk_w = (torch.gather(risk.reshape(S, -1), 1,
                           (rows * W + cols).reshape(S, -1))
              .reshape(S, *roi) if speed_map else None)
    wtk = tk._replace(xlim0=tk.xlim0 + ox.to(tk.xlim0.dtype) * tk.res,
                      ylim0=tk.ylim0 + oy.to(tk.ylim0.dtype) * tk.res)
    u = u.to(f)
    noise = eps.to(f) * tk.u_std.to(f)[:, None, None, :]
    vr, wr = tk.vrange.to(f), tk.wrange.to(f)
    v_all = torch.clamp(u[:, :, 0, None] + noise[..., 0].transpose(1, 2),
                        vr[:, 0, None, None], vr[:, 1, None, None])
    w_all = torch.clamp(u[:, :, 1, None] + noise[..., 1].transpose(1, 2),
                        wr[:, 0, None, None], wr[:, 1, None, None])
    costs_km = rollout_costs(lin, ang, risk_w, wtk, v_all, w_all, fast_trig,
                             speed_map, f)
    srt = torch.sort(costs_km, dim=-1, descending=True).values
    cvar = torch.empty(costs_km.shape[:2], dtype=f, device=dev)
    for s in range(S):
        n = numel if numel is not None else cvar_count(
            M, float(tk.cvar_alpha[s]))
        n = min(n, M)
        cvar[s] = srt[s, :, :n].sum(-1) / n
    lam = tk.lam.to(f)
    std = tk.u_std.to(f)
    coupling = lam[:, None] * (noise * (u / (std * std)[:, None, :])[:, None]
                               ).sum(dim=(-1, -2))
    costs = cvar + coupling
    beta = costs.min(dim=-1, keepdim=True).values
    w = torch.exp(-(costs - beta) / lam[:, None])
    w = w / w.sum(-1, keepdim=True)
    u_new = u + (w[:, :, None, None] * noise).sum(1)
    u_new = torch.stack([
        torch.clamp(u_new[..., 0], vr[:, 0, None], vr[:, 1, None]),
        torch.clamp(u_new[..., 1], wr[:, 0, None], wr[:, 1, None])], -1)
    return dict(u=u_new, costs=costs, weights=w,
                offset=torch.stack([oy, ox], -1), lin=lin, ang=ang)


# -- the episode step -------------------------------------------------------


def episode_step(state, u_new, gt_lin, gt_ang, inv_res, tk, dtype):
    """One masked step of a batch of episodes after its solve: the Euler
    step on each episode's ground truth at its state (zero off the grid),
    the receding-horizon shift, the goal distance, and the bookkeeping of
    unfinished episodes.  ``state``: dict of ``x (S, 3)``, ``u (S, T,
    2)``, ``reached``, ``steps``, ``cum_obj``, ``cum_dist``, ``dist``
    ``(S,)``.  Returns the new state."""
    f = dtype
    x = state["x"].to(f)
    Hg, Wg = gt_lin.shape[-2:]
    xi = torch.floor(x[:, 0] * inv_res).long()
    yi = torch.floor(x[:, 1] * inv_res).long()
    inb = (xi >= 0) & (xi < Wg) & (yi >= 0) & (yi < Hg)
    flat = yi.clamp(0, Hg - 1) * Wg + xi.clamp(0, Wg - 1)
    lt = torch.where(inb, gt_lin.reshape(len(x), -1).to(f).gather(
        1, flat[:, None])[:, 0], 0.0)
    at = torch.where(inb, gt_ang.reshape(len(x), -1).to(f).gather(
        1, flat[:, None])[:, 0], 0.0)
    dt = tk.dt.to(f)
    u0 = u_new[:, 0].to(f)
    x_new = torch.stack([x[:, 0] + dt * lt * torch.cos(x[:, 2]) * u0[:, 0],
                         x[:, 1] + dt * lt * torch.sin(x[:, 2]) * u0[:, 0],
                         x[:, 2] + dt * at * u0[:, 1]], -1)
    u_shift = torch.cat([u_new[:, 1:], u_new[:, -1:]], 1).to(f)
    d = x_new[:, :2] - tk.goal.to(f)
    dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) - tk.tol.to(f)
    act = ~state["reached"]
    return dict(
        x=torch.where(act[:, None], x_new, x),
        u=torch.where(act[:, None, None], u_shift, state["u"].to(f)),
        reached=state["reached"] | (act & (dist <= 0)),
        steps=state["steps"] + act.to(state["steps"].dtype),
        cum_obj=state["cum_obj"].to(f) + torch.where(act, dt + dist, 0.0),
        cum_dist=state["cum_dist"].to(f) + torch.where(act, dist, 0.0),
        dist=torch.where(act, dist, state["dist"].to(f)))


# -- what the configuration states --------------------------------------------


def pad_cells(cfg):
    """The zero-traction ring's width in cells: the distance at
    ``max_speed_padding`` in one step.  The configuration's grid and its
    ring must fit ``max_map_dim``: the reference crops no map."""
    pc = cfg["planner"]
    pad = int(math.ceil(pc["max_speed_padding"] * pc["dt"]
                        / cfg["grid"]["res"]))
    if any(n + 2 * pad > m for n, m in zip(cfg["grid"]["shape"],
                                           pc["max_map_dim"])):
        raise ValueError("the grid and its ring exceed max_map_dim")
    return pad


def reach_window(cfg, grid_shape):
    """The reachable window ``(rH, rW)`` of a solve on a grid of
    ``grid_shape`` cells (padded here), or None where it is not under
    three quarters of the map: the farthest a rollout moves in the
    horizon (max |v| times the largest traction, at least 1) in cells,
    plus 2, each side of the robot's cell."""
    pc, p = cfg["planner"], cfg["params"]
    pad = pad_cells(cfg)
    H, W = grid_shape[0] + 2 * pad, grid_shape[1] + 2 * pad
    T = int(pc["T"] / pc["dt"] + 1e-6)
    vmax = float(np.max(np.abs(p["vrange"])))
    tr_ub = max(1.0, float(cfg["world"]["bounds"][1]))
    cells = int(math.ceil(vmax * tr_ub * T * float(pc["dt"])
                          / float(cfg["grid"]["res"]))) + 2
    r = 2 * cells + 1
    rH, rW = min(H, r), min(W, r)
    return None if rH * rW * 4 >= H * W * 3 else (rH, rW)


def fast_trig(cfg, on_card):
    """Whether the rollout turns the heading by the Maclaurin rotation:
    on a card, where a step's largest turn dt * max|w| * the largest
    angular traction is at most 0.6 rad; exact sines and cosines
    elsewhere."""
    pc, p = cfg["planner"], cfg["params"]
    turn = (float(pc["dt"]) * float(np.max(np.abs(p["wrange"])))
            * float(cfg["world"]["bounds"][1]))
    return bool(on_card) and turn <= 0.6


def method_alphas(method, alpha):
    """``(det_alpha, cvar_alpha, alpha_dyn)`` of a protocol method at the
    sweep's ``alpha``: noisy_dyn takes the CVaR over its M maps at alpha;
    the M = 1 methods condense each terrain's PMF at alpha and restrict
    the draw to the alpha quantile."""
    if method == "noisy_dyn":
        return None, alpha, 1.0
    return alpha, 1.0, alpha


def task(cfg, world, x0, goal, alpha_dyn, cvar_alpha, device):
    """The reference's ``Task`` of S scenarios: ``x0 (S, 3)``, ``goal (S,
    2)``, ``alpha_dyn`` and ``cvar_alpha`` ``(S,)`` or scalars."""
    p, pc = cfg["params"], cfg["planner"]
    f32 = torch.float32
    S = len(x0)
    lb, ub = world["bin_values_bounds"]
    ratio = np.float32(0.01 * (ub - lb))
    pad = pad_cells(cfg)
    res = cfg["grid"]["res"]

    def full(v):
        return torch.full((S,), float(np.float32(v)), dtype=f32,
                          device=device)

    def rows(v):
        return torch.tensor(np.broadcast_to(np.asarray(v, np.float32),
                                            (S, 2)).copy(), device=device)

    def per(v):
        v = np.broadcast_to(np.asarray(v, np.float32), (S,))
        return torch.tensor(v.copy(), device=device)

    return Task(
        x0=torch.tensor(np.array(x0, np.float32), device=device),
        goal=torch.tensor(np.array(goal, np.float32), device=device),
        tol=full(p["goal_tolerance"]), v_post=full(p["v_post_rollout"]),
        lam=full(p["lambda_weight"]), u_std=rows(p["u_std"]),
        vrange=rows(p["vrange"]), wrange=rows(p["wrange"]),
        dt=full(pc["dt"]), xlim0=full(-pad * res), ylim0=full(-pad * res),
        res=full(res), lin_lb=full(lb), lin_ratio=full(ratio),
        ang_lb=full(lb), ang_ratio=full(ratio), alpha_dyn=per(alpha_dyn),
        cvar_alpha=per(cvar_alpha))
