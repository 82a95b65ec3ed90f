"""Closed-loop simulation: the benchmark's inner loop.

``trial`` runs one episode as the JAX package's ``sim.trial`` does: solve,
step the ground-truth ``TractionGrid`` on the host, shift and update,
accumulating the same metrics with the same timeout penalty.  The planner
is any object with ``solve()`` and ``shift_and_update(x, useq,
num_shifts)``: an ``MPPIPlanner`` solves on its device (the CUDA kernels on
a card); the simulation itself is host numpy.
"""

from __future__ import annotations

import numpy as np


def simulate_step(x, u, lin_traction, ang_traction, dt):
    """Euler unicycle step on realized tractions (host numpy)."""
    return np.array([
        x[0] + dt * lin_traction * np.cos(x[2]) * u[0],
        x[1] + dt * lin_traction * np.sin(x[2]) * u[0],
        x[2] + dt * ang_traction * u[1],
    ])


def trial(mppi_planner, traction_grid, dt, max_steps, mppi_params,
          return_history=False, on_step=None, **_unused):
    """One closed-loop episode; returns the trial-metric dict:
    time_to_goal, success, dist_to_goal, cum_dist_to_goal, avg_dist_to_goal,
    cum_obj.  With ``return_history`` the dict also carries ``xhist``
    ``(steps+1, 3)`` and ``uhist`` ``(steps, 2)``.

    ``on_step(t, xhist_prefix)`` is an optional hook called after each solve
    and before the simulation step (``xhist_prefix`` holds states 0..t)."""
    xhist = np.full((max_steps + 1, 3), np.nan)
    uhist = np.full((max_steps, 2), np.nan)
    xhist[0] = mppi_params["x0"]
    goal_reached = False
    dist_to_goal = np.nan
    cum_obj = 0.0
    cum_dist_to_goal = 0.0
    t = 0

    for t in range(max_steps):
        useq = mppi_planner.solve()
        if on_step is not None:
            on_step(t, xhist[:t + 1])
        u_curr = useq[0]
        uhist[t] = u_curr

        lt, at = traction_grid.get(xhist[t, 0], xhist[t, 1])
        xhist[t + 1] = simulate_step(xhist[t], u_curr, lt, at, dt)

        mppi_planner.shift_and_update(xhist[t + 1], useq, num_shifts=1)

        dist_to_goal = (np.linalg.norm(xhist[t + 1, :2] - mppi_params["xgoal"])
                        - mppi_params["goal_tolerance"])
        cum_obj += dt + dist_to_goal
        cum_dist_to_goal += dist_to_goal

        if dist_to_goal <= 0:
            goal_reached = True
            break

    if goal_reached:
        dist_to_goal = np.nan
    else:
        cum_obj += dist_to_goal / mppi_params["v_post_rollout"]

    logger = dict(
        time_to_goal=(t + 1) * dt if goal_reached else np.nan,
        success=goal_reached,
        dist_to_goal=dist_to_goal,
        cum_dist_to_goal=cum_dist_to_goal,
        avg_dist_to_goal=cum_dist_to_goal / (t + 1),
        cum_obj=cum_obj,
    )
    if return_history:
        logger["xhist"] = xhist[:t + 2]
        logger["uhist"] = uhist[:t + 1]
    return logger
