"""Softmax-weighted control update (information-theoretic MPPI):

  beta  = min_k cost_k
  w_k   = exp(-(cost_k - beta) / lambda) / sum_j exp(-(cost_j - beta) / lambda)
  u'    = clip(u + sum_k w_k * eps_k)

The sums run in the halving tree's order (``tree.py``), as the card's
kernel (``kernels/update_useq.py``) sums them.  The weighted noise sum is
a product and a sum over k, not a matrix product, so it stays in full
float32 whatever the caller's TF32 settings.

Every argument may carry a leading scenario axis B (the JAX update under
``jax.vmap``): costs ``(B, K)``, noise ``(B, K, T, 2)``, u ``(B, T, 2)``,
lambda ``(B,)`` and the ranges ``(B, 2)``.

When the K axis is split over the ranks of a process group (the sharded
solve, ``parallel/sharded.py``), the three reductions over k run across the
group as well: ``beta`` an all-reduce MIN, the normalizer and the weighted
noise sum all-reduce SUMs, as the JAX update's ``pmin`` / ``psum`` over its
``axis_name`` (``mppi_numba_tpu/ops/update.py:44-53``).  The scenario axis
stays leading, so one all-reduce serves all of a rank's scenarios.
"""

from __future__ import annotations

from .kernels.update_useq import update_useq_fused, update_useq_plain


def update_useq(costs, noise, u_cur, lambda_weight, vrange, wrange,
                group=None):
    """One MPPI control update.

    Args:
      costs: float32 ``(K,)`` rollout costs.
      noise: float32 ``(K, T, 2)`` control perturbations.
      u_cur: float32 ``(T, 2)`` current nominal control sequence.
      lambda_weight: scalar temperature.
      vrange, wrange: ``(2,)`` actuation bounds.
      group: the process group the K axis is split over (costs and noise
        hold this rank's ``K_local`` rows), or None.

    Returns:
      (u_new ``(T, 2)``, weights ``(K,)``), each with the leading scenario
      axis of the arguments; the weights are this rank's rows under a group.

    Without a group this is ``update_useq_fused`` (the kernel on CUDA
    tensors); with one, the plain version's torch ops around the
    collectives.
    """
    if group is None:
        return update_useq_fused(costs, noise, u_cur, lambda_weight, vrange,
                                 wrange)
    return update_useq_plain(costs, noise, u_cur, lambda_weight, vrange,
                             wrange, group=group)
