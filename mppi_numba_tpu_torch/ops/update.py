"""Softmax-weighted control update (information-theoretic MPPI):

  beta  = min_k cost_k
  w_k   = exp(-(cost_k - beta) / lambda) / sum_j exp(-(cost_j - beta) / lambda)
  u'    = clip(u + sum_k w_k * eps_k)

The weighted noise sum is a product and a sum over k, not a matrix product,
so it stays in full float32 whatever the caller's TF32 settings
(``torch.backends.cuda.matmul.allow_tf32``, float32 matmul precision).

Every argument may carry a leading scenario axis B (the JAX update under
``jax.vmap``): costs ``(B, K)``, noise ``(B, K, T, 2)``, u ``(B, T, 2)``,
lambda ``(B,)`` and the ranges ``(B, 2)``.
"""

from __future__ import annotations

import torch

from ..models import clip_controls


def update_useq(costs, noise, u_cur, lambda_weight, vrange, wrange):
    """One MPPI control update.

    Args:
      costs: float32 ``(K,)`` rollout costs.
      noise: float32 ``(K, T, 2)`` control perturbations.
      u_cur: float32 ``(T, 2)`` current nominal control sequence.
      lambda_weight: scalar temperature.
      vrange, wrange: ``(2,)`` actuation bounds.

    Returns:
      (u_new ``(T, 2)``, weights ``(K,)``), each with the leading scenario
      axis of the arguments.
    """
    beta = torch.min(costs, dim=-1, keepdim=True).values
    w = torch.exp(-(costs - beta) / lambda_weight[..., None])
    w = w / torch.sum(w, dim=-1, keepdim=True)
    du = torch.sum(w[..., None, None] * noise, dim=-3)
    u_new = u_cur + du
    v, om = clip_controls(u_new, vrange[..., None, :], wrange[..., None, :])
    return torch.stack([v, om], dim=-1), w
