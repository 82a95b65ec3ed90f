"""CVaR over the map samples: mean of the worst alpha-fraction of M costs."""

from __future__ import annotations

import torch


def cvar_from_costs(costs_km, cvar_numel):
    """Reduce per-(rollout, map-sample) costs to per-rollout CVaR.

    Args:
      costs_km: float32 ``(K, M)``.
      cvar_numel: ``ceil(M * cvar_alpha)``; ``M`` yields the plain mean.

    Returns:
      float32 ``(K,)`` — mean of the ``cvar_numel`` largest costs per row.
    """
    M = costs_km.shape[-1]
    if cvar_numel >= M:
        return torch.mean(costs_km, dim=-1)
    # Sorted (descending), as ``lax.top_k`` returns them: the mean then sums
    # in the JAX package's order.  The solve's softmax turns cost ulps into
    # control differences, so the order is kept, not left to chance.
    worst = torch.topk(costs_km, cvar_numel, dim=-1, sorted=True).values
    return torch.mean(worst, dim=-1)


def cvar_from_costs_dynamic(costs_km, cvar_alpha):
    """CVaR with alpha as a float32 tensor: sort descending + masked mean."""
    M = costs_km.shape[-1]
    srt = torch.sort(costs_km, dim=-1, descending=True).values
    numel = torch.ceil(M * cvar_alpha).to(torch.int32)
    mask = (torch.arange(M, device=costs_km.device) < numel).to(costs_km.dtype)
    return (srt * mask).sum(-1) / numel.to(costs_km.dtype)
