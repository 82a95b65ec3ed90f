"""CVaR over the map samples: mean of the worst alpha-fraction of M costs.

With the M axis split over the ranks of a process group (the map-sharded
solve), ``cvar_from_costs_distributed`` and
``cvar_from_costs_dynamic_distributed`` reduce across the group
(``mppi_numba_tpu/ops/cvar.py:36-76``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import all_gather_cat


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
    """CVaR with alpha as a float32 tensor: sort descending + masked mean.
    With a leading scenario axis, costs ``(B, K, M)`` and one alpha a
    scenario ``(B,)``; returns ``(B, K)``."""
    M = costs_km.shape[-1]
    srt = torch.sort(costs_km, dim=-1, descending=True).values
    numel = torch.ceil(M * cvar_alpha).to(torch.int32)[..., None]  # (.., 1)
    mask = (torch.arange(M, device=costs_km.device)
            < numel[..., None]).to(costs_km.dtype)                  # (.., 1, M)
    return (srt * mask).sum(-1) / numel.to(costs_km.dtype)


def cvar_from_costs_distributed(costs_km, cvar_numel, m_total, group):
    """CVaR when the M axis is split over the ranks of ``group``.

    Two-phase top-k: each rank keeps its ``min(cvar_numel, M_local)``
    worst costs, sorted descending as ``lax.top_k`` returns them; the ranks
    all-gather those candidates and take the global worst ``cvar_numel``
    (at most that many of the global worst lie on any one rank).  The
    global worst come out of the candidates sorted as the single-device
    ``torch.topk`` sorts them, so the mean sums in its order: the result
    equals ``cvar_from_costs`` on the whole M axis bit for bit.  At alpha 1
    (``cvar_numel >= m_total``) the ranks all-reduce their sums instead,
    which sums in another order than the single-device mean.

    Args:
      costs_km: float32 ``(K_local, M_local)`` (a leading scenario axis
        allowed): this rank's slice.
      cvar_numel: the global ``ceil(m_total * alpha)``.
      m_total: the global M.
      group: the process group the M axis is split over.

    Returns:
      float32 ``(K_local,)``, the same on every rank of the group.
    """
    m_local = costs_km.shape[-1]
    if cvar_numel >= m_total:
        total = torch.sum(costs_km, dim=-1)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total / m_total
    keep = min(cvar_numel, m_local)
    local_top = torch.topk(costs_km, keep, dim=-1, sorted=True).values
    cand = all_gather_cat(local_top, -1, group)
    worst = torch.topk(cand, cvar_numel, dim=-1, sorted=True).values
    return torch.mean(worst, dim=-1)


def cvar_from_costs_dynamic_distributed(costs_km, cvar_alpha, group):
    """``cvar_from_costs_dynamic`` over an M axis split over ``group``:
    alpha is a tensor, so no candidate count is fixed; the ranks gather
    their whole cost slices (in M order) and reduce as one device does,
    bit for bit."""
    return cvar_from_costs_dynamic(all_gather_cat(costs_km, -1, group),
                                   cvar_alpha)
