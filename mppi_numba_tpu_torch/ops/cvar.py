"""CVaR over the map samples: mean of the worst alpha-fraction of M costs.

The worst costs are summed in descending order (``torch.topk`` /
``torch.sort``, NaN largest), left to right (``tree.fold_sum``), the order
of the solve's kernel (``kernels/cvar_costs.py``): the static count, the
run-time alpha and the m-sharded candidate pool give the same bits for the
same count.

With the M axis split over the ranks of a process group (the map-sharded
solve), ``cvar_from_costs_distributed`` and
``cvar_from_costs_dynamic_distributed`` reduce across the group
(``mppi_numba_tpu/ops/cvar.py:36-76``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import all_gather_cat
from .tree import fold_sum


def cvar_from_costs(costs_km, cvar_numel):
    """Reduce per-(rollout, map-sample) costs to per-rollout CVaR.

    Args:
      costs_km: float32 ``(K, M)``.
      cvar_numel: ``ceil(M * cvar_alpha)``; ``M`` yields the plain mean.

    Returns:
      float32 ``(K,)`` — mean of the ``cvar_numel`` largest costs per row,
      summed largest first.
    """
    n = min(cvar_numel, costs_km.shape[-1])
    worst = torch.topk(costs_km, n, dim=-1, sorted=True).values
    # A device tensor, not a Python number: torch divides a CUDA tensor by
    # a host scalar as a product with its reciprocal.
    return fold_sum(worst) / costs_km.new_full((), float(n))


def cvar_from_costs_dynamic(costs_km, cvar_alpha):
    """CVaR with alpha as a float32 tensor: sort descending, the costs
    past ``ceil(M * alpha)`` replaced by -0.0, summed largest first over
    the count.  With a leading scenario axis, costs ``(B, K, M)`` and one alpha
    a scenario ``(B,)``; returns ``(B, K)``."""
    M = costs_km.shape[-1]
    srt = torch.sort(costs_km, dim=-1, descending=True).values
    numel = torch.ceil(M * cvar_alpha).to(torch.int32)[..., None]  # (.., 1)
    keep = (torch.arange(M, device=costs_km.device)
            < numel[..., None])                                     # (.., 1, M)
    return (fold_sum(torch.where(keep, srt, -0.0))
            / numel.to(costs_km.dtype))


def cvar_pool(costs_km, cvar_numel, group):
    """The candidates of the two-phase top-k over the ranks of ``group``:
    each rank's ``min(cvar_numel, M_local)`` worst costs, all-gathered
    (at most ``cvar_numel`` of the global worst lie on any one rank).
    ``(K_local, S * keep)``, a leading scenario axis allowed."""
    keep = min(cvar_numel, costs_km.shape[-1])
    local_top = torch.topk(costs_km, keep, dim=-1, sorted=True).values
    return all_gather_cat(local_top, -1, group)


def cvar_from_costs_distributed(costs_km, cvar_numel, m_total, group):
    """CVaR when the M axis is split over the ranks of ``group``.

    Two-phase top-k: the ranks gather their candidates (``cvar_pool``)
    and take the global worst ``cvar_numel`` of the pool, sorted as the
    single-device CVaR sorts them and summed in the same order: the result
    equals ``cvar_from_costs`` on the whole M axis bit for bit.  At alpha 1
    (``cvar_numel >= m_total``) the ranks all-reduce their sums instead,
    which sums in another order than the single-device CVaR.

    Args:
      costs_km: float32 ``(K_local, M_local)`` (a leading scenario axis
        allowed): this rank's slice.
      cvar_numel: the global ``ceil(m_total * alpha)``.
      m_total: the global M.
      group: the process group the M axis is split over.

    Returns:
      float32 ``(K_local,)``, the same on every rank of the group.
    """
    if cvar_numel >= m_total:
        total = torch.sum(costs_km, dim=-1)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total / m_total
    return cvar_from_costs(cvar_pool(costs_km, cvar_numel, group),
                           cvar_numel)


def cvar_from_costs_dynamic_distributed(costs_km, cvar_alpha, group):
    """``cvar_from_costs_dynamic`` over an M axis split over ``group``:
    alpha is a tensor, so no candidate count is fixed; the ranks gather
    their whole cost slices (in M order) and reduce as one device does,
    bit for bit."""
    return cvar_from_costs_dynamic(all_gather_cat(costs_km, -1, group),
                                   cvar_alpha)
