"""CVaR over the map samples: mean of the worst alpha-fraction of M costs.

Each path computes as its JAX counterpart (``mppi_numba_tpu/ops/cvar.py``)
does on the CPU, bit for bit given the same costs: the worst costs in
descending order (``torch.topk`` / ``torch.sort``, NaN largest), summed in
XLA's CPU order (``tree.window_sum``), and

* a static count below M (``cvar_from_costs``): the worst ``numel``
  summed in windows over ``numel``, times ``float32(1 / numel)`` (XLA
  folds the mean's division by a constant into that product);
* a static count of M or more: the row as stored (no sort) summed in
  windows over M, times ``float32(1 / M)``;
* a run-time alpha (``cvar_from_costs_dynamic``): the sorted row times
  the 0/1 mask of the count, summed in windows over M, divided by the
  count.

So the static count and the run-time alpha of the same count differ in
the last bits, as JAX's do.  The solve's kernel
(``kernels/cvar_costs.py``) sums in the same order.

With the M axis split over the ranks of a process group (the map-sharded
solve), ``cvar_from_costs_distributed`` and
``cvar_from_costs_dynamic_distributed`` reduce across the group
(``mppi_numba_tpu/ops/cvar.py:36-76``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import all_gather_cat
from .tree import window_sum


def reciprocal(like, n):
    """``float32(1 / n)`` (the float32 quotient, which is what XLA folds
    into a mean) as a 0-d tensor of ``like``'s dtype and device."""
    return like.new_full((), float(np.float32(1.0) / np.float32(n)))


def cvar_from_costs(costs_km, cvar_numel):
    """Reduce per-(rollout, map-sample) costs to per-rollout CVaR.

    Args:
      costs_km: float32 ``(K, M)`` (a leading scenario axis allowed).
      cvar_numel: ``ceil(M * cvar_alpha)``; ``M`` or more yields the plain
        mean of the row as stored.

    Returns:
      float32 ``(K,)`` — mean of the ``cvar_numel`` largest costs per row.
    """
    M = costs_km.shape[-1]
    if cvar_numel >= M:
        return window_sum(costs_km) * reciprocal(costs_km, M)
    worst = torch.topk(costs_km, cvar_numel, dim=-1, sorted=True).values
    return window_sum(worst) * reciprocal(costs_km, cvar_numel)


def cvar_from_costs_dynamic(costs_km, cvar_alpha):
    """CVaR with alpha as a float32 tensor: sort descending, multiply by
    the mask of the first ``ceil(M * alpha)`` (a masked cost is +-0.0 by
    its sign, an infinite one NaN, as in JAX), sum over M, divide by the
    count.  With a leading scenario axis, costs ``(B, K, M)`` and one alpha
    a scenario ``(B,)``; returns ``(B, K)``."""
    M = costs_km.shape[-1]
    srt = torch.sort(costs_km, dim=-1, descending=True).values
    numel = torch.ceil(M * cvar_alpha).to(torch.int32)[..., None]  # (.., 1)
    mask = (torch.arange(M, device=costs_km.device)
            < numel[..., None]).to(costs_km.dtype)                  # (.., 1, M)
    return window_sum(srt * mask) / numel.to(costs_km.dtype)


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
    (``cvar_numel >= m_total``) each rank sums its slice in windows, the
    ranks gather the sums and add them in rank order, times ``float32(1 /
    m_total)``: JAX's ``psum`` of the slices' sums on the CPU, bit for
    bit, which is not the single-device order.

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
        sums = all_gather_cat(window_sum(costs_km)[..., None], -1, group)
        total = sums[..., 0]
        for r in range(1, sums.shape[-1]):
            total = total + sums[..., r]
        return total * reciprocal(costs_km, m_total)
    return cvar_from_costs(cvar_pool(costs_km, cvar_numel, group),
                           cvar_numel)


def cvar_from_costs_dynamic_distributed(costs_km, cvar_alpha, group):
    """``cvar_from_costs_dynamic`` over an M axis split over ``group``:
    alpha is a tensor, so no candidate count is fixed; the ranks gather
    their whole cost slices (in M order) and reduce as one device does,
    bit for bit."""
    return cvar_from_costs_dynamic(all_gather_cat(costs_km, -1, group),
                                   cvar_alpha)
