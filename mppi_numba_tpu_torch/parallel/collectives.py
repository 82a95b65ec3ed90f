"""The one collective of the sharded path that ``torch.distributed`` does
not have as such: an all-gather that concatenates along any axis.

``all_gather_into_tensor`` concatenates the ranks' tensors along dim 0.
The sharded solve gathers along other axes: the map samples behind the
scenario axis, the CVaR candidates along the last.  Gathering along dim 0
and moving the rank axis into place keeps it one collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_cat(x, dim, group):
    """The tensors ``x`` of every rank of ``group`` concatenated along
    ``dim``, in the group's rank order (``jax.lax.all_gather(...,
    axis=dim, tiled=True)``): one ``all_gather_into_tensor``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    dim = dim % x.dim()
    shape = tuple(x.shape)
    return (out.view((n,) + shape).movedim(0, dim)
            .reshape(shape[:dim] + (n * shape[dim],) + shape[dim + 1:]))
