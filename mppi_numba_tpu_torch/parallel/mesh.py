"""The device mesh of a sharded solve: ``(scenario, k, m)`` over the ranks
of the process group.

* ``scenario``: independent planning problems (no traffic between them);
* ``k``: the control rollouts of one solve, with three all-reduces an
  optimisation iteration for the softmax update (``ops/update.py``);
* ``m``: the map samples of one solve, with a two-phase distributed top-k
  (or, at alpha 1, a gather of the ranks' sums) for the CVaR
  (``ops/cvar.py``).

The JAX package's ``mppi_numba_tpu/parallel/mesh.py``, on
``torch.distributed.device_mesh``: one process a device, rank ``r`` at the
mesh coordinate of ``r`` in row-major order, so ``k`` and ``m`` are the
innermost axes and their collectives stay among neighbouring ranks (the
ranks of one host under ``torchrun``).  A mesh spans every rank of the
process group.  Where the JAX mesh has two axes (no ``num_map_shards``)
this one has ``m`` of size 1.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

SCENARIO_AXIS = "scenario"
ROLLOUT_AXIS = "k"
MAP_AXIS = "m"
AXES = (SCENARIO_AXIS, ROLLOUT_AXIS, MAP_AXIS)


def local_device_index():
    """This rank's card: ``LOCAL_RANK`` (``torchrun``'s; the global rank
    where it is unset) modulo the cards of the host.  On a host with one
    card every rank shares ``cuda:0``."""
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return local % torch.cuda.device_count()


def rank_device(mesh):
    """The device of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def _device_type(devices):
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices='cpu' to build the mesh on the "
                "CPU")
        return "cuda"
    if devices not in ("cuda", "cpu"):
        raise ValueError("devices must be None, 'cuda' or 'cpu', got "
                         "{!r}".format(devices))
    return devices


def make_mesh(num_scenario_shards=1, num_rollout_shards=None, devices=None,
              num_map_shards=None):
    """Build the ``(scenario, k, m)`` mesh over every rank of the process
    group (``torch.distributed`` initialised, ``multihost.initialize``).

    ``num_rollout_shards=None`` takes the ranks left over by the scenario
    and map axes; ``num_map_shards=None`` is one map shard.  ``devices``:
    the device type of the ranks' tensors, ``"cuda"`` (the default; raises
    on a host without a card) or ``"cpu"``.  On a card each rank's device
    is ``cuda:(LOCAL_RANK % device_count)``, set here before the mesh is
    built.  Collective; every rank calls it with the same arguments.
    """
    device_type = _device_type(devices)
    n = dist.get_world_size()
    n_m = 1 if num_map_shards is None else num_map_shards
    if num_rollout_shards is None:
        if n % (num_scenario_shards * n_m) != 0:
            raise ValueError("{} ranks not divisible into {} x {}".format(
                n, num_scenario_shards, n_m))
        num_rollout_shards = n // (num_scenario_shards * n_m)
    shape = (num_scenario_shards, num_rollout_shards, n_m)
    if math.prod(shape) != n:
        raise ValueError("mesh {} does not cover the {} ranks of the "
                         "process group".format(shape, n))
    if device_type == "cuda":
        torch.cuda.set_device(local_device_index())
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def balanced_mesh(devices=None):
    """Split the ranks evenly-ish between the scenario and rollout axes."""
    n = dist.get_world_size()
    s = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return make_mesh(s, n // s, devices)
