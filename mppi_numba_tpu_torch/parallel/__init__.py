"""One solve, and a batch of episodes, over many ranks: the JAX package's
``mppi_numba_tpu/parallel/`` on ``torch.distributed``.

SPMD, one process a device: every rank runs the same program on its own
shard and the shards meet in collectives over the groups of a
``DeviceMesh`` with axes ``(scenario, k, m)`` (``mesh.py``).
``sharded.py`` holds the sharded solve and the sharded episode batch,
``multihost.py`` the bring-up of the process group.
"""

from .mesh import MAP_AXIS, ROLLOUT_AXIS, SCENARIO_AXIS

__all__ = ["SCENARIO_AXIS", "ROLLOUT_AXIS", "MAP_AXIS"]
