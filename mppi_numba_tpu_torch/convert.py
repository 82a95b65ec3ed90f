"""Carry solver state between the JAX package and this port.

The system has no weights: a solve's state is its ``MapInputs``, its
``TerrainTask`` and the nominal control sequence.  Both packages name the
NamedTuple fields alike, so state crosses field by field as numpy arrays.
This module imports neither JAX nor the JAX package: any NamedTuple whose
leaves ``np.asarray`` accepts will do.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import MapInputs, TerrainTask


def _to_tensor(leaf, device):
    if leaf is None:
        return None
    return torch.tensor(np.array(leaf), device=device)


def _to_numpy(leaf):
    if leaf is None:
        return None
    return leaf.cpu().numpy()


def maps_to_port(maps, device):
    """A ``MapInputs`` with numpy-convertible leaves -> the port's, on
    ``device``, bit for bit."""
    return MapInputs(**{f: _to_tensor(getattr(maps, f), device)
                        for f in MapInputs._fields})


def task_to_port(task, device):
    """A ``TerrainTask`` with numpy-convertible leaves -> the port's, on
    ``device``, bit for bit (a missing ``cvar_alpha`` stays None)."""
    return TerrainTask(**{f: _to_tensor(getattr(task, f, None), device)
                          for f in TerrainTask._fields})


def to_port(maps, task, u_seq, device):
    """``(maps, task, u_seq)`` with numpy-convertible leaves -> the port's
    ``(MapInputs, TerrainTask, tensor)`` on ``device``, bit for bit."""
    return (maps_to_port(maps, device), task_to_port(task, device),
            _to_tensor(u_seq, device))


def to_numpy(maps, task, u_seq):
    """The port's ``(MapInputs, TerrainTask, tensor)`` -> the same
    NamedTuples and array with numpy leaves."""
    return (MapInputs(*(_to_numpy(x) for x in maps)),
            TerrainTask(*(_to_numpy(x) for x in task)),
            _to_numpy(u_seq))
