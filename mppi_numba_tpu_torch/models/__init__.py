"""Pluggable dynamics models.

A model is a pure step function over broadcastable tensors

    step(x, y, th, v, w, lin_traction, ang_traction, dt) -> (x, y, th)

selected by name via ``SolverStatic.model``.  The eager rollout runs any
registered model; the CUDA rollout kernel serves the unicycle only.
"""

from __future__ import annotations

from .unicycle import unicycle_step, clip_controls
from .bicycle import bicycle_step, make_bicycle_step

_REGISTRY = {
    "unicycle": unicycle_step,
    "bicycle": bicycle_step,
}

# Models whose per-step translation is bounded by ``dt * lin_traction * v``.
_UNICYCLE_DISPLACEMENT_BOUNDED = {"unicycle", "bicycle"}


def register_model(name, step_fn, displacement_bounded=False):
    """Register a custom dynamics step function under ``name``.

    Pass ``displacement_bounded=True`` iff the model's per-step translation
    never exceeds ``dt * lin_traction * |v|``.
    """
    _REGISTRY[name] = step_fn
    if displacement_bounded:
        _UNICYCLE_DISPLACEMENT_BOUNDED.add(name)
    else:
        _UNICYCLE_DISPLACEMENT_BOUNDED.discard(name)


def has_displacement_bound(name):
    """Whether a reachable-window bound is valid for this model."""
    return name in _UNICYCLE_DISPLACEMENT_BOUNDED


def get_step_fn(name):
    """Resolve a registered model name to its step function."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError("unknown dynamics model {!r}; registered: {}".format(
            name, sorted(_REGISTRY))) from None


__all__ = ["unicycle_step", "clip_controls", "bicycle_step",
           "make_bicycle_step", "register_model", "get_step_fn",
           "has_displacement_bound"]
