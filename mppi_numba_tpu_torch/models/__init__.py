"""Pluggable dynamics models.

A model is a pure step function over broadcastable tensors

    step(x, y, th, v, w, lin_traction, ang_traction, dt) -> (x, y, th)

selected by name via ``SolverStatic.model``.  The eager rollout runs any
registered model.  The CUDA rollout kernels run the built-in models, which
carry a ``kernel_model`` tag ``(name, wheelbase)`` that the kernel wrappers
read (``kernel_model``); a custom ``register_model`` function has none,
since Python cannot be compiled into the kernels, and runs on the card
with ``backend = "eager"`` only.
"""

from __future__ import annotations

from .unicycle import unicycle_step, clip_controls
from .bicycle import bicycle_step, make_bicycle_step

_REGISTRY = {
    "unicycle": unicycle_step,
    "bicycle": bicycle_step,
}

# Kernel model ids: the MODEL template argument of csrc/rollout_*.cu.
KERNEL_MODELS = {"unicycle": 0, "bicycle": 1}

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


def kernel_model(step_fn):
    """The CUDA rollout kernels' form of ``step_fn``: ``(model id,
    wheelbase)``.  ``None`` is the unicycle.  Raises
    ``NotImplementedError`` for a step function with no ``kernel_model``
    tag (a custom ``register_model`` model)."""
    if step_fn is None:
        step_fn = unicycle_step
    tag = getattr(step_fn, "kernel_model", None)
    if tag is None or tag[0] not in KERNEL_MODELS:
        names = [n for n, f in _REGISTRY.items() if f is step_fn]
        raise NotImplementedError(
            "dynamics model {!r} has no form in the CUDA rollout kernels "
            "(a Python step function cannot be compiled into them); "
            "cfg.backend = 'eager' runs it on the card with plain PyTorch "
            "ops".format(names[0] if names
                         else getattr(step_fn, "__name__", step_fn)))
    return KERNEL_MODELS[tag[0]], float(tag[1])


__all__ = ["unicycle_step", "clip_controls", "bicycle_step",
           "make_bicycle_step", "register_model", "get_step_fn",
           "has_displacement_bound", "kernel_model", "KERNEL_MODELS"]
