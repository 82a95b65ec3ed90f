"""Checkpoint / resume (SURVEY §5.4), as the JAX package's
``checkpoint.py`` has it.

The reference's only persistent state is data-level: benchmark DataFrames +
experiment config pickles, and the planner's warm-started control sequence.
This module covers both:

* planner state snapshots (optimized control sequence, previous sequence,
  the generator's state where the JAX package keeps its key, params):
  everything needed to resume replanning mid-mission;
* experiment logs with the reference pickle's key set, so
  ``benchmark_vis``-style plotting works on either engine's output; the
  JAX package's own experiment pickles load here without importing it.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch


def save_planner_state(planner, path):
    """Snapshot the mutable planner state to ``path`` (host arrays: the
    controls, and the generator's state as ``get_state()`` bytes)."""
    state = dict(
        u_cur=planner.u_cur.detach().cpu().numpy(),
        u_prev=planner.u_prev.detach().cpu().numpy(),
        generator_state=planner._generator.get_state().numpy(),
        params=planner.params,
    )
    with open(path, "wb") as fh:
        pickle.dump(state, fh)
    return state


def load_planner_state(planner, path):
    """Restore a snapshot; the planner resumes exactly where it left off.

    TDMs are map data, not planner state: a terrain planner must have its
    TDMs attached (``setup``/``set_tdm``) BEFORE restoring, exactly as after
    a fresh construction (reference workflow: mppi_numba/terrain.py:78-84).

    The controls are copied into the planner's own input buffer in place
    (a solve graph captured on a card reads that buffer's address, so a
    rebound tensor would leave it solving from stale controls); then the
    params are set (into the task buffer) and the generator's state is put
    back, so the next solve, replayed or eager, draws what the saved
    planner's next solve would have drawn.
    """
    if getattr(planner, "tdm_set", True) is False:
        raise RuntimeError(
            "load_planner_state: attach TDMs first (planner.setup(...) or "
            "set_tdm(...)) -- the snapshot holds planner state, not maps.")
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    planner._u_in.copy_(torch.from_numpy(
        np.asarray(state["u_cur"], np.float32)))
    planner.u_cur = planner._u_in
    planner.u_prev = torch.tensor(np.asarray(state["u_prev"], np.float32),
                                  device=planner.device)
    planner._last_useq_np = None
    if state["params"] is not None:
        planner.set_params(state["params"])
    planner._generator.set_state(torch.from_numpy(
        np.asarray(state["generator_state"], np.uint8)))
    return planner


def save_experiment(path, logger_df, **config_items):
    """Persist a benchmark run with the reference pickle's layout
    (reference: benchmark.ipynb[cell 7], read back by
    benchmark_vis.ipynb[cell 2])."""
    out = dict(logger=logger_df)
    out.update(config_items)
    with open(path, "wb") as fh:
        pickle.dump(out, fh)


class _StubState:
    """Placeholder for classes of another implementation's package (the
    reference's ``mppi_numba``, or the JAX package): their pickled
    attributes, nothing of their code."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


def _foreign_class(module, name):
    """The class a pickle's ``module.name`` loads as, for the packages this
    one must never import (the reference's ``mppi_numba``, and the JAX
    package, which imports JAX): the JAX package's ``Config`` as this
    package's (its attributes set as pickled, no ``__init__`` run), every
    other class as an attribute-holding stub.  None for other modules."""
    root = module.split(".")[0]
    if root == "mppi_numba_tpu":
        if (module, name) == ("mppi_numba_tpu.config", "Config"):
            from .config import Config
            return Config
        return type(name, (_StubState,), {"__module__": module})
    if root == "mppi_numba":
        return type(name, (_StubState,), {"__module__": module})
    return None


class _ExperimentUnpickler(pickle.Unpickler):
    """Loads experiment pickles this program or the JAX package wrote,
    mapping the JAX package's classes (``_foreign_class``) so that
    loading never imports it."""

    def find_class(self, module, name):
        cls = _foreign_class(module, name)
        return cls if cls is not None else super().find_class(module, name)


def load_experiment(path):
    """Load an experiment pickle written by ``save_experiment`` here or in
    the JAX package (e.g. ``mppi_benchmark/*.pickle``, whose ``cfg`` is a
    JAX-package ``Config``: it loads as this package's ``Config``), without
    importing the JAX package.  The file is trusted (this program or the
    JAX package wrote it); use ``load_reference_experiment`` for the
    reference's pickles."""
    with open(path, "rb") as fh:
        return _ExperimentUnpickler(fh).load()


# Reference pickles are untrusted input (they ship with /root/reference);
# pickle's default find_class would happily resolve arbitrary callables for
# a crafted __reduce__ payload, and module-ROOT allowlisting is not enough —
# numpy/pandas contain exec-capable helpers (e.g.
# numpy.testing._private.utils.runstring).  Resolution is therefore
# restricted to the EXACT (module, name) globals a legitimate experiment
# pickle contains — recorded by instrumenting loads of the reference's own
# paper pickle and this repo's benchmark pickles — and everything under
# ``mppi_numba`` (and the JAX package) is stubbed.
_ALLOWED_GLOBALS = {
    ("builtins", "bytearray"), ("builtins", "slice"),
    ("builtins", "complex"), ("builtins", "frozenset"),
    ("collections", "OrderedDict"),
    ("numpy", "dtype"), ("numpy", "ndarray"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("pandas", "DataFrame"), ("pandas", "Index"), ("pandas", "RangeIndex"),
    ("pandas", "MultiIndex"), ("pandas", "Series"),
    ("pandas", "StringDtype"), ("pandas", "CategoricalDtype"),
    ("pandas._libs.internals", "_unpickle_block"),
    ("pandas.arrays", "ArrowStringArray"),
    ("pandas.core.frame", "DataFrame"),
    ("pandas.core.series", "Series"),
    ("pandas.core.indexes.base", "Index"),
    ("pandas.core.indexes.base", "_new_Index"),
    ("pandas.core.indexes.range", "RangeIndex"),
    ("pandas.core.internals.managers", "BlockManager"),
    ("pyarrow.lib", "_restore_array"),
    ("pyarrow.lib", "py_buffer"),
    ("pyarrow.lib", "type_for_alias"),
}


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("mppi_numba", "mppi_numba_tpu"):
            return type(name, (_StubState,), {"__module__": module})
        if (module, name) not in _ALLOWED_GLOBALS:
            raise pickle.UnpicklingError(
                "load_reference_experiment: refusing to resolve {}.{} from "
                "an untrusted reference pickle (not in the explicit "
                "allowlist of DataFrame/ndarray reconstruction globals)"
                .format(module, name))
        return super().find_class(module, name)


def load_reference_experiment(path):
    """Load an experiment pickle produced by the REFERENCE implementation.

    Reference pickles embed instances of its ``mppi_numba`` classes (e.g.
    ``Config``), which require a CUDA-capable import; those are replaced by
    attribute-preserving stubs so the DataFrames and numeric config are
    readable anywhere (reference: benchmark.ipynb[cell 7] writes them,
    benchmark_vis.ipynb[cell 2] reads them)."""
    with open(path, "rb") as fh:
        return _TolerantUnpickler(fh).load()
