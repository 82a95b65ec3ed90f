"""MPPI with probabilistic traversability in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100.

A port of ``mppi_numba_tpu`` (JAX/Pallas on a TPU), which stays the
reference.  This package imports neither JAX nor ``mppi_numba_tpu``.

Public surface:

    from mppi_numba_tpu_torch import Config, MPPIPlanner, TDM, ...
"""

from .config import Config, SolverStatic
from .mppi import MPPIPlanner
from .terrain import TDM, quantize_pmf_int8
from .types import MapInputs, SolveAux, TerrainTask

__version__ = "0.1.0"

__all__ = [
    "Config", "SolverStatic",
    "TDM", "quantize_pmf_int8",
    "MPPIPlanner",
    "TerrainTask", "MapInputs", "SolveAux",
]
