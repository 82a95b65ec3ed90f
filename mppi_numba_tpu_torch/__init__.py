"""MPPI with probabilistic traversability in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100.

A port of ``mppi_numba_tpu`` (JAX/Pallas on a TPU), which stays the
reference.  This package imports neither JAX nor ``mppi_numba_tpu``, and
importing it needs neither pandas nor matplotlib (``benchmark.run_trials``
imports pandas when called; ``benchmark_vis`` and ``visualization`` are
imported by name).

Public surface (the JAX package's, plus the barebone planner):

    from mppi_numba_tpu_torch import Config, MPPIPlanner, TDM, Terrain, ...
    from mppi_numba_tpu_torch import BareboneConfig, BareboneMPPI
"""

from .barebone import BareboneConfig, BareboneMPPI
from .config import Config, SolverStatic
from .density import Density, GaussianMixture
from .terrain import (TDM, TDM_Numba, Terrain, TractionGrid,
                      cvar_bin_for_terrain_pmf, cvar_value_for_terrain_pmf,
                      condense_pmf_grid_det, risk_map_from_pmf_grid,
                      quantize_pmf_int8, unknown_mask_from_confidence,
                      sample_realization_from_pmf_grid)
from .mppi import MPPIPlanner, MPPI_Numba
from .types import BareboneTask, MapInputs, SolveAux, TerrainTask
from .sim import trial, simulate_step
from .benchmark import (make_benchmark_world, make_semantic_grid, run_trials,
                        default_benchmark_params, METHODS, PAPER_METHODS)

__version__ = "0.1.0"

__all__ = [
    "Config", "SolverStatic",
    "Density", "GaussianMixture",
    "TDM", "TDM_Numba", "Terrain", "TractionGrid",
    "cvar_bin_for_terrain_pmf", "cvar_value_for_terrain_pmf",
    "condense_pmf_grid_det", "risk_map_from_pmf_grid", "quantize_pmf_int8",
    "unknown_mask_from_confidence", "sample_realization_from_pmf_grid",
    "MPPIPlanner", "MPPI_Numba",
    "BareboneConfig", "BareboneMPPI",
    "TerrainTask", "MapInputs", "BareboneTask", "SolveAux",
    "trial", "simulate_step",
    "make_benchmark_world", "make_semantic_grid", "run_trials",
    "default_benchmark_params", "METHODS", "PAPER_METHODS",
]
