"""Tensor ops of the solve: costs, sampling, packing, rollout, CVaR, update.

The names the JAX package's ``mppi_numba_tpu.ops`` exports, with its
``__all__``.  ``sample_noise`` takes a ``torch.Generator`` where JAX's
takes a key; the map samplers take the key's two uint32 words as an int64
tensor.
"""

from .costs import stage_cost, term_cost, barebone_stage_cost, barebone_term_cost
from .sampling import sample_noise, sample_traction_grids, quantize_bin_values
from .packing import pack_map_words, unpack_lin, unpack_ang, unpack_cell_penalty_mask, unpack_risk
from .cvar import cvar_from_costs
from .update import update_useq

__all__ = [
    "stage_cost", "term_cost", "barebone_stage_cost", "barebone_term_cost",
    "sample_noise", "sample_traction_grids", "quantize_bin_values",
    "pack_map_words", "unpack_lin", "unpack_ang", "unpack_cell_penalty_mask",
    "unpack_risk", "cvar_from_costs", "update_useq",
]
