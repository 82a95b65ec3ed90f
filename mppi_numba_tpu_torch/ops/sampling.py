"""Random sampling ops: control noise and traction-map draws.

Randomness comes from an explicit ``torch.Generator``.  Each sampler is
split into a draw and a pure function of the drawn numbers, so the tests
can hand the JAX package's own draws to the pure part and compare the two
packages bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_noise(generator, u_std, num_rollouts, num_steps):
    """Draw the (K, T, 2) Gaussian control perturbations for one iteration."""
    eps = torch.randn((num_rollouts, num_steps, 2), generator=generator,
                      device=u_std.device, dtype=torch.float32)
    return eps * u_std


def quantize_bin_values(bin_values, bin_values_bounds):
    """Quantize bin traction values to the int8 0..100 map encoding:
    ``int8(100 * (bin_values - lb) / range)`` in float32, truncating."""
    bin_values = np.asarray(bin_values, dtype=np.float32)
    lb, ub = np.float32(bin_values_bounds[0]), np.float32(bin_values_bounds[1])
    rng = ub - lb
    return (np.float32(100.0) * (bin_values - lb) / rng).astype(np.int8)


def draw_map_uniforms(generator, num_samples, num_cells, device):
    """The per-cell uniforms of one solve's map draw: float32 (M, H*W)."""
    return torch.rand((num_samples, num_cells), generator=generator,
                      device=device, dtype=torch.float32)


def traction_bins_from_uniforms(u, pmf_grid, alpha_dyn):
    """Per-cell PMF bin indices from uniforms: int32 ``(M, H, W)``.

    ``sampled = ceil(u * (100 * alpha_dyn))`` in float32, then the bin
    index is ``sum_b(cum_b < sampled)`` over the int32 cumulative PMF.  A
    column whose mass sums below 100 can give index ``B`` (one past the
    last bin); ``decode_bins`` maps that index as the JAX package does.
    """
    B, H, W = pmf_grid.shape
    cum = torch.cumsum(pmf_grid.reshape(B, H * W).to(torch.int32), dim=0)
    sampled = torch.ceil(u * (100.0 * alpha_dyn)).to(torch.int32)   # (M, HW)
    # One compare per bin keeps the working set at (M, HW) instead of
    # (B, M, HW): an integer sum, identical in any order.
    bin_idx = torch.zeros_like(sampled)
    for b in range(B):
        bin_idx += (cum[b] < sampled).to(torch.int32)
    return bin_idx.reshape(u.shape[0], H, W)


# Value of a bin index one past the last bin: what ``jnp.take``'s default
# "fill" mode returns for an out-of-range index of an int8 table.
_FILL_INT8 = -128


def decode_bins(qbin_values, bin_idx):
    """Bin indices -> quantized int8 traction values (0..100).

    Index ``B`` (a draw past the end of a column that sums below 100)
    decodes to -128, as ``jnp.take`` fills it in the JAX package.
    """
    fill = torch.full((1,), _FILL_INT8, dtype=qbin_values.dtype,
                      device=qbin_values.device)
    lut = torch.cat([qbin_values, fill])
    return torch.index_select(lut, 0, bin_idx.reshape(-1)).reshape(
        bin_idx.shape)
