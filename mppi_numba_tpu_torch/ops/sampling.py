"""Random sampling ops: control noise and traction-map draws.

Randomness comes from an explicit ``torch.Generator``.  Each sampler is
split into a draw and a pure function of the drawn numbers, so the tests
can hand the JAX package's own draws to the pure part and compare the two
packages bit for bit.

The map draw is counter-addressed: the uniform of element ``i`` of a
``(M, H*W)`` draw is a function of a two-word key and ``i`` alone, the
partitionable threefry2x32 of ``jax.random.uniform``, bit for bit.  So a
window of the map (the reachable-window crop) or a slice of the M axis can
be drawn on its own and equals the same part of the full draw.  The
generator supplies only the key.
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


# -- counter-addressed uniforms ----------------------------------------------
#
# threefry2x32 as jax._src.prng._threefry2x32_lowering computes it: 20
# rounds of add, rotate and xor over 32-bit words, a key injection after
# every 4.  Here in int64 tensor ops, every value kept in [0, 2**32): each
# add and left shift is masked, and the right shift of a nonnegative int64
# is the logical shift of its uint32.

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KEY_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter pairs ``(x1, x2)`` under the key
    ``(k1, k2)``: int64 tensors (or ints) holding uint32 values; returns
    the two int64 output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KEY_PARITY)
    x1 = (x1 + ks[0]) & _MASK32
    x2 = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK32
            x2 = (((x2 << r) & _MASK32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x1, x2


def uniform01_at_counters(key, idx):
    """float32 uniforms in [0, 1) at the flat counters ``idx`` (an int64
    tensor of values in [0, 2**32)): ``jax.random.uniform(key, shape)`` at
    those flat positions, bit for bit.

    ``key`` is an int64 ``(2,)`` tensor of the two uint32 key words (JAX's
    ``jax.random.key_data``).  The bits are ``b1 ^ b2`` of threefry2x32 on
    the counter pair ``(0, idx)``; the float is ``(bits >> 9) | 0x3F800000``
    read as float32, minus 1.
    """
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(idx), idx)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _check_counter_range(total):
    if total >= 2 ** 32:
        raise NotImplementedError(
            "counter-addressed draws support M*H*W < 2**32 (got {})".format(
                total))


def uniform_window(key, num_samples, full_hw, oy, ox, window_hw, m_offset=0,
                   full_num_samples=None):
    """A window of ``jax.random.uniform(key, (full_M, H*W))``, bit for bit.

    Args:
      key: int64 ``(2,)`` tensor of uint32 key words.
      num_samples: M rows drawn.
      full_hw: the full padded (H, W) that the equivalent full draw covers.
      oy / ox: the window's first row and column: ints or 0-d integer
        tensors on the key's device (read there, never on the host).
      window_hw: (rH, rW).
      m_offset: the first map-sample row of the full draw.
      full_num_samples: M of the full draw (default ``num_samples``).

    Returns:
      float32 ``(num_samples, rH*rW)`` uniforms in [0, 1).
    """
    H, W = full_hw
    rH, rW = window_hw
    full_m = num_samples if full_num_samples is None else full_num_samples
    _check_counter_range(full_m * H * W)
    dev = key.device
    i64 = torch.int64
    m = (torch.arange(num_samples, device=dev, dtype=i64)
         + m_offset)[:, None, None]
    rows = (torch.arange(rH, device=dev, dtype=i64) + oy)[None, :, None]
    cols = (torch.arange(rW, device=dev, dtype=i64) + ox)[None, None, :]
    idx = m * (H * W) + rows * W + cols
    return uniform01_at_counters(key, idx).reshape(num_samples, rH * rW)


def draw_map_key(generator, device, lead=()):
    """One solve's map key: two uint32 words from ``generator``, as an
    int64 ``(2,)`` tensor on ``device``; ``lead + (2,)``, one key a
    scenario, for a leading scenario axis ``lead``."""
    return torch.randint(0, 2 ** 32, tuple(lead) + (2,), generator=generator,
                         device=device, dtype=torch.int64)


# -- ranks and decode ----------------------------------------------------------


def traction_bins_from_uniforms(u, pmf_grid, alpha_dyn):
    """Per-cell PMF bin indices from uniforms: int32 ``(M, H, W)``.

    ``sampled = ceil(u * (100 * alpha_dyn))`` in float32, then the bin
    index is ``sum_b(cum_b < sampled)`` over the int32 cumulative PMF.  A
    column whose mass sums below 100 can give index ``B`` (one past the
    last bin); ``decode_bins`` maps that index as the JAX package does.

    One pass: the count of ``cum_b < sampled`` is the left insertion point
    of ``sampled`` in the cell's cumulative sorted ascending (the sort
    changes nothing where the masses are nonnegative, and keeps the count
    exact for any int8 column), index ``B`` included.
    """
    B, H, W = pmf_grid.shape
    cum = torch.cumsum(pmf_grid.reshape(B, H * W).to(torch.int32), dim=0)
    cum = torch.sort(cum.t(), dim=1).values.contiguous()             # (HW, B)
    sampled = torch.ceil(u * (100.0 * alpha_dyn)).to(torch.int32)   # (M, HW)
    bin_idx = torch.searchsorted(cum, sampled.t().contiguous(),
                                 side="left", out_int32=True)        # (HW, M)
    return bin_idx.t().contiguous().reshape(u.shape[0], H, W)


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


# -- the JAX package's samplers ------------------------------------------------


def _sample_window(key, pmf_grid, qbin_values, alpha_dyn, num_samples,
                   window, m_window):
    """``sample_traction_bins`` and ``sample_traction_grids``: ``(bins,
    grids)`` (grids None without ``qbin_values``)."""
    _, H, W = pmf_grid.shape
    full_hw, oy, ox = window if window is not None else ((H, W), 0, 0)
    full_m, m0 = (m_window if m_window is not None
                  else (num_samples, 0))
    dev = pmf_grid.device
    if dev.type != "cuda":
        u = uniform_window(key, num_samples, full_hw, oy, ox, (H, W),
                           m_offset=m0, full_num_samples=full_m)
        bins = traction_bins_from_uniforms(u, pmf_grid, alpha_dyn)
        return bins, (None if qbin_values is None
                      else decode_bins(qbin_values, bins))
    from .kernels.map_sample import sample_traction_window

    def on_card(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    qbins = (torch.zeros(pmf_grid.shape[0], dtype=torch.int8, device=dev)
             if qbin_values is None else qbin_values)
    alpha = torch.as_tensor(alpha_dyn, dtype=torch.float32, device=dev)
    bins, _, grids, _ = sample_traction_window(
        key, pmf_grid, None, qbins, None, alpha, num_samples,
        window=None if window is None else (full_hw, on_card(oy),
                                            on_card(ox)),
        m_offset=int(m0), full_num_samples=full_m)
    return bins, (None if qbin_values is None else grids)


def sample_traction_bins(key, pmf_grid, alpha_dyn, num_samples, window=None,
                         m_window=None):
    """Per-cell PMF bin indices of ``num_samples`` sampled maps: int32
    ``(M, H, W)``; the JAX package's ``sample_traction_bins``, bit for bit.

    Args:
      key: int64 ``(2,)`` tensor of the draw's uint32 key words (JAX's
        ``jax.random.key_data``).
      pmf_grid: int8 ``(B, H, W)`` PMF.
      alpha_dyn: the quantile restriction (float, or float32 tensor).
      num_samples: M.
      window: ``(full_hw, oy, ox)`` when the PMF is a window of a
        ``full_hw`` map starting at ``(oy, ox)``: each cell's uniform is
        drawn at its global counter.
      m_window: ``(full_M, m_offset)``: rows ``[m_offset, m_offset + M)``
        of a ``full_M``-row draw.

    On the CPU: ``uniform_window`` then ``traction_bins_from_uniforms``.
    On a card: one launch of the map-sampling kernel in its bins mode
    (``ops.kernels.map_sample.sample_traction_window``).
    """
    return _sample_window(key, pmf_grid, None, alpha_dyn, num_samples,
                          window, m_window)[0]


def sample_traction_grids(key, pmf_grid, qbin_values, alpha_dyn, num_samples,
                          window=None, m_window=None):
    """``num_samples`` sampled int8 traction grids ``(M, H, W)``: the bins
    of ``sample_traction_bins`` decoded through ``qbin_values`` (int8
    ``(B,)``) by ``decode_bins``; the JAX package's
    ``sample_traction_grids``, bit for bit.  Arguments as for
    ``sample_traction_bins``; on a card one launch of the map-sampling
    kernel in its bins mode, which decodes in the same pass."""
    return _sample_window(key, pmf_grid, qbin_values, alpha_dyn,
                          num_samples, window, m_window)[1]
