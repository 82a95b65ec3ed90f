"""Port sampling and packing vs the JAX package: bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.ops import packing as jpacking
from mppi_numba_tpu.ops import sampling as jsampling
from mppi_numba_tpu_torch.ops import packing as tpacking
from mppi_numba_tpu_torch.ops import sampling as tsampling


def _pmf_grid(rng, B=22, H=11, W=13, unnormalized_cells=0):
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    raw[rng.rand(B, H, W) < 0.4] = 0.0
    raw[0] += 1.0
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    for i in range(unnormalized_cells):
        pmf[:, i % H, (3 * i) % W] = 0
        pmf[1, i % H, (3 * i) % W] = 7 + i
    return pmf


@pytest.mark.parametrize("alpha_dyn", [1.0, 0.4])
@pytest.mark.parametrize("unnormalized", [0, 5])
def test_traction_bins_bitwise(alpha_dyn, unnormalized):
    rng = np.random.RandomState(11)
    pmf = _pmf_grid(rng, unnormalized_cells=unnormalized)
    B, H, W = pmf.shape
    M = 9
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsampling.sample_traction_bins(
        key, jnp.asarray(pmf), jnp.float32(alpha_dyn), M))
    u = np.asarray(jax.random.uniform(key, (M, H * W), dtype=jnp.float32))
    got = tsampling.traction_bins_from_uniforms(
        torch.tensor(u), torch.tensor(pmf),
        torch.tensor(alpha_dyn, dtype=torch.float32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if unnormalized:
        assert (want == B).any()      # the off-the-end draw is exercised


def test_decode_bins_bitwise_including_index_past_last_bin():
    """Index B (a draw past a column summing below 100) decodes to -128,
    as jnp.take's default fill does: it is not clamped to the last bin."""
    rng = np.random.RandomState(12)
    B = 22
    qbins = np.linspace(0, 100, B).astype(np.int8)
    idx = rng.randint(0, B + 1, size=(5, 7, 9)).astype(np.int32)
    idx[0, 0, 0] = B
    want = np.asarray(jsampling.decode_bins(jnp.asarray(qbins),
                                            jnp.asarray(idx)))
    got = tsampling.decode_bins(torch.tensor(qbins), torch.tensor(idx))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0].item() == -128


def test_quantize_bin_values_equal():
    bv = np.linspace(0.0, 1.0, 22)
    np.testing.assert_array_equal(
        tsampling.quantize_bin_values(bv, (0.0, 1.0)),
        jsampling.quantize_bin_values(bv, (0.0, 1.0)))


@pytest.mark.parametrize("with_risk", [False, True])
def test_pack_map_words_bitwise(with_risk):
    rng = np.random.RandomState(13)
    M, H, W = 6, 9, 11
    lin = rng.randint(0, 101, (M, H, W)).astype(np.int8)
    ang = rng.randint(0, 101, (M, H, W)).astype(np.int8)
    lin[0, 0, :3] = -128                  # decode fill values
    ang[0, 1, :3] = -128
    obs = (rng.rand(H, W) < 0.2).astype(np.int8)
    unk = (rng.rand(H, W) < 0.2).astype(np.int8)
    risk = rng.randint(0, 101, (H, W)).astype(np.int8)
    want = np.asarray(jpacking.pack_map_words(
        jnp.asarray(lin), jnp.asarray(ang), jnp.asarray(obs),
        jnp.asarray(unk), jnp.asarray(risk) if with_risk else None))
    got = tpacking.pack_map_words(
        torch.tensor(lin), torch.tensor(ang), torch.tensor(obs),
        torch.tensor(unk), torch.tensor(risk) if with_risk else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0].item() == np.int32(-128)    # 0xFFFFFF80


def test_sample_noise_scaling():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    u_std = torch.tensor([2.0, 3.0])
    noise = tsampling.sample_noise(g1, u_std, 300, 40)
    eps = torch.randn((300, 40, 2), generator=g2)
    assert noise.shape == (300, 40, 2) and noise.dtype == torch.float32
    np.testing.assert_array_equal(noise.numpy(), (eps * u_std).numpy())
    std = noise.reshape(-1, 2).std(0).numpy()
    np.testing.assert_allclose(std, [2.0, 3.0], rtol=0.05)


def test_map_draw_from_generator():
    """A solve's map draw: a key of two uint32 words from the generator,
    then the counter-addressed uniforms of that key."""
    rng = np.random.RandomState(14)
    pmf = torch.tensor(_pmf_grid(rng))
    B, H, W = pmf.shape
    key = tsampling.draw_map_key(torch.Generator().manual_seed(3),
                                 torch.device("cpu"))
    want = torch.randint(0, 2 ** 32, (2,),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int64)
    assert key.dtype == torch.int64 and key.shape == (2,)
    np.testing.assert_array_equal(key.numpy(), want.numpy())
    assert ((key >= 0) & (key < 2 ** 32)).all()
    u = tsampling.uniform_window(key, 4, (H, W), 0, 0, (H, W))
    assert u.shape == (4, H * W) and u.dtype == torch.float32
    assert ((u >= 0) & (u < 1)).all()
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jax.random.uniform(
            jnp.asarray(key.numpy().astype(np.uint32)), (4, H * W))))
    bins = tsampling.traction_bins_from_uniforms(u, pmf, torch.tensor(1.0))
    assert bins.shape == (4, H, W) and int(bins.max()) < B


def _per_bin_loop(u, pmf_grid, alpha_dyn):
    """The rank as one compare, cast and add per bin: the oracle of the
    one-pass ``traction_bins_from_uniforms``."""
    B, H, W = pmf_grid.shape
    cum = torch.cumsum(pmf_grid.reshape(B, H * W).to(torch.int32), dim=0)
    sampled = torch.ceil(u * (100.0 * alpha_dyn)).to(torch.int32)
    bin_idx = torch.zeros_like(sampled)
    for b in range(B):
        bin_idx += (cum[b] < sampled).to(torch.int32)
    return bin_idx.reshape(u.shape[0], H, W)


@pytest.mark.parametrize("alpha_dyn", [0.2, 1.0])
@pytest.mark.parametrize("B", [1, 2, 4, 12, 22])
def test_traction_bins_one_pass_equals_per_bin_loop(B, alpha_dyn):
    """The one-pass rank equals the per-bin loop bit for bit, columns that
    sum below 100 included (their draws past the last bin give index B)."""
    rng = np.random.RandomState(B)
    H, W, M = 9, 14, 33
    pmf = _pmf_grid(rng, B=B, H=H, W=W)
    pmf[:, 0, :5] = 0                       # columns summing to 0..40
    pmf[0, 0, :5] = np.arange(0, 50, 10)
    pmf[-1, 1, :3] = 0                      # the last bin's mass dropped
    u = torch.rand((M, H * W), generator=torch.Generator().manual_seed(B))
    u[0, :4] = torch.tensor([0.0, 0.5, 0.999999, 0.2])
    alpha = torch.tensor(alpha_dyn, dtype=torch.float32)
    want = _per_bin_loop(u, torch.tensor(pmf), alpha)
    got = tsampling.traction_bins_from_uniforms(u, torch.tensor(pmf), alpha)
    assert got.dtype == torch.int32 and got.shape == (M, H, W)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want == B).any()                # past the last bin
