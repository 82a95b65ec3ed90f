"""The JAX package's ``ops`` names in the port: the same ``__all__``, the
map samplers bit for bit with JAX's at JAX's keys, the unpackers exact on
both packages' words, and the config constants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_numba_tpu.config as jconfig
import mppi_numba_tpu.ops as jops
import mppi_numba_tpu_torch.config as tconfig
import mppi_numba_tpu_torch.ops as tops


def _key_words(key):
    return torch.tensor(np.asarray(jax.random.key_data(key)).astype(np.int64))


def _pmf(rng, B, H, W):
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    raw[0] += 1.0
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    return pmf


def test_ops_all_equals_jax():
    assert tops.__all__ == jops.__all__
    assert len(tops.__all__) == 14
    namespace = {}
    exec("from mppi_numba_tpu_torch.ops import *", namespace)
    assert set(jops.__all__) <= set(namespace)
    assert all(callable(namespace[name]) for name in jops.__all__)


def test_config_constants_equal():
    for name in ("max_threads_per_block", "max_square_block_dim",
                 "max_blocks"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name


# (window start, m_window, alpha, alpha passed as a Python float)
SAMPLER_CASES = {
    "whole": (None, None, 1.0, False),
    "whole_alpha_0.3": (None, None, 0.3, False),
    "whole_alpha_0.2_python_float": (None, None, 0.2, True),
    "window": ((4, 6), None, 1.0, False),
    "m_window": (None, (20, 7), 1.0, False),
    "window_m_window_alpha_0.4": ((9, 2), (13, 5), 0.4, False),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_samplers_bitwise_with_jax(case):
    """``sample_traction_bins`` and ``sample_traction_grids`` of the port
    (on the CPU: ``uniform_window``, the ranks, the decode) equal JAX's at
    JAX's key words, for the whole map, a window of a larger map, rows of a
    larger draw, and alpha below 1."""
    start, m_window, alpha, python_float = SAMPLER_CASES[case]
    rng = np.random.RandomState(3)
    B, H, W, M = 12, 7, 9, 6
    pmf = _pmf(rng, B, H, W)
    qbins = np.sort(rng.choice(101, B, replace=False)).astype(np.int8)
    key = jax.random.PRNGKey(11)
    j_alpha = alpha if python_float else jnp.float32(alpha)
    t_alpha = alpha if python_float else torch.tensor(alpha,
                                                      dtype=torch.float32)
    j_kw, t_kw = {}, {}
    if start is not None:
        full_hw = (H + 12, W + 10)
        j_kw["window"] = (full_hw, jnp.int32(start[0]), jnp.int32(start[1]))
        t_kw["window"] = (full_hw, start[0], start[1])
    if m_window is not None:
        j_kw["m_window"] = t_kw["m_window"] = m_window
    want_bins = np.asarray(jops.sampling.sample_traction_bins(
        key, jnp.asarray(pmf), j_alpha, M, **j_kw))
    want_grids = np.asarray(jops.sample_traction_grids(
        key, jnp.asarray(pmf), jnp.asarray(qbins), j_alpha, M, **j_kw))
    bins = tops.sampling.sample_traction_bins(
        _key_words(key), torch.tensor(pmf), t_alpha, M, **t_kw)
    grids = tops.sample_traction_grids(
        _key_words(key), torch.tensor(pmf), torch.tensor(qbins), t_alpha, M,
        **t_kw)
    assert bins.dtype == torch.int32 and grids.dtype == torch.int8
    np.testing.assert_array_equal(bins.numpy(), want_bins)
    np.testing.assert_array_equal(grids.numpy(), want_grids)


@pytest.mark.parametrize("with_risk", [False, True])
def test_unpackers_exact_on_both_packages_words(with_risk):
    """Each unpacker returns the field it reads, on the words either
    package's ``pack_map_words`` writes (and the two packages' words are
    the same), the -128 fill value's sign extension included."""
    rng = np.random.RandomState(5)
    M, H, W = 4, 6, 7
    lin = rng.randint(0, 101, (M, H, W)).astype(np.int8)
    ang = rng.randint(0, 101, (M, H, W)).astype(np.int8)
    lin[0, 0, :2] = -128
    obs = (rng.rand(H, W) < 0.3).astype(np.int8)
    unk = (rng.rand(H, W) < 0.3).astype(np.int8)
    risk = rng.randint(0, 101, (H, W)).astype(np.int8) if with_risk else None
    j_words = np.asarray(jops.pack_map_words(
        jnp.asarray(lin), jnp.asarray(ang), jnp.asarray(obs),
        jnp.asarray(unk), None if risk is None else jnp.asarray(risk)))
    t_words = tops.pack_map_words(
        torch.tensor(lin), torch.tensor(ang), torch.tensor(obs),
        torch.tensor(unk), None if risk is None else torch.tensor(risk))
    np.testing.assert_array_equal(t_words.numpy(), j_words)
    for words in (t_words, torch.tensor(j_words)):
        jw = jnp.asarray(words.numpy())
        for name in ("unpack_lin", "unpack_ang", "unpack_risk"):
            got = getattr(tops, name)(words)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(jops, name)(jw)))
        obs_t, unk_t = tops.unpack_cell_penalty_mask(words)
        obs_j, unk_j = jops.unpack_cell_penalty_mask(jw)
        np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
        np.testing.assert_array_equal(unk_t.numpy(), np.asarray(unk_j))
        # Each field as packed, where no -128 lin byte sign-extends over
        # the fields above it (there every bit above it reads 1).
        ok = lin >= 0
        filled = {"ang": 255, "obs": 1, "risk": 255}
        fields = {"ang": (tops.unpack_ang(words), ang),
                  "obs": (obs_t, np.broadcast_to(obs, (M, H, W))),
                  "risk": (tops.unpack_risk(words),
                           np.broadcast_to(0 if risk is None else risk,
                                           (M, H, W)))}
        for name, (got, want) in fields.items():
            got = got.numpy()
            np.testing.assert_array_equal(got[ok], want[ok].astype(np.int32))
            assert (got[~ok] == filled[name]).all(), name
        np.testing.assert_array_equal(tops.unpack_lin(words).numpy(),
                                      lin.astype(np.int32) & 0xFF)
