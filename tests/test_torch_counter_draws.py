"""The port's counter-addressed map draws vs the JAX package's: threefry2x32
uniforms at flat counters, the full draw, windows of it, and the plain
version of the ``map_sample`` kernel, all bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.ops import sampling as jsampling
from mppi_numba_tpu_torch.ops import sampling as tsampling
from mppi_numba_tpu_torch.ops.kernels import map_sample

# Keys with small and with large words (a split key fills all 32 bits).
_KEYS = [jax.random.PRNGKey(0), jax.random.PRNGKey(7),
         jax.random.split(jax.random.PRNGKey(1234))[1]]


def _port_key(key):
    return torch.tensor(np.asarray(jax.random.key_data(key)).astype(np.int64))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("key_index", range(len(_KEYS)))
def test_uniform01_at_counters_bitwise(key_index):
    key = _KEYS[key_index]
    rng = np.random.RandomState(key_index)
    idx = np.concatenate([
        rng.randint(0, 2 ** 32, size=4000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                 np.uint32)])
    want = np.asarray(jsampling._uniform01_at_counters(key, jnp.asarray(idx)))
    got = tsampling.uniform01_at_counters(_port_key(key),
                                          torch.tensor(idx.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("key_index", range(len(_KEYS)))
def test_full_draw_equals_jax_random_uniform(key_index):
    key = _KEYS[key_index]
    M, H, W = 6, 13, 19
    want = np.asarray(jax.random.uniform(key, (M, H * W)))
    got = tsampling.uniform_window(_port_key(key), M, (H, W), 0, 0, (H, W))
    assert got.shape == (M, H * W)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("oy,ox,rH,rW,m_offset", [
    (0, 0, 17, 23, 0), (3, 4, 7, 9, 0), (10, 15, 7, 8, 0),   # tests/test_roi.py
    (10, 15, 7, 8, 3)])
def test_uniform_window_bitwise(oy, ox, rH, rW, m_offset):
    key = _KEYS[2]
    M, full_m, H, W = 2, 5, 17, 23
    want = np.asarray(jsampling.uniform_window(
        key, M, (H, W), jnp.int32(oy), jnp.int32(ox), (rH, rW),
        m_offset=m_offset, full_num_samples=full_m))
    got = tsampling.uniform_window(
        _port_key(key), M, (H, W), torch.tensor(oy, dtype=torch.int32),
        torch.tensor(ox, dtype=torch.int32), (rH, rW), m_offset=m_offset,
        full_num_samples=full_m)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # The window is the same part of the full draw.
    full = np.asarray(jax.random.uniform(key, (full_m, H * W))).reshape(
        full_m, H, W)
    np.testing.assert_array_equal(
        got.numpy().reshape(M, rH, rW),
        full[m_offset:m_offset + M, oy:oy + rH, ox:ox + rW])


def _pmf(rng, B, H, W, unnormalized):
    raw = rng.randint(0, 100, size=(B, H, W)).astype(float)
    raw[0] += 1.0
    pmf = (raw / raw.sum(0) * 100).astype(np.int8)
    pmf[-1] = 100 - pmf[:-1].sum(0)
    if unnormalized:
        pmf[:, 5, 9:13] = 0                 # inside every window below
        pmf[0, 5, 9:13] = (5, 15, 30, 60)   # columns summing below 100
    return pmf


@pytest.mark.parametrize("alpha_dyn", [1.0, 0.2])
@pytest.mark.parametrize("case", ["full", "window", "window_m_offset",
                                  "unnormalized"])
def test_sample_traction_window_plain_matches_jax(case, alpha_dyn):
    """The plain version of the map_sample kernel equals JAX's
    ``sample_traction_bins(window=..., m_window=...)`` + ``decode_bins`` for
    lin and ang, bins and grids, bit for bit."""
    rng = np.random.RandomState(3)
    H, W, M, full_m = 15, 21, 4, 7
    window = case != "full"
    oy, ox, rH, rW = (4, 9, 8, 10) if window else (0, 0, H, W)
    m_offset = 2 if case == "window_m_offset" else 0
    key = _KEYS[1]
    lin = _pmf(rng, 12, H, W, case == "unnormalized")
    ang = _pmf(rng, 5, H, W, case == "unnormalized")
    lq = np.sort(rng.choice(101, 12, replace=False)).astype(np.int8)
    aq = np.sort(rng.choice(101, 5, replace=False)).astype(np.int8)
    crop = (slice(None), slice(oy, oy + rH), slice(ox, ox + rW))
    jwin = ((H, W), jnp.int32(oy), jnp.int32(ox)) if window else None
    mwin = (full_m, m_offset) if case == "window_m_offset" else None
    want = []
    for pmf, q in ((lin, lq), (ang, aq)):
        bins = jsampling.sample_traction_bins(
            key, jnp.asarray(pmf[crop]), jnp.float32(alpha_dyn), M,
            window=jwin, m_window=mwin)
        want.append((np.asarray(bins),
                     np.asarray(jsampling.decode_bins(jnp.asarray(q), bins))))
    twin = (((H, W), torch.tensor(oy, dtype=torch.int32),
             torch.tensor(ox, dtype=torch.int32)) if window else None)
    before = map_sample.sample_traction_window.launches
    got = map_sample.sample_traction_window(
        _port_key(key), torch.tensor(lin[crop].copy()),
        torch.tensor(ang[crop].copy()), torch.tensor(lq), torch.tensor(aq),
        torch.tensor(alpha_dyn, dtype=torch.float32), M, window=twin,
        m_offset=m_offset,
        full_num_samples=full_m if case == "window_m_offset" else None)
    assert map_sample.sample_traction_window.launches == before  # CPU: plain
    lin_bins, ang_bins, lin_grids, ang_grids = got
    for t, dtype in ((lin_bins, torch.int32), (ang_bins, torch.int32),
                     (lin_grids, torch.int8), (ang_grids, torch.int8)):
        assert t.dtype == dtype and t.shape == (M, rH, rW)
    np.testing.assert_array_equal(lin_bins.numpy(), want[0][0])
    np.testing.assert_array_equal(ang_bins.numpy(), want[1][0])
    np.testing.assert_array_equal(lin_grids.numpy(), want[0][1])
    np.testing.assert_array_equal(ang_grids.numpy(), want[1][1])
    if case == "unnormalized" and alpha_dyn == 1.0:
        assert (lin_grids.numpy() == -128).any()   # past the last bin
    # With no ang plane (TDM.sample_grids) the lin outputs are the same.
    lin_only = map_sample.sample_traction_window(
        _port_key(key), torch.tensor(lin[crop].copy()), None,
        torch.tensor(lq), None, torch.tensor(alpha_dyn, dtype=torch.float32),
        M, window=twin, m_offset=m_offset,
        full_num_samples=full_m if case == "window_m_offset" else None)
    assert lin_only[1] is None and lin_only[3] is None
    np.testing.assert_array_equal(lin_only[0].numpy(), want[0][0])
    np.testing.assert_array_equal(lin_only[2].numpy(), want[0][1])


def test_counter_range_guard_raises():
    """A draw of M*H*W >= 2**32 elements cannot be counter-addressed with
    32-bit counters: refused, as in the JAX package."""
    key = _port_key(_KEYS[0])
    with pytest.raises(NotImplementedError, match="2\\*\\*32"):
        tsampling.uniform_window(key, 1, (65536, 65536), 0, 0, (1, 1))
    with pytest.raises(NotImplementedError, match="2\\*\\*32"):
        tsampling.uniform_window(key, 1, (256, 256), 0, 0, (1, 1),
                                 full_num_samples=65536)
    pmf = torch.full((1, 1, 1), 100, dtype=torch.int8)
    q = torch.zeros(1, dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        map_sample.sample_traction_window(
            key, pmf, pmf, q, q, 1.0, 1,
            window=((65536, 65536), 0, 0))
    # The largest draw below the limit is allowed.
    tsampling.uniform_window(key, 1, (65535, 65536), 65534, 65535, (1, 1))


def test_draw_map_key_words_are_uint32():
    g = torch.Generator().manual_seed(0)
    keys = torch.stack([tsampling.draw_map_key(g, torch.device("cpu"))
                        for _ in range(200)])
    assert keys.dtype == torch.int64
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    assert int(keys.max()) >= 2 ** 31           # the high bit is drawn
