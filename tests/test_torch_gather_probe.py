"""The gather probe's plain chains vs the JAX package's gather probe
(``scripts/gather_probe.py``), bit for bit.

The script is loaded by path: importing it registers its two probe
primitives with JAX (and their lowerings), which is why this test has a
file of its own.  Its ``reference(_cg_ref | _fg_ref, ...)`` is the chain's
semantics on the CPU; the kernel is held against the plain chains on a
card in test_torch_kernels_gpu.py and chip_smoke.py.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from mppi_numba_tpu_torch.probes import gather_probe

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "gather_probe.py")
ITERS = 16


@pytest.fixture(scope="module")
def tpu_probe():
    spec = importlib.util.spec_from_file_location("tpu_gather_probe", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    # The script puts its own checkout's root on sys.path when it loads;
    # that entry must not outlive the load.
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def _inputs(mode, S, R=32, L=128, seed=0):
    """The TPU probe's own input recipe (its ``probe``), from numpy."""
    rng = np.random.RandomState(seed)
    mod = S * (L if mode == "flat" else 1)
    table = rng.randint(0, 1 << 20, size=(S, L)).astype(np.int32)
    idx = rng.randint(0, mod, size=(R, L)).astype(np.int32)
    return table, idx, mod


@pytest.mark.parametrize("S", [8, 64])
@pytest.mark.parametrize("mode", ["column", "flat"])
def test_plain_chain_matches_tpu_probe_reference(tpu_probe, mode, S):
    table, idx, mod = _inputs(mode, S, seed=S)
    ref = tpu_probe._cg_ref if mode == "column" else tpu_probe._fg_ref
    want = tpu_probe.reference(ref, table, idx, mod, iters=ITERS)
    chain, plain = gather_probe.CHAINS[mode]
    got = plain(torch.tensor(table), torch.tensor(idx), mod, ITERS)
    assert got.dtype == torch.int32 and got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # On CPU tensors the wrapper runs the plain chain and launches nothing.
    launches = chain.launches
    np.testing.assert_array_equal(
        chain(torch.tensor(table), torch.tensor(idx), mod, ITERS).numpy(),
        want)
    assert chain.launches == launches


@pytest.mark.parametrize("mode", ["column", "flat"])
def test_plain_chain_marks_the_entries_it_reads(mode):
    """``seen`` is set at exactly the flat table entries the chain reads,
    counted here with numpy."""
    S, L, iters = 64, 128, ITERS
    table, idx, mod = _inputs(mode, S, R=4, seed=3)
    want = np.zeros(S * L, bool)
    x = idx.astype(np.int64)
    lane = np.arange(L)
    for _ in range(iters):
        cell = x % (S * L) if mode == "flat" else (x % S) * L + lane
        want[cell] = True
        x = (table.reshape(-1)[cell] ^ x) % mod
    seen = torch.zeros(S * L, dtype=torch.bool)
    _, plain = gather_probe.CHAINS[mode]
    got = plain(torch.tensor(table), torch.tensor(idx), mod, iters, seen)
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(seen.numpy(), want)
    assert 0 < want.sum() < S * L


def test_inputs_and_probe_need_a_card():
    """The probe's input recipe keeps the chain's values nonnegative (where
    the kernel's unsigned % equals the reference's); its run needs a card."""
    for mode in gather_probe.MODES:
        table, idx, mod = gather_probe.make_inputs(mode, 64, 32, "cpu")
        assert mod == (64 * 128 if mode == "flat" else 64)
        assert table.shape == (64, 128) and idx.shape == (32, 128)
        assert int(table.min()) >= 0 and int(table.max()) < 1 << 20
        assert int(idx.min()) >= 0 and int(idx.max()) < mod
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe runs there, not here")
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_probe.run()
