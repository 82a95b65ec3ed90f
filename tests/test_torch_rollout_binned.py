"""The binned layouts of the port vs the JAX package: the packers and the
LUT bit for bit, the binned kernel's plain version against the JAX
package's interpret-mode binned kernel, and each binned layout against the
byte layout.  The kernel itself is tested on a card in
test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu.ops import packing as jpacking
from mppi_numba_tpu.ops.pallas.rollout_kernel import (
    build_bin_luts as j_build_bin_luts, build_task_vec as j_build_task_vec,
    terrain_rollout_costs_pallas_binned)
from mppi_numba_tpu.ops.rollout import _clipped_controls_tk as j_clipped
from mppi_numba_tpu.types import TerrainTask as JTask
from mppi_numba_tpu_torch.convert import task_to_port
from mppi_numba_tpu_torch.ops import packing as tpacking
from mppi_numba_tpu_torch.ops.kernels import rollout_binned, rollout_byte
from mppi_numba_tpu_torch.ops.rollout import _clipped_controls_tk
from mppi_numba_tpu_torch.ops.sampling import decode_bins

RTOL, ATOL = 1e-5, 1e-4      # tests/test_pallas_kernel.py's own tolerance
# cell_bits -> PMF bins of the test maps: the most each plane can index, so
# that a draw one past the last bin spills into the neighbouring field
# (crumbs, nibbles); byte pairs carry decoded values, -128 included.
BINS = {2: 4, 4: 16, 8: 22}


def _task():
    f32 = np.float32
    return JTask(
        x0=np.array([4.0, 3.0, 0.3], f32), xgoal=np.array([18.0, 12.0], f32),
        goal_tolerance=f32(0.5), v_post_rollout=f32(0.01),
        lambda_weight=f32(1.0), u_std=np.array([1.0, 1.5], f32),
        vrange=np.array([0.0, 2.0], f32), wrange=np.array([-3.0, 3.0], f32),
        dt=f32(0.1), dist_weight=f32(1.0), obs_penalty=f32(1e4),
        unknown_penalty=f32(1e2), alpha_dyn=f32(1.0), res=f32(1.0),
        xlim0=f32(0.0), ylim0=f32(0.0), lin_lb=f32(0.0),
        lin_ratio=f32(0.01), ang_lb=f32(0.0), ang_ratio=f32(0.01))


def _problem(cell_bits, seed, K=128, M=5, T=16, H=21, W=30,
             past_last=True):
    """Bin indices (0..B, B only when ``past_last``), their decoded grids,
    the shared planes, the quantized bin values, controls and noise."""
    rng = np.random.RandomState(seed)
    B = BINS[cell_bits]
    hi = B + 1 if past_last else B
    lin_bins = rng.randint(0, hi, (M, H, W)).astype(np.int32)
    ang_bins = rng.randint(0, hi, (M, H, W)).astype(np.int32)
    qbins = np.sort(rng.choice(101, B, replace=False)).astype(np.int8)
    obs = (rng.rand(H, W) < 0.1).astype(np.int8)
    unk = (rng.rand(H, W) < 0.1).astype(np.int8)
    risk = rng.randint(1, 101, (H, W)).astype(np.int8)
    u = rng.uniform(-0.5, 1.5, (T, 2)).astype(np.float32)
    noise = rng.randn(K, T, 2).astype(np.float32)
    return dict(lin_bins=lin_bins, ang_bins=ang_bins, qbins=qbins, obs=obs,
                unk=unk, risk=risk, u=u, noise=noise, H=H, W=W, T=T)


def _grids(p):
    """Decoded int8 grids, the -128 fill past the last bin included."""
    q = torch.tensor(p["qbins"])
    return (decode_bins(q, torch.tensor(p["lin_bins"])).numpy(),
            decode_bins(q, torch.tensor(p["ang_bins"])).numpy())


def _cells(pkg, cell_bits, p):
    """The cell plane of ``pkg`` ('jax' or 'port') for ``cell_bits``."""
    if cell_bits == 8:
        a, b = _grids(p)
    else:
        a, b = p["lin_bins"], p["ang_bins"]
    mod, wrap = ((jpacking, jnp.asarray) if pkg == "jax"
                 else (tpacking, torch.tensor))
    fn = {2: mod.pack_bin_crumbs, 4: mod.pack_bin_nibbles,
          8: mod.pack_byte_pairs}[cell_bits]
    return fn(wrap(a), wrap(b))


@pytest.mark.parametrize("shape", [(3, 4, 8), (3, 5, 7), (2, 1, 1)])
@pytest.mark.parametrize("cell_bits", [2, 4, 8])
def test_cell_packers_bitwise(cell_bits, shape):
    """Ragged H*W zero-pads the last word; a bin one past the last spills
    its top bit into the ang field; a -128 value sign-extends."""
    M, H, W = shape
    p = _problem(cell_bits, seed=cell_bits, M=M, H=H, W=W)
    p["lin_bins"][0, 0, 0] = BINS[cell_bits]          # past the last bin
    want = np.asarray(_cells("jax", cell_bits, p))
    got = _cells("port", cell_bits, p)
    assert got.dtype == torch.int32
    assert got.shape == (M, -(-(H * W) // (32 // (2 * cell_bits))))
    np.testing.assert_array_equal(got.numpy(), want)
    if cell_bits == 8:
        assert got[0, 0].item() & 0xFFFF == 0xFF80    # -128, sign-extended


@pytest.mark.parametrize("shape", [(4, 8), (5, 7), (21, 30), (1, 1)])
def test_shared_plane_packers_bitwise(shape):
    p = _problem(4, seed=7, M=1, H=shape[0], W=shape[1])
    want = np.asarray(jpacking.pack_mask_nibbles(jnp.asarray(p["obs"]),
                                                 jnp.asarray(p["unk"])))
    got = tpacking.pack_mask_nibbles(torch.tensor(p["obs"]),
                                     torch.tensor(p["unk"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jpacking.pack_risk_bytes(jnp.asarray(p["risk"])))
    got = tpacking.pack_risk_bytes(torch.tensor(p["risk"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lin_bins,ang_bins", [(4, 4), (12, 9), (16, 16)])
def test_build_bin_luts_bitwise(lin_bins, ang_bins):
    rng = np.random.RandomState(lin_bins)
    task = _task()._replace(lin_lb=np.float32(0.05),
                            lin_ratio=np.float32(0.0093),
                            ang_lb=np.float32(0.1),
                            ang_ratio=np.float32(0.0071))
    lq = np.sort(rng.choice(101, lin_bins, replace=False)).astype(np.int8)
    aq = np.sort(rng.choice(101, ang_bins, replace=False)).astype(np.int8)
    jt = JTask(*(None if x is None else jnp.asarray(x) for x in task))
    want = np.asarray(j_build_bin_luts(jt, jnp.asarray(lq), jnp.asarray(aq)))
    got = rollout_binned.build_bin_luts(task_to_port(task, "cpu"),
                                        torch.tensor(lq), torch.tensor(aq))
    assert got.shape == (2, rollout_binned.LUT_BINS)
    np.testing.assert_array_equal(got.numpy(), want[:2, :got.shape[1]])
    assert not want[:2, got.shape[1]:].any() and not want[2:].any()


def _port_args(cell_bits, p, speed_map):
    """The binned wrapper's positional arguments for problem ``p``."""
    pt = task_to_port(_task(), "cpu")
    mask = tpacking.pack_mask_nibbles(torch.tensor(p["obs"]),
                                      torch.tensor(p["unk"]))
    q = torch.tensor(p["qbins"])
    lut = (None if cell_bits == 8
           else rollout_binned.build_bin_luts(pt, q, q))
    risk = (tpacking.pack_risk_bytes(torch.tensor(p["risk"])) if speed_map
            else None)
    v, w = _clipped_controls_tk(torch.tensor(p["u"]), torch.tensor(p["noise"]),
                                pt.vrange, pt.wrange)
    return (_cells("port", cell_bits, p), mask, lut,
            rollout_byte.build_task_vec(pt), v.contiguous(), w.contiguous(),
            risk)


@pytest.mark.parametrize("fast_trig", [False, True])
@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("cell_bits", [2, 4, 8])
def test_plain_binned_matches_jax_pallas_interpret(cell_bits, speed_map,
                                                   fast_trig):
    p = _problem(cell_bits, seed=20 + cell_bits)
    H, W, T = p["H"], p["W"], p["T"]
    jt = JTask(*(None if x is None else jnp.asarray(x) for x in _task()))
    q = jnp.asarray(p["qbins"])
    v, w = j_clipped(jnp.asarray(p["u"]), jnp.asarray(p["noise"]), jt.vrange,
                     jt.wrange)
    want = np.asarray(terrain_rollout_costs_pallas_binned(
        _cells("jax", cell_bits, p),
        jpacking.pack_mask_nibbles(jnp.asarray(p["obs"]),
                                   jnp.asarray(p["unk"])),
        None if cell_bits == 8 else j_build_bin_luts(jt, q, q),
        j_build_task_vec(jt), v, w,
        jpacking.pack_risk_bytes(jnp.asarray(p["risk"])) if speed_map
        else None,
        H=H, W=W, T=T, fast_trig=fast_trig, interpret=True,
        cell_bits=cell_bits))
    args = _port_args(cell_bits, p, speed_map)
    np.testing.assert_array_equal(args[4].numpy(), np.asarray(v))
    got = rollout_binned.terrain_rollout_costs_binned(
        *args, H=H, W=W, T=T, cell_bits=cell_bits, fast_trig=fast_trig)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fast_trig", [False, True])
@pytest.mark.parametrize("speed_map", [False, True])
@pytest.mark.parametrize("cell_bits", [2, 4, 8])
def test_binned_layout_equals_byte_layout(cell_bits, speed_map, fast_trig):
    """On maps whose columns sum to 100 (no draw past the last bin) every
    binned layout computes the byte layout's costs bit for bit: the LUT
    entry and the byte decode are the same two float32 operations."""
    p = _problem(cell_bits, seed=40 + cell_bits, past_last=False)
    H, W, T = p["H"], p["W"], p["T"]
    args = _port_args(cell_bits, p, speed_map)
    got = rollout_binned.terrain_rollout_costs_binned_plain(
        *args, H=H, W=W, T=T, cell_bits=cell_bits, fast_trig=fast_trig)
    lin, ang = _grids(p)
    words = tpacking.pack_map_words(
        torch.tensor(lin), torch.tensor(ang), torch.tensor(p["obs"]),
        torch.tensor(p["unk"]), torch.tensor(p["risk"]) if speed_map else None)
    want = rollout_byte.terrain_rollout_costs_byte_plain(
        words, *args[3:6], H=H, W=W, T=T, speed_map=speed_map,
        fast_trig=fast_trig)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_binned_wrapper_on_cpu_never_builds_or_counts(monkeypatch):
    from mppi_numba_tpu_torch.ops.kernels import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was built or loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    p = _problem(4, seed=60, M=2, T=4, H=4, W=5)
    before = rollout_binned.terrain_rollout_costs_binned.launches
    out = rollout_binned.terrain_rollout_costs_binned(
        *_port_args(4, p, True), H=4, W=5, T=4, cell_bits=4, fast_trig=True)
    assert out.shape == (128, 2) and torch.isfinite(out).all()
    assert rollout_binned.terrain_rollout_costs_binned.launches == before
    lib = _build.library_path("rollout_binned")
    assert lib.name.startswith("rollout_binned-") and lib.suffix == ".so"
    assert (_build.CSRC / "rollout_binned.cu").exists()
