"""The launch shapes of the barebone rollout kernel
(``ops/kernels/barebone_rollout.py::launch_shape``) and of the wide update
(``ops/kernels/update_useq.py::wide_launch_shape``), held on the CPU: each
shape fits the card's grid and shared memory and the kernel's own limits,
the wide update's stages read every padded position once, and the wide
update's summation order, written out here as the kernels run it, equals
the plain version (``update_useq_plain``, the halving tree) bit for bit.

The kernels run on a card only (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 2); the order written out below is the one the
sources document (``csrc/update_wide.cu``: pairwise over each thread's
leaves in bit-reversed order, then the position classes, then each
column's groups through a warp's lanes).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mppi_numba_tpu_torch.ops.kernels import barebone_rollout as kbare
from mppi_numba_tpu_torch.ops.kernels import update_useq as kupdate
from mppi_numba_tpu_torch.ops.tree import padded_length

CSRC = Path(kbare.__file__).resolve().parents[2] / "csrc"
H100_SMS = 132
GRID_X = 2 ** 31 - 1
# A block's opt-in shared memory on an H100, less what a kernel may hold
# statically beside it.
OPTIN_BYTES = 232448 - 2048
# Shared memory a block may use without an opt-in (the barebone kernel
# sets none).
STATIC_SHARED_LIMIT = 48 * 1024


def _source(name):
    return (CSRC / name).read_text()


# -- the barebone rollout -------------------------------------------------

BAREBONE_KS = (1, 31, 33, 255, 257, 1000, 8448, 33793, 10 ** 6, GRID_X)


@pytest.mark.parametrize("N", [0, 2, 9, 300])
@pytest.mark.parametrize("T", [1, 7, 8, 9, 257])
@pytest.mark.parametrize("K", BAREBONE_KS)
def test_barebone_launch_shape_fits(K, T, N):
    """Every (K, T, N) gets a width the launcher takes (32, 64 or 128),
    blocks covering K within the grid, whole tiles of 8 steps covering T
    and shared memory a block may use without an opt-in; a warp a block
    only where 64 would leave fewer than two blocks an SM, 128 wherever
    it fills the card twice."""
    threads, blocks, tiles, smem = kbare.launch_shape(K, T, N)
    assert threads in (32, 64, 128)
    assert (blocks - 1) * threads < K <= blocks * threads <= 2 * GRID_X
    assert blocks <= GRID_X
    assert (tiles - 1) * kbare.TILE_STEPS < T <= tiles * kbare.TILE_STEPS
    assert smem == kbare.shared_bytes(threads)
    assert smem <= STATIC_SHARED_LIMIT
    assert threads == 32 or blocks >= 2 * H100_SMS
    assert (threads == 128) == (-(-K // 128) >= 2 * H100_SMS)


@pytest.mark.parametrize("K,sms,threads", [
    (1000, 132, 32), (1000, 8, 64), (1024, 132, 32), (40000, 132, 128),
    (1000000, 132, 128), (20000, 132, 64), (16000, 132, 32),
    (16000, 16, 128)])
def test_barebone_launch_spreads_small_k_over_the_sms(K, sms, threads):
    """The example's K = 1,000 runs a warp a block (32 blocks on 32 of an
    H100's SMs, where the former kernel ran 4 blocks of 256); a card of
    fewer SMs keeps wider blocks."""
    assert kbare.launch_shape(K, 50, 2, sms)[0] == threads


def test_barebone_constants_match_the_source():
    """The wrapper's widths, tile and obstacle counts held in registers
    are the source's, and the launcher refuses any other width."""
    src = _source("barebone_rollout.cu")
    for name, value in (("kMaxThreads", kbare.MAX_THREADS),
                        ("kTileSteps", kbare.TILE_STEPS)):
        assert re.search(r"constexpr int {} = {};".format(name, value), src)
    assert re.search(r"threads != 32 && threads != 64 && threads != 128",
                     src)
    assert "__launch_bounds__(kMaxThreads)" in src
    # An instantiation for each count the engine sends, the generic one
    # for every other count (no obstacle included).
    cases = re.findall(r"case (\d+): BAREBONE_LAUNCH\((\d+)\)", src)
    assert [(int(a), int(b)) for a, b in cases] == [
        (n, n) for n in kbare.REGISTER_OBSTACLE_COUNTS]
    assert "default: BAREBONE_LAUNCH(-1)" in src


# -- the wide update --------------------------------------------------------

WIDE_KS = (32769, 40000, 65536, 65537, 100000, 10 ** 6, GRID_X)
WIDE_TS = (1, 2, 3, 7, 50, 128, 129, 130, 4096, 4097, 20000)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", WIDE_TS)
@pytest.mark.parametrize("K", WIDE_KS)
def test_wide_launch_shape_fits(B, K, T):
    """Every (B, K, T) past the fused path gets a shape the launcher
    takes: 256 groups of a power of two P >= 256 positions covering the
    padded K, the 2T columns in chunks of at most 256 (even, a multiple of
    4 where T is even: 16-byte copies), each chunk non-empty, Q a power of
    two with whole stages of 32 Q rows in P, CJ Q threads up to a warp and
    at most 512, shared memory within the opt-in, the grid within its x
    limit, and the finishing block's shared memory holding at least one
    column's 256 partial sums."""
    s = kupdate.wide_launch_shape(B, K, T)
    G = kupdate.WIDE_GROUPS
    P, CJ, Q, chunks = (s["positions"], s["columns"], s["classes"],
                        s["chunks"])
    assert P * G == padded_length(K) >= K
    assert P >= 256 and P & (P - 1) == 0
    assert CJ % 2 == 0 and CJ <= kupdate.WIDE_MAX_COLS
    assert (chunks - 1) * CJ < 2 * T <= chunks * CJ
    assert s["bulk"] == (T % 2 == 0)
    assert CJ % (4 if s["bulk"] else 2) == 0
    assert 1 <= Q <= kupdate.WIDE_MAX_Q and Q & (Q - 1) == 0
    assert P % (kupdate.WIDE_STAGE * Q) == 0
    assert CJ * Q <= s["threads"] <= kupdate.WIDE_MAX_THREADS
    assert s["threads"] % 32 == 0 and s["threads"] - CJ * Q < 32
    assert s["shared_bytes"] <= OPTIN_BYTES
    stage = kupdate.WIDE_STAGE * Q * CJ
    assert kupdate.WIDE_RING * stage >= G
    assert chunks * G <= GRID_X
    assert s["blocks"] == chunks * G * B


@pytest.mark.parametrize("K,T,shape", [
    (40000, 50, (256, 100, 1, 4, 416, True, 103936)),
    (100000, 50, (512, 100, 1, 4, 416, True, 103936)),
    (1000000, 50, (4096, 100, 1, 4, 416, True, 103936)),
    (32769, 1, (256, 2, 1, 8, 32, False, 7168)),
    (65537, 4097, (512, 250, 33, 2, 512, False, 128768))])
def test_wide_launch_shape_at_the_engines_shapes(K, T, shape):
    """The barebone engine's K = 40,000 / 1e5 / 1e6 at T = 50: the 100
    columns in one chunk, 4 threads a column, a stage of 128 rows (51 KB)
    twice; one step; 4,097 steps in 33 chunks."""
    s = kupdate.wide_launch_shape(1, K, T)
    assert tuple(s[k] for k in ("positions", "columns", "chunks", "classes",
                                "threads", "bulk",
                                "shared_bytes")) == shape


def _bitrev(i, bits):
    """``i`` bit-reversed over ``bits`` bits (numpy arrays too)."""
    out = np.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def _noise_rows(K, T):
    """Every row ``update_wide_noise`` stages, as the source computes it:
    group g's stage n, row r = m Q + q, position s = bit_reverse(n 32 + m)
    Q + q, row g + G s.  Returns (G, stages, R) row indices."""
    s = kupdate.wide_launch_shape(1, K, T)
    G, P, Q = kupdate.WIDE_GROUPS, s["positions"], s["classes"]
    R = kupdate.WIDE_STAGE * Q
    stages = P // R
    g = np.arange(G)[:, None, None]
    n = np.arange(stages)[None, :, None]
    r = np.arange(R)[None, None, :]
    hi = _bitrev(n * kupdate.WIDE_STAGE + (r // Q), (P // Q).bit_length() - 1)
    return g + G * (hi * Q + r % Q)


@pytest.mark.parametrize("K,T", [(32769, 1), (40000, 50), (65537, 2),
                                 (100000, 50), (100000, 130), (1048577, 1)])
def test_wide_stages_read_every_position_once(K, T):
    """The noise kernel's stages, over its 256 groups, read each of the
    padded K positions exactly once (the rows past K are padding), and
    the eta kernel's threads do too."""
    L = padded_length(K)
    rows = _noise_rows(K, T).ravel()
    assert np.array_equal(np.sort(rows), np.arange(L))
    G = kupdate.WIDE_GROUPS
    P = L // G
    a = np.arange(P // 256)[:, None, None]
    tid = np.arange(256)[None, :, None]
    g = np.arange(G)[None, None, :]
    eta_rows = (g + G * (a * 256 + tid)).ravel()
    assert np.array_equal(np.sort(eta_rows), np.arange(L))


def _pairwise_in_push_order(v):
    """Leaves pushed in order along the last axis, summed pairwise (i with
    i ^ 1, then pairs of pairs): ``Pairwise`` / ``Streamed``."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _lanes(x):
    """The last five levels as xor shuffles over a warp's 32 lanes (the
    last axis); every lane ends with the sum, lane 0's returned."""
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., np.arange(32) ^ o]
    return x[..., 0]


def _warp_tree(v):
    """``warp_tree`` over the last axis (W <= 512 threads or groups),
    padded with -0.0 to 512: lane l holds l + 32 m, m < 16, halved in
    registers, then xor shuffles."""
    pad = np.full(v.shape[:-1] + (512 - v.shape[-1],), -0.0, np.float32)
    y = np.concatenate([v, pad], -1)
    y = y[..., (np.arange(32)[:, None] + 32 * np.arange(16)[None, :])]
    n = 16
    while n > 1:
        n //= 2
        y = y[..., :n] + y[..., n:2 * n]
    return _lanes(y[..., 0])


def _kernel_order_update(costs, noise, u, lam, vrange, wrange):
    """The wide update's three launches' arithmetic in their order, one
    scenario: float32 numpy adds where the kernels add, torch's own exp
    and division where they compute those."""
    K, T = noise.shape[0], noise.shape[1]
    s = kupdate.wide_launch_shape(1, K, T)
    G, P, CJ, Q = (kupdate.WIDE_GROUPS, s["positions"], s["columns"],
                   s["classes"])
    L = G * P
    beta = costs.min()
    e = torch.exp(-(torch.tensor(costs) - torch.tensor(beta))
                  / torch.tensor(lam)).numpy()
    e_pad = np.concatenate([e, np.full(L - K, -0.0, np.float32)])
    # update_wide_eta: thread tid pushes a < per (16 a group, padded),
    # then the block's threads; update_wide_noise: warp_tree over the
    # groups.
    per = P // 256
    A = max(per, 16)
    a = _bitrev(np.arange(A), A.bit_length() - 1)
    k = (np.arange(G)[:, None, None]
         + G * (a[None, None, :] * 256 + np.arange(256)[None, :, None]))
    leaves = np.where(a[None, None, :] < per, e_pad[np.minimum(k, L - 1)],
                      np.float32(-0.0))
    etas = _warp_tree(_pairwise_in_push_order(leaves))
    eta = _warp_tree(etas)
    w = (torch.tensor(e) / torch.tensor(eta)).numpy()
    # update_wide_noise: thread (j, q) pushes its leaves in stage order,
    # then the levels over q, then the chunk's last block: warp_tree over
    # the groups of each column.
    w_pad = np.concatenate([w, np.full(L - K, -0.0, np.float32)])
    x = np.concatenate([noise.reshape(K, 2 * T),
                        np.zeros((L - K, 2 * T), np.float32)])
    rows = _noise_rows(K, T)                     # (G, stages, R)
    R = rows.shape[-1]
    order = rows.reshape(G, -1, R // Q, Q)       # (G, stages, m, q)
    order = order.transpose(0, 3, 1, 2).reshape(G, Q, -1)  # push order
    prod = w_pad[order][..., None] * x[order]    # (G, Q, P / Q, 2T)
    part = _pairwise_in_push_order(np.moveaxis(prod, -1, -2))  # (G, Q, 2T)
    h = Q
    while h > 1:
        h //= 2
        part = part[:, :h] + part[:, h:2 * h]
    du = _warp_tree(part[:, 0].T)                # (2T,)
    u_new = u.reshape(-1) + du
    lo = np.where(np.arange(2 * T) % 2, wrange[0], vrange[0])
    hi = np.where(np.arange(2 * T) % 2, wrange[1], vrange[1])
    return np.minimum(np.maximum(u_new, lo), hi).reshape(T, 2), w


@pytest.mark.parametrize("K,T", [(32769, 1), (40000, 3), (65537, 2),
                                 (40000, 130), (100000, 7), (1048577, 1),
                                 (2097153, 1)])
def test_wide_kernel_order_equals_the_plain_tree(K, T):
    """The wide update's order as its sources run it (each thread's leaves
    pairwise in bit-reversed order, a stage at a time; the position
    classes; each column's 256 groups through a warp), at one stage and
    at several, one chunk of columns and two, and at 32 and 64 of eta's
    positions a thread (its streamed groups of 16): u and the weights equal
    ``update_useq_plain`` bit for bit, a NaN-free row of costs with a
    tenth crashed."""
    rng = np.random.RandomState(K + T)
    f32 = np.float32
    costs = (rng.rand(K) * 300).astype(f32)
    costs[rng.rand(K) < 0.1] += f32(1e5)
    noise = (rng.randn(K, T, 2) * 2).astype(f32)
    u = (rng.rand(T, 2) * 2 - 0.5).astype(f32)
    lam = f32(1.0)
    vr, wr = np.array([0.0, 3.0], f32), np.array([-3.14, 3.14], f32)
    with np.errstate(invalid="ignore"):
        got_u, got_w = _kernel_order_update(costs, noise, u, lam, vr, wr)
    want_u, want_w = kupdate.update_useq_plain(
        torch.tensor(costs), torch.tensor(noise), torch.tensor(u),
        torch.tensor(lam), torch.tensor(vr), torch.tensor(wr))
    assert np.array_equal(got_w.view(np.int32),
                          want_w.numpy().view(np.int32))
    assert np.array_equal(got_u.astype(f32).view(np.int32),
                          want_u.numpy().view(np.int32))


def test_wide_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors past ``FUSED_K`` the wide wrapper (and the fused one
    that routes to it) is the plain version, bit for bit, and counts no
    launch."""
    K, T = kupdate.FUSED_K + 5, 3
    rng = np.random.RandomState(0)
    args = [torch.tensor(x) for x in (
        (rng.rand(2, K) * 50).astype(np.float32),
        rng.randn(2, K, T, 2).astype(np.float32),
        rng.rand(2, T, 2).astype(np.float32),
        np.array([1.0, 0.5], np.float32),
        np.array([[0.0, 2.0]] * 2, np.float32),
        np.array([[-2.5, 2.5]] * 2, np.float32))]
    before = (kupdate.update_useq_fused.launches,
              kupdate.update_useq_wide.launches)
    want = kupdate.update_useq_plain(*args)
    for fn in (kupdate.update_useq_wide, kupdate.update_useq_fused):
        got = fn(*args)
        assert all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
    assert (kupdate.update_useq_fused.launches,
            kupdate.update_useq_wide.launches) == before


# -- the timing driver --------------------------------------------------------

def test_barebone_kernels_driver_covers_both_kernels_paths():
    """``drivers/barebone_kernels.py`` times the rollout at the example's
    and the Config's K with the engine's two obstacles, at counts of the
    generic instantiation too, and the update on its wide path only."""
    from mppi_numba_tpu_torch.drivers import barebone_kernels as drv

    assert {(1000, 50, 2), (1000000, 50, 2)} <= set(drv.ROLLOUT_SHAPES)
    counts = {N for _, _, N in drv.ROLLOUT_SHAPES}
    assert counts & set(kbare.REGISTER_OBSTACLE_COUNTS)
    assert counts - set(kbare.REGISTER_OBSTACLE_COUNTS)
    assert drv.WIDE_KS and all(K > kupdate.FUSED_K for K in drv.WIDE_KS)


def test_barebone_kernels_driver_refuses_what_it_cannot_time(monkeypatch):
    """Another checkout's package only when run as a file (imported, the
    package is this one's); and no timing without a card."""
    from mppi_numba_tpu_torch.drivers import barebone_kernels as drv

    with pytest.raises(SystemExit, match="as a file"):
        drv.main(["--tree", "elsewhere"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        drv.main([])
