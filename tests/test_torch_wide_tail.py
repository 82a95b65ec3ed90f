"""The two solve-tail kernels past their former caps, their orders held on
the CPU: ``cvar_coupling_kernel`` (the coupling past ``STAGED_T`` steps, a
launch of its own) and ``cvar_wide_kernel`` (the CVaR past ``SORTED_M``
map samples), both in ``csrc/cvar_wide.cu``.

Each kernel's order is written out here in numpy as its source documents
it, and held bit for bit against the plain versions
(``ops/tree.py::tree_sum`` for the coupling, the descending worst costs
and ``ops/tree.py::window_sum`` for the CVaR): the coupling's 512 position
classes a row, its groups of 4 step indices halved, the groups pushed in
bit-reversed order onto a stack of 16 (and past 16 groups the
super-groups onto a second stack), then the classes' halving; the wide
kernel's walk over its key histograms (a key's top 12 bits, then 8, 8
and 4: the bins each round gathers, the bin refined by the next level, a
key's copies past a round), and each round's sort (past 8,192 keys a
radix sort, 4 bits a pass over the digits that vary, each thread's keys
ranked by its own digit counts and placed by their scan; a sort below).
The kernels themselves run on a card only
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mppi_numba_tpu_torch.ops.cvar import (cvar_from_costs,
                                           cvar_from_costs_dynamic)
from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kc
from mppi_numba_tpu_torch.ops.tree import tree_sum, window_sum

CSRC = Path(kc.__file__).resolve().parents[2] / "csrc"
GRID_X = 2 ** 31 - 1
# A block's opt-in shared memory on an H100, less what a kernel may hold
# statically beside it.
OPTIN_BYTES = 232448 - 2048
F32 = np.float32


def _source():
    return (CSRC / "cvar_wide.cu").read_text()


def _constant(name):
    """An ``int`` constant of ``csrc/cvar_wide.cu`` or ``cvar_common.cuh``
    written as a literal."""
    for src in (_source(), (CSRC / "cvar_common.cuh").read_text()):
        m = re.search(r"constexpr int {} = (\d+);".format(name), src)
        if m:
            return int(m.group(1))
    raise KeyError(name)


def _bitrev(i, bits):
    out = np.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def _halve(x, axis):
    """The halving tree over ``axis`` (a power of two long): x[i] +=
    x[i + n / 2], ..., float32 adds."""
    x = np.moveaxis(x, axis, -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _pairwise(x):
    """Leaves in push order along the last axis summed pairwise (i with
    i ^ 1, then pairs of pairs): ``tree::Pairwise`` / ``tree::Streamed``."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


# -- the coupling past STAGED_T ----------------------------------------------

def _coupling_kernel_order(noise, u, u_std):
    """``cvar_coupling_kernel``'s arithmetic, one scenario: noise (K, T,
    2), u (T, 2), u_std (2,) float32 -> (K,).  The terms as the kernel
    forms them (u / sigma^2 once, times each row's noise); pair t = j +
    256 r of class 2j + c; r = c' + C s, the 4 s of a group halved, the C
    groups pushed in bit-reversed order of c' (pairwise: the register
    stack of 16 and, past 16 groups, the local one over super-groups);
    then the 512 classes: lane l + 32 m halved over m, then over the
    lanes."""
    K, T = noise.shape[:2]
    _, threads, C = kc.coupling_launch_shape(1, K, T)
    assert threads == kc.COUPLING_THREADS == 256
    G = kc.COUPLING_LEAVES
    R = G * C
    var = u_std * u_std
    scaled = (torch.tensor(u) / torch.tensor(var)).numpy()
    terms = noise * scaled[None]                         # (K, T, 2)
    pad = np.full((K, threads * R - T, 2), -0.0, F32)
    x = np.concatenate([terms, pad], 1)                  # t = r 256 + j
    x = x.reshape(K, G, C, threads, 2)                   # r = s C + c'
    g = _halve(x, 1)                                     # (K, C, 256, 2)
    g = g[:, _bitrev(np.arange(C), C.bit_length() - 1)]  # push order
    part = _pairwise(np.moveaxis(g, 1, -1))              # (K, 256, 2)
    cls = part.reshape(K, kc.COUPLING_CLASSES)           # class 2j + c
    y = _halve(cls.reshape(K, 16, 32), 1)                # (K, lanes)
    return _halve(y, 1)


def _coupling_inputs(B, K, T, seed):
    rng = np.random.RandomState(seed)
    noise = (rng.randn(B, K, T, 2) * np.array([2.0, 3.0])).astype(F32)
    u = (rng.rand(B, T, 2) * 2 - 0.5).astype(F32)
    u_std = (rng.rand(B, 2) + 0.5).astype(F32)
    return noise, u, u_std


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [4097, 4100, 8193, 20000, 40000])
def test_coupling_kernel_order_equals_the_plain_tree(T, B):
    """The coupling kernel's order (512 classes a row, groups of 4 step
    indices, the fixed stack of 16 groups, and from T = 20,000 the second
    stack over super-groups) equals ``tree_sum`` over the (t, c) terms and
    the coupling of ``cvar_costs_plain`` (at lambda 1, a zero CVaR) bit
    for bit, every scenario with its own u and sigma."""
    K = 5
    noise, u, u_std = _coupling_inputs(B, K, T, seed=T + B)
    got = np.stack([_coupling_kernel_order(noise[b], u[b], u_std[b])
                    for b in range(B)])
    tn, tu, ts = torch.tensor(noise), torch.tensor(u), torch.tensor(u_std)
    want = kc.coupling_sums_plain(tn, tu, ts).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    terms = (tn * (tu / (ts * ts)[:, None, :])[:, None]).flatten(-2)
    assert np.array_equal(want.view(np.int32),
                          tree_sum(terms).numpy().view(np.int32))
    zero = torch.zeros((B, K, 20))
    with_cvar = kc.cvar_costs_plain(zero, tn, tu, ts, torch.ones(B),
                                    numel=4)
    assert np.array_equal(with_cvar.numpy().view(np.int32),
                          want.view(np.int32))


COUPLING_ROWS = [(B, K) for B in (1, 3, 65539)
                 for K in (1, 2, 37, 1000, 1024, 40000)
                 if B * K < 2 ** 31] + [(1, 2 ** 31 - 1)]


@pytest.mark.parametrize("B,K", COUPLING_ROWS)
@pytest.mark.parametrize("T", [1, 4096, 4097, 20000, 40000, 10 ** 6])
def test_coupling_launch_shape_fits(B, K, T):
    """Every shape the coupling kernel gets: a block of 256 threads a pair
    of rows (the grid within its x limit where B K < 2^31, the rows
    covered once), groups a power of two whose 4 x 256 x groups step
    indices cover T and no more than twice over past 1,024, as the
    source's ``coupling_log_groups``; its static shared memory (two rows'
    512 class sums) within 48 KB, and with its ring of three stages of a
    group's u and two rows' noise within a block's opt-in, two blocks an
    SM."""
    blocks, threads, groups = kc.coupling_launch_shape(B, K, T)
    assert threads == _constant("kCoupleThreads")
    assert kc.COUPLING_ROWS == _constant("kCoupleRows")
    assert blocks * kc.COUPLING_ROWS >= B * K
    assert blocks == B * -(-K // kc.COUPLING_ROWS) <= GRID_X
    assert groups & (groups - 1) == 0
    steps = kc.COUPLING_LEAVES * groups * threads
    assert steps >= T and (groups == 1 or steps < 2 * T)
    assert _constant("kCoupleLeaves") == kc.COUPLING_LEAVES == 4
    static = 4 * kc.COUPLING_ROWS * kc.COUPLING_CLASSES
    ring = 3 * kc.COUPLING_LEAVES * (kc.COUPLING_ROWS + 1) * threads * 8
    assert static <= 48 * 1024
    assert _constant("kCoupleStages") == 3
    assert _constant("kCoupleBlocks") == 2
    assert 2 * (static + ring + 1024) <= 232448


# -- the wide CVaR past SORTED_M ---------------------------------------------

SORTED_M = kc.SORTED_M
KEYS_PER_THREAD = SORTED_M // kc.WIDE_THREADS   # a round's keys a thread
RADIX_FROM = 8192       # rounds past it: the radix sort (kRadixFrom)
# The histograms' levels: a key's top 12 bits, then 8, 8 and the last 4.
LEVEL_BITS = (12, 8, 8, 4)
LEVEL_SHIFT = (20, 12, 4, 0)


def _order_keys(x):
    """``order_key``: float32 -> uint32 in the floats' order, NaN last."""
    b = x.view(np.uint32).astype(np.uint64)
    k = np.where(b & 0x80000000, ~b & 0xffffffff, b | 0x80000000)
    return np.where(np.isnan(x), 0xffffffff, k).astype(np.uint32)


def _key_values(k):
    """``key_value``: the float of a key (every NaN key the canonical
    NaN)."""
    k = k.astype(np.uint64)
    b = np.where(k & 0x80000000, k & 0x7fffffff, ~k & 0xffffffff)
    return b.astype(np.uint32).view(F32)


def _plan_round(w, lh, need):
    """``plan_round``: from each level's cursor down, whole bins while the
    round's keys fit in SORTED_M; "gather" at the bin that reaches need
    or before one that does not fit; "refine" a bin that does not fit
    alone, or does not fit where the take ends (the next level, its
    prefix); at the last level "copies" of its one key when the round
    holds nothing else.  (The kernel reads the bins 256 at a time; its
    decisions are these.)"""
    while True:
        L, cur = w["level"], w["cursor"][w["level"]]
        if cur < 0:
            if L == 0:
                return "gather"
            w["level"] -= 1
            continue
        shift = LEVEL_SHIFT[L]
        run = w["acc"]
        for e in range(cur, -1, -1):
            cnt = int(lh[L][e])
            run += cnt
            if run > SORTED_M:
                above = run - cnt
                if e < cur:
                    w["acc"] = above
                    w["lo"] = w["prefix"][L] | ((e + 1) << shift)
                w["cursor"][L] = e
                if cnt > SORTED_M or run >= need:
                    if L + 1 < 4:
                        w["cursor"][L] = e - 1
                        w["level"] = L + 1
                        w["cursor"][L + 1] = (1 << LEVEL_BITS[L + 1]) - 1
                        w["prefix"][L + 1] = w["prefix"][L] | (e << shift)
                        return "refine"
                    if cnt > SORTED_M and above == 0:
                        w["cursor"][L] = e - 1
                        w["acc"] = cnt
                        w["lo"] = w["prefix"][L] | e
                        return "copies"
                return "gather"
            if run >= need:
                w["acc"] = run
                w["lo"] = w["prefix"][L] | (e << shift)
                w["cursor"][L] = e - 1
                return "gather"
        w["acc"] = run
        w["lo"] = w["prefix"][L]
        w["cursor"][L] = -1


def _histogram(keys, L, prefix):
    """Level L's histogram of the keys under ``prefix`` (the bits above
    its digit)."""
    shift, bits = LEVEL_SHIFT[L], LEVEL_BITS[L]
    mask = 0 if L == 0 else (0xffffffff << (shift + bits)) & 0xffffffff
    under = keys[(keys & np.uint32(mask)) == np.uint32(prefix & mask)]
    return np.bincount((under >> np.uint32(shift))
                       & np.uint32((1 << bits) - 1), minlength=1 << bits)


def _round_sort(keys):
    """A round's sort: past RADIX_FROM keys ``round_sort``, a stable LSD
    radix sort, 4 bits a pass over the digits that vary, blocked (thread
    t: positions 16 t + i), each key placed at the scan of the threads'
    counts cnt[(15 - digit) * threads + t] plus its rank among its
    thread's keys of that digit; at RADIX_FROM keys and fewer the bitonic
    network (``sort_gathered``: any descending sort gives its keys).
    Returns the keys sorted and the radix passes run."""
    got = len(keys)
    assert 1 <= got <= SORTED_M
    if got <= RADIX_FROM:
        return np.sort(keys)[::-1], 0
    vary = int(np.bitwise_or.reduce(keys) ^ np.bitwise_and.reduce(keys))
    thread = np.arange(got) // KEYS_PER_THREAD
    passes = 0
    for dp in range(8):
        if (vary >> (4 * dp)) & 0xf == 0:
            continue
        passes += 1
        d = ((keys >> np.uint32(4 * dp)) & np.uint32(15)).astype(np.int64)
        e = (15 - d) * kc.WIDE_THREADS + thread
        counts = np.bincount(e, minlength=16 * kc.WIDE_THREADS)
        base = np.cumsum(counts) - counts
        rank = np.empty(got, np.int64)
        for v in np.unique(e):
            at = np.nonzero(e == v)[0]
            rank[at] = np.arange(len(at))
        assert rank.max() < 16       # 4 bits of a register
        pos = base[e] + rank
        assert np.array_equal(np.sort(pos), np.arange(got))
        out = np.empty_like(keys)
        out[pos] = keys
        keys = out
    return keys, passes


def _wide_kernel_rounds(row, take):
    """``cvar_wide_kernel``'s rounds over one row (M > SORTED_M, take its
    worst count): the level-0 histogram, then rounds planned by the walk
    (refining bins as it goes), each a gathered key range sorted, or a
    key's copies in rounds of at most SORTED_M.  Returns ``(terms, log)``:
    the first take terms, largest first, as the rounds write them; log the
    rounds' (kind, keys, terms), the refined (level, prefix) and the
    passes over the row."""
    keys = _order_keys(row)
    lh = [_histogram(keys, 0, 0), None, None, None]
    w = dict(level=0, cursor=[(1 << LEVEL_BITS[0]) - 1, 0, 0, 0],
             prefix=[0, 0, 0, 0], acc=0, lo=0)
    log = dict(rounds=[], refined=[], passes=1)
    hi, done, terms = 1 << 32, 0, []
    while done < take:
        need = take - done
        while True:
            action = _plan_round(w, lh, need)
            if action != "refine":
                break
            L = w["level"]
            lh[L] = _histogram(keys, L, w["prefix"][L])
            log["refined"].append((L, w["prefix"][L]))
            log["passes"] += 1
        got, lo = w["acc"], w["lo"]
        assert got > 0
        if action == "copies":
            n = min(got, need)
            assert int(np.sum(keys == lo)) == got > SORTED_M
            for start in range(0, n, SORTED_M):
                c = min(SORTED_M, n - start)
                terms.append(np.full(c, _key_values(np.uint32(lo)), F32))
                log["rounds"].append(("copies", got, c))
            done += n
        else:
            picked = keys[(keys >= lo) & (keys < hi)]
            log["passes"] += 1
            assert len(picked) == got <= SORTED_M
            srt, _ = _round_sort(picked)
            emit = min(got, need)
            terms.append(_key_values(srt[:emit]))
            log["rounds"].append(("gather", got, emit))
            done += emit
        hi = lo
        w["acc"] = 0
    return np.concatenate(terms) if terms else np.zeros(0, F32), log


def _wide_row(kind, M, seed):
    """A row of M costs: ``crashes`` (the tail's, a tenth crashed: 1e5
    added), ``one_bin`` (every key's top 12 bits alike, the first
    histogram's one bin: costs in [256, 288)), ``equal`` (one value),
    ``specials`` (NaN, +-inf and +-0.0 among crashed costs)."""
    rng = np.random.RandomState(seed)
    row = (rng.rand(M) * 300).astype(F32)
    if kind == "crashes":
        row[rng.rand(M) < 0.1] += F32(1e5)
    elif kind == "one_bin":
        row = (256 + rng.rand(M) * 31.9).astype(F32)
    elif kind == "equal":
        row[:] = row[0]
    elif kind == "specials":
        row[rng.rand(M) < 0.1] += F32(1e5)
        at = rng.permutation(M)
        row[at[:7]] = np.nan
        row[at[7:11]] = np.inf
        row[at[11:14]] = -np.inf
        row[at[14:20]] = 0.0
        row[at[20:26]] = -0.0
    return row


def _count(M, count):
    """(take, static numel or None, alpha or None) of a count."""
    if count == "alpha1":
        return M, None, 1.0
    n = math.ceil(0.2 * M)
    return n, n, None


WIDE_CASES = [(kind, M, count)
              for kind in ("crashes", "one_bin", "equal", "specials")
              for M in (16385, 32768, 70000)
              for count in ("numel", "alpha1")]


@pytest.mark.parametrize("kind,M,count", WIDE_CASES)
def test_wide_kernel_rounds_give_the_plain_terms(kind, M, count):
    """The wide kernel's rounds (which bins each gathers, the bin refined
    by the next 8 bits, a key's copies in rounds of their own, the radix
    sort of each round) give the plain version's worst take costs in its
    descending order, equal as floats; their windowed
    sum (XLA's CPU order, over the take for a static count, over M for
    alpha) times the count's reciprocal or divided by it equals the plain
    CVaR bit for bit; every round holds at most SORTED_M keys."""
    row = _wide_row(kind, M, seed=M + len(kind))
    take, numel, alpha = _count(M, count)
    terms, log = _wide_kernel_rounds(row, take)
    assert len(terms) == take
    assert all(0 < got for _, got, _ in log["rounds"])
    assert all(c <= SORTED_M for _, _, c in log["rounds"])
    t = torch.tensor(row)
    want = torch.sort(t, descending=True).values[:take].numpy()
    # Equal as floats: +0.0 and -0.0 are equal costs, which torch's sort
    # leaves in either order and the kernel's keys order.
    assert np.array_equal(terms, want, equal_nan=True)
    if numel is not None:
        got = window_sum(torch.tensor(terms)) * (F32(1) / F32(numel))
        plain = cvar_from_costs(t[None], numel)[0]
    else:
        full = np.concatenate([terms, np.zeros(M - take, F32)])
        got = window_sum(torch.tensor(full)) / F32(take)
        plain = cvar_from_costs_dynamic(t[None], torch.tensor(alpha))[0]
    got, plain = np.float32(got), np.float32(plain)
    # A NaN sum: the kernel's and its plain version's on the card are the
    # card's one NaN; the CPU's keeps a payload.
    assert (np.isnan(got) and np.isnan(plain)) or (
        got.view(np.int32) == plain.view(np.int32))


def test_wide_kernel_rounds_refine_only_the_bin_that_does_not_fit():
    """At the tail's shape (M = 70,000, a tenth crashed) no bin of the
    first histogram holds more than SORTED_M keys: numel 14,000 is one
    round, its last bin refined (it does not fit, and the take ends in
    it), three passes over the row; alpha 1 takes every key in six rounds
    of whole bins, none refined.  A row whose keys all share their top 12 bits
    refines that one bin (a third pass) and then rounds over its
    sub-bins."""
    row = _wide_row("crashes", 70000, seed=3)
    _, log = _wide_kernel_rounds(row, 14000)
    assert [r[0] for r in log["rounds"]] == ["gather"]
    assert [L for L, _ in log["refined"]] == [1] and log["passes"] == 3
    _, log = _wide_kernel_rounds(row, 70000)
    assert len(log["rounds"]) == 6 and log["refined"] == []
    assert sum(c for _, _, c in log["rounds"]) == 70000
    row = _wide_row("one_bin", 40000, seed=4)
    keys = _order_keys(row)
    assert len(np.unique(keys >> np.uint32(20))) == 1
    _, log = _wide_kernel_rounds(row, 8000)
    assert [L for L, _ in log["refined"]] == [1]
    assert log["refined"][0][1] >> 20 == int(keys[0]) >> 20
    assert log["passes"] == 3


def test_wide_kernel_rounds_sum_copies_past_a_round():
    """All keys equal: three refined levels, then the one key's copies in
    rounds of SORTED_M (the last partial), no gather and no sort; with a
    different key above them, that key's round comes first, alone."""
    row = _wide_row("equal", 40000, seed=0)
    _, log = _wide_kernel_rounds(row, 40000)
    assert [L for L, _ in log["refined"]] == [1, 2, 3]
    assert [r[2] for r in log["rounds"]] == [16384, 16384, 7232]
    assert {r[0] for r in log["rounds"]} == {"copies"}
    row[5] = row[0] * 2
    terms, log = _wide_kernel_rounds(row, 20000)
    assert log["rounds"][0] == ("gather", 1, 1)
    assert [r[0] for r in log["rounds"][1:]] == ["copies", "copies"]
    assert terms[0] == row[5] and np.all(terms[1:] == row[0])


@pytest.mark.parametrize("got", [1, 2, 511, 8192, 8193, 8208, 16383,
                                 16384])
def test_round_sort_is_a_stable_descending_sort(got):
    """A round's sort puts every key once, in descending order, at every
    fill of a round (one key, the largest the bitonic network takes, one
    past it and 16 past that, a full round): the radix sort's
    blocked ranks and the scan of the threads' digit counts; a round whose
    keys share their top 16 bits runs only the radix passes over the 4
    digits that vary."""
    rng = np.random.RandomState(got)
    keys = rng.randint(1, 2 ** 32, size=got, dtype=np.uint64).astype(
        np.uint32)
    radix = got > RADIX_FROM
    srt, passes = _round_sort(keys)
    assert np.array_equal(srt, np.sort(keys)[::-1])
    assert passes == (8 if radix else 0)
    keys = (keys & np.uint32(0xffff)) | np.uint32(0xc3410000)
    srt, passes = _round_sort(keys)
    assert np.array_equal(srt, np.sort(keys)[::-1])
    assert passes == (4 if radix else 0)


def _wide_words(unsorted):
    """``wide_words(unsorted)`` of the source, from its constants: a
    round's padded terms (or its keys, a word of padding after every 16),
    the counts, the windows' level buffers and carries; past a static
    count of M also the radix sort's counts, the levels' histograms and
    the sweeps' ring of three steps of 8 keys a thread."""
    def win_count(c):
        return (c + 30) // 32 + 1

    def win_words(c):
        return (33 * win_count(c) + 3) & ~3

    warps = kc.WIDE_THREADS // 32
    round_words = max(win_words(SORTED_M),
                      SORTED_M + SORTED_M // KEYS_PER_THREAD)
    words = (round_words + (8 + warps) + win_words(win_count(SORTED_M))
             + win_words(win_count(win_count(SORTED_M))) + 2 * 8)
    if not unsorted:
        words += (256 * warps + (1 << 12) + 3 * 256
                  + 3 * 8 * kc.WIDE_THREADS)
    return words


def test_wide_kernel_launch_fits_the_card():
    """The wide kernel's block (1,024 threads, 16 keys a thread of a
    round: SORTED_M) and its shared memory (``wide_words``, as the source
    sums it, and its static walk and windows' progress) within a block's
    opt-in, a static count of M launched with less than half; the
    constants the model above uses are the source's."""
    assert kc.WIDE_THREADS == _constant("kWideTPR") == 1024
    assert KEYS_PER_THREAD * kc.WIDE_THREADS == SORTED_M == 16384
    assert re.search(r"constexpr int kSortedM = 1024 \* 16;",
                     (CSRC / "cvar_common.cuh").read_text())
    assert _constant("kWinLevels") == 8 and _constant("kLevels") == 4
    assert _constant("kRadixFrom") == RADIX_FROM
    assert _constant("kSweep") == 8 and _constant("kSweepStages") == 3
    src = _source()
    assert re.search(r"return L == 0 \? 12 : L == 3 \? 4 : 8;", src)
    assert re.search(r"return L == 0 \? 20 : L == 1 \? 12 : L == 2 \? 4 : 0;",
                     src)
    assert re.search(r"kWideMisc = 8 \+ kWideWarps", src)
    assert re.search(r"return kRoundWords \+ kWideMisc \+ "
                     r"win_words\(win_count\(kSortedM\)\) \+", src)
    assert re.search(r": kBins \* kWideWarps \+ kLevelWords \+\s+"
                     r"kSweepStages \* kSweep \* kWideTPR", src)
    # The counts and histograms lie 16-byte aligned past the windows.
    assert (_wide_words(True) % 4) == 0
    assert 4 * _wide_words(False) + 256 <= OPTIN_BYTES
    assert _wide_words(True) < _wide_words(False) // 2
    for B, K in ((1, 256), (3, 37), (1, 10 ** 6)):
        assert B * K <= GRID_X
