"""Gather-latency probe: a dependent gather chain, the hand-written CUDA
kernel, its wrappers and its plain PyTorch versions.

For every (r, lane) of an int32 ``(R, L)`` index tile the chain runs
``iters`` steps of ``x <- (gather(table, x) ^ x) % mod`` over an int32
``(S, L)`` table, the gather being the column gather ``table[x % S, lane]``
(``column_gather_chain``) or the flat gather ``table.flat[x % (S*L)]``
(``flat_gather_chain``).  Each step's address is the last step's result, so
the time per step is the latency of one load from wherever the table
lives: L1 for a few KB, the 50 MB L2, or HBM.  That latency, at each table
size, is what the rollout kernels' map lookups pay per step, and what a
choice of map layout trades against.

It replaces ``scripts/gather_probe.py::make_kernel(...).run``, the probe of
which table shapes the TPU's ``tpu.dynamic_gather`` serves (sizes S = 8,
64, 512 and 6568 rows of 128 lanes; the TPU served the flat gather at S = 8
only).  Run it on a card:

    python -m mppi_numba_tpu_torch.probes.gather_probe

It prints one JSON line per (mode, S, R) of ``MODES`` x ``SIZES`` x
``ROWS``: whether the kernel equals the plain version bit for bit, the ns
per chain step, the table's bytes and the entries the chain read, and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import statistics

import torch

from .. import _card

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/gather_probe.cu"
REPLACES = "scripts/gather_probe.py:95"

ITERS = 512
LANES = 128
MODES = ("column", "flat")
# Table rows: the TPU probe's four sizes (4 KB to 3.4 MB), 512 KB (the
# smallest table past an SM's 256 KB of L1 and shared memory: its step is
# an L2 hit), then 32 MB (inside the 50 MB L2) and 256 MB (HBM).
SIZES = (8, 64, 512, 1024, 6568, 65536, 524288)
# Index-tile rows: the TPU's tile (latency) and 132 SMs x 1024 threads over
# 128 lanes (a full card of chains in flight).
ROWS = (32, 1056)
# Each case is timed three times, this many launches each.
REPS = 10
TABLE_VALUES = 1 << 20


def column_gather_chain_plain(table, idx, mod, iters, seen=None):
    """Plain PyTorch column chain: ``x <- (table[x % S, lane] ^ x) % mod``,
    ``iters`` times, from ``x = idx``.  int32 ``(S, L)`` table, int32
    ``(R, L)`` idx; returns int32 ``(R, L)``.  ``seen``, a bool tensor of
    ``table.numel()`` entries, is set where the chain reads the table."""
    S, L = table.shape
    lane = torch.arange(idx.shape[1], device=idx.device)
    x = idx
    for _ in range(iters):
        row = torch.remainder(x, S).long()
        if seen is not None:
            seen[row * L + lane] = True
        x = torch.remainder(torch.gather(table, 0, row) ^ x, mod)
    return x


def flat_gather_chain_plain(table, idx, mod, iters, seen=None):
    """Plain PyTorch flat chain: ``x <- (table.flat[x % (S*L)] ^ x) %
    mod``, ``iters`` times, from ``x = idx``; ``seen`` as for
    ``column_gather_chain_plain``."""
    flat = table.reshape(-1)
    n = flat.numel()
    x = idx
    for _ in range(iters):
        cell = torch.remainder(x, n).long()
        if seen is not None:
            seen[cell] = True
        x = torch.remainder(flat[cell] ^ x, mod)
    return x


def _check_cuda_args(table, idx, mod, iters, flat, check_values):
    checks = [
        (table.dtype == torch.int32 and table.dim() == 2
         and table.is_contiguous(), "table must be contiguous int32 (S, L)"),
        (idx.dtype == torch.int32 and idx.dim() == 2 and idx.is_contiguous()
         and idx.device == table.device,
         "idx must be contiguous int32 (R, L) on the table's device"),
        (flat or idx.shape[1] == table.shape[1],
         "the column gather needs idx and table of one width L"),
        (0 < table.numel() < 2 ** 31 and 0 < idx.numel() < 2 ** 31,
         "table and idx must be non-empty with fewer than 2^31 entries"),
        (0 < mod < 2 ** 31 and iters >= 0,
         "need 0 < mod < 2^31 and iters >= 0"),
        # Nonnegative inputs keep every x in [0, 2^31): the kernel's
        # unsigned % then equals the reference's flooring %.
        (not check_values
         or (bool((table >= 0).all()) and bool((idx >= 0).all())),
         "table and idx must be nonnegative"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError("gather chain: " + msg)


def _launch(table, idx, mod, iters, flat, check_values):
    from ..ops.kernels._build import load

    _check_cuda_args(table, idx, mod, iters, flat, check_values)
    fn = load("gather_probe").gather_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(idx)
    R, L = idx.shape
    # The runtime launches on its current device: make it the tensors'.
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, L,
                 table.shape[0], table.numel(), int(mod), int(iters),
                 int(flat), stream)
    if err != 0:
        raise RuntimeError("gather_probe kernel launch failed: CUDA error "
                           "{}".format(err))
    return out


def column_gather_chain(table, idx, mod, iters=ITERS, check_values=True):
    """The column chain.  On CUDA tensors this launches
    ``csrc/gather_probe.cu`` and adds one to ``column_gather_chain.launches``;
    on CPU tensors it runs ``column_gather_chain_plain``.

    The kernel's unsigned ``%`` equals the plain version's flooring one on
    nonnegative inputs, which the wrapper checks with a scan of ``table``
    and ``idx`` that waits for the device; ``check_values=False`` skips the
    scan for inputs the caller has checked already (a timed repeat)."""
    if not table.is_cuda:
        return column_gather_chain_plain(table, idx, mod, iters)
    out = _launch(table, idx, mod, iters, False, check_values)
    column_gather_chain.launches += 1
    return out


def flat_gather_chain(table, idx, mod, iters=ITERS, check_values=True):
    """The flat chain.  On CUDA tensors this launches
    ``csrc/gather_probe.cu`` and adds one to ``flat_gather_chain.launches``;
    on CPU tensors it runs ``flat_gather_chain_plain``.  ``check_values``
    as for ``column_gather_chain``."""
    if not table.is_cuda:
        return flat_gather_chain_plain(table, idx, mod, iters)
    out = _launch(table, idx, mod, iters, True, check_values)
    flat_gather_chain.launches += 1
    return out


column_gather_chain.launches = 0
flat_gather_chain.launches = 0

CHAINS = {"column": (column_gather_chain, column_gather_chain_plain),
          "flat": (flat_gather_chain, flat_gather_chain_plain)}


def make_inputs(mode, S, R, device, seed=0):
    """The TPU probe's inputs: an ``(S, LANES)`` table of values in
    [0, 2^20), an ``(R, LANES)`` idx in [0, mod), mod = S (column) or
    S * LANES (flat).  Returns ``(table, idx, mod)``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mod = S * LANES if mode == "flat" else S
    table = torch.randint(0, TABLE_VALUES, (S, LANES), generator=g,
                          device=device, dtype=torch.int32)
    idx = torch.randint(0, mod, (R, LANES), generator=g, device=device,
                        dtype=torch.int32)
    return table, idx, mod


def run(device="cuda"):
    """Probe every (mode, S, R) of ``MODES`` x ``SIZES`` x ``ROWS``: hold
    the kernel's ``ITERS``-step chain against the plain chain, bit for bit,
    count the table entries the chain reads, and time the chain three
    times, ``REPS`` launches each, keeping the median.  Returns one dict per
    case."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe needs a CUDA device")
    card_name, _, power_limit = _card.card_line().rpartition(", ")
    results = []
    for mode in MODES:
        chain, plain = CHAINS[mode]
        for S in SIZES:
            for R in ROWS:
                table, idx, mod = make_inputs(mode, S, R, device)
                seen = torch.zeros(table.numel(), dtype=torch.bool,
                                   device=table.device)
                got = chain(table, idx, mod, ITERS)
                want = plain(table, idx, mod, ITERS, seen)
                runs = [_card.time_cuda(lambda: chain(
                    table, idx, mod, ITERS, check_values=False), REPS, 2)
                    for _ in range(3)]
                ms = statistics.median(runs)
                results.append(dict(
                    mode=mode, S=S, R=R, L=table.shape[1], iters=ITERS,
                    correct=bool(torch.equal(got, want)),
                    max_abs_err=int((got - want).abs().max()),
                    ns_per_step=ms * 1e6 / ITERS, ms=ms, runs_ms=runs,
                    table_bytes=table.numel() * 4,
                    touched_entries=int(seen.sum()), card=card_name,
                    power_limit=power_limit))
                del table, idx, seen, got, want
    return results


def main():
    results = run()
    for res in results:
        print(json.dumps(res), flush=True)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
