"""The solve's tail at every path's shape: the CVaR plus coupling kernel
(``cvar_costs``) and the update kernel (``update_useq_fused``) against the
torch ops they replaced, each held bit for bit against its plain version.

The JAX package has no script of its own for this: XLA fuses the tail
into its jitted solve.  ``TAIL_CASES`` are the shapes the port's paths
give the two kernels; ``chip_smoke.py`` phase 2 holds the kernels at each
and phase 4 times some of them.

    python -m mppi_numba_tpu_torch.drivers.tail_bench [--device cpu]

Prints the card line, then one JSON line a case: whether each kernel
equals its plain version bit for bit, and the ms of one call of each
kernel and of the torch ops it replaced (``torch.topk(sorted=True)`` +
``mean`` for a static count, ``torch.sort`` + a masked sum for alpha,
each plus the coupling's product and sum; the update's minimum, exp,
sums, division, weighted noise sum, add and clamps), 50 calls in one
CUDA graph on a card, each beside its bound (``tail_bound_ms``, which
``chip_smoke.py`` uses too); past ``STAGED_T`` steps also the coupling
kernel's own call (``coupling_sums``) beside its bound
(``coupling_bound_ms``).
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from .. import _card
from ..models import clip_controls
from ..ops.kernels import cvar_costs as kc
from ..ops.kernels import update_useq as ku
from ._common import (SMALL_K, SMALL_M, SMALL_T, add_device_arg,
                      add_small_arg, clock, emit, start)

N = 50
# (case, scenarios, K, M, T, count): count a static numel, "alpha" (the
# planner's run-time alpha, 0.2) or the sweep's alphas, cycled over the
# scenarios.  One scenario is the single solve's shapes (no scenario
# axis).  World (a) static and as the planner runs it; the sweep's 30
# episodes at its five alphas; the det modes' M = 1 at T = 40, 80 and 100
# (and the sweep's det chunk); external PMF's K = 2048 / M = 512 / T = 80;
# the confidence example's M = 64 / T = 60; the barebone engine's K = 1000
# / T = 50 on its (K, 1) costs; model_bench's K = 10240 under tdm and
# det_dyn; the m-sharded candidate pools of world (a)'s numel 205 over 2,
# 4 and 8 map ranks and a run-time alpha's gathered rows; and M past 1024
# (a block a row): 2048, 4096, a ragged 5000, 8192 at the planner's alpha
# and the Config's largest, 15,000, at the sweep's first and last alphas.
# Then the shapes the kernels once refused: T = 4,097 and 20,000 (the
# coupling its own launch), the barebone engine's K = 40,000, 100,000 and
# its Config's 1e6 (the wide update), and M = 16,384 (the last a team sorts),
# 32,768 and 70,000 (the wide CVaR) at numel ceil(0.2 M) and at alpha 1.
# Then the windowed sum's counts (XLA's CPU order, windows of 32): world
# (a) at numel 33 (a window and one term) and at a static count of M (the
# row summed as stored, no sort), and a static count of M at M = 16,384
# and 70,000 (the wide kernel's rounds of the row).
SWEEP_ALPHAS = (1.0, 0.8, 0.6, 0.4, 0.2)
TAIL_CASES = (
    ("a_static_205", 1, 1024, 1024, 100, 205),
    ("a_planner_alpha", 1, 1024, 1024, 100, "alpha"),
    ("sweep_b30_alphas", 30, 1024, 1024, 100, SWEEP_ALPHAS),
    ("det_M1_T40", 1, 1024, 1, 40, 1),
    ("det_M1_T80", 1, 1024, 1, 80, 1),
    ("det_M1_T100", 1, 1024, 1, 100, 1),
    ("sweep_det_b30_M1", 30, 1024, 1, 100, 1),
    ("external_K2048_M512_T80", 1, 2048, 512, 80, "alpha"),
    ("confidence_M64_T60", 1, 1024, 64, 60, "alpha"),
    ("barebone_K1000_T50", 1, 1000, 1, 50, 1),
    ("model_bench_K10240_tdm", 1, 10240, 1024, 100, 205),
    ("model_bench_K10240_det", 1, 10240, 1, 100, 1),
    ("pool_2_ranks_410", 4, 1024, 410, 100, 205),
    ("pool_4_ranks_820", 4, 1024, 820, 100, 205),
    ("pool_8_ranks_1024", 1, 1024, 1024, 100, 205),
    ("gathered_rows_alpha", 4, 512, 1024, 100, "alpha"),
    ("shared_memory_sort_M2048", 1, 256, 2048, 20, 410),
    ("shared_memory_sort_M4096", 2, 64, 4096, 10, "alpha"),
    ("ragged_M5000", 1, 256, 5000, 20, 1000),
    ("M8192_alpha", 1, 128, 8192, 20, "alpha"),
    ("config_max_M15000", 2, 64, 15000, 10, (1.0, 0.2)),
    ("streamed_T4097", 1, 1024, 16, 4097, 4),
    ("streamed_T20000", 1, 1024, 16, 20000, "alpha"),
    ("wide_update_K40000", 1, 40000, 1, 50, 1),
    ("wide_update_K100000", 1, 100000, 1, 50, 1),
    ("wide_update_K1000000", 1, 1000000, 1, 50, 1),
    ("M16384_numel", 1, 256, 16384, 20, 3277),
    ("M16384_alpha1", 1, 256, 16384, 20, (1.0,)),
    ("wide_M32768_numel", 1, 256, 32768, 20, 6554),
    ("wide_M32768_alpha1", 1, 256, 32768, 20, (1.0,)),
    ("wide_M70000_numel", 1, 256, 70000, 20, 14000),
    ("wide_M70000_alpha1", 1, 256, 70000, 20, (1.0,)),
    ("a_static_33", 1, 1024, 1024, 100, 33),
    ("a_static_all_1024", 1, 1024, 1024, 100, 1024),
    ("M16384_static_all", 1, 256, 16384, 20, 16384),
    ("wide_M70000_static_all", 1, 256, 70000, 20, 70000),
)


# H100 SXM rates (NVIDIA data sheet; the ALU pipe's 64 INT32 lanes an SM a
# clock at the 1,980 MHz boost clock on 132 SMs, Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9


def tail_bound_ms(B, K, M, T, numel, unsorted=False):
    """Least times of the solve's two tail calls at (B scenarios, K, M,
    T), each the larger of its bytes over HBM bandwidth and its
    operations: integer comparisons over the ALU pipe's rate plus float32
    operations over the float32 peak.  What the functions need, not what
    the kernels spend: the CVaR selects the worst ``numel`` of M costs
    and orders them, M + numel log2 numel comparisons a row (a selection
    and a comparison sort of what it selected), folds them and divides
    once; the coupling is a division, a product and an
    add a term (2T terms) and lambda's product; the update a subtraction,
    a negation, a division, an exp (counted as one) and two sums' adds a
    rollout, a product and an add a rollout and (t, c), and an add and a
    clamp (2) a (t, c).  Bytes: each input read once, each output written
    once: the CVaR call the costs, the noise, u, sigma, lambda and alpha
    in, the (B, K) costs out; the update the costs, noise, u, lambda and
    both ranges in, u and the weights out.  ``unsorted``: a static count
    of M, whose sum takes the row as it is (no comparison).  Returns
    ``((ms, bound_by) of cvar_costs, (ms, bound_by) of
    update_useq_fused)``."""
    rows = B * K
    a_bytes = 4 * (rows * M + rows * T * 2 + B * T * 2 + 4 * B + rows)
    a_int = 0 if unsorted else rows * (
        M + numel * max(1.0, math.log2(max(numel, 1))))
    a_flt = rows * (numel + 1 + 3 * 2 * T + 2)
    b_bytes = 4 * (rows + rows * T * 2 + 2 * B * T * 2 + 5 * B + rows)
    b_flt = rows * 7 + rows * T * 2 * 2 + B * T * 2 * 3
    out = []
    for nbytes, t_ops in ((a_bytes, a_int / ALU_OPS_PER_S
                           + a_flt / FP32_OPS_PER_S),
                          (b_bytes, b_flt / FP32_OPS_PER_S)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops *= 1e3
        out.append((max(t_bytes, t_ops),
                    "bytes" if t_bytes > t_ops else "operations"))
    return tuple(out)


def coupling_bound_ms(B, K, T):
    """Least time of ``coupling_sums`` at (B, K, T): the larger of its
    bytes over HBM bandwidth (the noise, u and sigma read once, the (B,
    K) sums written once) and its float32 operations over the float32
    peak (a division a scenario's (t, c), a product and an add a row's).
    Returns ``(ms, bound_by)``."""
    rows = B * K
    nbytes = 4 * (rows * T * 2 + B * T * 2 + 2 * B + rows)
    ops = B * T * 2 + rows * T * 2 * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def case_count(case, kw):
    """The fold's terms a row at a case (a static count, or the mean of
    the scenarios' ceil(M alpha), at most M) and whether a static count
    sums the row unsorted: ``tail_bound_ms``'s ``numel`` and
    ``unsorted``."""
    M = case[3]
    if "numel" in kw:
        return min(kw["numel"], M), kw["numel"] >= M
    n = torch.ceil(M * kw["alpha"].float().cpu()).clamp(max=M)
    return float(n.mean()), False


def tail_case_inputs(case, device, seed=None):
    """One ``TAIL_CASES`` case's inputs on ``device``: rollout-like costs
    (a tenth of the (rollout, map) pairs crashed: the obstacle penalty
    1e5 added), noise scaled by sigma (2, 3), controls in [-0.5, 1.5),
    lambda 1 and the flagship's ranges, one a scenario, drawn from a
    generator of ``seed`` (default: the case's place in ``TAIL_CASES``).
    Returns ``(a_args, a_kw, (lambda, vrange, wrange))``:
    ``cvar_costs(*a_args, **a_kw)``, then the update of its costs."""
    name, B, K, M, T, count = case
    dev = torch.device(device)
    if seed is None:
        seed = 1100 + [c[0] for c in TAIL_CASES].index(name)
    g = torch.Generator(device=dev).manual_seed(seed)
    costs = torch.rand((B, K, M), generator=g, device=dev) * 300
    crash = torch.rand((B, K, M), generator=g, device=dev) < 0.1
    costs = torch.where(crash, costs + 1e5, costs)
    sigma = torch.tensor([2.0, 3.0], device=dev).expand(B, 2).contiguous()
    noise = (torch.randn((B, K, T, 2), generator=g, device=dev)
             * sigma[:, None, None, :])
    u = torch.rand((B, T, 2), generator=g, device=dev) * 2 - 0.5
    lam = torch.ones(B, device=dev)
    vr = torch.tensor([0.0, 3.0], device=dev).expand(B, 2).contiguous()
    wr = torch.tensor([-3.14, 3.14], device=dev).expand(B, 2).contiguous()
    if isinstance(count, int):
        kw = dict(numel=count)
    else:
        alphas = (0.2,) if count == "alpha" else count
        kw = dict(alpha=torch.tensor([alphas[b % len(alphas)]
                                      for b in range(B)], device=dev))
    ts = [costs, noise, u, sigma, lam, vr, wr]
    if B == 1:
        ts = [t[0] for t in ts]
        kw = {k: v if isinstance(v, int) else v[0] for k, v in kw.items()}
    costs, noise, u, sigma, lam, vr, wr = ts
    return (costs, noise, u, sigma, lam), kw, (lam, vr, wr)


def torch_coupling(noise, u, u_std):
    """The coupling's sums as the torch ops the coupling kernel replaced:
    u / sigma^2, the product and the sum over (t, c)."""
    scaled = u / (u_std * u_std)[..., None, :]
    return torch.sum(noise * scaled[..., None, :, :], dim=(-2, -1))


def torch_cvar_costs(costs, noise, u, u_std, lam, numel=None, alpha=None):
    """The CVaR plus coupling as the torch ops the kernel replaced."""
    M = costs.shape[-1]
    if alpha is None:
        cvar = torch.topk(costs, min(numel, M), dim=-1,
                          sorted=True).values.mean(-1)
    else:
        srt = torch.sort(costs, dim=-1, descending=True).values
        n = torch.ceil(M * alpha).to(torch.int32)[..., None]
        keep = (torch.arange(M, device=costs.device)
                < n[..., None]).to(costs.dtype)
        cvar = (srt * keep).sum(-1) / n.to(costs.dtype)
    scaled = u / (u_std * u_std)[..., None, :]
    return cvar + lam[..., None] * torch.sum(noise * scaled[..., None, :, :],
                                             dim=(-2, -1))


def torch_update(costs, noise, u, lam, vrange, wrange):
    """The softmax update as the torch ops the kernel replaced."""
    beta = torch.min(costs, dim=-1, keepdim=True).values
    w = torch.exp(-(costs - beta) / lam[..., None])
    w = w / torch.sum(w, dim=-1, keepdim=True)
    u_new = u + torch.sum(w[..., None, None] * noise, dim=-3)
    v, om = clip_controls(u_new, vrange[..., None, :], wrange[..., None, :])
    return torch.stack([v, om], -1), w


def bitwise(got, want):
    """Whether two float32 results (tensors or tuples of them) have the
    same bits."""
    if isinstance(got, tuple):
        return all(bitwise(g, w) for g, w in zip(got, want))
    return got.shape == want.shape and torch.equal(
        got.contiguous().view(torch.int32),
        want.contiguous().view(torch.int32))


def time_call(fn, n, device):
    """Mean ms of ``fn()`` over ``n`` calls: replayed from one CUDA graph
    on a card (device clock), eager on the host clock on the CPU."""
    if device.type == "cuda":
        return _card.time_cuda_graph(fn, n, 2)
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def measure(case, device, n):
    """One case's line: the kernels against their plain versions (bit for
    bit) and the kernels' and the torch ops' ms."""
    a_args, kw, (lam, vr, wr) = tail_case_inputs(case, device)
    noise, u = a_args[1], a_args[2]
    costs_k = kc.cvar_costs(*a_args, **kw)
    b_args = (costs_k, noise, u, lam, vr, wr)
    name, B, K, M, T, count = case
    numel, unsorted = case_count(case, kw)
    (a_ms, a_by), (b_ms, b_by) = tail_bound_ms(B, K, M, T, numel, unsorted)
    line = dict(
        case=name, scenarios=B, K=K, M=M, T=T,
        count=count if isinstance(count, (int, str)) else list(count),
        cvar_bitwise=bitwise(costs_k, kc.cvar_costs_plain(*a_args, **kw)),
        update_bitwise=bitwise(ku.update_useq_fused(*b_args),
                               ku.update_useq_plain(*b_args)),
        cvar_ms=time_call(lambda: kc.cvar_costs(*a_args, **kw), n, device),
        cvar_torch_ops_ms=time_call(
            lambda: torch_cvar_costs(*a_args, **kw), n, device),
        cvar_bound_ms=a_ms, cvar_bound_by=a_by,
        update_ms=time_call(lambda: ku.update_useq_fused(*b_args), n,
                            device),
        update_torch_ops_ms=time_call(lambda: torch_update(*b_args), n,
                                      device),
        update_bound_ms=b_ms, update_bound_by=b_by)
    if kc.kernel_path(B, K, M, T)[3]:
        c_args = (noise, u, a_args[3])
        c_ms, c_by = coupling_bound_ms(B, K, T)
        line.update(
            coupling_bitwise=bitwise(kc.coupling_sums(*c_args),
                                     kc.coupling_sums_plain(*c_args)),
            coupling_ms=time_call(lambda: kc.coupling_sums(*c_args), n,
                                  device),
            coupling_torch_ops_ms=time_call(
                lambda: torch_coupling(*c_args), n, device),
            coupling_bound_ms=c_ms, coupling_bound_by=c_by)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    add_small_arg(ap)
    args = ap.parse_args(argv)
    device, card = start(args)
    cases, n = TAIL_CASES, N
    if args.small:
        cases = [(name, B, SMALL_K, min(M, SMALL_M), SMALL_T, count)
                 for name, B, K, M, T, count in TAIL_CASES[:3]]
        n = 2
    for case in cases:
        line = measure(case, device, n)
        if not (line["cvar_bitwise"] and line["update_bitwise"]
                and line.get("coupling_bitwise", True)):
            raise RuntimeError("tail_bench: a kernel differs from its plain "
                               "version: {}".format(line))
        emit(dict(line, card=card, clock=clock(device).replace(
            "CUDA-graph replays", "{} calls in one CUDA graph".format(n))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
