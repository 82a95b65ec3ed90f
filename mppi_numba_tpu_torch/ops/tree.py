"""The summation orders of the solve's reductions, each the same on the
CPU and in the kernels (``csrc/tree_sum.cuh``, ``csrc/cvar_costs.cu``).

The order is part of the result: the update's softmax turns one ulp of a
cost into some 1e-4 of a control after two iterations at lambda 1.

``tree_sum``, the halving tree, for the control coupling and the update:
take a row of n terms and pad it with -0.0 to a power of two L >= n; then,
while L > 1: L <- L / 2 and ``v[i] <- v[i] + v[i + L]`` for i < L; the sum
is ``v[0]``.  It maps onto a CUDA block without reordering: the levels
above the block's width are adds inside a thread (thread j owns j + r *
width), then shared memory, then the last five levels are warp shuffles.

``fold_sum``, left to right, for the CVaR's worst costs (sorted
descending): the JAX package's reduction on the CPU sums a row of up to 32
terms in this order, and the port's whole-solve tests, whose CVaR takes
the worst 4 of 16 costs, hold the controls to within 2e-4 of it after two
iterations; the halving tree moved them 6x past that.

Both give the same bits for any number of -0.0 terms padded at the end,
since ``x + (-0.0) == x`` for every float x (-0.0 included): the
top-``numel`` sum of the static CVaR, the masked sum over all M of the
run-time alpha and the sum over the m-sharded candidate pool agree bit for
bit.
"""

from __future__ import annotations

import torch


def padded_length(n):
    """The least power of two >= ``n`` (1 for n <= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def tree_sum(x, dim=-1):
    """Sum ``x`` over ``dim`` in the halving tree's order; float32 in,
    float32 out, ``dim`` removed."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    L = padded_length(n)
    if L > n:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (L - n,), -0.0)], -1)
    while L > 1:
        L //= 2
        x = x[..., :L] + x[..., L:]
    return x[..., 0]


def fold_sum(x, dim=-1):
    """Sum ``x`` over ``dim`` left to right, ``((x0 + x1) + x2) + ...``;
    float32 in, float32 out, ``dim`` removed."""
    x = x.movedim(dim, -1)
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total
