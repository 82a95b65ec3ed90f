"""The summation orders of the solve's reductions, each the same on the
CPU and in the kernels (``csrc/tree_sum.cuh``, ``csrc/cvar_common.cuh``):
XLA's CPU order for the CVaR, the halving tree for the coupling and the
update.

The order is part of the result: the update's softmax turns one ulp of a
cost into some 1e-4 of a control after two iterations at lambda 1.

``window_sum``, XLA's CPU order for a row reduction, for the CVaR (the
JAX package's ``jnp.sum`` / ``jnp.mean`` over its cost rows): a row of n
<= 32 terms folds left to right from +0.0 (n = 1: the term itself); a
longer row is padded with +0.0 to m = ceil(n / 32) windows of 32,
floor(pad / 2) zeros in front and the rest behind, each window folds left
to right from +0.0, and the m partial sums are summed the same way.  XLA
on the CPU rewrites a reduction of more than 32 terms into that
``reduce-window`` of 32 followed by a reduce of the partials; the model
equals ``jnp.sum`` bit for bit (``tests/test_torch_solve_tail.py``).
Zeros change no partial sum that starts from +0.0, but where the windows
fall depends on n: the static CVaR sums its ``numel`` worst costs in
windows over ``numel``, the run-time alpha its masked sorted row in
windows over M, and the two differ in the last bits, as JAX's do.

``tree_sum``, the halving tree, for the control coupling and the update:
take a row of n terms and pad it with -0.0 to a power of two L >= n; then,
while L > 1: L <- L / 2 and ``v[i] <- v[i] + v[i + L]`` for i < L; the sum
is ``v[0]``.  It maps onto a CUDA block without reordering: the levels
above the block's width are adds inside a thread (thread j owns j + r *
width), then shared memory, then the last five levels are warp shuffles.
It gives the same bits for any number of -0.0 terms padded at the end,
since ``x + (-0.0) == x`` for every float x (-0.0 included).
"""

from __future__ import annotations

import torch

WINDOW = 32


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


def window_levels(n):
    """The windows of ``window_sum`` over n terms, level by level: ``[(n,
    lo), ...]``, each level's term count and the +0.0 terms padded in front
    of it, up to the level of at most 32 terms."""
    levels = []
    while True:
        m = -(-n // WINDOW)
        levels.append((n, (WINDOW * m - n) // 2))
        if n <= WINDOW:
            return levels
        n = m


def window_sum(x, dim=-1):
    """Sum ``x`` over ``dim`` in XLA's CPU order (windows of 32, see the
    module docstring); float32 in, float32 out, ``dim`` removed."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n == 1:
        return x[..., 0]
    lead = x.shape[:-1]
    for n, lo in window_levels(n):
        m = -(-n // WINDOW)
        x = torch.cat([x.new_zeros(lead + (lo,)), x,
                       x.new_zeros(lead + (WINDOW * m - n - lo,))], -1)
        x = x.reshape(lead + (m, WINDOW))
        total = x.new_zeros(lead + (m,))
        for j in range(WINDOW):
            total = total + x[..., j]
        x = total
    return x[..., 0]
