"""The solve's tail: the CVaR over M plus the control coupling
(``ops/kernels/cvar_costs.py``) and the softmax-weighted update
(``ops/kernels/update_useq.py``), their plain versions against the JAX
package's functions, and the summation orders they share with the kernels
(``ops/tree.py``).

Inputs come from a numpy seed at small sizes.  Tolerances: the CVaR plus
coupling within rtol 1e-5 / atol 1e-6 of JAX's (float32 sums of the same
terms in another order); the update's controls within the JAX package's
whole-solve rtol 2e-4 / atol 2e-5, its weights within rtol 1e-5 / atol
1e-8.  The kernels themselves run on a card only
(``tests/test_torch_kernels_gpu.py``).
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_numba_tpu import ops as jops
from mppi_numba_tpu.ops import cvar as jcvar
from mppi_numba_tpu.ops import rollout as jrollout
from mppi_numba_tpu.ops import update as jupdate
from mppi_numba_tpu_torch import ops as tops
from mppi_numba_tpu_torch.config import rec_max_control_rollouts
from mppi_numba_tpu_torch.drivers import tail_bench
from mppi_numba_tpu_torch.ops.cvar import (cvar_from_costs,
                                           cvar_from_costs_dynamic)
from mppi_numba_tpu_torch.ops.kernels import cvar_costs as kcvar
from mppi_numba_tpu_torch.ops.kernels import update_useq as kupdate
from mppi_numba_tpu_torch.ops.tree import fold_sum, padded_length, tree_sum

A_TOL = dict(rtol=1e-5, atol=1e-6)
U_TOL = dict(rtol=2e-4, atol=2e-5)
W_TOL = dict(rtol=1e-5, atol=1e-8)
PENALTY = 1e5        # the flagship's obstacle penalty: a crash's cost


def _inputs(seed, B, K, M, T):
    """Costs with ties and rows of equal crash penalties, noise, controls
    and per-scenario task values; ``B`` None for no scenario axis."""
    rng = np.random.RandomState(seed)
    lead = () if B is None else (B,)
    f32 = np.float32
    costs = (rng.rand(*lead, K, M) * 100).astype(f32)
    costs[..., 1, :] = np.round(costs[..., 1, :] / 10) * 10     # ties
    costs[..., 2, :] = PENALTY                                  # all crash
    costs[..., 3, : (M + 1) // 2] = PENALTY + 7.5               # half crash
    noise = rng.randn(*lead, K, T, 2).astype(f32)
    u = rng.uniform(-1, 2, lead + (T, 2)).astype(f32)
    n = 1 if B is None else B
    u_std = np.stack([rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 3.0, n)],
                     -1).astype(f32)
    lam = rng.uniform(0.5, 2.0, n).astype(f32)
    alpha = rng.uniform(0.05, 1.0, n).astype(f32)
    if B is None:
        u_std, lam, alpha = u_std[0], lam[0], alpha[0]
    return costs, noise, u, u_std, lam, alpha


def _t(*xs):
    return [torch.tensor(x) for x in xs]


def _jax_a(costs, noise, u, u_std, lam, numel=None, alpha=None):
    """JAX's cvar_from_costs(_dynamic) + control_coupling, vmapped over a
    scenario axis."""
    def one(c, e, uu, s, lm, al):
        cvar = (jcvar.cvar_from_costs(c, numel) if al is None
                else jcvar.cvar_from_costs_dynamic(c, al))
        return cvar + jrollout.control_coupling(uu, e, s, lm)

    args = [jnp.asarray(x) for x in (costs, noise, u, u_std, lam)]
    al = None if alpha is None else jnp.asarray(alpha)
    if costs.ndim == 2:
        return np.asarray(one(*args, al))
    if al is None:
        return np.asarray(jax.vmap(lambda *a: one(*a, None))(*args))
    return np.asarray(jax.vmap(one)(*args, al))


SHAPES = [(K, M, T) for K in (37, 64) for M in (1, 5, 64, 100)
          for T in (3, 7)]


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("K,M,T", SHAPES)
def test_plain_a_static_matches_jax(K, M, T, B):
    """The static count at 1, M - 1 and M (M: the plain mean)."""
    costs, noise, u, u_std, lam, _ = _inputs(K + M + T, B, K, M, T)
    for numel in sorted({1, max(M - 1, 1), M}):
        got = kcvar.cvar_costs_plain(*_t(costs, noise, u, u_std, lam),
                                     numel=numel)
        want = _jax_a(costs, noise, u, u_std, lam, numel=numel)
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(numel),
                                   **A_TOL)


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("K,M,T", SHAPES)
def test_plain_a_dynamic_matches_jax(K, M, T, B):
    """A run-time alpha (a different one a scenario)."""
    costs, noise, u, u_std, lam, alpha = _inputs(K * M + T, B, K, M, T)
    got = kcvar.cvar_costs_plain(*_t(costs, noise, u, u_std, lam),
                                 alpha=torch.tensor(alpha))
    want = _jax_a(costs, noise, u, u_std, lam, alpha=alpha)
    np.testing.assert_allclose(got.numpy(), want, **A_TOL)


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("M", [1, 5, 64, 100])
def test_static_and_dynamic_cvar_agree_bitwise(M, B):
    """The same count, static or from alpha: the same bits (the sort's
    worst costs, -0.0 past the count, summed largest first)."""
    costs, noise, u, u_std, lam, _ = _inputs(M, B, 37, M, 3)
    tc = torch.tensor(costs)
    lead = () if B is None else (B,)
    for numel in sorted({1, max(M // 3, 1), max(M - 1, 1), M}):
        # An alpha whose float32 ceil(M * alpha) is numel.
        alpha = np.float32((numel - 0.5) / M)
        assert int(np.ceil(np.float32(M) * alpha)) == numel
        ta = torch.full(lead, float(alpha))
        static = cvar_from_costs(tc, numel)
        dynamic = cvar_from_costs_dynamic(tc, ta)
        assert torch.equal(static, dynamic), numel
        args = _t(costs, noise, u, u_std, lam)
        assert torch.equal(kcvar.cvar_costs_plain(*args, numel=numel),
                           kcvar.cvar_costs_plain(*args, alpha=ta)), numel


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("K,T", [(37, 3), (64, 7), (1000, 7)])
def test_plain_b_matches_jax(K, T, B):
    """The update from plain A's costs at lambda 1."""
    costs, noise, u, u_std, _, alpha = _inputs(K + T, B, K, 5, T)
    lead = () if B is None else (B,)
    lam = np.ones(lead, np.float32)
    vr = np.broadcast_to(np.array([0.0, 2.0], np.float32), lead + (2,))
    wr = np.broadcast_to(np.array([-2.5, 2.5], np.float32), lead + (2,))
    costs_k = kcvar.cvar_costs_plain(*_t(costs, noise, u, u_std, lam),
                                     alpha=torch.tensor(alpha))
    got_u, got_w = kupdate.update_useq_plain(
        costs_k, *_t(noise, u, lam, np.ascontiguousarray(vr),
                     np.ascontiguousarray(wr)))

    def one(c, e, uu, lm, v, w):
        return jupdate.update_useq(c, e, uu, lm, v, w)

    args = [jnp.asarray(x) for x in (costs_k.numpy(), noise, u, lam, vr, wr)]
    want_u, want_w = one(*args) if B is None else jax.vmap(one)(*args)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **U_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **W_TOL)


def test_fused_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions, bit for bit,
    and count no launch; the solve's names route to them."""
    costs, noise, u, u_std, lam, alpha = _inputs(3, 3, 64, 64, 7)
    args = _t(costs, noise, u, u_std, lam)
    before = (kcvar.cvar_costs.launches, kupdate.update_useq_fused.launches)
    a = kcvar.cvar_costs(*args, alpha=torch.tensor(alpha))
    assert torch.equal(a, kcvar.cvar_costs_plain(*args,
                                                 alpha=torch.tensor(alpha)))
    vr = torch.tensor([[0.0, 2.0]] * 3)
    wr = torch.tensor([[-2.5, 2.5]] * 3)
    got = kupdate.update_useq_fused(a, args[1], args[2], args[4], vr, wr)
    want = kupdate.update_useq_plain(a, args[1], args[2], args[4], vr, wr)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        tops.update_useq(a, args[1], args[2], args[4], vr, wr), want))
    assert (kcvar.cvar_costs.launches,
            kupdate.update_useq_fused.launches) == before


def test_ops_keep_the_jax_signatures():
    """``ops.cvar_from_costs`` and ``ops.update_useq`` take JAX's
    arguments and give its results within the stated tolerances."""
    costs, noise, u, u_std, lam, _ = _inputs(11, None, 64, 100, 7)
    got = tops.cvar_from_costs(torch.tensor(costs), 20)
    want = np.asarray(jops.cvar_from_costs(jnp.asarray(costs), 20))
    np.testing.assert_allclose(got.numpy(), want, **A_TOL)
    vr, wr = np.array([0.0, 2.0], np.float32), np.array([-2.5, 2.5],
                                                        np.float32)
    c = got.numpy()
    gu, gw = tops.update_useq(*_t(c, noise, u, np.float32(1.0), vr, wr))
    ju, jw = jops.update_useq(*(jnp.asarray(x) for x in (c, noise, u)),
                              jnp.float32(1.0), jnp.asarray(vr),
                              jnp.asarray(wr))
    np.testing.assert_allclose(gu.numpy(), np.asarray(ju), **U_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **W_TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 32, 33, 100, 205, 1000])
def test_sums_do_not_change_with_padded_length(n):
    """Any number of -0.0 terms padded at the end leaves both orders'
    bits as they were: the tree at every power of two past n, the fold at
    any length."""
    rng = np.random.RandomState(n)
    x = torch.tensor((rng.randn(16, n) * 10.0 ** rng.uniform(-3, 5, (16, n))
                      ).astype(np.float32))
    x[0] = -0.0
    base_tree, base_fold = tree_sum(x), fold_sum(x)
    for extra in (1, padded_length(n) - n + 1, 3 * padded_length(n)):
        pad = torch.cat([x, torch.full((16, extra), -0.0)], -1)
        assert torch.equal(tree_sum(pad).view(torch.int32),
                           base_tree.view(torch.int32)), extra
        assert torch.equal(fold_sum(pad).view(torch.int32),
                           base_fold.view(torch.int32)), extra
    assert torch.equal(fold_sum(x[:, :1]), x[:, 0])


def test_tree_is_the_halving_order():
    """The tree adds v[i] + v[i + L/2] level by level, not in pairs of
    neighbours: a row whose two orders round apart."""
    x = torch.tensor([[1.0, 1e8, -1e8, 1.0]])
    # Halving: (1 + -1e8) + (1e8 + 1) = -1e8 + 1e8 = 0 in float32.
    assert tree_sum(x).item() == 0.0
    # Neighbours would give (1 + 1e8) + (-1e8 + 1) = 0 too; a fold 1.
    assert fold_sum(x).item() == 1.0
    y = torch.tensor([[3.0, 1e8, 1.0, -1e8]])
    # Halving: (3 + 1) + (1e8 - 1e8) = 4; neighbours: 1e8 - 1e8 = 0.
    assert tree_sum(y).item() == 4.0


# Every path's M: the det modes' and the barebone's 1, the confidence
# example's 64, external PMF's 512, the flagship's and the sweep's 1024,
# the m-sharded pools S * min(numel, M / S) of the flagship's numel 205 at
# S = 2, 4 and 8 ranks (410, 820 and 1024), the run-time alpha's gathered
# rows (M), and the Config's largest M (a solve at any Config's M).
PATH_M = {"det_barebone": 1, "confidence": 64, "external": 512,
          "flagship_sweep": 1024,
          **{"pool_{}".format(S): S * min(205, 1024 // S) for S in (2, 4, 8)},
          "config_max": rec_max_control_rollouts}


@pytest.mark.parametrize("path", sorted(PATH_M))
def test_the_kernel_cap_covers_every_path(path):
    """Every path's M takes the team kernel (a row sorted by one team),
    and the argument check accepts it."""
    M = PATH_M[path]
    assert kcvar.kernel_path(1, 8, M, 5)[0] == "cvar_costs_kernel"
    K, T = 8, 5
    args = [torch.zeros(K, M), torch.zeros(K, T, 2), torch.zeros(T, 2),
            torch.ones(2), torch.tensor(1.0)]
    assert kcvar.check_args(*args, numel=min(205, M), alpha=None) == (
        1, K, M, T)


def test_the_kernel_cap_raises_past_it():
    """Of the argument checks' refusals only the count's remains: the M
    and K caps are gone (``test_check_args_accept_the_lifted_shapes``)."""
    M = 70000
    args = [torch.zeros(4, M), torch.zeros(4, 3, 2), torch.zeros(3, 2),
            torch.ones(2), torch.tensor(1.0)]
    with pytest.raises(ValueError, match="one of numel and alpha"):
        kcvar.check_args(*args, numel=None, alpha=None)


# Shapes the kernels' argument checks once refused: T past 4,096 steps,
# M past 15,000 map samples (70,000: past the rollouts' former 65,535 too)
# and K up to the barebone Config's 1e6 rollouts, with and without a
# scenario axis.
LIFTED = {"T4097": (None, 8, 4, 4097), "T20000": (2, 8, 4, 20000),
          "M70000": (None, 4, 70000, 3), "M70000_B2": (2, 4, 70000, 3),
          "K1000000": (None, 1000000, 1, 3)}


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_check_args_accept_the_lifted_shapes(name):
    """Both tail kernels' argument checks accept T = 4,097 and 20,000,
    M = 70,000 and K = 1e6 on CPU tensors, naming the shapes back."""
    B, K, M, T = LIFTED[name]
    lead = () if B is None else (B,)
    n = () if B is None else (B,)
    costs = torch.zeros(lead + (K, M))
    noise = torch.zeros(lead + (K, T, 2))
    u = torch.zeros(lead + (T, 2))
    assert kcvar.check_args(
        costs, noise, u, torch.ones(n + (2,)), torch.ones(n), numel=None,
        alpha=torch.full(n, 0.2)) == (B or 1, K, M, T)
    assert kupdate.check_args(
        costs[..., 0], noise, u, torch.ones(n), torch.zeros(n + (2,)),
        torch.zeros(n + (2,))) == (B or 1, K, T)


CSRC = Path(kcvar.__file__).resolve().parents[2] / "csrc"


def _compiled(source, macro):
    """The (first, second) template arguments a csrc source instantiates,
    read from its shape list ``#define <macro>(X_) X_(a, b) ...``."""
    text = (CSRC / source).read_text()
    body = re.search(r"#define {}\(X_\)(.*?)\n\n".format(macro), text,
                     re.S).group(1)
    return {(int(a), int(b))
            for a, b in re.findall(r"X_\((\d+), (\d+)\)", body)}


def _cvar_instance(tpr, M):
    """The (threads a row, keys a thread) instantiation a launch takes."""
    return tpr, max(padded_length(M), tpr) // tpr


def _update_instance(K, shape):
    """The (positions a thread, blocks a cluster) instantiation."""
    width, cluster = shape
    return max(padded_length(K), 32) // width, cluster


def _source_has(source, *patterns):
    text = (CSRC / source).read_text()
    return all(re.search(p, text) for p in patterns)


@pytest.mark.parametrize("B", [1, 3, 30])
@pytest.mark.parametrize("K", [1, 17, 512, 1000, 1024, 2048, 10240, 15000,
                               kupdate.FUSED_K, kupdate.FUSED_K + 1, 40000,
                               100000, 1000000])
def test_every_launch_shape_the_launchers_pick_is_compiled(B, K):
    """Whatever the launchers pick (host arithmetic on the shapes) is an
    instantiation the kernels' sources compile, with at most 8 own rows a
    thread for the update: a shape past them would return
    cudaErrorInvalidValue.  Past T = 4,096 every CVaR instantiation's
    streamed twin, past M = 16,384 the wide CVaR kernel (1,024 threads),
    past K = 32,768 the wide update (at least 16 blocks a scenario, each
    4,096 positions)."""
    cvar_shapes = _compiled("cvar_common.cuh", "CVAR_SHAPES")
    update_shapes = _compiled("update_useq.cu", "UPDATE_SHAPES")
    assert all(a // c <= 8 for a, c in update_shapes)
    # Each (threads, keys) shape's launch instantiates both twins, the
    # staged one in cvar_costs.cu's library, the streamed in cvar_wide.cu's.
    assert _source_has("cvar_costs.cu",
                       r"cvar_costs_kernel<TPR_, E_, false><<<")
    assert _source_has("cvar_wide.cu", r"cvar_costs_kernel<TPR_, E_, true><<<",
                       r"cvar_wide_kernel<<<")
    assert _source_has("cvar_common.cuh", r"kSortedM = kWideTPR \* 16",
                       r"kStagedT = 4096")
    for M in (1, 2, 64, 65, 512, 1000, 1024, 1025, 4096, 5000, 8192,
              15000, 16384, 16385, 32768, 70000):
        for T in (1, 100, 4096, 4097, 20000):
            for sms in (132, 114, 8):
                path, tpr, E, streamed = kcvar.kernel_path(B, K, M, T, sms)
                assert streamed == (T > kcvar.STAGED_T or M > kcvar.SORTED_M)
                if M > kcvar.SORTED_M:
                    assert (path, tpr) == ("cvar_wide_kernel", 1024), M
                else:
                    assert path == "cvar_costs_kernel"
                    assert (tpr, E) == _cvar_instance(tpr, M)
                    assert (tpr, E) in cvar_shapes, (M, sms, tpr)
    assert _source_has("update_wide.cu", r"kFusedK = kMaxBlock \* 64",
                       r"kWidePer = kWideW \* kWideA",
                       r"extern \"C\" int update_useq_wide_launch")
    for T in (1, 7, 40, 100, 4096, 4097):
        if K > kupdate.FUSED_K:
            G = kupdate.wide_blocks(K)
            assert G >= 16 and G * kupdate.WIDE_POSITIONS >= K
            assert G * kupdate.WIDE_POSITIONS == padded_length(K)
            continue
        for sms in (132, 114, 8):
            shape = kupdate.launch_shape(B, K, T, sms)
            assert _update_instance(K, shape) in update_shapes, (T, shape)


def _card_tests():
    """``tests/test_torch_kernels_gpu.py`` as a module (it imports no JAX):
    its case lists, held here without a card."""
    spec = importlib.util.spec_from_file_location(
        "torch_kernels_gpu_cases",
        Path(__file__).with_name("test_torch_kernels_gpu.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("sms", [132, 114])
def test_card_edge_tests_reach_every_cvar_instantiation(sms):
    """The card-only CVaR edge test's rows get, through the launcher, the
    team each case names, and the cases cover every instantiation the
    source compiles."""
    card = _card_tests()
    reached = set()
    for M, tpr in card.CVAR_EDGE_TEAMS:
        B, K = card.cvar_edge_rows(M, tpr, sms)
        assert kcvar.threads_per_row(B, K, M, sms) == tpr, (M, tpr)
        assert (B * K) % 4, (M, tpr)   # no multiple of a block's 4 teams
        reached.add(_cvar_instance(tpr, M))
    assert reached == _compiled("cvar_common.cuh", "CVAR_SHAPES")


def test_card_edge_tests_reach_every_update_instantiation():
    """The card-only update test's shapes cover, through ``launch_shape``
    on an H100's 132 SMs, every instantiation the source compiles."""
    reached = {_update_instance(K, kupdate.launch_shape(B or 1, K, T))
               for B, K, T in _card_tests().UPDATE_EDGE_SHAPES}
    assert reached == _compiled("update_useq.cu", "UPDATE_SHAPES")


# The launchers' choices on an H100 (132 SMs) at every TAIL_CASES shape:
# the CVaR's threads a row, the update's (threads a block, blocks a
# cluster), or past K = 32,768 the wide path's blocks a scenario.
LAUNCHES = {
    "a_static_205": (128, (256, 4)),
    "a_planner_alpha": (128, (256, 4)),
    "sweep_b30_alphas": (32, (256, 1)),
    "det_M1_T40": (32, (256, 4)),
    "det_M1_T80": (32, (256, 4)),
    "det_M1_T100": (32, (256, 4)),
    "sweep_det_b30_M1": (32, (256, 1)),
    "external_K2048_M512_T80": (32, (512, 4)),
    "confidence_M64_T60": (32, (256, 4)),
    "barebone_K1000_T50": (32, (256, 4)),
    "model_bench_K10240_tdm": (32, (512, 4)),
    "model_bench_K10240_det": (32, (512, 4)),
    "pool_2_ranks_410": (32, (256, 1)),
    "pool_4_ranks_820": (32, (256, 1)),
    "pool_8_ranks_1024": (128, (256, 4)),
    "gathered_rows_alpha": (32, (128, 1)),
    "shared_memory_sort_M2048": (512, (64, 4)),
    "shared_memory_sort_M4096": (512, (32, 2)),
    "ragged_M5000": (512, (64, 4)),
    "M8192_alpha": (512, (32, 4)),
    "config_max_M15000": (1024, (32, 2)),
    "streamed_T4097": (32, (256, 1)),
    "streamed_T20000": (32, (256, 1)),
    "wide_update_K40000": (32, ("wide", 16)),
    "wide_update_K100000": (32, ("wide", 32)),
    "wide_update_K1000000": (32, ("wide", 256)),
    "M16384_numel": (1024, (64, 4)),
    "M16384_alpha1": (1024, (64, 4)),
    "wide_M32768_numel": (1024, (64, 4)),
    "wide_M32768_alpha1": (1024, (64, 4)),
    "wide_M70000_numel": (1024, (64, 4)),
    "wide_M70000_alpha1": (1024, (64, 4)),
}


@pytest.mark.parametrize("case", tail_bench.TAIL_CASES,
                         ids=[c[0] for c in tail_bench.TAIL_CASES])
def test_launchers_choose_each_path_shapes_team(case):
    """The launch shapes each path's shape gets on an H100, held here on
    the CPU: a change to the rules shows as a change of this table."""
    name, B, K, M, T, _ = case
    update = (kupdate.launch_shape(B, K, T) if K <= kupdate.FUSED_K
              else ("wide", kupdate.wide_blocks(K)))
    assert (kcvar.threads_per_row(B, K, M), update) == LAUNCHES[name]
