"""The planners' visualisation rollouts: the hand-written CUDA kernels and
their wrappers; the plain PyTorch versions are ``ops/rollout.py::
terrain_vis_fused_plain`` and ``barebone_vis_fused_plain``.

``terrain_vis_fused`` and ``barebone_vis_fused`` launch
``csrc/vis_rollout.cu`` for CUDA tensors and run the plain versions for
CPU tensors.  Each kernel is a planner's whole vis function (the JAX
package's ``solver.get_terrain_vis`` / ``get_barebone_vis``, which XLA
compiles around the ``lax.scan``s ``terrain_vis_states`` /
``barebone_vis_states``; no Pallas kernel): the controls, the crop's
shifted limits, the packed word's two bytes and the T-step loop, in the
plain versions' order of operations (the bicycle's wheelbase by its
float32 reciprocal, as PyTorch divides by a Python scalar on CUDA), so the
kernels equal them bit for bit on CUDA tensors.  The terrain vis runs a
block a rollout, its chain on one thread, its grid planes (the
``"shared"`` route, where they fit and cost no wave: ``vis_route``),
controls and states staged in shared memory; the barebone vis a warp a rollout, 32 steps at a
time.  A vis graph replays one kernel node where the torch loop
replayed thousands.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ...models import KERNEL_MODELS, kernel_model, unicycle_step
from ..rollout import barebone_vis_fused_plain, terrain_vis_fused_plain
from .cvar_costs import H100_SMS, check_tensor

KERNEL_SOURCE = "mppi_numba_tpu_torch/csrc/vis_rollout.cu"
REPLACES = ("mppi_numba_tpu/ops/rollout.py:133-176,232-249 "
            "(terrain_vis_states, barebone_vis_states) in "
            "mppi_numba_tpu/solver.py:327-362,392-400 (get_terrain_vis, "
            "get_barebone_vis), XLA-compiled lax.scans; no Pallas kernel")
# The source's kThreads and kChunk: a terrain block's threads (a block a
# rollout; the barebone kernel runs a warp a rollout), and the steps of a
# chunk of the terrain kernel's control ring.
THREADS = 128
CHUNK = 1024
# Shared memory an H100 block may take (its opt-in, 227 KB); on a card the
# route is chosen against the card's own (``vis_prepare``).
SMEM_BUDGET = 232448
# Rollouts a launch: the kernel indexes them with 32-bit ints.
MAX_ROLLOUTS = 2 ** 31 - 1
# The terrain task's fields the kernel reads, in the launch's order, with
# their shapes.
TERRAIN_FIELDS = (("x0", (3,)), ("dt", ()), ("res", ()), ("xlim0", ()),
                  ("ylim0", ()), ("lin_lb", ()), ("lin_ratio", ()),
                  ("ang_lb", ()), ("ang_ratio", ()), ("vrange", (2,)),
                  ("wrange", (2,)))
BAREBONE_FIELDS = (("x0", (3,)), ("dt", ()), ("vrange", (2,)),
                   ("wrange", (2,)))


def _round16(n):
    return -(-n // 16) * 16


def ring_chunk(T):
    """Steps a chunk of the terrain kernel's control ring holds at T steps
    (the source's ``ring_chunk``)."""
    return max(1, min(T, CHUNK))


def plane_bytes(cells):
    """Shared bytes a staged int8 plane takes (the source's
    ``plane_bytes``): the 16-byte chunks from the one holding its first
    byte to the one holding its last, at any alignment."""
    return _round16(cells + 32)


def smem_bytes(T, H, W, det, bicycle, shared_grid):
    """The terrain kernel's dynamic shared memory, as the source's
    ``layout`` lays it out: two chunks of controls (float2), of noise rows
    (det) and of tanf of the steering (bicycle); a chunk of states; the
    grid's two planes (``shared_grid``)."""
    c = ring_chunk(T)
    return (16 * c + (16 * c if det else 0)
            + (_round16(8 * c) if bicycle else 0) + _round16(12 * c)
            + (2 * plane_bytes(H * W) if shared_grid else 0))


VisRoute = collections.namedtuple("VisRoute", "route chunk smem_bytes")

# The shared memory an H100 SM holds, the bytes it reserves a block, and
# the threads it runs at once: ``h100_blocks_at_once``.
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
THREADS_PER_SM = 2048


def h100_blocks_at_once(route, smem):
    """Terrain blocks an H100 runs at once with ``smem`` dynamic shared
    bytes each, by its threads and shared memory alone: the model
    ``vis_route`` takes off a card.  On a card the wrapper asks the
    card's occupancy calculator, which counts registers too
    (``blocks_per_sm``)."""
    return H100_SMS * min(THREADS_PER_SM // THREADS,
                          SMEM_PER_SM // (smem + SMEM_RESERVED))


def waves(V, at_once):
    """Rounds of ``at_once`` blocks that V blocks take."""
    return -(-V // at_once)


def vis_route(V, T, H, W, det, bicycle, budget=SMEM_BUDGET,
              at_once=h100_blocks_at_once):
    """How ``terrain_vis_kernel`` runs V rollouts of T steps on an H x W
    grid: a block of ``THREADS`` a rollout, the controls in a ring of
    ``chunk``-step chunks, and the grid staged in shared memory (route
    ``"shared"``) where it fits beside the ring in ``budget`` bytes and the
    launch takes no more waves than on the global route (``at_once(route,
    smem)``: blocks the card runs at once); else read from global memory
    (``"global"``).  The staged grid keeps an SM to fewer blocks: at 250 x
    250, one, and past 132 rollouts an H100 would queue them where the
    global route runs them all at once.  A pure function of the shape and
    of the card's limits: each route is its own instantiation, and neither
    is taken after the other failed."""
    chunk = ring_chunk(T)
    glob = smem_bytes(T, H, W, det, bicycle, False)
    shared = smem_bytes(T, H, W, det, bicycle, True)
    if shared <= budget and (waves(V, at_once("shared", shared))
                             <= waves(V, at_once("global", glob))):
        return VisRoute("shared", chunk, shared)
    return VisRoute("global", chunk, glob)


def vis_rows(V, det, lin_grids, noise_vis):
    """The rollouts a vis draws: tdm ``min(V, M)`` (grids ``[:V]``), the
    det modes and the barebone engine ``max(1, N)`` of ``N`` noise rows
    (``u_cur``, then a noisy row for each noise row past the first)."""
    if det:
        return max(1, noise_vis.shape[0])
    return min(V, lin_grids.shape[0])


@functools.lru_cache(maxsize=None)
def _library():
    """The built library, its entry points' ctypes signatures set once."""
    from ._build import load

    lib = load("vis_rollout")
    lib.terrain_vis_launch.argtypes = (
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.barebone_vis_launch.argtypes = ([ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 2
                                        + [ctypes.c_void_p])
    lib.vis_prepare.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.vis_kernel_attributes.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.vis_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.sincos_check_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.terrain_vis_launch, lib.barebone_vis_launch,
               lib.vis_prepare, lib.vis_kernel_attributes,
               lib.vis_blocks_per_sm, lib.sincos_check_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _prepared(index):
    """Lets the terrain kernels take card ``index``'s opt-in shared memory
    (once a card, outside any capture: a planner's first vis call on a card
    is eager); returns that opt-in, bytes a block."""
    optin = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().vis_prepare(ctypes.byref(optin))
    if err != 0:
        raise RuntimeError("vis_rollout: setting the kernels' shared memory "
                           "failed: CUDA error {}".format(err))
    return optin.value


# The kernels in ``vis_kernel_attributes``' order.
KERNEL_NAMES = ("terrain_vis_kernel<unicycle, shared>",
                "terrain_vis_kernel<unicycle, global>",
                "terrain_vis_kernel<bicycle, shared>",
                "terrain_vis_kernel<bicycle, global>",
                "barebone_vis_kernel")


def kernel_attributes(index=0):
    """Each kernel's registers a thread, local (stack) bytes a thread,
    static shared bytes and the dynamic shared bytes it may take, on card
    ``index`` (after ``vis_prepare``): ``{name: dict}``."""
    _prepared(index)
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        vals = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            err = _library().vis_kernel_attributes(which, vals)
        if err != 0:
            raise RuntimeError("vis_rollout: {}'s attributes: CUDA error "
                               "{}".format(name, err))
        out[name] = dict(zip(("registers", "local_bytes",
                              "static_smem_bytes", "max_dynamic_smem_bytes"),
                             vals))
    return out


def kernel_name(bicycle, route):
    """The ``KERNEL_NAMES`` entry of a terrain instantiation."""
    return "terrain_vis_kernel<{}, {}>".format(
        "bicycle" if bicycle else "unicycle", route)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(name, smem, index=0):
    """Blocks of kernel ``name`` (``KERNEL_NAMES``) an SM of card ``index``
    holds at once with ``smem`` bytes of dynamic shared memory each (the
    CUDA occupancy calculator): past that many blocks on every SM, the
    launch's blocks queue."""
    _prepared(index)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().vis_blocks_per_sm(KERNEL_NAMES.index(name), smem,
                                           ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError("vis_rollout: {}'s occupancy: CUDA error "
                           "{}".format(name, err))
    return blocks.value


def route_on_card(V, T, H, W, det, bicycle, index=0):
    """``vis_route`` on card ``index``: its opt-in shared memory, its SMs
    and the occupancy calculator's blocks an SM."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count

    def at_once(route, smem):
        return sms * blocks_per_sm(kernel_name(bicycle, route), smem, index)

    return vis_route(V, T, H, W, det, bicycle, _prepared(index), at_once)


def check_fast_sincos(index=0):
    """The terrain chain's branch-free sine and cosine (the source's
    ``fast_sincos``) against ``sincosf`` on card ``index``, on every
    float32 of magnitude below 105,615 and every NaN: ``(inputs whose bits
    differ, inputs checked)``."""
    out = torch.zeros(2, dtype=torch.int64, device=torch.device("cuda",
                                                                index))
    _launch("sincos_check", [out.data_ptr()], [], out.device)
    return tuple(int(n) for n in out.tolist())


def _check_controls(what, u_cur, u_prev, noise_vis, det, dev):
    """The controls' shapes; returns T."""
    if not (isinstance(u_cur, torch.Tensor) and u_cur.dim() == 2):
        raise ValueError("{}: u_cur must be a float32 (T, 2) tensor, got "
                         "{}".format(what, getattr(u_cur, "shape", u_cur)))
    T = u_cur.shape[0]
    check_tensor(what + ": u_cur", u_cur, (T, 2), dev)
    check_tensor(what + ": u_prev", u_prev, (T, 2), dev)
    if det:
        if not (isinstance(noise_vis, torch.Tensor)
                and noise_vis.dim() == 3):
            raise ValueError("{}: noise_vis must be a float32 (N, T, 2) "
                             "tensor".format(what))
        check_tensor(what + ": noise_vis", noise_vis,
                     (noise_vis.shape[0], T, 2), dev)
    return T


def _check_task(what, task, fields, dev):
    for name, shape in fields:
        check_tensor("{}: task.{}".format(what, name), getattr(task, name),
                     shape, dev)


def _launch(name, args, ints, dev):
    """Launch ``<name>_launch`` on ``dev``'s current stream; raise on a
    failed launch."""
    with torch.cuda.device(dev):
        err = getattr(_library(), name + "_launch")(
            *args, *ints, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(
            name, err))


def terrain_vis_fused(lin_grids, ang_grids, u_cur, u_prev, noise_vis,
                      roi_offset, task, *, V, det, crop=False,
                      step_fn=unicycle_step, route=None):
    """The terrain planner's vis rollouts: the semantics (and the
    arguments) of ``ops/rollout.py::terrain_vis_fused_plain``.

    Returns float32 ``(V', T+1, 3)`` states (V' = ``vis_rows``).  On CUDA
    tensors this launches ``terrain_vis_kernel`` once, on the route
    ``route_on_card`` chooses from the shape (``route``: ``"shared"`` or
    ``"global"`` names it instead, as the checks that hold each route do;
    a shared grid that does not fit raises), and adds one to
    ``terrain_vis_fused.launches`` and to that route's entry of
    ``terrain_vis_fused.route_launches``; a model with no kernel form raises
    ``NotImplementedError`` (``backend = "eager"`` runs it) before any
    build or launch, and a failed build or launch raises.  On CPU tensors
    it runs the plain version.
    """
    dev = u_cur.device
    if dev.type != "cuda":
        return terrain_vis_fused_plain(lin_grids, ang_grids, u_cur, u_prev,
                                       noise_vis, roi_offset, task, V=V,
                                       det=det, crop=crop, step_fn=step_fn)
    model, wheelbase = kernel_model(step_fn)
    what = "terrain_vis"
    T = _check_controls(what, u_cur, u_prev, noise_vis, det, dev)
    for g, label in ((lin_grids, "lin_grids"), (ang_grids, "ang_grids")):
        if not (isinstance(g, torch.Tensor) and g.dtype == torch.int8
                and g.dim() == 3 and g.device == dev
                and g.shape == lin_grids.shape and g.shape[0] >= 1):
            raise ValueError("{}: {} must be int8 (M, H, W) grids on {} "
                             "like lin_grids, got {}".format(
                                 what, label, dev,
                                 getattr(g, "shape", g)))
    _, H, W = lin_grids.shape
    if H < 1 or W < 1 or H * W >= 2 ** 31:
        raise ValueError("{}: grids of {} x {} cells out of range".format(
            what, H, W))
    _check_task(what, task, TERRAIN_FIELDS, dev)
    if crop and not (isinstance(roi_offset, torch.Tensor)
                     and roi_offset.dtype == torch.int32
                     and tuple(roi_offset.shape) == (2,)
                     and roi_offset.device == dev):
        raise ValueError("{}: a cropped vis reads roi_offset, an int32 (2,) "
                         "tensor on {}; got {}".format(what, dev, roi_offset))
    rows = vis_rows(V, det, lin_grids, noise_vis)
    if not 1 <= rows <= MAX_ROLLOUTS:
        raise ValueError("{}: {} rollouts out of range".format(what, rows))
    out = torch.empty((rows, T + 1, 3), dtype=torch.float32, device=dev)
    ins = [lin_grids.contiguous(), ang_grids.contiguous(),
           u_cur.contiguous(), u_prev.contiguous(),
           noise_vis.contiguous() if det else u_cur,
           roi_offset.contiguous() if crop else lin_grids] + [
        getattr(task, name).contiguous() for name, _ in TERRAIN_FIELDS]
    bicycle = model == KERNEL_MODELS["bicycle"]
    optin = _prepared(dev.index)
    if route is None:
        route = route_on_card(rows, T, H, W, det, bicycle, dev.index).route
    elif route not in ("shared", "global"):
        raise ValueError("{}: route {!r} is not 'shared' or 'global'".format(
            what, route))
    elif (route == "shared"
          and smem_bytes(T, H, W, det, bicycle, True) > optin):
        raise ValueError("{}: a {} x {} grid at T = {} does not fit in "
                         "shared memory".format(what, H, W, T))
    _launch("terrain_vis", [t.data_ptr() for t in ins] + [out.data_ptr()],
            [rows, T, H, W, int(det), int(crop), model, wheelbase,
             int(route == "shared")], dev)
    terrain_vis_fused.launches += 1
    terrain_vis_fused.route_launches[route] += 1
    return out


terrain_vis_fused.launches = 0
# Launches by route (``vis_route``), beside the total.
terrain_vis_fused.route_launches = {"shared": 0, "global": 0}


def barebone_vis_fused(task, u_cur, u_prev, noise_vis):
    """The barebone planner's vis rollouts: the semantics of
    ``ops/rollout.py::barebone_vis_fused_plain``, float32 ``(max(1, N),
    T+1, 3)`` from ``N`` noise rows ``(N, T, 2)``.

    On CUDA tensors this launches ``barebone_vis_kernel`` once and adds
    one to ``barebone_vis_fused.launches``; a failed build or launch
    raises.  On CPU tensors it runs the plain version.
    """
    dev = u_cur.device
    if dev.type != "cuda":
        return barebone_vis_fused_plain(task, u_cur, u_prev, noise_vis)
    what = "barebone_vis"
    T = _check_controls(what, u_cur, u_prev, noise_vis, True, dev)
    _check_task(what, task, BAREBONE_FIELDS, dev)
    rows = vis_rows(None, True, None, noise_vis)
    if rows > MAX_ROLLOUTS:
        raise ValueError("{}: {} rollouts out of range".format(what, rows))
    out = torch.empty((rows, T + 1, 3), dtype=torch.float32, device=dev)
    ins = [u_cur.contiguous(), u_prev.contiguous(),
           noise_vis.contiguous()] + [
        getattr(task, name).contiguous() for name, _ in BAREBONE_FIELDS]
    _launch("barebone_vis", [t.data_ptr() for t in ins] + [out.data_ptr()],
            [rows, T], dev)
    barebone_vis_fused.launches += 1
    return out


barebone_vis_fused.launches = 0
