"""CUDA graphs: a call's launches captured once and replayed from the host
with one launch.

PyTorch launches a kernel for every op, and in most of the port's solves
the host takes longer to make those launches than the device takes to run
them (``PERF.md`` section 5).  The JAX package runs one XLA program per
solve; here ``Captured`` records the launches of one call in a CUDA graph
and ``replay()`` reruns them.  The solves (``solver.SolveGraph``: the
terrain solve, the barebone solve and the sharded solve with its NCCL
collectives), the planners' visualisation rollouts (``VisGraph``) and the
device simulator's step are captured this way on a card.

A graph reruns its launches on the addresses it captured: its inputs are
tensors that outlive it, updated in place between replays (``copy_``),
never rebound, and its outputs live in the graph's memory pool, where the
next replay overwrites them.
"""

from __future__ import annotations

import ctypes

import torch

# CUgraphNodeType (CUDA's cuda.h): the node kinds a capture makes.
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               10: "mem_alloc", 11: "mem_free"}


def counted_wrappers():
    """The kernel wrappers that count their launches in ``.launches``."""
    from .ops.kernels import (cvar_costs, map_sample, rollout_binned,
                              rollout_byte, update_useq)
    from .probes import gather_probe

    return (map_sample.sample_traction_window,
            map_sample.sample_and_pack_window,
            map_sample.sample_and_pack_crop,
            rollout_byte.terrain_rollout_costs_byte,
            rollout_binned.terrain_rollout_costs_binned,
            cvar_costs.cvar_costs, cvar_costs.cvar_costs_wide,
            update_useq.update_useq_fused, update_useq.update_useq_wide,
            *(chain for chain, _ in gather_probe.CHAINS.values()))


class Captured:
    """``fn()`` captured in one CUDA graph.

    Args:
      fn: a function of no arguments: the launches to capture.  It reads
        and writes tensors that outlive it; what it returns (tensors, or a
        structure of them) is ``outputs``.
      generator: the ``torch.Generator`` that ``fn`` draws from, or None.
        It is registered with the graph
        (``torch.cuda.CUDAGraph.register_generator_state``), so each replay
        draws the numbers an eager call would draw from the generator's
        state at that point, and advances it as that call would.  A
        PyTorch without that API raises: replays would repeat the first
        draws.
      keep: tensors that ``fn`` updates in place; the warm-up call's writes
        to them are undone.
      device: the CUDA device ``fn`` runs on (default: the current one);
        the capture and each replay run on its current stream.

    The capture's error mode is thread-local: only this thread's calls
    that are unsafe during a capture break it, not another thread's (NCCL's
    watchdog polls its events while a capture of collectives runs).

    Before the capture, one eager call on a side stream builds and loads
    the kernels' libraries and entry points; the generator's state and
    ``keep`` are then put back, so the first replay does what an eager call
    made instead of the capture would.  Launch counts (the wrappers of
    ``counted_wrappers``): the warm-up call and the capture are set-up and
    leave them as they were; each replay adds the launches it captured.
    ``node_counts`` counts the graph's nodes by kind (``"kernel"``: every
    kernel a replay launches, torch's own included).  A capture that fails
    raises; nothing falls back to eager calls.
    """

    def __init__(self, fn, generator=None, keep=(), device=None):
        dev = torch.device("cuda" if device is None else device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        with torch.cuda.device(dev):
            self._capture(fn, generator, keep)

    def _capture(self, fn, generator, keep):
        # keep_graph: the captured cudaGraph_t stays readable (its nodes
        # are counted), and the graph is instantiated below.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None and not hasattr(graph,
                                                 "register_generator_state"):
            raise RuntimeError(
                "torch {} cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state): every replay would "
                "repeat the captured draws".format(torch.__version__))
        wrappers = counted_wrappers()
        counts = [w.launches for w in wrappers]
        state = None if generator is None else generator.get_state()
        kept = [t.clone() for t in keep]

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        if generator is not None:
            generator.set_state(state)
        for t, k in zip(keep, kept):
            t.copy_(k)

        warmed = [w.launches for w in wrappers]
        if generator is not None:
            graph.register_generator_state(generator)
        # Capture on the side stream, on this device: torch.cuda.graph's
        # own default stream is made once a process, on the device current
        # at its first use, and a capture on another card's stream records
        # nothing.
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self.outputs = fn()
        self.node_counts = _node_counts(graph.raw_cuda_graph())
        graph.instantiate()
        self._captured = [(w, w.launches - n)
                          for w, n in zip(wrappers, warmed)
                          if w.launches != n]
        for w, n in zip(wrappers, counts):
            w.launches = n
        self._graph = graph

    @property
    def captured_launches(self):
        """``{wrapper name: launches}`` of one replay."""
        return {w.__name__: n for w, n in self._captured}

    @property
    def kernel_nodes(self):
        """The kernels one replay launches."""
        return self.node_counts.get("kernel", 0)

    def replay(self):
        """Rerun the captured launches on the current stream; returns
        ``outputs``, which this replay has overwritten."""
        with torch.cuda.device(self.device):
            self._graph.replay()
        for w, n in self._captured:
            w.launches += n
        return self.outputs


def _node_counts(raw_graph):
    """``{node kind: count}`` of a ``cudaGraph_t`` (an address), read
    through libcuda's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int)]

    def call(fn, *args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError("{} returned CUresult {}".format(fn.__name__,
                                                                rc))

    graph = ctypes.c_void_p(int(raw_graph))
    n = ctypes.c_size_t(0)
    call(cuda.cuGraphGetNodes, graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(cuda.cuGraphGetNodes, graph, nodes, ctypes.byref(n))
    counts = {}
    kind = ctypes.c_int()
    for node in nodes[:n.value]:
        call(cuda.cuGraphNodeGetType, node, ctypes.byref(kind))
        name = _NODE_TYPES.get(kind.value, "type {}".format(kind.value))
        counts[name] = counts.get(name, 0) + 1
    return counts


class VisGraph:
    """Visualisation rollouts ``vis(*head, u_cur, u_prev, *tail)`` captured
    in a CUDA graph on ``head`` and ``tail`` (a planner's buffers and one
    solve graph's outputs), the two control sequences copied into the
    graph's own buffers at each call: the terrain planner's (``head`` the
    maps and the task; ``tail`` the noise rows, the grids and the window's
    offset) and the barebone planner's (the task; the noise rows)."""

    def __init__(self, vis, head, tail, u_like):
        self.head, self.tail = tuple(head), tuple(tail)
        self._u = (torch.empty_like(u_like), torch.empty_like(u_like))
        self._call = Captured(lambda: vis(*self.head, *self._u, *self.tail),
                              device=u_like.device)

    def reads(self, head, tail):
        """Whether the graph reads these inputs (the same objects)."""
        return all(same_tensors(a, b) for a, b in
                   zip(tuple(head) + tuple(tail), self.head + self.tail))

    def __call__(self, u_cur, u_prev):
        """The (V, T+1, 3) states, in the graph's memory."""
        self._u[0].copy_(u_cur)
        self._u[1].copy_(u_prev)
        return self._call.replay()


def same_tensors(a, b):
    """Whether two tensors, or two tuples of tensors (``MapInputs``,
    ``TerrainTask``), are the same objects field by field."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    return (a is b or (a is not None and b is not None and len(a) == len(b)
                       and all(x is y for x, y in zip(a, b))))
