"""A function of tensors run as one replay of a captured CUDA graph: the
port's counterpart of ``jax.jit`` for the model step and for a chunk of
``tpu.steps_per_call`` steps (``Simulator._build_step_fn``,
``Simulator._build_chunk_fn``).

``Captured(fn)`` wraps a function of trees of tensors (a tensor, a dataclass
such as ``State`` or ``Forcing``, a dict, a list or a tuple of them; None,
numbers and strings are part of the structure) that returns such a tree and
writes none of its inputs. Called with tensors on the CPU it calls ``fn``.
Called with CUDA tensors it:

* keys a graph on the structure of its arguments: the tree, each tensor's
  shape, dtype and device, each non-tensor leaf (so the number of steps, the
  dtype, the forcing leaves that are None, the nesting keys and the wave
  fields each select their own graph);
* at the first call of a structure copies the arguments into static device
  buffers, runs ``fn`` on them eagerly (the warm-up, whose result is the
  call's: kernels are built and their attributes set outside any capture),
  then captures ``fn`` on the same buffers into a ``torch.cuda.CUDAGraph``;
* at a later call copies into the buffers the arguments that changed (one
  ``torch._foreach_copy_``; a tensor that is the one the last call copied,
  at the same version, is not copied again) and replays the graph;
* returns copies of the graph's outputs, which the next replay does not
  overwrite.

``generators`` names the ``torch.Generator`` objects whose draws ``fn``
makes (a list, or a callable that returns one at each capture): a perturbed
member's noise stream, the batched ensemble's member streams. Each graph
registers every one (``CUDAGraph.register_generator_state``) before its
capture. The warm-up draws eagerly and advances them, as the first call's
draws; the capture advances none of them (checked); each replay advances
each by the graph's whole increment and draws where an eager call would, so
warm-up and replays follow the eager sequence bit for bit, and a
``set_state`` between calls sets where the next replay draws. A generator
that cannot be registered raises.

A failed capture or replay raises; nothing falls back to the eager call.
Python's garbage collector is off during a capture (a graph destroyed by a
collection frees device memory, which a capture cannot hold). The
wrapper runs ``fn`` under ``torch.no_grad()`` on the card: a gradient goes
through ``Simulator.raw_step_fn``, never through a graph.
``momentum_cuda.launches``, ``welding_cuda.launches`` and
``transport_cuda.launches`` count the substep, welding and transport
kernels' launches that a replay makes: the capture records them
without running them, so each count is set back after the capture and
raised by that many at every replay.

Each graph's ``stats`` also hold ``warmup_s``, the warm-up call's seconds up
to its synchronize, and ``phases``, the graph's phase table: the step's
``utils.timer.phase`` contexts mark their boundaries in the graph under
capture (``PhaseMarks``: the capture's tail node at each boundary, from
``cuStreamGetCaptureInfo_v2``), and after the capture the graph's nodes are
listed in the order they run, each with the phase it lies in and its kind
(``kernel``, ``memset``, ``memcpy`` or ``other``), as runs ``[phase, kind,
count]``; a node outside every phase is ``unattributed``. One stream makes
the graph a chain, so the order is the chain's. Where libcuda lacks a
call, or the graph is no chain, ``phases`` is None and the log line says
why. The table costs ``phases_s`` of set-up, two calls into libcuda a
node. The marks add no node: a replay runs the same graph whether or not
anyone reads the table.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import inspect
import time
import weakref
from typing import Callable, Optional

import torch

from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda, welding_cuda
from nextsim_tpu_torch.utils import timer

#: the wrappers whose ``launches`` count their kernel's launches
_COUNTERS = (momentum_cuda, welding_cuda, transport_cuda)


def flatten(tree):
    """(tensor leaves in order, a hashable description of everything else)."""
    leaves = []
    return leaves, _walk(tree, leaves)


def _walk(x, leaves):
    """``flatten``'s description of ``x``, its tensors appended to
    ``leaves``. A function of the module, not a closure in ``flatten``: a
    recursive closure is a reference cycle, which would keep ``leaves`` (a
    call's inputs) on the device until the garbage collector ran."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("T", tuple(x.shape), x.dtype, x.device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return ("D", type(x), names, tuple(_walk(getattr(x, n), leaves) for n in names))
    if isinstance(x, dict):
        keys = tuple(x)
        return ("M", keys, tuple(_walk(x[k], leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        return ("L" if isinstance(x, list) else "U", tuple(_walk(v, leaves) for v in x))
    return ("C", x)


def unflatten(treedef, leaves):
    """The tree ``flatten`` described, with ``leaves`` in place of its tensors."""
    return _build(treedef, iter(leaves))


def _build(d, it):
    """``unflatten``'s tree of ``d``, its tensors taken from ``it`` (no
    closure, as ``_walk``)."""
    tag = d[0]
    if tag == "T":
        return next(it)
    if tag == "D":
        return d[1](**{n: _build(c, it) for n, c in zip(d[2], d[3])})
    if tag == "M":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    if tag == "L":
        return [_build(c, it) for c in d[1]]
    if tag == "U":
        return tuple(_build(c, it) for c in d[1])
    return d[1]


def _copies(treedef, leaves):
    """The tree with a fresh copy of every tensor leaf (one foreach copy)."""
    fresh = [torch.empty_like(x) for x in leaves]
    if fresh:
        torch._foreach_copy_(fresh, list(leaves))
    return unflatten(treedef, fresh)


def graph_nodes(graph) -> Optional[int]:
    """The node count of a graph captured with ``keep_graph=True``, from the
    driver (``cuGraphGetNodes``); None where this PyTorch or driver does not
    expose it."""
    try:
        raw = graph.raw_cuda_graph()
        cuda = ctypes.CDLL("libcuda.so.1")
    except (AttributeError, RuntimeError, OSError):
        return None
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


def upload(graph) -> bool:
    """Upload an instantiated graph to the device (``cuGraphUpload``) on the
    current stream, so that its first replay does not pay for it; False
    where this PyTorch or driver does not expose it."""
    try:
        raw = graph.raw_cuda_graph_exec()
        cuda = ctypes.CDLL("libcuda.so.1")
    except (AttributeError, RuntimeError, OSError):
        return False
    stream = torch.cuda.current_stream().cuda_stream
    return cuda.cuGraphUpload(ctypes.c_void_p(raw), ctypes.c_void_p(stream)) == 0


#: libcuda's node types (CUgraphNodeType) that a phase table names;
#: every other type is "other"
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE


@functools.lru_cache(maxsize=1)
def _libcuda():
    """``libcuda.so.1`` with the calls the phase table makes declared, or
    None where it cannot be loaded."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    p = ctypes.POINTER
    for name, args in (
            ("cuStreamGetCaptureInfo_v2", [ctypes.c_void_p, p(ctypes.c_int), p(ctypes.c_uint64),
                                           p(ctypes.c_void_p), p(p(ctypes.c_void_p)), p(ctypes.c_size_t)]),
            ("cuGraphGetNodes", [ctypes.c_void_p, p(ctypes.c_void_p), p(ctypes.c_size_t)]),
            ("cuGraphNodeGetDependencies", [ctypes.c_void_p, p(ctypes.c_void_p), p(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [ctypes.c_void_p, p(ctypes.c_int)])):
        fn = getattr(cuda, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, ctypes.c_int
    return cuda


class PhaseMarks:
    """The phase boundaries of one stream capture (``utils.timer.recording``):
    at each, the capture's tail nodes and the phase that starts after them.
    ``error`` says why no table can be made from them, or is None."""

    def __init__(self):
        self.marks = []
        self.graph = None  # the graph under capture, as libcuda names it
        self.error = None
        cuda = _libcuda()
        self._info = None if cuda is None else getattr(cuda, "cuStreamGetCaptureInfo_v2", None)
        if self._info is None:
            self.error = "libcuda has no cuStreamGetCaptureInfo_v2"

    @contextlib.contextmanager
    def phase(self, name: str):
        self._mark(name)
        try:
            yield
        finally:
            self._mark(timer.UNATTRIBUTED)

    def _mark(self, name: str) -> None:
        if self.error is not None:
            return
        status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
        deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t()
        stream = torch.cuda.current_stream().cuda_stream
        err = self._info(stream, ctypes.byref(status), ctypes.byref(cid), ctypes.byref(graph),
                         ctypes.byref(deps), ctypes.byref(n))
        if err or status.value != _CAPTURE_ACTIVE:
            self.error = f"cuStreamGetCaptureInfo_v2 gave error {err}, capture status {status.value}"
        elif self.graph is not None and graph.value != self.graph:
            self.error = "a phase boundary saw another graph under capture"
        else:
            self.graph = graph.value
            self.marks.append((tuple(deps[i] for i in range(n.value)), name))


def phase_table(graph, marks: PhaseMarks):
    """(the phase table of a graph captured with ``keep_graph=True``, None)
    from the marks of its capture, or (None, why not). libcuda lists a
    captured chain's nodes in the order they were captured; each node's
    dependencies and kind are asked for one at a time (listing the graph's
    edges at once takes seconds on a graph of ~140k nodes)."""
    if marks.error is not None:
        return None, marks.error
    cuda = _libcuda()
    if cuda is None or any(getattr(cuda, f, None) is None
                           for f in ("cuGraphGetNodes", "cuGraphNodeGetDependencies", "cuGraphNodeGetType")):
        return None, "libcuda lacks cuGraphGetNodes, cuGraphNodeGetDependencies or cuGraphNodeGetType"
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError) as e:
        return None, f"no raw graph: {e}"
    if marks.graph is not None and marks.graph != raw:
        return None, "the marks were taken on another graph"
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        return None, "cuGraphGetNodes failed"
    listed = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(raw, listed, ctypes.byref(n)):
        return None, "cuGraphGetNodes failed"
    nodes, deps, kinds = list(listed), [], []
    two, k, kind = (ctypes.c_void_p * 2)(), ctypes.c_size_t(), ctypes.c_int()
    for node in nodes:
        k.value = 2
        if cuda.cuGraphNodeGetDependencies(node, two, ctypes.byref(k)) or \
                cuda.cuGraphNodeGetType(node, ctypes.byref(kind)):
            return None, "cuGraphNodeGetDependencies or cuGraphNodeGetType failed"
        deps.append(tuple(two[:k.value]))
        kinds.append(NODE_KINDS.get(kind.value, "other"))
    return chain_table(nodes, deps, kinds, marks.marks)


def chain_table(nodes, deps, kinds, marks):
    """The phase table of a graph from its ``nodes`` as libcuda lists them,
    each node's ``deps`` (a tuple) and ``kinds``, and the capture's
    ``marks``, (tail nodes, phase) at each boundary in order (a phase starts
    after its tail node, or at the first node where it has none):
    (runs ``[phase, kind, count]`` in the list's order, None), or (None, why
    not) unless each node depends on the one listed before it alone, which
    makes the list the graph's one chain."""
    if any(d != ((nodes[i - 1],) if i else ()) for i, d in enumerate(deps)):
        return None, "the graph is no chain in the order its nodes are listed"
    start, starts = timer.UNATTRIBUTED, {}
    for tail, name in marks:
        if len(tail) > 1:
            return None, f"a phase boundary saw {len(tail)} tail nodes: the capture is no chain"
        if not tail:
            if starts:
                return None, "a phase boundary saw no tail node after the graph's first"
            start = name
        else:
            starts[tail[0]] = name
    if not set(starts) <= set(nodes):
        return None, "a phase boundary's tail node is not in the graph"
    table, name = [], start
    for node, kind in zip(nodes, kinds):
        if table and table[-1][0] == name and table[-1][1] == kind:
            table[-1][2] += 1
        else:
            table.append([name, kind, 1])
        name = starts.get(node, name)
    return table, None


def _register(graph, generators, name):
    """Registers every generator's state with ``graph`` before its capture;
    returns their states. Raises where this PyTorch cannot register one."""
    register = getattr(graph, "register_generator_state", None)
    if generators and register is None:
        raise RuntimeError(f"{name}: this PyTorch cannot register a generator with a CUDA graph "
                           "(CUDAGraph.register_generator_state), and the program draws from one")
    for g in generators:
        register(g)
    return [g.get_state() for g in generators]


class _Graph:
    """One captured structure: its static inputs, graph and outputs."""

    def __init__(self, fn, treedef, leaves, log, name, generators=()):
        """Sets up the buffers, runs the warm-up (its result in
        ``self.result``, handed to the caller once) and captures, with
        ``generators`` registered."""
        self.static = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in leaves]
        torch._foreach_copy_(self.static, list(leaves))
        self._src = list(leaves)
        self._ver = [x._version for x in leaves]
        args = unflatten(treedef, self.static)
        with torch.no_grad():
            t0 = time.perf_counter()
            out_leaves, out_def = flatten(fn(*args))
            self.result = _copies(out_def, out_leaves)
            torch.cuda.synchronize()
            warmup_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            counted = [m.launches for m in _COUNTERS]
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            drawn = _register(self.graph, generators, name)
            # no garbage collection during the capture: a collected graph's
            # destruction frees device memory, which invalidates a capture
            gc.collect()
            gc_was_on = gc.isenabled()
            gc.disable()
            marks = PhaseMarks()
            try:
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"), timer.recording(marks):
                    out = fn(*args)
            finally:
                if gc_was_on:
                    gc.enable()
            t1 = time.perf_counter()
            if any(not torch.equal(g.get_state(), st) for g, st in zip(generators, drawn)):
                raise RuntimeError(f"{name}: the capture advanced a registered generator")
            self.launches = [m.launches - c for m, c in zip(_COUNTERS, counted)]
            for m, c in zip(_COUNTERS, counted):
                m.launches = c
            nodes = graph_nodes(self.graph)
            t2 = time.perf_counter()
            phases, why = phase_table(self.graph, marks)
            t3 = time.perf_counter()
            self.graph.instantiate()
            uploaded = upload(self.graph)
            torch.cuda.synchronize()
        self.out_leaves, self.out_def = flatten(out)
        self.stats = {
            "nodes": nodes,
            "warmup_s": warmup_s,
            "capture_s": t1 - t0,
            "phases_s": t3 - t2,
            "instantiate_s": time.perf_counter() - t1 - (t3 - t2),  # the upload included
            "uploaded": uploaded,
            "pool_bytes": torch.cuda.memory_reserved() - reserved,
            "kernel_launches": self.launches[0],
            "welding_launches": self.launches[1],
            "transport_launches": self.launches[2],
            "generators": len(generators),
            "phases": phases,
        }
        if log is not None:
            log.info(f"{name}: warm-up call {warmup_s:.2f} s; captured a CUDA graph of {nodes} nodes in "
                     f"{self.stats['capture_s']:.2f} s, instantiated in {self.stats['instantiate_s']:.2f} s, "
                     f"pool {self.stats['pool_bytes'] / 2**20:.1f} MiB; "
                     + (f"phase table of {len(phases)} runs in {t3 - t2:.2f} s" if phases is not None
                        else f"no phase table: {why}"))

    def replay(self, leaves):
        dst, src = [], []
        for i, x in enumerate(leaves):
            if x is not self._src[i] or x._version != self._ver[i]:
                dst.append(self.static[i])
                src.append(x)
                self._src[i] = x
                self._ver[i] = x._version
        if dst:
            torch._foreach_copy_(dst, src)
        self.graph.replay()
        for m, n in zip(_COUNTERS, self.launches):
            m.launches += n
        return _copies(self.out_def, self.out_leaves)


def _weak(fn):
    """A callable that returns ``fn``: weakly held where it is a bound method."""
    return weakref.WeakMethod(fn) if inspect.ismethod(fn) else (lambda: fn)


class Captured:
    """``fn`` as a replay of a CUDA graph on the card (see the module's
    docstring); ``capture=False`` calls ``fn`` on every device;
    ``generators``: the generators ``fn`` draws from, a list or a callable
    that returns one."""

    def __init__(self, fn: Callable, name: str = "program", log=None, capture: bool = True, generators=()):
        # a bound method is held weakly, so that its object and its graphs
        # are freed when the caller drops it, not by a later collection
        self._fn = _weak(fn)
        self._generators = _weak(generators)
        self.name = name
        self.log = log
        self.capture = capture
        self.graphs = {}

    @property
    def fn(self) -> Callable:
        return self._fn()

    @property
    def generators(self) -> list:
        """The generators the function draws from, as a list."""
        gens = self._generators()
        return list(gens() if callable(gens) else gens)

    def __call__(self, *args):
        leaves, treedef = flatten(args)
        devices = {x.device.type for x in leaves}
        if not self.capture or devices != {"cuda"}:
            if "cuda" in devices and len(devices) > 1:
                raise ValueError(f"{self.name}: tensors on {sorted(devices)}; a captured call takes CUDA tensors only")
            return self.fn(*args)
        g = self.graphs.get(treedef)
        if g is None:
            g = self.graphs[treedef] = _Graph(self.fn, treedef, leaves, self.log, self.name,
                                              self.generators)
            result, g.result = g.result, None
            return result
        return g.replay(leaves)

    @property
    def stats(self) -> dict:
        """The numbers of the last graph captured: nodes, warm-up, capture,
        phase-table and instantiation seconds, pool bytes, substep-kernel and
        welding-kernel launches, generators registered, the phase table."""
        return list(self.graphs.values())[-1].stats if self.graphs else {}
