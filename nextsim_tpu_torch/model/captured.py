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
``momentum_cuda.launches`` and ``welding_cuda.launches`` count the substep
and welding kernels' launches that a replay makes: the capture records them
without running them, so each count is set back after the capture and
raised by that many at every replay.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import inspect
import time
import weakref
from typing import Callable, Optional

import torch

from nextsim_tpu_torch.ops import momentum_cuda, welding_cuda

#: the wrappers whose ``launches`` count their kernel's launches
_COUNTERS = (momentum_cuda, welding_cuda)


def flatten(tree):
    """(tensor leaves in order, a hashable description of everything else)."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T", tuple(x.shape), x.dtype, x.device)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return ("D", type(x), names, tuple(walk(getattr(x, n)) for n in names))
        if isinstance(x, dict):
            keys = tuple(x)
            return ("M", keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, (list, tuple)):
            return ("L" if isinstance(x, list) else "U", tuple(walk(v) for v in x))
        return ("C", x)

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    """The tree ``flatten`` described, with ``leaves`` in place of its tensors."""
    it = iter(leaves)

    def build(d):
        tag = d[0]
        if tag == "T":
            return next(it)
        if tag == "D":
            return d[1](**{n: build(c) for n, c in zip(d[2], d[3])})
        if tag == "M":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if tag == "L":
            return [build(c) for c in d[1]]
        if tag == "U":
            return tuple(build(c) for c in d[1])
        return d[1]

    return build(treedef)


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
            out_leaves, out_def = flatten(fn(*args))
            self.result = _copies(out_def, out_leaves)
            torch.cuda.synchronize()
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
            try:
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
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
            self.graph.instantiate()
            uploaded = upload(self.graph)
            torch.cuda.synchronize()
        self.out_leaves, self.out_def = flatten(out)
        self.stats = {
            "nodes": nodes,
            "capture_s": t1 - t0,
            "instantiate_s": time.perf_counter() - t1,  # the upload included
            "uploaded": uploaded,
            "pool_bytes": torch.cuda.memory_reserved() - reserved,
            "kernel_launches": self.launches[0],
            "welding_launches": self.launches[1],
            "generators": len(generators),
        }
        if log is not None:
            log.info(f"{name}: captured a CUDA graph of {nodes} nodes in {self.stats['capture_s']:.2f} s, "
                     f"instantiated in {self.stats['instantiate_s']:.2f} s, pool "
                     f"{self.stats['pool_bytes'] / 2**20:.1f} MiB")

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
        """The numbers of the last graph captured: nodes, capture and
        instantiation seconds, pool bytes, substep-kernel and welding-kernel
        launches, generators registered."""
        return list(self.graphs.values())[-1].stats if self.graphs else {}
