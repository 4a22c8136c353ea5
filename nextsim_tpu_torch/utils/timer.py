"""Hierarchical wall-clock timer (the counterpart of
nextsim_tpu/utils/timer.py).

Same API and output shape as the reference's profiler (reference:
model/timer.hpp:21-65, model/timer.cpp): named tick/tock pairs form a tree by
call lineage; ``print_all`` renders the tree with per-node totals, percent of
parent, and an "Unaccounted for" row where children don't cover the parent.

Timings around asynchronous CUDA launches are meaningless unless the device
work is complete, so ``tock(name, block_on=x)`` first synchronizes the
device of tensor ``x``; without it a node times the host. While a
``torch.profiler`` runs, each tick/tock pair is also a ``record_function``
range of the node's name, so the nodes lie on the profiler's clock beside
the device's entries.

``phase(name)`` names a part of the model step (thermodynamics, the
momentum solver's parts, transport, ...) where the step is built. Eagerly
it is a ``record_function`` range while a profiler runs, and nothing
otherwise. While ``model.captured`` captures the step into a CUDA graph, it
marks where the phase starts and ends in the graph under capture
(``recording``), from which the capture makes the graph's phase table: a
replay runs no Python, so no range can name its kernels. Phases do not
nest: a phase's end returns to ``UNATTRIBUTED``.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

#: the phase of what runs outside every ``phase``
UNATTRIBUTED = "unattributed"

#: the marks of the graph under capture (``model.captured.PhaseMarks``),
#: set by ``recording`` for the capture's length; None otherwise
_MARKS = contextvars.ContextVar("phase_marks", default=None)

_NOTHING = contextlib.nullcontext()


def phase(name: str):
    """The context of the step's phase ``name``: a mark of its boundaries in
    the graph under capture, a ``record_function`` range while a profiler
    runs, else nothing."""
    marks = _MARKS.get()
    if marks is not None:
        return marks.phase(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOTHING


@contextlib.contextmanager
def recording(marks):
    """``phase`` marks its boundaries in ``marks`` (``marks.phase(name)``)
    inside this context."""
    token = _MARKS.set(marks)
    try:
        yield marks
    finally:
        _MARKS.reset(token)


@dataclass
class _Node:
    name: str
    parent: Optional["_Node"]
    elapsed: float = 0.0
    started: Optional[float] = None
    lap_time: float = 0.0
    children: Dict[str, "_Node"] = field(default_factory=dict)
    span: Optional[object] = None  # the open record_function range, while profiled


class Timer:
    """Hierarchical named timers: tick("a"); tick("b"); tock("b"); tock("a")."""

    def __init__(self) -> None:
        self._root = _Node("root", None)
        self._root.started = time.perf_counter()
        self._current = self._root

    def tick(self, name: str) -> None:
        node = self._current.children.get(name)
        if node is None:
            node = _Node(name, self._current)
            self._current.children[name] = node
        if torch.autograd._profiler_enabled():
            node.span = torch.profiler.record_function(name)
            node.span.__enter__()
        node.started = time.perf_counter()
        self._current = node

    def tock(self, name: str, block_on=None) -> float:
        if block_on is not None and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        node = self._current
        if node.name != name:
            raise RuntimeError(f"Timer.tock({name!r}) does not match current timer {node.name!r}")
        assert node.started is not None
        if node.span is not None:
            node.span.__exit__(None, None, None)
            node.span = None
        node.lap_time = time.perf_counter() - node.started
        node.elapsed += node.lap_time
        node.started = None
        assert node.parent is not None
        self._current = node.parent
        return node.lap_time

    def lap(self, name: str) -> float:
        node = self._current.children.get(name)
        return node.lap_time if node else 0.0

    def elapsed(self, name: str, node: Optional[_Node] = None) -> float:
        found = self._find(name, node or self._root)
        return found.elapsed if found else 0.0

    def _find(self, name: str, node: _Node) -> Optional[_Node]:
        if node.name == name:
            return node
        for child in node.children.values():
            hit = self._find(name, child)
            if hit is not None:
                return hit
        return None

    def total(self) -> float:
        assert self._root.started is not None
        return time.perf_counter() - self._root.started

    def print_all(self) -> str:
        lines: List[str] = ["   %-36s %11s %9s" % ("Timer", "total [s]", "% parent")]
        total = self.total()
        self._render(self._root, total, 0, lines)
        return "\n".join(lines)

    def _render(self, node: _Node, parent_elapsed: float, depth: int, lines: List[str]) -> None:
        if node is not self._root:
            frac = 100.0 * node.elapsed / parent_elapsed if parent_elapsed > 0 else 0.0
            lines.append("   %-36s %11.3f %8.1f%%" % ("| " * depth + node.name, node.elapsed, frac))
        child_sum = sum(c.elapsed for c in node.children.values())
        for child in node.children.values():
            self._render(child, node.elapsed if node is not self._root else parent_elapsed, depth + 1, lines)
        if node.children and node is not self._root and node.elapsed > 0:
            unacc = node.elapsed - child_sum
            lines.append(
                "   %-36s %11.3f %8.1f%%"
                % ("| " * (depth + 1) + "Unaccounted for", unacc, 100.0 * unacc / node.elapsed)
            )
