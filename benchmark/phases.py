"""The device time of a replay's phases: each captured graph's phase table
(``Captured.stats["phases"]``: runs ``[phase, kind, count]`` of its nodes in
the order they run, the program's ``utils.timer.phase`` names) laid over the
device entries of the traced calls.

A replay runs no Python, so its kernels carry no range of their phase; but a
graph captured on one stream is a chain, and its kernels, memsets and
copies reach the trace in the table's order (a graph's copy node runs as a
kernel of its own, ``memcpy128`` or ``memcpy32_post``, and a memset node is
traced as ``Memset (Unknown)``). A replay is found by its first substep
kernel (``blocked_substeps``): the graph's first node lies as many entries
before it as the table has traced nodes before its first
``momentum.substeps`` run. The alignment holds only if every substep node
lands on a substep kernel and no other node does, every memset node on a
``Memset`` entry, every copy node on a ``Memcpy`` entry or a ``memcpy``
kernel, and no kernel node on either; every substep kernel of the trace
has to lie in an aligned replay. Anything else reads nothing (None), never
a guess. Nodes of the kind ``other`` (empty, event) have no entry. An entry
lost or added shows where it displaces a substep kernel, a memset or a
copy; one among plain kernels before the first of those would move a
kernel's time to its neighbour's phase unseen.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

SUBSTEPS = "momentum.substeps"
SUBSTEP_KERNEL = "blocked_substeps"
#: node kinds with an entry of their own in a device trace, and the
#: prefixes of that entry's name (a kernel's: none of the others')
ENTRY = {"kernel": (), "memset": ("Memset",), "memcpy": ("Memcpy", "memcpy")}
NOT_KERNEL = ENTRY["memset"] + ENTRY["memcpy"]


def traced_nodes(table) -> List[Tuple[str, str]]:
    """(phase, kind) of each of the table's nodes that has a device entry,
    in order."""
    return [(phase, kind) for phase, kind, n in table if kind in ENTRY for _ in range(n)]


def _lands(node: Tuple[str, str], name: str) -> bool:
    phase, kind = node
    if kind == "kernel":
        return not name.startswith(NOT_KERNEL) and (SUBSTEP_KERNEL in name) == (phase == SUBSTEPS)
    return name.startswith(ENTRY[kind])


def split(trace, capture) -> Optional[Dict[str, dict]]:
    """{phase: {"s": device seconds, "kernels": kernels}} over every replay
    in ``trace`` (``tracing.Trace``) of a graph in ``capture`` (the graphs'
    stats), or None where the trace does not align with a table."""
    tables = [traced_nodes(s["phases"]) for s in capture if s.get("phases")]
    tables = [(t, next(i for i, n in enumerate(t) if n[0] == SUBSTEPS))
              for t in tables if any(n[0] == SUBSTEPS for n in t)]
    device = sorted(trace.device, key=lambda e: e[1])
    anchors = [i for i, e in enumerate(device) if SUBSTEP_KERNEL in e[0]]
    if not tables or not anchors:
        return None
    out: Dict[str, dict] = {}
    end = 0  # the entries before this index lie in aligned replays or before them
    for a in anchors:
        if a < end:
            continue
        for nodes, first in tables:
            start = a - first
            if start < end or start + len(nodes) > len(device):
                continue
            if all(_lands(n, e[0]) for n, e in zip(nodes, device[start:start + len(nodes)])):
                break
        else:
            return None
        for (phase, kind), (_, s, e) in zip(nodes, device[start:start + len(nodes)]):
            got = out.setdefault(phase, {"s": 0.0, "kernels": 0})
            got["s"] += e - s
            got["kernels"] += kind == "kernel"
        end = start + len(nodes)
    return out


def ms_per_step(ctx, phases) -> Optional[float]:
    """Device milliseconds a model step of the named phases in the traced
    replays (``harness.Ctx``), or None where the trace does not align or
    holds none of them."""
    trace = ctx.trace
    if trace is None or not trace.steps or not ctx.capture:
        return None
    got = split(trace, ctx.capture)
    if got is None or not any(p in got for p in phases):
        return None
    return 1e3 * sum(got[p]["s"] for p in phases if p in got) / trace.steps
