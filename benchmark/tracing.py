"""The profiler arithmetic: what the per-layer readers and the result's
``breakdown`` take from a ``torch.profiler`` trace of the window's first
calls.

Adapted from ``chip_smoke.py``'s ``profiled`` and ``host_calls``: the
card's own entries (kernels, copies, memsets) and the host's operators, with
one change: the device's busy time is the union of its activity intervals,
not a sum of entries, so that overlapping work on two streams counts once.
A device-side entry that repeats a host span of the same name (a
``record_function`` annotation) is no device work and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

NOT_KERNELS = ("Memcpy", "Memset")  # device entries that are no kernel


@dataclasses.dataclass
class Trace:
    """A traced stretch of the window: ``device`` and ``host`` entries as
    (name, start_s, end_s) on the profiler's clock, the host wall of the
    stretch (synchronized at both ends) and the model steps it held."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    steps: int

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if not e[0].startswith(NOT_KERNELS)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity intervals, in order."""
        out: List[Tuple[float, float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_time(self, contains: str) -> float:
        """Seconds of the device entries whose name contains ``contains``."""
        return sum(e - s for n, s, e in self.device if contains in n)

    def top_ops(self, n: int = 10) -> list:
        """The device entries that took most time, summed by name."""
        total = {}
        for name, s, e in self.device:
            total[name] = total.get(name, 0.0) + (e - s)
        return [[name[:160], t] for name, t in sorted(total.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with no device activity between the first
        and the last, each named by what the host was doing at its middle:
        the outermost and the innermost host entry there."""
        busy = self.busy_intervals()
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        out = []
        for length, s, e in sorted(gaps, reverse=True)[:n]:
            mid = 0.5 * (s + e)
            around = [h for h in self.host if h[1] <= mid <= h[2]]
            if around:
                outer = min(around, key=lambda h: h[1])[0]
                inner = max(around, key=lambda h: h[1])[0]
                label = outer if outer == inner else f"{outer} > {inner}"
            else:
                label = "no host entry"
            out.append([label[:160], length])
        return out


def from_profiler(prof, wall_s: float, steps: int) -> Trace:
    """A ``Trace`` from a stopped ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        entry = (ev.name(), s, s + ev.duration_ns() * 1e-9)
        (device if ev.device_type() == cuda else host).append(entry)
    host_names = {h[0] for h in host}
    device = [d for d in device if d[0] not in host_names]
    return Trace(device=device, host=host, wall_s=wall_s, steps=steps)


def breakdown(trace: Optional[Trace]) -> Optional[dict]:
    if trace is None or not trace.device:
        return None
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
