"""The drivers of the traffic mixes: one module each, found by the name a
mix gives under ``driver`` in ``traffic/<mix>.json``: ``drivers/<driver>.py``.
A mix of a new kind (a gradient, a coupled run) brings a module of its own;
no file that is there is edited.

A driver module has

* ``Driver(opts, traffic, device, seed)``: the program built from the
  run's options (``init_s``: its constructor's seconds), with ``shape``,
  ``members``, ``dtype``, ``timer`` (the program's Timer), ``spans`` (the
  benchmark's own, ``Span``), ``sim`` (the Simulator whose parameters the
  readers take), ``seed_cohesion(field)``, ``time_after_call()`` (model time
  of the last forcing the next call asks for), ``call()`` (one call of the
  window: the model steps it made), ``capture_stats()`` and ``result()``
  (what the check needs, on the host, ``kind`` the module's name);
  optionally ``counters()``: {name: number} of the program's cumulative
  counts (calls of a phase, exchanges, launches), whose change over the
  readers' stretch ``harness.Ctx.counters`` gives;
* ``steps_a_call_bound(opts, traffic)``: the most model steps a call can
  make, from which the input data's span is sized before the program is
  built;
* ``compare(ref, got, device, control)``: {number: {label: gap}}, the
  numbers of ``check.ORDER`` that the call's results give against the
  reference (``check.run`` adds ``init_gap`` and takes the worst label);
  with ``control`` the reference in bfloat16 takes the program's place;
* optionally ``reference(options, device)``: the plain reference of the
  mix's path, in place of ``reference.model.Reference`` (which refuses the
  options it does not run): an object with ``init_state(random_number)``
  (the initial state that ``init_gap`` compares) and whatever ``compare``
  calls. A path that ``Reference`` does not run brings its own reference
  here, in new files.
"""

from __future__ import annotations

import importlib
import time

DAYS_IN_SEC = 1.0 / 86400.0


def load(name: str):
    """The driver module ``drivers/<name>.py``."""
    return importlib.import_module(f"benchmark.drivers.{name}")


class Span:
    """A callable that calls ``fn`` inside ``record_function(name)``, adds
    its host seconds to ``totals[name]`` and keeps its last result."""

    def __init__(self, fn, name: str, totals: dict):
        self.fn, self.name, self.totals = fn, name, totals
        self.last = None
        totals.setdefault(name, 0.0)

    def __call__(self, *args, **kwargs):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{self.name}"):
            self.last = self.fn(*args, **kwargs)
        self.totals[self.name] += time.perf_counter() - t0
        return self.last
