"""The comparison that decides ``correct``.

What the window's last call produced is held to the plain reference
(``reference/model.py``, float64), which follows it from the state that call
started from; the traffic mix's driver (``drivers/<driver>.py``, its
``compare``) says how. The numbers compared, each the worst of its planes
(and of the members):

* ``state_gap``: per State plane after the call, the norm of the
  difference over the larger norm (``relative_gaps``), over the planes that
  the cell's limit does not except;
* ``state_bulk_gap`` and ``state_tail_gap``: per State plane, the 90th and
  the 99th percentile of the difference over the plane's own support (where
  either side is not 0), over its root mean square there (``tail_gaps``):
  a fault or a lower precision confined to a tenth, or a hundredth, of a
  field (a region, a coast, the fronts) reads in them;
* ``forcing_gap``: every plane of the last step's forcing as the program's
  forcing layer made it (for a batched ensemble the provider's shared
  forcing; the members' noise is inside the state's numbers);
* ``init_gap``: every plane of the initial state, from the same input
  files and the run's cohesion draw.

A limit in ``limits/<cell>.json`` is a number, or ``{"limit": x, "except":
[...]}`` for a number held over every plane but those named (and the
reason why, under ``"why"``).

The reference is the driver module's ``reference(options, device)`` where
it defines one (a cell whose path ``Reference`` does not run brings its own
in a new file), else ``Reference(options, device)``, which refuses the
options it does not run.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from benchmark.reference.model import Reference, planes, relative_gaps
from benchmark.reference.plain.core.state import State

ORDER = ("state_gap", "state_bulk_gap", "state_tail_gap", "forcing_gap", "init_gap")


def host_planes(tree, index=None) -> dict:
    """The array planes of a host State or Forcing (member ``index`` of a
    member-first stack) as CPU tensors, by name."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if v is not None and getattr(v, "ndim", 0) >= 2:
            out[f.name] = torch.as_tensor(v if index is None else v[index])
    return out


def reference_state(tree, device, index=None) -> State:
    """A host State as a float64 reference State on ``device``."""
    kw = {}
    for f in dataclasses.fields(State):
        v = getattr(tree, f.name)
        kw[f.name] = None if v is None else \
            torch.as_tensor(v if index is None else v[index]).to(device=device, dtype=torch.float64)
    return State(**kw)


def low_precision(ref: Reference, dtype) -> Reference:
    """The reference with its grid arrays in ``dtype``: the control's step."""
    low = copy.copy(ref)
    low.grid_arrays = {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v) for k, v in ref.grid_arrays.items()}
    return low


def in_dtype(tree, dtype):
    """A reference State or Forcing with its planes in ``dtype``."""
    return tree.replace(**{k: v.to(dtype) for k, v in planes(tree).items()})


def limit_of(spec) -> tuple:
    """(the limit, the planes it excepts) of a limits entry."""
    if isinstance(spec, dict):
        return float(spec["limit"]), tuple(spec.get("except", ()))
    return float(spec), ()


def worst(gaps: dict, excepted=()) -> tuple:
    """(the largest gap, its label) over the labels whose plane (the label's
    last word) is not in ``excepted``."""
    kept = {k: v for k, v in gaps.items() if k.split()[-1] not in excepted}
    name = max(kept, key=kept.get) if kept else ""
    return (kept[name] if name else 0.0), name


def run(got: dict, options: dict, limits: dict, device, control: bool = False) -> dict:
    """{name: {"value", "limit", "plane"}} for each number ``limits``
    names, in ORDER. ``control``: the reference in bfloat16 takes the
    program's place (its initial state, and the driver's ``compare``)."""
    from benchmark import drivers

    kind = drivers.load(got["kind"])
    ref = getattr(kind, "reference", Reference)(options, device)
    with torch.no_grad():
        initial = ref.init_state(got["seeded_field"].numpy())
        program = planes(in_dtype(initial, torch.bfloat16)) if control else host_planes(got["initial"])
        gaps = {"init_gap": relative_gaps(program, planes(initial))}
        del initial
        gaps.update(kind.compare(ref, got, device, control))
    out = {}
    for name in ORDER:
        if name in limits:
            limit, excepted = limit_of(limits[name])
            value, plane = worst(gaps[name], excepted)
            out[name] = {"value": value, "limit": limit, "plane": plane}
    return out


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
