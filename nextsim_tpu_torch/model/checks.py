"""Runtime invariant checking (the counterpart of nextsim_tpu/model/checks.py).

* ``violations`` mirrors checkFieldsFast (reference: model/finiteelement.cpp
  :14536-14655): common-sense min/max + NaN screening of the prognostic
  fields and an ice-speed ceiling of 5 m/s, reduced on the device to one
  int32 flag per check so the host reads back one small vector.
* ``check_velocity_fields`` (debugging.check_velocity_fields) flags rogue
  node velocities on the device.
* ``check_fields`` and ``detailed_report`` (debugging.check_fields) are the
  slow host audit of a host copy of the state (numpy arrays).

On a device mesh the device checks take ``owned`` (``Seam.owned``) and
reduce a rank's owned cells only, so that no ring cell counts twice; the
Simulator combines the ranks' results with an all-reduce where it reads
them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from nextsim_tpu_torch.core.state import host_array

# (field, min, max) — reference fe.cpp:14539-14558
CELL_BOUNDS: List[Tuple[str, float, float]] = [
    ("thick", 0.0, 50.0),
    ("snow_thick", 0.0, 10.0),
    ("conc", 0.0, 1.0),
    ("damage", 0.0, 1.0),
    ("ridge_ratio", 0.0, 1.0),
    ("tice", -100.0, 0.0),
    ("sst", -5.0, 50.0),
    ("sss", 0.0, 50.0),
]
YOUNG_BOUNDS: List[Tuple[str, float, float]] = [
    ("tsurf_young", -100.0, 0.0),
    ("h_young", 0.0, 2.0),
    ("hs_young", 0.0, 2.0),
    ("conc_young", 0.0, 1.0),
]
MAX_SPEED = 5.0  # m/s (fe.cpp:14614)


def violations(state, use_young_ice: bool = True, owned=None, members: bool = False) -> torch.Tensor:
    """An int32 vector of per-check violation flags, on the state's device;
    ``owned`` crops a rank's block to its owned region. ``members``: the
    state is a batched one, a member axis before the plane's two axes
    (``core.state.member_minor``), and the flags are (N, checks), each
    member's own (on a device mesh, each member's owned cells), as the JAX
    package's ``jax.vmap`` of the step gives them."""
    if owned is not None:
        state = owned(state)
    if members:
        def any_(b):  # over every axis but the member axis (-3)
            return b.movedim(-3, 0).flatten(1).any(dim=1)
    else:
        any_ = torch.any
    checks = CELL_BOUNDS + (YOUNG_BOUNDS if use_young_ice else [])
    flags = []
    for name, lo, hi in checks:
        v = getattr(state, name)
        flags.append(any_(torch.isnan(v)) | any_(v < lo) | any_(v > hi))
    speed = torch.hypot(state.vt_u, state.vt_v)
    flags.append(any_(torch.isnan(speed)) | any_(speed > MAX_SPEED))
    return torch.stack(flags, dim=-1).to(torch.int32)


def describe(flags, use_young_ice: bool = True) -> List[str]:
    """Host-side: turn the violation flags into messages."""
    checks = CELL_BOUNDS + (YOUNG_BOUNDS if use_young_ice else [])
    names = [c[0] for c in checks] + ["velocity"]
    return [
        f"checkFieldsFast failed for {name} (NaN or out of bounds)"
        for name, f in zip(names, np.asarray(flags))
        if f
    ]


def field_stats(state) -> Dict[str, Tuple[float, float]]:
    """min/max per field — debugging aid (reference checkFields verbose)."""
    out = {}
    for name, *_ in CELL_BOUNDS + YOUNG_BOUNDS:
        v = host_array(getattr(state, name))
        out[name] = (float(np.nanmin(v)), float(np.nanmax(v)))
    speed = host_array(torch.hypot(state.vt_u, state.vt_v))
    out["speed"] = (float(np.nanmin(speed)), float(np.nanmax(speed)))
    return out


def check_velocity_fields(state, node_mask, spd_lim: float = 0.5, owned=None):
    """Statistical velocity-outlier detection (reference: checkVelocityFields,
    fe.cpp:14487-14530): for nodes faster than spd_lim, the relative error
    of the node velocity vs. the mean/std of its 4 neighbours; returns
    (count, max_rel_err) as device scalars, over the owned nodes when
    ``owned`` crops a rank's block."""
    from nextsim_tpu_torch.ops import stencil

    u, v = state.vt_u, state.vt_v
    spd = torch.hypot(u, v)
    fast = (spd > spd_lim) & (node_mask > 0.5)

    def stats(x):
        mean = stencil.neighbor_mean_nodes(x, node_mask)
        mean2 = stencil.neighbor_mean_nodes(x * x, node_mask)
        var = torch.clamp(mean2 - mean * mean, min=1e-12)
        return mean, torch.sqrt(var)

    mu_u, sd_u = stats(u)
    mu_v, sd_v = stats(v)
    rel = torch.hypot((mu_u - u) / sd_u, (mu_v - v) / sd_v)
    rel = torch.where(fast, rel, 0.0)
    if owned is not None:
        rel = owned(rel)
    rogue = rel > 4.0
    return rogue.sum(), rel.max()


def detailed_report(state, j: int, i: int, forcing=None) -> str:
    """Per-cell field dump for debugging a flagged element (reference:
    checkFields with debugging.test_element_number, fe.cpp:14661+): every
    prognostic value at the cell, the node velocities, and each available
    forcing plane. ``state`` and ``forcing`` hold host arrays."""
    import dataclasses

    lines = [f"--- cell ({j},{i}) ---"]
    if forcing is not None:
        for f in dataclasses.fields(forcing):
            v = getattr(forcing, f.name)
            if v is None or getattr(v, "ndim", 0) < 2:
                continue
            v = np.asarray(v)
            jj = min(j, v.shape[-2] - 1)
            ii = min(i, v.shape[-1] - 1)
            lines.append(f"forcing {f.name:14s} = {float(v[..., jj, ii].ravel()[0]):.6g}")
    for name, *_ in CELL_BOUNDS + YOUNG_BOUNDS:
        v = np.asarray(getattr(state, name))
        val = v[..., j, i] if v.ndim == 3 else v[j, i]
        lines.append(f"{name:14s} = {np.array2string(np.atleast_1d(val), precision=6)}")
    for name in ("vt_u", "vt_v"):
        v = np.asarray(getattr(state, name))
        lines.append(f"{name:14s} = {v[j, i]:.6g}")
    return "\n".join(lines)


def check_fields(state, forcing=None, use_young_ice: bool = True) -> List[str]:
    """Detailed per-element audit (reference: checkFields,
    fe.cpp:14661-14860): NaN-screen every forcing plane first, then every
    prognostic variable with bounds, naming the first offending cell (flat
    element id + (j,i)) per message. ``state`` and ``forcing`` hold host
    arrays; this is the slow debug mode behind debugging.check_fields."""
    import dataclasses

    msgs: List[str] = []

    def first_bad(mask2d) -> str:
        idx = int(np.argmax(mask2d))
        j, i = np.unravel_index(idx, mask2d.shape)
        return f"element {idx} (j={j}, i={i})"

    if forcing is not None:
        for f in dataclasses.fields(forcing):
            v = getattr(forcing, f.name)
            if v is None or getattr(v, "ndim", 0) < 2:
                continue
            v = np.asarray(v)
            nanmask = np.isnan(v).reshape(-1, *v.shape[-2:]).any(axis=0)
            if nanmask.any():
                msgs.append(f"Found nan in FORCING {f.name} at {first_bad(nanmask)}")
    checks = CELL_BOUNDS + (YOUNG_BOUNDS if use_young_ice else [])
    # common-sense maxima beyond the hard bounds (fe.cpp too_high_values)
    too_high = {"thick": 35.0}
    for name, lo, hi in checks:
        v = np.asarray(getattr(state, name))
        flat = v.reshape(-1, *v.shape[-2:])
        nanmask = np.isnan(flat).any(axis=0)
        if nanmask.any():
            msgs.append(f"Found nan in VARIABLE {name} at {first_bad(nanmask)}")
            continue
        low = (flat < lo).any(axis=0)
        high = (flat > hi).any(axis=0)
        if low.any():
            msgs.append(f"VARIABLE {name} < min allowed {lo} at {first_bad(low)}")
        if high.any():
            msgs.append(f"VARIABLE {name} > max allowed {hi} at {first_bad(high)}")
        if name in too_high:
            warn = (flat > too_high[name]).any(axis=0)
            if warn.any():
                msgs.append(
                    f"VARIABLE {name} suspiciously high (> {too_high[name]}) "
                    f"at {first_bad(warn)}"
                )
    speed = np.hypot(np.asarray(state.vt_u), np.asarray(state.vt_v))
    if np.isnan(speed).any():
        msgs.append(f"Found nan in VARIABLE velocity at {first_bad(np.isnan(speed))}")
    elif (speed > MAX_SPEED).any():
        msgs.append(
            f"VARIABLE speed > max allowed {MAX_SPEED} at {first_bad(speed > MAX_SPEED)}"
        )
    return msgs
