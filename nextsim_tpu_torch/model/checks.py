"""Runtime invariant checking (the counterpart of the checkFieldsFast part of
nextsim_tpu/model/checks.py).

``violations`` mirrors checkFieldsFast (reference: model/finiteelement.cpp
:14536-14655): common-sense min/max + NaN screening of the prognostic fields
and an ice-speed ceiling of 5 m/s, reduced on the device to one int32 flag
per check so the host reads back one small vector.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

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


def violations(state, use_young_ice: bool = True) -> torch.Tensor:
    """An int32 vector of per-check violation flags, on the state's device."""
    checks = CELL_BOUNDS + (YOUNG_BOUNDS if use_young_ice else [])
    flags = []
    for name, lo, hi in checks:
        v = getattr(state, name)
        flags.append(torch.any(torch.isnan(v)) | torch.any(v < lo) | torch.any(v > hi))
    speed = torch.hypot(state.vt_u, state.vt_v)
    flags.append(torch.any(torch.isnan(speed)) | torch.any(speed > MAX_SPEED))
    return torch.stack(flags).to(torch.int32)


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
        v = getattr(state, name).detach().cpu().numpy()
        out[name] = (float(np.nanmin(v)), float(np.nanmax(v)))
    speed = torch.hypot(state.vt_u, state.vt_v).detach().cpu().numpy()
    out["speed"] = (float(np.nanmin(speed)), float(np.nanmax(speed)))
    return out
