"""One-way nesting: sponge-band relaxation toward an outer-domain run (the
counterpart of nextsim_tpu/ops/nesting.py).

Equivalent of the reference's nesting (reference: forcingNesting
fe.cpp:11060-11130; nestingIce fe.cpp:4878-4915; nestingDynamics
fe.cpp:4915-4966): within a band near the open boundary, tracers (and
optionally velocity + stress) are nudged toward the outer model's fields
with frequency

    f(d) = (1/tau) * g(d / L)

where d is distance to the boundary, L = nudge_lengthscale * resolution,
tau = nudge_timescale, and g is 'exponential' (exp(-d/L)) or 'linear'
(max(0, 1 - d/L)) (reference: options nesting.nudge_function).

The distance field and the weights are precomputed on the host from the
grid's open-boundary cells; the relaxation is a torch update on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NestingParams:
    method: str = "nudging"
    timescale_days: float = 0.5  # nesting.nudge_timescale
    lengthscale: float = 10.0  # nesting.nudge_lengthscale [cells]
    function: str = "exponential"  # exponential | linear
    nest_dynamic_vars: bool = False  # nesting.nest_dynamic_vars

    @staticmethod
    def from_config(cfg) -> "NestingParams":
        return NestingParams(
            method=cfg["nesting.method"],
            timescale_days=cfg["nesting.nudge_timescale"],
            lengthscale=cfg["nesting.nudge_lengthscale"],
            function=cfg["nesting.nudge_function"],
            nest_dynamic_vars=cfg["nesting.nest_dynamic_vars"],
        )


def distance_to_open_boundary(grid) -> np.ndarray:
    """Cell distance (in cells) to the nearest open-boundary cell, computed
    by breadth-first sweeps (host, once at init). Cells far away get +inf."""
    open_cells = np.asarray(grid.open_mask) > 0.5
    dist = np.full(grid.shape, np.inf)
    dist[open_cells] = 0.0
    active = open_cells.copy()
    # limited sweeps: the sponge only matters within ~4 lengthscales
    for it in range(4 * 64):
        nd = np.minimum.reduce(
            [
                np.roll(dist, 1, 0), np.roll(dist, -1, 0),
                np.roll(dist, 1, 1), np.roll(dist, -1, 1),
            ]
        ) + 1.0
        newdist = np.minimum(dist, nd)
        if np.array_equal(newdist, dist):
            break
        dist = newdist
    dist[np.asarray(grid.mask) < 0.5] = np.inf
    return dist


def nudge_weight(dist_cells: np.ndarray, p: NestingParams, dt: float) -> np.ndarray:
    """Per-cell relaxation weight in [0,1] for one step of dt seconds."""
    L = max(p.lengthscale, 1e-6)
    if p.function == "linear":
        g = np.maximum(0.0, 1.0 - dist_cells / L)
    else:
        g = np.exp(-dist_cells / L)
    g = np.where(np.isfinite(dist_cells), g, 0.0)
    rate = g / (p.timescale_days * 86400.0)
    return np.clip(dt * rate, 0.0, 1.0).astype(np.float32)


NESTED_TRACERS = (
    "conc", "thick", "snow_thick", "damage", "ridge_ratio",
    # young-ice tracers nest too when the category is active
    # (reference: nestingIce fe.cpp:4900-4905)
    "conc_young", "h_young", "hs_young",
)


def apply_nesting(state, outer: Dict[str, torch.Tensor], weight, p: NestingParams):
    """Relax tracers (and optionally velocity/stress) toward `outer` fields
    (reference: nestingIce fe.cpp:4878-4915, nestingDynamics 4915-4966)."""
    updates = {}
    for name in NESTED_TRACERS:
        if name in outer and getattr(state, name, None) is not None:
            cur = getattr(state, name)
            updates[name] = cur + weight * (outer[name] - cur)
    if p.nest_dynamic_vars:
        if "vt_u" in outer:
            wn = _cell_weight_to_nodes(weight)
            updates["vt_u"] = state.vt_u + wn * (outer["vt_u"] - state.vt_u)
            updates["vt_v"] = state.vt_v + wn * (outer["vt_v"] - state.vt_v)
        if "sigma" in outer:
            updates["sigma"] = state.sigma + weight[None] * (outer["sigma"] - state.sigma)
    return state.replace(**updates) if updates else state


def _cell_weight_to_nodes(w):
    from nextsim_tpu_torch.ops import stencil

    return stencil.node_mean_of_cells(w, torch.ones_like(w))
