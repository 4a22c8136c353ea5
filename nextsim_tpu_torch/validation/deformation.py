"""Deformation-rate statistics (Rampal 2016 / Olason 2024 channel): a copy
of nextsim_tpu/validation/deformation.py, pinned to it by the tests.

The reference community validates BBM dynamics by the heavy-tailed PDFs of
divergence/shear/total deformation, not pointwise fields (SURVEY §6;
Lagrangian-vs-Eulerian trajectories cannot match pointwise at long
horizons, SURVEY §7 hard part ii). These pure-numpy helpers serve both
`nextsim_tpu_torch/tools/deformation_stats.py` (CLI) and `validation/ref_compare.py`'s
statistical comparison channel.
"""

from __future__ import annotations

import numpy as np

DAY = 86400.0


def deformation_rates(u_node: np.ndarray, v_node: np.ndarray, dx: float):
    """Cell divergence, shear and total deformation [1/s] from node
    velocities (same Q1 operators as the model, ops/stencil.py)."""
    r = 1.0 / (2.0 * dx)
    u_sw, u_se, u_nw, u_ne = u_node[:-1, :-1], u_node[:-1, 1:], u_node[1:, :-1], u_node[1:, 1:]
    v_sw, v_se, v_nw, v_ne = v_node[:-1, :-1], v_node[:-1, 1:], v_node[1:, :-1], v_node[1:, 1:]
    dudx = (u_se + u_ne - u_sw - u_nw) * r
    dudy = (u_nw + u_ne - u_sw - u_se) * r
    dvdx = (v_se + v_ne - v_sw - v_nw) * r
    dvdy = (v_nw + v_ne - v_sw - v_se) * r
    div = dudx + dvdy
    shear = np.sqrt((dudx - dvdy) ** 2 + (dudy + dvdx) ** 2)
    total = np.sqrt(div**2 + shear**2)
    return div, shear, total


def stats(total: np.ndarray, mask=None):
    """Percentiles + a log-log tail-slope estimate of the deformation PDF."""
    vals = total[mask > 0.5] if mask is not None else total.ravel()
    vals = vals[np.isfinite(vals) & (vals > 0)]
    if vals.size < 10:
        return {"n": int(vals.size)}
    out = {
        "n": int(vals.size),
        "mean_per_day": float(vals.mean() * DAY),
        "p50_per_day": float(np.percentile(vals, 50) * DAY),
        "p90_per_day": float(np.percentile(vals, 90) * DAY),
        "p99_per_day": float(np.percentile(vals, 99) * DAY),
        "max_per_day": float(vals.max() * DAY),
    }
    # tail exponent: slope of log-survival between p90 and p99.9
    xs = np.percentile(vals, [90, 99, 99.9])
    if xs[0] > 0 and xs[-1] > xs[0]:
        probs = np.array([0.10, 0.01, 0.001])
        slope = np.polyfit(np.log(xs), np.log(probs), 1)[0]
        out["tail_exponent"] = float(-slope)
    return out
