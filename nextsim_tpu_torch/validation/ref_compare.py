"""Reference field-diff harness: triangle-mesh snapshots -> structured grid
(the counterpart of nextsim_tpu/validation/ref_compare.py).

The north-star validation (BASELINE.json) is "prognostic fields allclose to
the reference after N steps on the toy config" (reference:
config-files/nextsim.toy.cfg:1-62, run via model/run.sh:55). The reference
executable cannot be built in this image (Boost.MPI / NetCDF-C++ / Gmsh are
absent and installs are forbidden), so this module is the *harness* half:
given reference output produced elsewhere (docker/README.md has the recipe),
it makes the comparison a one-command operation:

1. ``load_snapshot`` reads a ``{mesh,field}_<name>.{bin,dat}`` pair with
   :mod:`nextsim_tpu_torch.output.ref_binary` (format: core/src/exporter.cpp
   writeMesh/writeField — records Elements/id/Nodes_x/Nodes_y for the mesh;
   Time, optional M_VT (interleaved [u...;v...], fe.cpp:14280), then one
   record per exported element variable, names from model_variable.cpp).
2. ``TriLocator`` does point location on the triangle mesh (centroid k-d tree
   + barycentric containment — the role of the reference's bamg quadtree in
   InterpFromMeshToMesh2dx, contrib/bamg/src/InterpFromMeshToMesh2dx.cpp).
3. ``snapshot_to_grid`` samples P0 element fields (piecewise-constant, as the
   reference's own P0 interpolation does) and P1 nodal fields (barycentric)
   at our cell centers / nodes.
4. ``compare_snapshot`` diffs against a model state and returns a metrics
   report (bias, RMSE, max-abs, fraction-within-tolerance) per variable.

Everything but ``run_comparison`` is host numpy; ``run_comparison`` steps
the port's Simulator on ``--device`` (``cuda`` by default)::

    python -m nextsim_tpu_torch.validation.ref_compare /path/to/ref/outputs \
        --config-files <reference>/config-files/nextsim.toy.cfg [--device cpu]
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from nextsim_tpu_torch.output import ref_binary

# reference export name -> (State field, how to read it)
ELEMENT_VARS = {
    "Concentration": "conc",
    "Thickness": "thick",
    "Snow": "snow_thick",
    "Damage": "damage",
    "Ridge_ratio": "ridge_ratio",
    "SST": "sst",
    "SSS": "sss",
    "Concentration_young_ice": "conc_young",
    "Thickness_young_ice": "h_young",
    "Snow_young_ice": "hs_young",
}


@dataclasses.dataclass
class RefSnapshot:
    """One reference output pair, parsed."""

    name: str
    time: float  # days since 1900-01-01 (reference date.hpp:61 convention)
    nodes_x: np.ndarray  # (N,)
    nodes_y: np.ndarray  # (N,)
    triangles: np.ndarray  # (T, 3) 0-based into nodes
    elements: Dict[str, np.ndarray]  # P0 fields, (T,)
    nodal: Dict[str, np.ndarray]  # P1 fields, (N,) — M_VT split into _x/_y

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def centroids(self) -> Tuple[np.ndarray, np.ndarray]:
        tx = self.nodes_x[self.triangles]
        ty = self.nodes_y[self.triangles]
        return tx.mean(axis=1), ty.mean(axis=1)

    @property
    def mean_resolution(self) -> float:
        """Mean triangle edge-equivalent length sqrt(2*area)."""
        tx = self.nodes_x[self.triangles]
        ty = self.nodes_y[self.triangles]
        area = 0.5 * np.abs(
            (tx[:, 1] - tx[:, 0]) * (ty[:, 2] - ty[:, 0])
            - (tx[:, 2] - tx[:, 0]) * (ty[:, 1] - ty[:, 0])
        )
        return float(np.sqrt(2.0 * area.mean()))


def load_snapshot(directory: str, name: str, mesh_name: Optional[str] = None) -> RefSnapshot:
    """Read ``{directory}/mesh_{mesh_name}`` + ``{directory}/field_{name}``.

    ``mesh_name`` defaults to ``name``; with ``output.datetime_in_filename=
    false`` and no regridding the reference reuses the step-0 mesh, so pass
    the newest available ``mesh_*`` at or before the field snapshot.
    """
    mesh = ref_binary.read_file(os.path.join(directory, f"mesh_{mesh_name or name}"))
    field = ref_binary.read_file(os.path.join(directory, f"field_{name}"))

    node_id = mesh["id"].astype(np.int64)
    elements = mesh["Elements"].astype(np.int64).reshape(-1, 3)
    # Elements holds gmsh node *ids* (entities.hpp indices); map via the id
    # record to positions. Ids are usually 1..N contiguous but not guaranteed
    # after reordering.
    id_to_pos = np.full(node_id.max() + 1, -1, dtype=np.int64)
    id_to_pos[node_id] = np.arange(node_id.size)
    triangles = id_to_pos[elements]
    if (triangles < 0).any():
        raise ValueError("mesh Elements reference unknown node ids")

    nodes_x = np.asarray(mesh["Nodes_x"], np.float64)
    nodes_y = np.asarray(mesh["Nodes_y"], np.float64)
    n_nodes = nodes_x.size
    n_tri = triangles.shape[0]

    time = float(np.asarray(field.pop("Time"))[0]) if "Time" in field else np.nan
    elem_fields: Dict[str, np.ndarray] = {}
    nodal_fields: Dict[str, np.ndarray] = {}
    for fname, arr in field.items():
        arr = np.asarray(arr, np.float64)
        if arr.size == n_tri:
            elem_fields[fname] = arr
        elif arr.size == 2 * n_nodes:
            # interleaved vector [x-comps; y-comps] (fe.cpp:14280 M_VT layout)
            nodal_fields[fname + "_x"] = arr[:n_nodes]
            nodal_fields[fname + "_y"] = arr[n_nodes:]
        elif arr.size == n_nodes:
            nodal_fields[fname] = arr
        # else: scalar/bookkeeping record — ignore
    return RefSnapshot(
        name=name, time=time, nodes_x=nodes_x, nodes_y=nodes_y,
        triangles=triangles, elements=elem_fields, nodal=nodal_fields,
    )


def list_snapshots(directory: str) -> List[Tuple[str, str]]:
    """All (field name, matching mesh name) pairs in a reference output dir,
    ordered by the field files' modification-independent numeric/date key."""
    fields = sorted(
        os.path.basename(p)[len("field_"):-len(".bin")]
        for p in glob.glob(os.path.join(directory, "field_*.bin"))
    )
    meshes = {
        os.path.basename(p)[len("mesh_"):-len(".bin")]
        for p in glob.glob(os.path.join(directory, "mesh_*.bin"))
    }

    def sort_key(n: str):
        m = re.fullmatch(r"\d+", n)
        return (0, int(n), "") if m else (1, 0, n)

    fields.sort(key=sort_key)
    out = []
    for f in fields:
        mesh = f if f in meshes else None
        if mesh is None:
            # fall back to the latest mesh sorting at or before this field
            earlier = [m for m in sorted(meshes, key=sort_key) if sort_key(m) <= sort_key(f)]
            mesh = earlier[-1] if earlier else (sorted(meshes, key=sort_key)[0] if meshes else None)
        if mesh is not None:
            out.append((f, mesh))
    return out


class TriLocator:
    """Point location on a triangle mesh: centroid k-d tree + barycentric
    containment test (role of the bamg quadtree in InterpFromMeshToMesh2dx)."""

    def __init__(self, snap: RefSnapshot, k: int = 12):
        from scipy.spatial import cKDTree

        self.snap = snap
        cx, cy = snap.centroids
        self.tree = cKDTree(np.column_stack([cx, cy]))
        self.k = min(k, snap.num_triangles)
        tx = snap.nodes_x[snap.triangles]
        ty = snap.nodes_y[snap.triangles]
        # barycentric transform per triangle: solve for (l1, l2) in
        # p - p0 = l1 (p1-p0) + l2 (p2-p0)
        d1x, d1y = tx[:, 1] - tx[:, 0], ty[:, 1] - ty[:, 0]
        d2x, d2y = tx[:, 2] - tx[:, 0], ty[:, 2] - ty[:, 0]
        det = d1x * d2y - d2x * d1y
        det = np.where(np.abs(det) < 1e-30, 1e-30, det)
        self.p0 = np.column_stack([tx[:, 0], ty[:, 0]])
        self.inv = np.stack(
            [np.column_stack([d2y, -d2x]) / det[:, None],
             np.column_stack([-d1y, d1x]) / det[:, None]], axis=1
        )  # (T, 2, 2)

    def locate(self, px: np.ndarray, py: np.ndarray, tol: float = 1e-9):
        """Return (tri_index, barycentric (M,3), inside flag) per point."""
        pts = np.column_stack([px.ravel(), py.ravel()])
        _, cand = self.tree.query(pts, k=self.k)
        cand = np.atleast_2d(cand)  # (M, k)
        rel = pts[:, None, :] - self.p0[cand]  # (M, k, 2)
        l12 = np.einsum("mkij,mkj->mki", self.inv[cand], rel)  # (M, k, 2)
        l0 = 1.0 - l12.sum(axis=2)
        bary = np.concatenate([l0[..., None], l12], axis=2)  # (M, k, 3)
        inside = (bary >= -tol).all(axis=2)  # (M, k)
        # first containing candidate; fall back to the nearest centroid
        first = np.argmax(inside, axis=1)
        has = inside.any(axis=1)
        pick = np.where(has, first, 0)
        rows = np.arange(pts.shape[0])
        tri = cand[rows, pick]
        b = np.clip(bary[rows, pick], 0.0, 1.0)
        b = b / np.maximum(b.sum(axis=1, keepdims=True), 1e-30)
        return tri, b, has

    def sample_p0(self, values: np.ndarray, px: np.ndarray, py: np.ndarray):
        tri, _, inside = self.locate(px, py)
        out = values[tri]
        return out.reshape(px.shape), inside.reshape(px.shape)

    def sample_p1(self, node_values: np.ndarray, px: np.ndarray, py: np.ndarray):
        tri, bary, inside = self.locate(px, py)
        vals = (node_values[self.snap.triangles[tri]] * bary).sum(axis=1)
        return vals.reshape(px.shape), inside.reshape(px.shape)


def build_matching_grid(snap: RefSnapshot, dx: Optional[float] = None, pad_cells: int = 1):
    """A closed square Grid covering the reference mesh's bounding box.

    The reference's toy mesh (square_with_point.msh) is not shipped with the
    source, so the comparison grid is derived from the snapshot itself: the
    bounding box of the nodes, at resolution ``dx`` (default: the mesh's mean
    resolution rounded to a tidy value).
    """
    from nextsim_tpu_torch.grid.grid import Grid

    if dx is None:
        dx = snap.mean_resolution
    xmin, xmax = snap.nodes_x.min(), snap.nodes_x.max()
    ymin, ymax = snap.nodes_y.min(), snap.nodes_y.max()
    nx = int(np.ceil((xmax - xmin) / dx)) + 2 * pad_cells
    ny = int(np.ceil((ymax - ymin) / dx)) + 2 * pad_cells
    return Grid.square(nx=nx, ny=ny, dx=float(dx),
                       x0=float(xmin - pad_cells * dx),
                       y0=float(ymin - pad_cells * dx))


def snapshot_to_grid(snap: RefSnapshot, grid, names: Optional[List[str]] = None):
    """Sample reference fields at our grid's cell centers (P0 fields) and
    nodes (P1 fields). Returns ({name: (ny,nx) or (ny+1,nx+1)}, cell_inside,
    node_inside) where *_inside flags points covered by the triangle mesh."""
    loc = TriLocator(snap)
    cx, cy = grid.cell_xy()
    npx, npy = grid.node_xy()
    out: Dict[str, np.ndarray] = {}
    cell_inside = node_inside = None
    for name in names or list(snap.elements) + list(snap.nodal):
        if name in snap.elements:
            out[name], cell_inside = loc.sample_p0(snap.elements[name], cx, cy)
        elif name in snap.nodal:
            out[name], node_inside = loc.sample_p1(snap.nodal[name], npx, npy)
        else:
            raise KeyError(f"{name} not in snapshot (have {sorted(snap.elements)} + {sorted(snap.nodal)})")
    if cell_inside is None:
        _, cell_inside = loc.sample_p0(np.zeros(snap.num_triangles), cx, cy)
    if node_inside is None:
        _, node_inside = loc.sample_p1(np.zeros(snap.nodes_x.size), npx, npy)
    return out, cell_inside, node_inside


def _metrics(ref: np.ndarray, ours: np.ndarray, where: np.ndarray, tol: float):
    d = (ours - ref)[where]
    r = ref[where]
    return {
        "n": int(d.size),
        "bias": float(d.mean()) if d.size else 0.0,
        "rmse": float(np.sqrt((d ** 2).mean())) if d.size else 0.0,
        "max_abs": float(np.abs(d).max()) if d.size else 0.0,
        "ref_rms": float(np.sqrt((r ** 2).mean())) if d.size else 0.0,
        "frac_within_tol": float((np.abs(d) <= tol).mean()) if d.size else 1.0,
        "tol": tol,
    }


def statistical_metrics(sim, ref_fields: Dict[str, np.ndarray],
                        cell_ok: np.ndarray, node_ok: np.ndarray,
                        state=None):
    """The long-horizon comparison channel: deformation-PDF percentiles /
    tail exponent (Rampal 2016 / Olason 2024 statistics, SURVEY §6) and
    integral ice extent/area/volume — Lagrangian-vs-Eulerian trajectories
    cannot match pointwise at long horizons (SURVEY §7 hard part ii), but
    these distributions and integrals must.

    Returns {"deformation": {...}, "integrals": {...}} with per-quantity
    ref/ours values and ratios/relative differences.
    """
    from nextsim_tpu_torch.validation.deformation import deformation_rates, stats

    grid = sim.grid
    if state is None:  # callers with a gathered state pass it (one gather)
        state = sim.host_state()
    dx = grid.dx
    out: Dict[str, Dict] = {}

    conc_ref = ref_fields.get("Concentration")
    if "M_VT_x" in ref_fields:
        _, _, tot_ref = deformation_rates(
            np.where(node_ok, ref_fields["M_VT_x"], 0.0),
            np.where(node_ok, ref_fields["M_VT_y"], 0.0), dx,
        )
        _, _, tot_ours = deformation_rates(
            np.where(node_ok, np.asarray(state.vt_u, np.float64), 0.0),
            np.where(node_ok, np.asarray(state.vt_v, np.float64), 0.0), dx,
        )
        # each side masked by its OWN ice cover: the PDFs are per-field
        # distributions, not pointwise pairs
        mask_ref = cell_ok & (conc_ref > 0.15) if conc_ref is not None else cell_ok
        mask_ours = cell_ok & (np.asarray(state.conc) > 0.15)
        s_ref = stats(tot_ref, mask_ref.astype(float))
        s_ours = stats(tot_ours, mask_ours.astype(float))
        deform = {"ref": s_ref, "ours": s_ours}
        for q in ("p50_per_day", "p90_per_day", "p99_per_day", "mean_per_day"):
            if s_ref.get(q, 0.0) > 0.0 and q in s_ours:
                deform[f"ratio_{q.removesuffix('_per_day')}"] = (
                    s_ours[q] / s_ref[q]
                )
        if "tail_exponent" in s_ref and "tail_exponent" in s_ours:
            deform["tail_exponent_diff"] = (
                s_ours["tail_exponent"] - s_ref["tail_exponent"]
            )
        out["deformation"] = deform

    if conc_ref is not None:
        area = dx * dx * 1e-6  # km^2 per cell
        conc_ours = np.asarray(state.conc, np.float64)
        ints = {
            "ice_extent_km2": {
                "ref": float(((conc_ref > 0.15) & cell_ok).sum() * area),
                "ours": float(((conc_ours > 0.15) & cell_ok).sum() * area),
            },
            "ice_area_km2": {
                "ref": float(conc_ref[cell_ok].sum() * area),
                "ours": float(conc_ours[cell_ok].sum() * area),
            },
        }
        if "Thickness" in ref_fields:
            ints["ice_volume_km3"] = {
                "ref": float(ref_fields["Thickness"][cell_ok].sum() * area * 1e-3),
                "ours": float(
                    np.asarray(state.thick, np.float64)[cell_ok].sum() * area * 1e-3
                ),
            }
        for v in ints.values():
            v["rel_diff"] = (v["ours"] - v["ref"]) / max(abs(v["ref"]), 1e-12)
        out["integrals"] = ints
    return out


# tolerance tiers per forecast horizon (SURVEY §7 hard part ii): pointwise
# fields are binding at short range; beyond, the statistical channel decides
# (ratios of deformation percentiles, relative integral differences)
STATISTICAL_TOLERANCES = {
    "ratio_p90": (0.5, 2.0),  # deformation p90 within a factor 2
    "ratio_p99": (0.5, 2.0),
    "ice_extent_rel_diff": 0.10,
    "ice_area_rel_diff": 0.10,
    "ice_volume_rel_diff": 0.15,
}
POINTWISE_HORIZON_DAYS = 2.0


def compare_snapshot(snap: RefSnapshot, sim, tolerances: Optional[Dict[str, float]] = None,
                     horizon_days: Optional[float] = None):
    """Diff a reference snapshot against a Simulator's current state.

    Compares every ELEMENT_VARS field present in the snapshot plus ice speed
    (|M_VT| vs |vt|, on nodes), and attaches the statistical channel
    (deformation PDFs + integral metrics) under ``"_statistics"``. When
    ``horizon_days`` is given, ``"_tier"`` records which channel is binding
    at that forecast range (pointwise up to POINTWISE_HORIZON_DAYS,
    statistical beyond). Cells where either side is meshless/land are
    excluded. Returns {field: metrics dict}.
    """
    tolerances = dict(tolerances or {})
    defaults = {"Concentration": 0.1, "Thickness": 0.15, "Damage": 0.35, "speed": 0.05}
    grid = sim.grid
    state = sim.host_state()
    names = [n for n in ELEMENT_VARS if n in snap.elements]
    if "M_VT_x" in snap.nodal:
        names += ["M_VT_x", "M_VT_y"]
    ref_fields, cell_inside, node_inside = snapshot_to_grid(snap, grid, names)

    cell_ok = cell_inside & (np.asarray(grid.mask) > 0)
    node_ok = node_inside & (np.asarray(grid.node_mask) > 0)
    report: Dict[str, Dict[str, float]] = {}
    for rname in names:
        if rname.startswith("M_VT"):
            continue
        ours = np.asarray(getattr(state, ELEMENT_VARS[rname]), np.float64)
        tol = tolerances.get(rname, defaults.get(rname, 0.2))
        report[rname] = _metrics(ref_fields[rname], ours, cell_ok, tol)
    if "M_VT_x" in ref_fields:
        ref_speed = np.hypot(ref_fields["M_VT_x"], ref_fields["M_VT_y"])
        our_speed = np.hypot(np.asarray(state.vt_u, np.float64), np.asarray(state.vt_v, np.float64))
        report["speed"] = _metrics(ref_speed, our_speed, node_ok, tolerances.get("speed", defaults["speed"]))
    report["_statistics"] = statistical_metrics(
        sim, ref_fields, cell_ok, node_ok, state=state
    )
    if horizon_days is not None:
        report["_tier"] = (
            "pointwise" if horizon_days <= POINTWISE_HORIZON_DAYS else "statistical"
        )
        report["_horizon_days"] = float(horizon_days)
    return report


def run_comparison(ref_dir: str, config_files: List[str], overrides=None, dx=None, verbose=True,
                   device="cuda"):
    """Full comparison driver: run our model on the reference's own config to
    each snapshot time and diff. Returns [(name, time, report), ...]."""
    from nextsim_tpu_torch.config import Config
    from nextsim_tpu_torch.model.simulator import Simulator

    pairs = list_snapshots(ref_dir)
    if not pairs:
        raise FileNotFoundError(f"no field_*.bin in {ref_dir}")
    snaps = [load_snapshot(ref_dir, f, m) for f, m in pairs]
    snaps = [s for s in snaps if np.isfinite(s.time)]
    snaps.sort(key=lambda s: s.time)

    grid = build_matching_grid(snaps[0], dx=dx)
    ov = {"grid.preset": "square", "grid.nx": grid.nx, "grid.ny": grid.ny,
          "grid.resolution": grid.dx, "grid.x0": grid.x0, "grid.y0": grid.y0,
          "moorings.use_moorings": False, "restart.write_interval_restart": False,
          "output.output_per_day": 0}
    ov.update(overrides or {})
    cfg = Config.from_files(*config_files, overrides=ov)
    sim = Simulator(cfg, grid=grid, device=device)

    t_start = sim.current_time
    results = []
    for snap in snaps:
        n_steps = int(round((snap.time - sim.current_time) * 86400.0 / cfg["simul.timestep"]))
        for _ in range(max(n_steps, 0)):
            sim.step()
        report = compare_snapshot(snap, sim, horizon_days=snap.time - t_start)
        results.append((snap.name, snap.time, report))
        if verbose:
            tier = report.get("_tier", "pointwise")
            print(f"== field_{snap.name} (t={snap.time:.4f}, {max(n_steps,0)} "
                  f"steps advanced, binding tier: {tier})")
            for var, m in report.items():
                if var.startswith("_"):
                    continue
                print(f"  {var:28s} bias={m['bias']:+.4f} rmse={m['rmse']:.4f} "
                      f"max={m['max_abs']:.4f} within_tol({m['tol']:g})={m['frac_within_tol']:.1%}")
            st = report.get("_statistics", {})
            if "deformation" in st:
                d = st["deformation"]
                ratios = {k: round(v, 3) for k, v in d.items() if k.startswith("ratio_")}
                print(f"  deformation PDF ratios (ours/ref): {ratios} "
                      f"tail_dexp={d.get('tail_exponent_diff', float('nan')):+.2f}")
            for nm, v in st.get("integrals", {}).items():
                print(f"  {nm:28s} ref={v['ref']:.4g} ours={v['ours']:.4g} "
                      f"rel_diff={v['rel_diff']:+.2%}")
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ref_dir", help="directory with reference {mesh,field}_*.{bin,dat}")
    p.add_argument("--config-files", nargs="+", default=[], help="reference .cfg files to run our model with")
    p.add_argument("--dx", type=float, default=None, help="comparison grid resolution [m]")
    p.add_argument("--device", default="cuda", help="torch device to run on (default cuda; cpu runs on the host)")
    args = p.parse_args(argv)
    run_comparison(args.ref_dir, args.config_files, dx=args.dx, device=args.device)


if __name__ == "__main__":
    main()
