"""The port's validation harness and its host tools against the JAX package,
on the CPU.

The reference-comparison harness runs on synthetic reference-format
snapshots written with the port's ``output/ref_binary`` (a lattice
triangulation of the grid's nodes, two triangles a cell, as
tests/test_vs_reference.py does): the harness round trip, the matching grid,
a self-consistent compare and the statistical channel. ``compare_snapshot``
of both packages on the same state agrees within 1e-12; ``run_comparison``
through the port matches the JAX one in float64 within 1e-9 (cohesion
without its random part, which the two packages draw differently). The
deformation statistics are the JAX copies'; the three tools run on a
synthetic restart and snapshot.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu.validation import deformation as jdeformation
from nextsim_tpu.validation import ref_compare as jref
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.output import ref_binary
from nextsim_tpu_torch.output.restart import write_restart
from nextsim_tpu_torch.tools import deformation_stats, nan_bisect, plot_fields
from nextsim_tpu_torch.utils import dates
from nextsim_tpu_torch.validation import deformation as pdeformation
from nextsim_tpu_torch.validation import ref_compare as pref
from test_torch_momentum import jax_to_numpy
from test_vs_reference import _lattice_triangulation

torch.set_num_threads(1)

# tests/test_vs_reference.py's self-consistency configuration
SELF = {
    "grid.nx": 24, "grid.ny": 24, "grid.resolution": 10e3,
    "simul.timestep": 200, "dynamics.substeps": 60,
    "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant_partial",
    "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 15.0,
    "simul.spinup_duration": 0.0, "tpu.donate_state": False,
}


def write_pair(directory, name, nodes_x, nodes_y, triangles, elem_fields, nodal_vectors, time=4242.5):
    """A {mesh,field}_<name> pair in the reference Exporter layout (core/src/
    exporter.cpp writeMesh: Elements, id, Nodes_x, Nodes_y; exportResults
    fe.cpp:14270-14310: Time, M_VT, element variables), written by the
    port's ref_binary."""
    node_ids = np.arange(1, nodes_x.size + 1, dtype=np.int32)
    ref_binary.write_file(os.path.join(directory, f"mesh_{name}"), [
        ("Elements", "int", node_ids[triangles].ravel().astype(np.int32)),
        ("id", "int", node_ids),
        ("Nodes_x", "double", nodes_x),
        ("Nodes_y", "double", nodes_y),
    ])
    records = [("Time", "double", np.array([time]))]
    for vname, (u, v) in nodal_vectors.items():
        records.append((vname, "double", np.concatenate([u, v])))
    for fname, vals in elem_fields.items():
        records.append((fname, "double", vals))
    ref_binary.write_file(os.path.join(directory, f"field_{name}"), records)


def p0(field):
    """A cell field on the lattice triangles (triangles 2c and 2c+1 are cell c's)."""
    return np.repeat(np.asarray(field, np.float64).ravel(), 2)


def write_state_snapshot(directory, name, grid, state: dict, time):
    npx, npy = grid.node_xy()
    write_pair(directory, name, npx.ravel(), npy.ravel(), _lattice_triangulation(grid),
               {"Concentration": p0(state["conc"]), "Thickness": p0(state["thick"]),
                "Damage": p0(state["damage"]), "Snow": p0(state["snow_thick"])},
               {"M_VT": (np.asarray(state["vt_u"], np.float64).ravel(), np.asarray(state["vt_v"], np.float64).ravel())},
               time=time)


def assert_reports_close(a, b, tol, path="report"):
    """Two (nested) reports with the same keys and numbers within ``tol`` of
    the larger magnitude."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_reports_close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, str):
        assert a == b, path
    else:
        assert abs(a - b) <= tol * max(abs(a), abs(b), 1e-300), (path, a, b)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def test_harness_roundtrip_synthetic(tmp_path):
    """Analytic fields on a synthetic triangle mesh survive the full write ->
    read -> locate -> grid-sample pipeline."""
    grid = PGrid.square(nx=20, ny=16, dx=5e3, x0=-30e3, y0=10e3)
    npx, npy = grid.node_xy()
    tris = _lattice_triangulation(grid)
    nodes_x, nodes_y = npx.ravel(), npy.ravel()
    u = 1e-6 * nodes_x + 2e-6 * nodes_y  # P1 linear: barycentric interpolation is exact
    v = -3e-6 * nodes_x + 5.0
    cx, cy = nodes_x[tris].mean(axis=1), nodes_y[tris].mean(axis=1)
    ci = np.floor((cx - grid.x0) / grid.dx).astype(int)
    cj = np.floor((cy - grid.y0) / grid.dx).astype(int)
    conc = (cj * grid.nx + ci).astype(np.float64)  # P0: the centroid's cell id
    write_pair(tmp_path, "0", nodes_x, nodes_y, tris, {"Concentration": conc}, {"M_VT": (u, v)})

    snap = pref.load_snapshot(str(tmp_path), "0")
    assert snap.time == 4242.5 and snap.num_triangles == 2 * grid.nx * grid.ny
    assert set(snap.elements) == {"Concentration"} and set(snap.nodal) == {"M_VT_x", "M_VT_y"}
    jsnap = jref.load_snapshot(str(tmp_path), "0")  # the JAX reader reads the port's files the same
    np.testing.assert_array_equal(jsnap.triangles, snap.triangles)
    fields, cell_inside, node_inside = pref.snapshot_to_grid(snap, grid, ["Concentration", "M_VT_x", "M_VT_y"])
    assert cell_inside.all() and node_inside.all()
    jj, ii = np.meshgrid(np.arange(grid.ny), np.arange(grid.nx), indexing="ij")
    np.testing.assert_array_equal(fields["Concentration"], (jj * grid.nx + ii).astype(float))
    np.testing.assert_allclose(fields["M_VT_x"], 1e-6 * npx + 2e-6 * npy, rtol=0, atol=1e-9)
    np.testing.assert_allclose(fields["M_VT_y"], -3e-6 * npx + 5.0, rtol=0, atol=1e-9)
    assert pref.list_snapshots(str(tmp_path)) == jref.list_snapshots(str(tmp_path)) == [("0", "0")]


def test_matching_grid_covers_mesh(tmp_path):
    grid = PGrid.square(nx=12, ny=12, dx=8e3, x0=100e3, y0=-50e3)
    npx, npy = grid.node_xy()
    tris = _lattice_triangulation(grid)
    write_pair(tmp_path, "0", npx.ravel(), npy.ravel(), tris, {"Concentration": np.ones(tris.shape[0])}, {})
    snap = pref.load_snapshot(str(tmp_path), "0")
    g2 = pref.build_matching_grid(snap, dx=8e3)
    assert g2.x0 <= snap.nodes_x.min() and g2.x0 + g2.nx * g2.dx >= snap.nodes_x.max()
    assert g2.y0 <= snap.nodes_y.min() and g2.y0 + g2.ny * g2.dx >= snap.nodes_y.max()
    assert abs(snap.mean_resolution - 8e3) / 8e3 < 0.3  # sqrt(2*area) ~ dx
    jg = jref.build_matching_grid(jref.load_snapshot(str(tmp_path), "0"))
    pg = pref.build_matching_grid(snap)
    assert (pg.nx, pg.ny, pg.dx, pg.x0, pg.y0) == (jg.nx, jg.ny, jg.dx, jg.x0, jg.y0)


@pytest.fixture(scope="module")
def stepped():
    """The JAX Simulator 3 steps on tests/test_vs_reference.py's
    configuration; the port's Simulator on its state."""
    jsim = JSimulator(JConfig(overrides=SELF))
    for _ in range(3):
        jsim.step()
    psim = PSimulator(PConfig(overrides=SELF), device="cpu")
    psim.state = state_from_numpy(jax_to_numpy(jsim.state), device="cpu")
    psim.pcpt = jsim.pcpt
    return jsim, psim


def test_compare_snapshot_self_consistent_and_equal_to_jax(stepped, tmp_path):
    """A snapshot made from the model's own state diffs to ~zero, and the
    two packages' reports on the same state agree within 1e-12."""
    jsim, psim = stepped
    write_state_snapshot(tmp_path, "0", psim.grid, jax_to_numpy(jsim.state), psim.current_time)
    snap = pref.load_snapshot(str(tmp_path), "0")
    report = pref.compare_snapshot(snap, psim, horizon_days=0.1)
    for var in ("Concentration", "Thickness", "Damage", "speed"):
        assert report[var]["rmse"] < 1e-6, (var, report[var])
        assert report[var]["frac_within_tol"] == 1.0
    ref = jref.compare_snapshot(jref.load_snapshot(str(tmp_path), "0"), jsim, horizon_days=0.1)
    assert_reports_close(ref, report, 1e-12)


def test_statistical_channel_synthetic_truth(stepped, tmp_path):
    """~exact on a snapshot of the model's own state; a velocity field
    scaled by 1.6 moves the deformation ratios by that factor and leaves the
    integrals."""
    jsim, psim = stepped
    write_state_snapshot(tmp_path, "0", psim.grid, jax_to_numpy(jsim.state), psim.current_time)
    snap = pref.load_snapshot(str(tmp_path), "0")
    st = pref.compare_snapshot(snap, psim, horizon_days=0.1)["_statistics"]
    for q in ("ratio_p50", "ratio_p90", "ratio_p99"):
        assert abs(st["deformation"][q] - 1.0) < 0.02, (q, st["deformation"])
    for nm, v in st["integrals"].items():
        assert abs(v["rel_diff"]) < 1e-6, (nm, v)
    state = psim.state
    psim.state = state.replace(vt_u=state.vt_u * 1.6, vt_v=state.vt_v * 1.6)
    try:
        report2 = pref.compare_snapshot(snap, psim, horizon_days=5.0)
    finally:
        psim.state = state
    assert report2["_tier"] == "statistical"
    assert 1.5 < report2["_statistics"]["deformation"]["ratio_p90"] < 1.7
    assert abs(report2["_statistics"]["integrals"]["ice_area_km2"]["rel_diff"]) < 1e-6


def test_deformation_copy_is_pinned():
    rng = np.random.default_rng(3)
    u, v = rng.standard_normal((2, 31, 41)) * 0.1
    for a, b in zip(pdeformation.deformation_rates(u, v, 5e3), jdeformation.deformation_rates(u, v, 5e3)):
        np.testing.assert_array_equal(a, b)
    total = pdeformation.deformation_rates(u, v, 5e3)[2]
    mask = (rng.uniform(size=total.shape) > 0.3).astype(float)
    assert pdeformation.stats(total, mask) == jdeformation.stats(total, mask)
    assert pdeformation.stats(total[:2, :3]) == jdeformation.stats(total[:2, :3]) == {"n": 6}


# three snapshots one step apart of a drifting ice field on a 20^2 lattice;
# both packages run the model to each snapshot and diff
RUN_CMP = dict(SELF, **{"simul.time_init": "2015-10-16 00:00:00", "tpu.dtype": "float64",
                        "dynamics.alea_factor": 0.0, "dynamics.use_coriolis": True})


def write_reference_run(directory, n=3):
    grid = PGrid.square(nx=20, ny=20, dx=10e3, x0=-80e3, y0=40e3)
    cx, cy = grid.cell_xy()
    npx, npy = grid.node_xy()
    t0 = dates.string_to_datenum(RUN_CMP["simul.time_init"])
    for k in range(1, n + 1):
        conc = np.clip(0.9 + 0.1 * np.sin(cx / 60e3 + 0.1 * k) * np.cos(cy / 45e3), 0.0, 1.0)
        state = {"conc": conc, "thick": 1.0 + 0.5 * conc, "damage": 0.05 * k * (conc > 0.95),
                 "snow_thick": 0.1 * conc, "vt_u": 0.1 + 0.02 * np.sin(npy / 30e3 + k),
                 "vt_v": -0.05 * np.cos(npx / 40e3)}
        write_state_snapshot(directory, str(k), grid, state, t0 + k * RUN_CMP["simul.timestep"] / 86400.0)


def test_run_comparison_matches_jax(tmp_path):
    write_reference_run(tmp_path)
    with jax.enable_x64(True):
        ref = jref.run_comparison(str(tmp_path), [], overrides=dict(RUN_CMP), verbose=False)
    got = pref.run_comparison(str(tmp_path), [], overrides=dict(RUN_CMP), verbose=False, device="cpu")
    assert [r[:2] for r in got] == [r[:2] for r in ref] and len(got) == 3
    for (_, _, a), (_, _, b) in zip(ref, got):
        assert_reports_close(a, b, 1e-9)
    assert got[-1][2]["speed"]["rmse"] > 0.0 and got[-1][2]["_tier"] == "pointwise"


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def test_deformation_stats_tool(stepped, tmp_path, capsys):
    _, psim = stepped
    path = tmp_path / "field_x.npz"
    s = psim.host_state()
    np.savez(path, vt_u=s.vt_u, vt_v=s.vt_v, conc=s.conc)
    result = deformation_stats.main([str(path), str(psim.grid.dx)])
    printed = json.loads(capsys.readouterr().out.split("\n}\n")[0] + "\n}")
    assert printed == json.loads(json.dumps(result))
    div, shear, total = jdeformation.deformation_rates(s.vt_u, s.vt_v, psim.grid.dx)
    assert result["total"] == jdeformation.stats(total, s.conc > 0.15)
    assert result["total"]["n"] > 100 and all(np.isfinite(v) for v in result["shear"].values())
    assert (tmp_path / "field_x_deformation.png").exists()


def test_nan_bisect_tool(tmp_path):
    over = dict(SELF, **{"output.exporter_path": str(tmp_path), "dynamics.substeps": 20})
    sim = PSimulator(PConfig(overrides=over), device="cpu")
    sim.step()
    write_restart(sim, name="ckpt")
    args = ["--device", "cpu", "--steps", "3", *(f"{k}={v}" for k, v in over.items()), "restart.basename=ckpt"]
    report = nan_bisect.main(args)
    assert report == {"resumed_pcpt": 1, "steps_clean": 3, "first_bad": None}
    # a restart with a NaN: the report names the phase, field and cell
    with np.load(tmp_path / "restart" / "restart_ckpt.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["thick"][5, 7] = np.nan
    np.savez(tmp_path / "restart" / "restart_bad.npz", **arrays)
    report = nan_bisect.main([a if a != "restart.basename=ckpt" else "restart.basename=bad" for a in args])
    bad = report["first_bad"]
    assert report["steps_clean"] == 0 and bad["step"] == 1 and bad["phase"] == "momentum"
    assert bad["field"] in ("vt_u", "vt_v", "sigma", "thick") and bad["count"] > 0
    assert np.isnan(bad["before"]["thick"][1][1])  # the cell, centred in its neighbourhood


def test_plot_fields_tool(stepped, tmp_path, monkeypatch, capsys):
    jsim, psim = stepped
    snap = tmp_path / "field_x.npz"
    s = psim.host_state()
    np.savez(snap, conc=s.conc, thick=s.thick, damage=s.damage, vt_u=s.vt_u, vt_v=s.vt_v)
    data = plot_fields.load_any(str(snap))
    np.testing.assert_array_equal(data["speed"], np.hypot(s.vt_u, s.vt_v))
    write_state_snapshot(tmp_path, "0", psim.grid, jax_to_numpy(jsim.state), psim.current_time)
    ref = plot_fields.load_any(str(tmp_path / "field_0.bin"))  # the square records: the nodal velocity
    np.testing.assert_array_equal(ref["vt_u"], s.vt_u.astype(np.float64))
    assert ref["speed"].shape == psim.grid.node_shape
    assert plot_fields.main([str(snap), str(tmp_path / "x.png")]) == 0
    assert (tmp_path / "x.png").exists()
    # without matplotlib: a note, no file, no traceback
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    assert plot_fields.main([str(snap), str(tmp_path / "y.png")]) == 1
    assert "matplotlib is not installed" in capsys.readouterr().err
    assert not (tmp_path / "y.png").exists()
    assert deformation_stats.plot_pdf(np.ones((4, 4)), None, str(tmp_path / "z.png")) is None
