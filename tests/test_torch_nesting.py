"""The port's nesting against the JAX package's, on the CPU.

* ``distance_to_open_boundary`` and ``nudge_weight`` (host numpy in both):
  **bitwise**, for both nudge functions.
* ``apply_nesting`` with and without the dynamic variables, float32 and
  float64: **bitwise** (the same elementwise torch and ``jnp`` updates).
* Both outer-run formats, reference NetCDF files (curvilinear, time
  bracketed) and an outer run's npz snapshots: **bitwise** fields, as
  tensors of the simulator's dtype.
* A nested run (open boundary, ocean nesting, dynamic variables, thermo on)
  port against JAX: tests/test_golden.py's FIELD_TOLS and THERMO_TOLS after 4
  steps, and the ocean-nesting targets bitwise.
* Chunked stepping equals per-step stepping bitwise; a record that lacks
  fields of the earlier records turns that step's relaxation off, as the
  JAX package's on=0 template does.
"""

import json
import logging
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.core.state import State as JState
from nextsim_tpu.grid.grid import Grid as JGrid
from nextsim_tpu.model import nesting_source as jsrc
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu.ops import nesting as jnest
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy, state_to_numpy
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.model import nesting_source as psrc
from nextsim_tpu_torch.ops import nesting as pnest
from nextsim_tpu_torch.utils.dates import string_to_datenum
from test_torch_datasets import write_curvilinear
from test_torch_momentum import jax_to_numpy
from test_torch_simulator import THERMO_TOLS, assert_fields_within_golden_tols

T0 = "2015-10-16 00:00:00"
MODEL = dict(nx=24, ny=20, dx=10e3, boundary="open")

# reference nesting variables (dataset.cpp nesting_* descriptors) and ranges
OUTER_RANGES = {
    "sea_ice_area_fraction": (0.6, 0.95), "sea_ice_thickness": (0.8, 1.6),
    "surface_snow_thickness": (0.05, 0.2), "sea_ice_damage": (0.0, 0.3), "ridge_ratio": (0.0, 0.2),
    "young_ice_area_fraction": (0.0, 0.05), "young_ice_thickness": (0.0, 0.005),
    "surface_snow_thickness_on_young_ice": (0.0, 0.001),
    "sea_surface_temperature": (-1.8, -1.0), "sea_surface_salinity": (32.0, 34.0),
    "stress_tensor_first_component": (-2e3, 2e3), "stress_tensor_second_component": (-2e3, 2e3),
    "stress_tensor_third_component": (-1e3, 1e3),
    "sea_ice_x_velocity": (-0.1, 0.1), "sea_ice_y_velocity": (-0.1, 0.1),
}


def write_nesting_files(d, name="outer", seed=21, drop_on_day2=(), model=MODEL):
    """Daily reference-format nesting files around T0 on a coarse outer
    grid covering the model grid (``Grid.square(**model)``) with margin, two
    random records each."""
    mg = JGrid.square(**model)
    outer = JGrid.square(nx=mg.nx // 2 + 4, ny=mg.ny // 2 + 4, dx=2 * mg.dx,
                         x0=mg.x0 - 4 * mg.dx, y0=mg.y0 - 4 * mg.dx)
    rng = np.random.default_rng(seed)
    for i, day in enumerate(("2015-10-16", "2015-10-17")):
        t = string_to_datenum(day) * 24.0
        names = [v for v in OUTER_RANGES if not (i == 1 and v in drop_on_day2)]
        write_curvilinear(os.path.join(d, f"nesting_{name}_{day.replace('-', '')}.nc"), rng, names,
                          [t, t + 12.0], ranges=OUTER_RANGES, latlon=outer.cell_latlon())


def write_npz_snapshots(d, seed=22):
    """An outer run's exporter directory: field_*.npz + json manifests."""
    g = JGrid.square(**MODEL)
    rng = np.random.default_rng(seed)
    t0 = string_to_datenum(T0)
    os.makedirs(d, exist_ok=True)
    for k, t in enumerate((t0, t0 + 0.25)):
        arrays = {n: rng.uniform(0.0, 1.0, g.shape).astype(np.float32)
                  for n in ("conc", "thick", "snow_thick", "damage", "ridge_ratio")}
        arrays["vt_u"] = rng.uniform(-0.1, 0.1, g.node_shape).astype(np.float32)
        arrays["vt_v"] = rng.uniform(-0.1, 0.1, g.node_shape).astype(np.float32)
        arrays["sigma"] = rng.uniform(-1e3, 1e3, (3,) + g.shape).astype(np.float32)
        np.savez(os.path.join(d, f"field_{k}.npz"), **arrays)
        with open(os.path.join(d, f"field_{k}.json"), "w") as f:
            json.dump({"time": t}, f)


# ---------------------------------------------------------------------------
# weights and the relaxation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("function", ["exponential", "linear"])
def test_distance_and_weights_are_bitwise(function):
    jg, pg = JGrid.square(**MODEL), PGrid.square(**MODEL)
    dj, dp = jnest.distance_to_open_boundary(jg), pnest.distance_to_open_boundary(pg)
    np.testing.assert_array_equal(dp, dj)
    p_j = jnest.NestingParams(lengthscale=3.0, timescale_days=0.05, function=function)
    p_p = pnest.NestingParams(lengthscale=3.0, timescale_days=0.05, function=function)
    for dt in (200.0, 900.0):
        np.testing.assert_array_equal(pnest.nudge_weight(dp, p_p, dt), jnest.nudge_weight(dj, p_j, dt))
    cfg = {"nesting.nudge_function": function, "nesting.nest_dynamic_vars": True}
    assert (pnest.NestingParams.from_config(PConfig(overrides=cfg)).__dict__
            == jnest.NestingParams.from_config(JConfig(overrides=cfg)).__dict__)


def _outer_planes(g, rng, dt):
    out = {n: rng.uniform(0.0, 1.0, g.shape).astype(dt) for n in jnest.NESTED_TRACERS}
    out["vt_u"] = rng.uniform(-0.2, 0.2, g.node_shape).astype(dt)
    out["vt_v"] = rng.uniform(-0.2, 0.2, g.node_shape).astype(dt)
    out["sigma"] = rng.uniform(-1e4, 1e4, (3,) + g.shape).astype(dt)
    return out


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_apply_nesting_is_bitwise(dynamic, dtype_name):
    jg = JGrid.square(**MODEL)
    dt = np.float32 if dtype_name == "float32" else np.float64
    rng = np.random.default_rng(9)
    p_j = jnest.NestingParams(lengthscale=3.0, timescale_days=0.05, nest_dynamic_vars=dynamic)
    p_p = pnest.NestingParams(lengthscale=3.0, timescale_days=0.05, nest_dynamic_vars=dynamic)
    w = jnest.nudge_weight(jnest.distance_to_open_boundary(jg), p_j, 900.0).astype(dt)
    outer = _outer_planes(jg, rng, dt)
    with jax.enable_x64(dtype_name == "float64"):
        js = JState.zeros(jg, dtype=jnp.float32 if dt == np.float32 else jnp.float64)
        js = js.replace(**{k: jnp.asarray(rng.uniform(0.0, 1.0, v.shape).astype(dt))
                           for k, v in jax_to_numpy(js).items()})
        ps = state_from_numpy(jax_to_numpy(js))
        ref = jax_to_numpy(jnest.apply_nesting(js, {k: jnp.asarray(v) for k, v in outer.items()},
                                               jnp.asarray(w), p_j))
    got = state_to_numpy(pnest.apply_nesting(ps, {k: torch.as_tensor(v) for k, v in outer.items()},
                                             torch.as_tensor(w), p_p))
    before = state_to_numpy(ps)
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    moved = {f for f in ref if not np.array_equal(got[f], before[f])}
    expect = set(jnest.NESTED_TRACERS) | ({"vt_u", "vt_v", "sigma"} if dynamic else set())
    assert moved == expect, moved ^ expect


# ---------------------------------------------------------------------------
# the two outer-run sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_netcdf_source_is_bitwise(dtype_name, tmp_path):
    write_nesting_files(str(tmp_path))
    jg, pg = JGrid.square(**MODEL), PGrid.square(**MODEL)
    pdt = {"float32": torch.float32, "float64": torch.float64}[dtype_name]
    with jax.enable_x64(dtype_name == "float64"):
        js = jsrc.NestingNetCDFSource("outer", str(tmp_path), jg)
        ps = psrc.NestingNetCDFSource("outer", str(tmp_path), pg, pdt)
        t0 = string_to_datenum(T0)
        for dt_h in (0.0, 5.0, 17.0, 30.0):
            ref = {k: np.asarray(v) for k, v in js.fields_at(t0 + dt_h / 24.0).items()}
            got = ps.fields_at(t0 + dt_h / 24.0)
            assert set(got) == set(ref) == {
                "sigma", "conc", "thick", "snow_thick", "damage", "ridge_ratio", "conc_young",
                "h_young", "hs_young", "sst", "sss", "vt_u", "vt_v"}
            for k, r in ref.items():
                assert got[k].dtype == pdt
                np.testing.assert_array_equal(got[k].numpy(), r, err_msg=f"{k} at {dt_h} h")
    assert got["vt_u"].shape == pg.node_shape and got["sigma"].shape == (3,) + pg.shape
    assert psrc.NestingNetCDFSource("other", str(tmp_path), pg).fields_at(t0) is None


def test_npz_source_is_bitwise_and_picked_by_directory(tmp_path):
    d = str(tmp_path / "outer_run")
    write_npz_snapshots(d)
    jg, pg = JGrid.square(**MODEL), PGrid.square(**MODEL)
    cfg = {"nesting.outer_mesh": d}
    js = jsrc.make_nesting_source(JConfig(overrides=cfg), jg)
    ps = psrc.make_nesting_source(PConfig(overrides=cfg), pg, torch.float64)
    assert isinstance(ps, psrc.NestingSource) and isinstance(js, jsrc.NestingSource)
    t0 = string_to_datenum(T0)
    for t in (t0 - 1.0, t0, t0 + 0.1, t0 + 0.3):
        ref, got = js.fields_at(t), ps.fields_at(t)
        assert set(got) == set(ref)
        for k, r in ref.items():
            assert got[k].dtype == torch.float64
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(r).astype(np.float64), err_msg=k)
    assert psrc.NestingSource(str(tmp_path / "none"), pg).fields_at(t0) is None
    name_cfg = PConfig(overrides={"nesting.outer_mesh": "outer"})
    assert isinstance(psrc.make_nesting_source(name_cfg, pg), psrc.NestingNetCDFSource)


# ---------------------------------------------------------------------------
# nested runs
# ---------------------------------------------------------------------------

def nested_config(data_dir, **over):
    return dict({
        "simul.time_init": T0, "simul.timestep": 900, "simul.spinup_duration": 0.0,
        "grid.preset": "square", "grid.nx": MODEL["nx"], "grid.ny": MODEL["ny"],
        "grid.resolution": MODEL["dx"], "grid.boundary": "open",
        "setup.ice-type": "constant", "ideal_simul.init_concentration": 0.3,
        "ideal_simul.init_thickness": 0.5, "setup.dynamics-type": "free_drift",
        "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 8.0,
        "thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0,
        "nesting.use_nesting": True, "nesting.use_ocean_nesting": True,
        "nesting.nest_dynamic_vars": True,
        "nesting.outer_mesh": os.path.join(str(data_dir), "outer"),
        "nesting.nudge_timescale": 0.05, "nesting.nudge_lengthscale": 3.0,
        "tpu.donate_state": False,
    }, **over)


def test_nested_run_matches_jax(tmp_path):
    write_nesting_files(str(tmp_path))
    over = nested_config(tmp_path, **{"output.exporter_path": str(tmp_path / "out")})
    jsim = JSimulator(JConfig(overrides=over))
    psim = PSimulator(PConfig(overrides=over))
    psim.state = state_from_numpy(jax_to_numpy(jsim.state))
    c0 = float(psim.state.conc[2, 12])
    for _ in range(4):
        jsim.step()
        psim.step()
    ref, got = jax_to_numpy(jsim.state), state_to_numpy(psim.state)
    assert_fields_within_golden_tols(ref, got, "nested")
    for f, atol in THERMO_TOLS.items():
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=atol, err_msg=f)
    # the sponge pulled toward the outer run; ocean nesting set the targets
    assert float(psim.state.conc[2, 12]) > c0 + 0.05
    np.testing.assert_array_equal(psim.last_forcing.ocean_temp.numpy(),
                                  np.asarray(jsim.last_forcing.ocean_temp))
    np.testing.assert_array_equal(psim.last_forcing.ocean_salt.numpy(),
                                  np.asarray(jsim.last_forcing.ocean_salt))
    assert "forcing" in psim.timer.print_all()


def test_nested_run_bbm_chunked_equals_per_step(tmp_path):
    write_nesting_files(str(tmp_path))
    over = nested_config(tmp_path, **{"setup.dynamics-type": "bbm", "dynamics.substeps": 20,
                                      "simul.timestep": 200})
    a = PSimulator(PConfig(overrides=over))
    b = PSimulator(PConfig(overrides=over))
    for _ in range(4):
        a.step()
    b.step_chunk(4)
    assert a.pcpt == b.pcpt == 4
    for f, v in state_to_numpy(a.state).items():
        np.testing.assert_array_equal(state_to_numpy(b.state)[f], v, err_msg=f)


def test_partial_record_turns_the_step_off(tmp_path, caplog):
    """The second day's file lacks the thickness: those steps relax nothing
    (one log line), as the JAX package's zero template with on=0 does."""
    write_nesting_files(str(tmp_path), drop_on_day2=("sea_ice_thickness",))
    over = nested_config(tmp_path, **{"simul.time_init": "2015-10-16 23:00:00",
                                      "thermo.use_thermo_forcing": False,
                                      "nesting.use_ocean_nesting": False})
    sim = PSimulator(PConfig(overrides=over))
    ref = PSimulator(PConfig(overrides=dict(over, **{"nesting.use_nesting": False})))
    with caplog.at_level(logging.INFO, logger="nextsim_tpu"):
        for _ in range(8):  # 23:15 .. 01:00: day 1's records, then day 2's
            t = sim.current_time + sim.dt / 86400.0
            outer = sim.nesting[2].fields_at(t)
            before = state_to_numpy(sim.state)
            sim.step()
            ref.state = state_from_numpy(before)
            ref.pcpt = sim.pcpt - 1
            ref.step()
            same = all(np.array_equal(v, state_to_numpy(ref.state)[k])
                       for k, v in state_to_numpy(sim.state).items())
            assert same == ("thick" not in outer), (t, sorted(outer))
    assert sum("relaxation skipped" in r.message for r in caplog.records) == 1


def test_nest_fields_follows_the_jax_template_rule():
    """The key set grows with new fields; a record lacking a known field is
    skipped: the port's eager branch against the JAX package's on flag."""
    log = logging.getLogger("test_torch_nesting")
    jself = SimpleNamespace(log=log, dtype=jnp.float32)
    pself = SimpleNamespace(log=log, _nest_keys=None, _nest_partial_warned=False)
    a = {"conc": np.ones((2, 2))}
    ab = dict(a, thick=np.ones((2, 2)))
    for outer in (None, a, ab, a, ab, {}):
        jb = JSimulator._nest_bundle(jself, outer)
        pb = PSimulator._nest_fields(pself, outer)
        on = 0.0 if jb is None else float(jb[1])
        assert (pb is not None) == (on == 1.0), (sorted(outer or {}), on)
        if pb is not None:
            assert sorted(pb) == sorted(jb[0])


def test_restart_assimilation_and_nesting_no_longer_raise(tmp_path):
    write_nesting_files(str(tmp_path))
    sim = PSimulator(PConfig(overrides=nested_config(tmp_path)))
    assert sim.nesting is not None and isinstance(sim.nesting[1], torch.Tensor)
    assert sim.nesting[1].dtype == sim.dtype
    w = jnest.nudge_weight(jnest.distance_to_open_boundary(JGrid.square(**MODEL)),
                           jnest.NestingParams.from_config(JConfig(overrides=nested_config(tmp_path))),
                           900.0)
    np.testing.assert_array_equal(sim.nesting[1].numpy(), w)
