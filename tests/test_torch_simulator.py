"""The PyTorch port's main path as a whole, on the CPU.

* The slice: the port's ``Simulator`` against the JAX package's, 5 steps
  from the same initial state, on a 32^2 arctic grid and on the toy square,
  with thermodynamics off and on, held to tests/test_golden.py's
  cross-platform field tolerances (and THERMO_TOLS for the thermo fields).
* The dataset slice: the same on a 32^2 ``arctic_etopo`` grid at 100 km on
  synthetic ERA5 + TOPAZ4 + ETOPO files with TOPAZ ice and thermo on, and a
  restart with the OSISAF/AMSR2 assimilation.
* The golden toy run: the port's 15 steps against golden_toy_fields.npz
  (FIELD_TOLS) and golden_toy.json (2%), from the JAX package's initial
  random field (golden_toy_random_number.npy, pinned below).
* The port imports no jax; its copies of the JAX package's host-only
  modules (config schema, grid, projection, constants, dates) are pinned to
  their originals; the pieces of the main path around the step
  (State.zeros, init_state, ConstantForcing, time_info) agree with the
  JAX package's; the options ported since the first slice run; unported
  subsystems raise.
* The CUDA wrapper raises where it cannot launch its kernel.
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextsim_tpu.core.constants as jconst
import nextsim_tpu.utils.dates as jdates
from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.config import schema as jschema
from nextsim_tpu.core.state import State as JState
from nextsim_tpu.forcing.providers import ConstantForcing as JConstantForcing
from nextsim_tpu.grid.grid import Grid as JGrid
from nextsim_tpu.grid.projection import NPS_ASR as J_NPS_ASR
from nextsim_tpu.grid.projection import NPS_NEXTSIM as J_NPS
from nextsim_tpu.model import init_state as jinit
from nextsim_tpu.model.simulator import Simulator as JSimulator
import nextsim_tpu_torch.core.constants as tconst
import nextsim_tpu_torch.utils.dates as tdates
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy, state_to_numpy
from nextsim_tpu_torch.config import schema as tschema
from nextsim_tpu_torch.core.state import State as PState
from nextsim_tpu_torch.forcing.providers import ConstantForcing as PConstantForcing
from nextsim_tpu_torch.forcing.providers import make_provider
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.grid.projection import NPS_ASR as T_NPS_ASR
from nextsim_tpu_torch.grid.projection import NPS_NEXTSIM as T_NPS
from nextsim_tpu_torch.model import checks as tchecks
from nextsim_tpu_torch.model import init_state as tinit
from nextsim_tpu_torch.ops import momentum_cuda
from test_golden import FIELD_TOLS
from test_torch_datasets import curvilinear_latlon, write_era5, write_etopo
from test_torch_init_datasets import write_ice_products
from test_torch_momentum import jax_to_numpy

HERE = pathlib.Path(__file__).parent
REPO = HERE.parent

# tests/test_golden.py's toy configuration
GOLDEN_TOY = {
    "grid.nx": 48, "grid.ny": 48, "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00",
    "dynamics.substeps": 120,
    "dynamics.use_coriolis": False,
    "dynamics.alea_factor": 0.33,
    "dynamics.C_lab": 1.5e6,
    "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant_partial",
    "setup.atmosphere-type": "constant",
    "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 20.0,
    "simul.spinup_duration": 0.0,
    "tpu.donate_state": False,
}
SLICES = {
    # bench.py's arctic configuration cut to 32^2, wind on from the start
    "arctic32": {
        "grid.preset": "arctic", "grid.nx": 32, "grid.ny": 32, "grid.resolution": 10e3,
        "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00",
        "dynamics.substeps": 120, "dynamics.alea_factor": 0.33,
        "thermo.use_thermo_forcing": False, "setup.ice-type": "constant",
        "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 10.0, "ideal_simul.constant_wind_v": -3.0,
        "dynamics.use_coriolis": True, "simul.spinup_duration": 0.0,
        "tpu.donate_state": False,
    },
    "toy_square32": dict(GOLDEN_TOY, **{"grid.preset": "square", "grid.nx": 32, "grid.ny": 32}),
}
# thermodynamics on (the default Winton slab and young ice), with
# configs/arctic_10km.cfg's ice and an SST limit above the constant ocean's
# +1 C so that the ice survives the first step
THERMO_ON = {"thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0,
             "ideal_simul.init_concentration": 0.95, "ideal_simul.init_thickness": 1.5}
SLICES["arctic32_thermo"] = dict(SLICES["arctic32"], **THERMO_ON)
SLICES["toy_square32_thermo"] = dict(SLICES["toy_square32"], **THERMO_ON)
# absolute tolerances of the thermo fields after 5 steps against the jitted
# JAX Simulator in float32, about 30x the measured worst difference (tice
# 3.1e-5 C, sst 3.6e-7 C, sss 3.8e-6, conc_young 4.5e-8, h_young 2.2e-9 m)
THERMO_TOLS = {"tice": 1e-3, "sst": 1e-5, "sss": 1e-4, "conc_young": 1e-6, "h_young": 1e-7}


def assert_fields_within_golden_tols(ref, got, what):
    """tests/test_golden.py's per-field absolute tolerance with its outlier
    budget (damage/stress may flip the failure branch on isolated cells)."""
    for name, (atol, outlier_frac) in FIELD_TOLS.items():
        r = np.asarray(ref[name])
        g = got[name]
        assert np.isfinite(g).all(), (what, name)
        diff = np.abs(g - r)
        n_bad = int((diff > atol).sum())
        budget = max(1, int(outlier_frac * diff.size))
        assert n_bad <= budget, (
            f"{what}: {name} has {n_bad} cells beyond atol={atol} (budget "
            f"{budget}); max |diff|={diff.max():.3e}"
        )


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_matches_jax_simulator(name):
    over = SLICES[name]
    jsim = JSimulator(JConfig(overrides=over))
    psim = PSimulator(PConfig(overrides=over), device="cpu")
    psim.state = state_from_numpy(jax_to_numpy(jsim.state), device="cpu")
    for _ in range(5):
        jsim.step()
        psim.step()
    ref = jax_to_numpy(jsim.state)
    got = state_to_numpy(psim.state)
    assert_fields_within_golden_tols(ref, got, name)
    if over["thermo.use_thermo_forcing"]:
        assert float(np.abs(ref["sst"] - 1.0).max()) > 0.1  # thermo moved the slab ocean
        for f, atol in THERMO_TOLS.items():
            np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=atol, err_msg=f"{name}: {f}")
    # the whole state, not only the golden fields: same magnitudes
    for f, r in ref.items():
        np.testing.assert_allclose(np.abs(got[f]).mean(), np.abs(r).mean(), rtol=1e-2, atol=1e-6,
                                   err_msg=f)
    assert psim.pcpt == jsim.pcpt == 5


def _golden_run():
    psim = PSimulator(PConfig(overrides=GOLDEN_TOY), device="cpu")
    rnd = np.load(HERE / "golden_toy_random_number.npy")
    psim.state = psim.state.replace(random_number=torch.from_numpy(rnd))
    for _ in range(15):
        psim.step()
    return psim.state


def test_golden_toy_fields_and_stats():
    s = _golden_run()
    got = {"sigma": s.sigma.numpy(), **{k: getattr(s, k).numpy() for k in FIELD_TOLS if k != "sigma"}}
    with np.load(HERE / "golden_toy_fields.npz") as ref:
        assert_fields_within_golden_tols({k: ref[k] for k in ref.files}, got, "golden")
    conc, thick, damage = s.conc.numpy(), s.thick.numpy(), s.damage.numpy()
    speed = np.hypot(s.vt_u.numpy(), s.vt_v.numpy())
    stats = {
        "conc_sum": conc.sum(), "thick_sum": thick.sum(),
        "conc_max": conc.max(), "thick_max": thick.max(),
        "damage_mean": damage.mean(), "damage_max": damage.max(),
        "speed_max": speed.max(), "speed_mean": speed.mean(),
        "sigma_absmax": np.abs(s.sigma.numpy()).max(),
        "ridge_max": s.ridge_ratio.numpy().max(),
        "damage_grad_energy": (np.diff(damage, axis=0) ** 2).sum() + (np.diff(damage, axis=1) ** 2).sum(),
    }
    golden = json.loads((HERE / "golden_toy.json").read_text())
    assert set(golden) == set(stats)
    for key, ref in golden.items():
        assert abs(float(stats[key]) - ref) <= 0.02 * max(abs(ref), 1e-6) + 1e-6, (key, stats[key], ref)


def test_golden_random_fixture_is_current():
    """golden_toy_random_number.npy is the JAX package's init_state random
    field for the golden configuration."""
    cfg = JConfig(overrides=GOLDEN_TOY)
    state = jinit.init_state(cfg, JGrid.from_config(cfg))
    np.testing.assert_array_equal(
        np.load(HERE / "golden_toy_random_number.npy"), np.asarray(state.random_number)
    )


def test_step_chunk_equals_steps(tmp_path):
    """``step_chunk(3)`` (the 3-step program) equals 3 ``step`` calls (the
    1-step program) and the eager loop, bitwise: on the toy square, and with
    thermodynamics on across a day boundary (the chunk's steps start at
    23:53:20, 23:56:40 and 00:00:00) with the moorings' running means."""
    thermo = dict(SLICES["toy_square32_thermo"], **{
        "dynamics.substeps": 20, "simul.time_init": "2015-10-16 23:53:20", "moorings.use_moorings": True,
        "output.exporter_path": str(tmp_path)})
    for over in (dict(SLICES["toy_square32"], **{"dynamics.substeps": 20}), thermo):
        a = PSimulator(PConfig(overrides=over), device="cpu")
        b = PSimulator(PConfig(overrides=over), device="cpu")
        c = PSimulator(PConfig(overrides=over), device="cpu")
        for _ in range(3):
            a.step()
        b.step_chunk(3)
        c.step_chunk_eager(3)
        assert a.pcpt == b.pcpt == c.pcpt == 3
        for other in (b, c):
            for f, v in state_to_numpy(a.state).items():
                np.testing.assert_array_equal(state_to_numpy(other.state)[f], v, err_msg=f)
        if a.moorings is None:
            continue
        assert a.use_thermo and a.moorings._count == b.moorings._count == c.moorings._count == 3
        assert set(a.moorings._accum) == set(b.moorings._accum) == set(c.moorings._accum)
        for key, v in a.moorings._accum.items():
            np.testing.assert_array_equal(b.moorings._accum[key].numpy(), v.numpy(), err_msg=key)
            np.testing.assert_array_equal(c.moorings._accum[key].numpy(), v.numpy(), err_msg=key)


def test_simulator_takes_a_grid():
    """``Simulator(cfg, grid=...)`` uses the given grid, not the config's:
    a 24 x 20 square placed 500 km west and 300 km north of the config's 32^2
    one, with Coriolis on (the latitude moves with the grid). Both packages
    step 2 steps on it in float64."""
    over = dict(SLICES["toy_square32"], **{"tpu.dtype": "float64", "dynamics.use_coriolis": True,
                                           "dynamics.substeps": 60})
    kw = dict(nx=24, ny=20, dx=10e3, x0=-500e3, y0=300e3)
    with jax.enable_x64(True):
        jsim = JSimulator(JConfig(overrides=over), grid=JGrid.square(**kw))
        psim = PSimulator(PConfig(overrides=over), grid=PGrid.square(**kw), device="cpu")
        for a, b in zip(psim.grid.cell_xy(), jsim.grid.cell_xy()):
            np.testing.assert_array_equal(a, b)
        assert psim.grid.shape == (20, 24) and psim.state.conc.shape == (20, 24)
        psim.state = state_from_numpy(jax_to_numpy(jsim.state), device="cpu")
        for _ in range(2):
            jsim.step()
            psim.step()
        ref, got = jax_to_numpy(jsim.state), state_to_numpy(psim.state)
    for f, r in ref.items():
        np.testing.assert_allclose(got[f], r, rtol=0, atol=1e-9 * max(np.abs(r).max(), 1e-300), err_msg=f)
    # the config's own grid would have given another latitude, so other dynamics
    own = PSimulator(PConfig(overrides=dict(over, **{"grid.nx": 24, "grid.ny": 20})), device="cpu")
    own.state = state_from_numpy(ref, device="cpu")
    assert not np.array_equal(own.grid_arrays["node_lat"].numpy(), psim.grid_arrays["node_lat"].numpy())


def test_violation_flush_raises_with_messages(tmp_path):
    sim = PSimulator(PConfig(overrides=dict(SLICES["toy_square32"], **{
        "dynamics.substeps": 10, "output.exporter_path": str(tmp_path)})), device="cpu")
    conc = sim.state.conc.clone()
    conc[5, 5] = float("nan")
    sim.state = sim.state.replace(conc=conc)
    with pytest.raises(RuntimeError, match="checkFieldsFast failed for conc"):
        sim.step_chunk(2)
    assert (tmp_path / "field_crash.npz").exists()  # the crash dump


def test_violations_match_jax():
    from nextsim_tpu.model import checks as jchecks

    j = JState.zeros(JGrid.square(nx=8, ny=8))
    p = state_from_numpy(jax_to_numpy(j), device="cpu")
    bad = {"thick": 60.0, "tice": 1.0, "sss": -1.0}
    for f, v in bad.items():
        arr = np.array(jax_to_numpy(j)[f])
        arr.reshape(-1)[3] = v
        j = j.replace(**{f: jnp.asarray(arr)})
        p = p.replace(**{f: torch.from_numpy(arr)})
    np.testing.assert_array_equal(tchecks.violations(p).numpy(), np.asarray(jchecks.violations(j)))
    assert tchecks.describe(tchecks.violations(p).numpy()) == jchecks.describe(jchecks.violations(j))


def test_time_info_matches_jax():
    over = dict(SLICES["toy_square32"], **{"simul.time_init": "2015-09-14 23:00:00",
                                            "simul.timestep": 3600})
    jsim = JSimulator(JConfig(overrides=over))
    psim = PSimulator(PConfig(overrides=over), device="cpu")
    for t in (psim.current_time, psim.current_time + 1.0 / 24, psim.current_time + 0.5):
        ji = jsim.time_info_at(t)
        pi = psim.time_info_at(t)
        assert {k: float(v) for k, v in ji.items()} == {k: float(v) for k, v in pi.items()}


# ---------------------------------------------------------------------------
# the dataset slice
# ---------------------------------------------------------------------------

# a curvilinear (TOPAZ-like) source grid over the whole 3200 km arctic box
BIG_CURVILINEAR = dict(ny=30, nx=32, dx=120e3, lon0=0.0, x0=-1900e3, y0=-1800e3)
# configs/arctic_10km.cfg's forcing on a 32^2 arctic_etopo grid at 100 km
# (dte = 1.7 s < dx/800), winds on from the start
DATASET_SLICE = {
    "grid.preset": "arctic_etopo", "grid.nx": 32, "grid.ny": 32, "grid.resolution": 100e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00",
    "dynamics.substeps": 120, "dynamics.alea_factor": 0.33, "dynamics.use_coriolis": True,
    "setup.atmosphere-type": "era5", "setup.ocean-type": "topaz4_rean",
    "setup.ice-type": "topaz4_rean", "setup.bathymetry-type": "etopo",
    "thermo.use_thermo_forcing": True, "simul.spinup_duration": 0.0,
    "tpu.donate_state": False,
}


def write_dataset_dir(d):
    """ERA5, ETOPO and every ice product (TOPAZ4 included) under ``d``."""
    d = str(d)
    write_era5(d)
    write_etopo(d)
    write_ice_products(d, latlon=curvilinear_latlon(**BIG_CURVILINEAR))
    return d


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return write_dataset_dir(tmp_path_factory.mktemp("datasets"))


def _assert_states_bitwise(got, ref, skip=()):
    assert set(got) == set(ref)
    for f in ref:
        if f not in skip:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("dtype_name,thermo", [("float32", False), ("float64", True)])
def test_dataset_slice_matches_jax_simulator(dtype_name, thermo, dataset_dir, monkeypatch):
    """Thermo on is held in float64: ice initialised from a dataset keeps
    State.zeros' T1 = Tfr_ice, where Winton's layer enthalpy e1 is zero, so
    the sign of a one-ulp difference in T1 decides the first step's melt
    (torch's CPU float32 sqrt is one ulp off on such inputs; ROADMAP C)."""
    monkeypatch.setenv("NEXTSIM_DATA_DIR", dataset_dir)
    over = dict(DATASET_SLICE, **{"tpu.dtype": dtype_name, "thermo.use_thermo_forcing": thermo})
    with jax.enable_x64(dtype_name == "float64"):
        jsim = JSimulator(JConfig(overrides=over))
        psim = PSimulator(PConfig(overrides=over), device="cpu")
        assert 0.2 < psim.grid.mask.mean() < 0.95  # a coastline
        _assert_states_bitwise(state_to_numpy(psim.state), jax_to_numpy(jsim.state),
                               skip=("random_number",))
        psim.state = state_from_numpy(jax_to_numpy(jsim.state), device="cpu")
        for _ in range(5):
            jsim.step()
            psim.step()
        for f in dataclasses.fields(jsim.last_forcing):
            r = getattr(jsim.last_forcing, f.name)
            if r is not None:
                np.testing.assert_array_equal(getattr(psim.last_forcing, f.name).numpy(), np.asarray(r),
                                              err_msg=f.name)
        ref = jax_to_numpy(jsim.state)
    got = state_to_numpy(psim.state)
    assert got["conc"].dtype == np.dtype(dtype_name)
    assert_fields_within_golden_tols(ref, got, "dataset slice")
    if thermo:
        for f, atol in THERMO_TOLS.items():
            np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=atol, err_msg=f)
    # the datasets reached the step: varying depth, winds and currents
    lf = psim.last_forcing
    ocean = psim.grid.mask > 0.5
    assert lf.depth.numpy()[ocean].std() > 10.0
    assert float(lf.wind_u.std()) > 1.0 and float(lf.ocean_u.std()) > 0.01
    assert float(np.abs(got["vt_u"]).max()) > 0.0


def test_restart_with_assimilation_matches_jax(dataset_dir, monkeypatch, tmp_path):
    """A restart with setup.use_assimilation (the OSISAF/AMSR2 blend):
    assimilated state bitwise, then 2 steps within the golden tolerances."""
    from nextsim_tpu.output.restart import write_restart as jwrite_restart

    monkeypatch.setenv("NEXTSIM_DATA_DIR", dataset_dir)
    over = dict(DATASET_SLICE, **{"setup.ice-type": "topaz4_nrt-amsr2-osisaf",
                                   "output.exporter_path": str(tmp_path)})
    first = JSimulator(JConfig(overrides=over))
    first.step()
    jwrite_restart(first, name="final")
    over = dict(over, **{"restart.start_from_restart": True, "restart.basename": "final",
                         "setup.use_assimilation": True})
    jsim = JSimulator(JConfig(overrides=over))
    psim = PSimulator(PConfig(overrides=over), device="cpu")
    ref, got = jax_to_numpy(jsim.state), state_to_numpy(psim.state)
    _assert_states_bitwise(got, ref)
    before = jax_to_numpy(first.state)
    assert not np.array_equal(got["conc"], before["conc"])  # the blend moved conc
    assert np.abs(got["conc_upd"] - before["conc_upd"]).max() > 0.0
    assert not np.array_equal(got["sst"], before["sst"])  # and the slab ocean
    for _ in range(2):
        jsim.step()
        psim.step()
    assert_fields_within_golden_tols(jax_to_numpy(jsim.state), state_to_numpy(psim.state), "assimilated")


def test_assimilate_matches_jax():
    over = SLICES["arctic32"]
    jsim = JSimulator(JConfig(overrides=over))
    psim = PSimulator(PConfig(overrides=over), device="cpu")
    psim.state = state_from_numpy(jax_to_numpy(jsim.state), device="cpu")
    obs = np.random.default_rng(2).uniform(0.0, 1.0, psim.grid.shape)
    jsim.assimilate(obs)
    psim.assimilate(obs)
    _assert_states_bitwise(state_to_numpy(psim.state), jax_to_numpy(jsim.state))


# ---------------------------------------------------------------------------
# set-up pieces against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ice,thermo", [("constant", False), ("constant_partial", False),
                                       ("constant", True)])
def test_init_state_matches_jax(ice, thermo):
    """thermo on: the constant slab ocean is warmer than the SST limit, so
    the warm-water test clears the ice (reference constantIce)."""
    over = dict(SLICES["arctic32"], **{"setup.ice-type": ice, "ideal_simul.init_young_conc": 0.1,
                                        "ideal_simul.init_snow_thickness": 0.2,
                                        "thermo.use_thermo_forcing": thermo})
    jcfg, pcfg = JConfig(overrides=over), PConfig(overrides=over)
    jstate = jinit.init_state(jcfg, JGrid.from_config(jcfg))
    pstate = tinit.init_state(pcfg, PGrid.from_config(pcfg),
                              random_number=np.asarray(jstate.random_number), device="cpu")
    ref = jax_to_numpy(jstate)
    got = state_to_numpy(pstate)
    assert set(ref) == set(got)
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_init_state_random_field_is_seeded():
    cfg = PConfig(overrides=SLICES["toy_square32"])
    grid = PGrid.from_config(cfg)
    a = tinit.init_state(cfg, grid, seed=3, device="cpu").random_number
    b = tinit.init_state(cfg, grid, seed=3, device="cpu").random_number
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_state_zeros_matches_jax():
    grid_j, grid_p = JGrid.square(nx=9, ny=7), PGrid.square(nx=9, ny=7)
    cfg = SLICES["arctic32"]
    ref = jax_to_numpy(JState.zeros(grid_j, cfg=JConfig(overrides=cfg)))
    got = state_to_numpy(PState.zeros(grid_p, cfg=PConfig(overrides=cfg), device="cpu"))
    assert [f.name for f in dataclasses.fields(PState)] == [f.name for f in dataclasses.fields(JState)]
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_state_numpy_round_trip():
    s = PState.zeros(PGrid.square(nx=5, ny=4), device="cpu")
    back = state_from_numpy(state_to_numpy(s), dtype=torch.float64, device="cpu")
    assert back.conc.dtype == torch.float64 and back.conc_fsd is None
    for f, v in state_to_numpy(s).items():
        np.testing.assert_array_equal(state_to_numpy(back)[f], v)


def test_constant_forcing_matches_jax():
    over = dict(SLICES["arctic32"], **{"simul.spinup_duration": 2.0, "ideal_simul.constant_ssh": 0.3})
    jcfg, pcfg = JConfig(overrides=over), PConfig(overrides=over)
    jf = JConstantForcing(jcfg, JGrid.from_config(jcfg))
    pf = PConstantForcing(pcfg, PGrid.from_config(pcfg), device="cpu")
    for t in (0.5, 1.0, 3.0):
        assert pf.spinup_factor(t, 0.0) == jf.spinup_factor(t, 0.0)
        ref, got = jf(t, 0.0), pf(t, 0.0)
        for f in dataclasses.fields(ref):
            r = getattr(ref, f.name)
            if r is None:
                assert getattr(got, f.name) is None, f.name
            else:
                np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(r), err_msg=f.name)
    assert pf(3.0, 0.0) is pf(4.0, 0.0)  # cached once the spin-up is over


# ---------------------------------------------------------------------------
# what the port does not have raises
# ---------------------------------------------------------------------------

# a mesh runs one rank per block: in one process it is an error that names
# torchrun, the WIM on a mesh too (tests/test_torch_parallel_waves.py runs it
# on 4 ranks); bfloat16 is ported (it moved to PORTED below), and its
# refusals, where the JAX package's bfloat16 run fails, are
# tests/test_torch_bf16_outputs.py's
UNPORTED = {
    "mesh": ({"tpu.mesh_shape": "2x4"}, ValueError, "torchrun --nproc-per-node 8"),
    "shard_map": ({"tpu.mesh_shape": "2x2", "tpu.partition_mode": "shard_map",
                   "nextwim.use_wim": True}, ValueError, "torchrun --nproc-per-node 4"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_subsystems_raise(name):
    over, error, match = UNPORTED[name]
    with pytest.raises(error, match=match):
        PSimulator(PConfig(overrides=dict(SLICES["toy_square32"], **over)), device="cpu")


# the options that raised before thermodynamics, the outputs, the datasets,
# nesting, the waves, the coupler and the bfloat16 state were ported; the
# dataset ones read the files of write_dataset_dir
PORTED = {
    "thermo": {"thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0},
    "moorings": {"moorings.use_moorings": True, "moorings.output_timestep": 2,
                 "moorings.output_time_step_units": "time_steps"},
    "drifters": {"drifters.use_equally_spaced_drifters": True, "drifters.spacing": 40.0,
                 "drifters.equally_spaced_drifters_output_time_step": 400.0 / 86400.0},
    "snapshots": {"output.output_per_day": 216},
    "restart_in": {"restart.start_from_restart": True, "restart.basename": "final"},
    "restart_out": {"restart.write_final_restart": True},
    "check_fields": {"debugging.check_fields": True, "debugging.check_velocity_fields": True},
    "era5": {"setup.atmosphere-type": "era5"},
    "topaz4": {"setup.ice-type": "topaz4", "setup.ocean-type": "topaz4"},
    "arctic_etopo": {"grid.preset": "arctic_etopo", "setup.bathymetry-type": "etopo"},
    "nesting": {"nesting.use_nesting": True, "grid.boundary": "open", "nesting.use_ocean_nesting": True,
                "nesting.nest_dynamic_vars": True},
    "assimilation": {"restart.start_from_restart": True, "restart.basename": "final",
                     "setup.use_assimilation": True, "setup.ice-type": "topaz4_nrt-amsr2-osisaf"},
    "fsd": {"wave_coupling.num_fsd_bins": 4},
    "wim": {"nextwim.use_wim": True, "nextwim.couplingfreq": 2, "wimsetup.nwavefreq": 2,
            "wimsetup.nwavedirn": 4},
    "coupler": {"setup.ocean-type": "coupled", "coupler.timestep": 400},
    "coupler_waves": {"coupler.with_waves": True, "coupler.timestep": 400},
    "ensemble": {"statevector.ensemble_member": 1},
    "bfloat16": {"tpu.dtype": "bfloat16", "restart.write_final_restart": True},
}
DATASET_OPTIONS = ("era5", "topaz4", "arctic_etopo", "nesting", "assimilation")


def run_ported(name, over, tmp_path, monkeypatch, **base_over):
    """``Simulator.run`` of option ``name`` of PORTED with overrides
    ``over`` on the 32^2 toy square (4 steps of 200 s), with the dataset
    files, the outer run or the restart it reads: (the Simulator, the
    base overrides)."""
    base = dict(SLICES["toy_square32"], **{"dynamics.substeps": 20, "simul.duration": 800.0 / 86400.0,
                                          "output.exporter_path": str(tmp_path)}, **base_over)
    over = dict(over)
    if name in DATASET_OPTIONS:
        data = write_dataset_dir(tmp_path / "data")
        monkeypatch.setenv("NEXTSIM_DATA_DIR", data)
        if name == "nesting":
            from test_torch_nesting import write_nesting_files

            write_nesting_files(data, model=dict(nx=32, ny=32, dx=10e3, boundary="open"))
            over["nesting.outer_mesh"] = os.path.join(data, "outer")
    if name in ("restart_in", "assimilation"):
        PSimulator(PConfig(overrides=dict(base, **PORTED["restart_out"])), device="cpu").run()
    sim = PSimulator(PConfig(overrides=dict(base, **over)), device="cpu")
    sim.run()
    return sim, base


@pytest.mark.parametrize("name", sorted(PORTED))
def test_formerly_unported_options_run(name, tmp_path, monkeypatch):
    """Each option that the port used to refuse now runs through
    ``Simulator.run`` (4 steps of 200 s) and leaves its output."""
    sim, base = run_ported(name, PORTED[name], tmp_path, monkeypatch)
    assert sim.pcpt == 4
    assert np.isfinite(state_to_numpy(sim.state)["conc"]).all()
    files = {p.name for p in tmp_path.rglob("*")}
    expect = {"moorings": "Moorings_20151016.nc", "drifters": "Drifters_equally_spaced.nc",
              "snapshots": "field_final.npz", "restart_out": "restart_final.npz"}
    if name in expect:
        assert expect[name] in files, files
    if name == "thermo":
        assert "qa" in sim.diag and float(sim.state.conc.max()) > 0.0
    if name == "restart_in":
        assert sim.time_init > PSimulator(PConfig(overrides=base), device="cpu").time_init  # extended
    if name in DATASET_OPTIONS:
        assert "forcing" in sim.timer.print_all()
    lf = sim.last_forcing
    if name == "era5":
        assert float(lf.wind_u.std()) > 0.1 and lf.dair is not None
    if name == "topaz4":
        assert float(sim.state.conc.std()) > 0.0 and float(lf.ocean_temp.std()) > 0.0
    if name == "arctic_etopo":
        assert float(lf.depth.std()) > 0.0
    if name == "nesting":
        assert sim.nesting is not None and float(lf.ocean_temp.std()) > 0.0
    if name == "assimilation":
        assert float(sim.state.conc_upd.abs().max()) > 0.0
    if name == "fsd":
        total = sim.state.conc + sim.state.conc_young
        torch.testing.assert_close(sim.state.conc_fsd.sum(0), total, rtol=0, atol=1e-6)
        assert "dmax" in sim.diag
    if name == "wim":
        assert float(sim.wim_diag["hs"].max()) > 0.0 and sim.last_forcing.tau_wi_u is not None
    if name == "ensemble":  # the perturbed member's forcing is not the provider's
        base = sim.forcing_provider.provider(sim.current_time, sim.time_init)
        assert not torch.equal(lf.tair, base.tair) and not torch.equal(lf.wind_u, base.wind_u)
    if name in ("coupler", "coupler_waves"):
        assert sorted(p.name for p in (tmp_path / "coupler").glob("cpl_out_*.nc")) == [
            "cpl_out_20151016T000640Z.nc", "cpl_out_20151016T001320Z.nc"]
    if name == "bfloat16":  # every plane stays bfloat16; the restart holds |V2 records
        assert {getattr(sim.state, f.name).dtype for f in dataclasses.fields(sim.state)
                if getattr(sim.state, f.name) is not None} == {torch.bfloat16}
        with np.load(tmp_path / "restart" / "restart_final.npz") as data:
            assert data["conc"].dtype == np.dtype("V2")


def test_default_asr_without_files_is_constant_forcing(tmp_path, monkeypatch):
    """The default atmosphere-type (asr) routes to the dataset provider,
    which without its files gives the constant forcing, as in the JAX
    package."""
    from nextsim_tpu_torch.forcing.datasets import DatasetForcing

    monkeypatch.setenv("NEXTSIM_DATA_DIR", str(tmp_path))
    cfg = PConfig(overrides={"grid.nx": 16, "grid.ny": 16})
    assert cfg["setup.atmosphere-type"] == "asr"
    prov = make_provider(cfg, PGrid.from_config(cfg), device="cpu")
    assert isinstance(prov, DatasetForcing)
    const = PConstantForcing(cfg, PGrid.from_config(cfg), device="cpu")
    for f in dataclasses.fields(const(0.5, 0.0)):
        a, b = getattr(prov(0.5, 0.0), f.name), getattr(const(0.5, 0.0), f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

def _loop_inputs(dtype=torch.float32):
    from nextsim_tpu_torch.ops import momentum as pmom

    sim = PSimulator(PConfig(overrides=dict(SLICES["toy_square32"], **{"dynamics.substeps": 4})), device="cpu")
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    forcing = sim.forcing_provider(0.0, 0.0)
    consts, carry = pmom.substep_setup(sim.state, forcing, ga, sim.dt, sim.dyn)
    if dtype != torch.float32:
        carry = tuple(c.to(dtype) for c in carry)
    return consts, carry, sim


def _cuda_loop(consts, carry, sim):
    return momentum_cuda._substep_loop_cuda(
        consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx, "bbm", sim.dyn)


def test_kernel_request_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc to build the kernel the wrapper raises; it never falls
    back to the plain loop."""
    monkeypatch.setattr(momentum_cuda, "_lib", None)
    monkeypatch.setattr(momentum_cuda, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(momentum_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        momentum_cuda.build()
    consts, carry, sim = _loop_inputs()
    launches = momentum_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_loop(consts, carry, sim)
    assert momentum_cuda.launches == launches


def test_wrapper_rejects_what_the_kernel_does_not_take():
    consts, carry, sim = _loop_inputs()
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        _cuda_loop(consts, tuple(c.half() for c in carry), sim)
    bad = list(carry)
    bad[4] = carry[4][:-1]  # sxx one row short
    with pytest.raises(ValueError, match="sxx"):
        _cuda_loop(consts, tuple(bad), sim)
    bad[4] = carry[4].t().contiguous().t()  # right shape, column-major
    with pytest.raises(ValueError, match="contiguous"):
        _cuda_loop(consts, tuple(bad), sim)
    with pytest.raises(ValueError, match="volume"):
        _cuda_loop(SimpleNamespace(**dict(vars(consts), volume=consts.volume.double())), carry, sim)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        momentum_cuda.substep_loop(consts, tuple(c.to("meta") for c in carry), 4,
                                   sim.dt / 4, sim.dt, sim.grid.dx, "bbm", sim.dyn)


def test_cpu_carry_runs_the_plain_loop():
    consts, carry, sim = _loop_inputs()
    launches = momentum_cuda.launches
    out = momentum_cuda.substep_loop(consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx, "bbm", sim.dyn)
    ref = momentum_cuda.substep_loop_reference(consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx,
                                               "bbm", sim.dyn)
    assert momentum_cuda.launches == launches
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


def test_kernel_params_mirror_the_source():
    """The ctypes mirror of SubstepParams and the plane order follow the
    CUDA source."""
    src = (REPO / "nextsim_tpu_torch" / "csrc" / "momentum_substep.cu").read_text()
    body = src[src.index("struct SubstepParams {"):]
    body = body[:body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [n for n, _ in momentum_cuda._Params._fields_]
    enum = src[src.index("enum Plane {"):]
    enum = enum[:enum.index("};")]
    planes = [w.strip() for line in enum.splitlines()[1:]
              for w in line.split("//")[0].split(",") if w.strip()]
    assert planes[-1] == "N_PLANES"
    assert [p.lower() for p in planes[:-1]] == [
        {"dte_over_mass_const": "dte_over_mass", "beta_cor_const": "beta_cor"}.get(n, n).lower()
        for n in momentum_cuda._PLANES
    ]


# ---------------------------------------------------------------------------
# no jax, and the copies of the host-only modules
# ---------------------------------------------------------------------------

SLICE_MODULES = [
    "nextsim_tpu_torch", "nextsim_tpu_torch.config.schema", "nextsim_tpu_torch.core.constants",
    "nextsim_tpu_torch.core.state", "nextsim_tpu_torch.core.ties", "nextsim_tpu_torch.utils.dates",
    "nextsim_tpu_torch.grid.projection", "nextsim_tpu_torch.grid.grid",
    "nextsim_tpu_torch.grid.arctic", "nextsim_tpu_torch.forcing.base",
    "nextsim_tpu_torch.forcing.providers", "nextsim_tpu_torch.ops.stencil",
    "nextsim_tpu_torch.ops.rheology", "nextsim_tpu_torch.ops.momentum",
    "nextsim_tpu_torch.ops.momentum_cuda", "nextsim_tpu_torch.ops.welding_cuda", "nextsim_tpu_torch.ops.advection",
    "nextsim_tpu_torch.ops.transport", "nextsim_tpu_torch.model.params",
    "nextsim_tpu_torch.model.init_state", "nextsim_tpu_torch.model.checks",
    "nextsim_tpu_torch.model.simulator", "nextsim_tpu_torch.model.params_thermo",
    "nextsim_tpu_torch.ops.thermo", "nextsim_tpu_torch.ops.aerobulk",
    "nextsim_tpu_torch.core.variables", "nextsim_tpu_torch.forcing.netcdf_io",
    "nextsim_tpu_torch.utils.logging", "nextsim_tpu_torch.utils.timer",
    "nextsim_tpu_torch.utils.async_writer", "nextsim_tpu_torch.output.moorings",
    "nextsim_tpu_torch.output.exporter", "nextsim_tpu_torch.output.ref_binary",
    "nextsim_tpu_torch.output.restart", "nextsim_tpu_torch.output.drifters",
    "nextsim_tpu_torch.__main__", "nextsim_tpu_torch.forcing.datasets",
    "nextsim_tpu_torch.forcing.bathymetry", "nextsim_tpu_torch.model.init_ice_datasets",
    "nextsim_tpu_torch.ops.nesting", "nextsim_tpu_torch.model.nesting_source",
    "nextsim_tpu_torch.tools.synthetic_etopo", "nextsim_tpu_torch.tools.tune_substep",
    "nextsim_tpu_torch.tools.tune_welding",
    "nextsim_tpu_torch.ops.fsd", "nextsim_tpu_torch.wim.rtparam", "nextsim_tpu_torch.wim.wim",
    "nextsim_tpu_torch.wim.regrid", "nextsim_tpu_torch.wim.__main__", "nextsim_tpu_torch.wim",
    "nextsim_tpu_torch.coupling.exchange", "nextsim_tpu_torch.coupling",
    "nextsim_tpu_torch.ensemble", "nextsim_tpu_torch.ensemble.perturbation",
    "nextsim_tpu_torch.ensemble.batched", "nextsim_tpu_torch.ensemble.run_ensemble",
    "nextsim_tpu_torch.validation", "nextsim_tpu_torch.validation.deformation",
    "nextsim_tpu_torch.validation.ref_compare", "nextsim_tpu_torch.tools.deformation_stats",
    "nextsim_tpu_torch.tools.plot_fields", "nextsim_tpu_torch.tools.nan_bisect",
    "nextsim_tpu_torch.parallel", "nextsim_tpu_torch.parallel.distributed",
    "nextsim_tpu_torch.parallel.halo", "nextsim_tpu_torch.parallel.multihost",
    "nextsim_tpu_torch.parallel.seam", "nextsim_tpu_torch.model.captured", "nextsim_tpu_torch.bench",
]


def test_slice_modules_cover_the_package():
    mods = {".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in (REPO / "nextsim_tpu_torch").rglob("*.py") if p.name != "__init__.py"}
    assert mods <= set(SLICE_MODULES), sorted(mods - set(SLICE_MODULES))


def test_port_imports_no_jax():
    """In a fresh interpreter where importing jax fails, every module of the
    port imports, and neither jax nor the JAX package gets loaded."""
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'nextsim_tpu'):\n"
        "    sys.modules[name] = None  # any import of them raises ImportError\n"
        f"for mod in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nextsim_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_config_schema_copy_is_pinned():
    assert tschema.OPTIONS == jschema.OPTIONS
    assert tschema.ENUMS == jschema.ENUMS
    for cfgfile in ("toy.cfg", "arctic_10km.cfg"):
        path = str(REPO / "configs" / cfgfile)
        assert PConfig.from_files(path).as_dict() == JConfig.from_files(path).as_dict()
    assert PConfig.describe_options() == JConfig.describe_options()


def test_constants_and_dates_copies_are_pinned():
    public = lambda mod: {k: v for k, v in vars(mod).items()  # noqa: E731
                          if not k.startswith("_") and isinstance(v, (int, float))}
    assert public(tconst) == public(jconst)
    for s in ("2015-10-16", "2015-10-16 06:30:00", "2015-Oct-16", "20151016"):
        assert tdates.string_to_datenum(s) == jdates.string_to_datenum(s)
    t = jdates.string_to_datenum("2015-10-16 06:30:00")
    assert tdates.datenum_to_string(t) == jdates.datenum_to_string(t)
    assert tdates.datenum_to_datetime(t) == jdates.datenum_to_datetime(t)


def test_projection_copy_is_pinned():
    rng = np.random.default_rng(0)
    lat = rng.uniform(50.0, 90.0, 200)
    lon = rng.uniform(-180.0, 180.0, 200)
    for tp, jp in ((T_NPS, J_NPS), (T_NPS_ASR, J_NPS_ASR)):
        x, y = tp.forward(lat, lon)
        jx, jy = jp.forward(lat, lon)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        for a, b in zip(tp.inverse(x, y), jp.inverse(jx, jy)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("over", [
    {"grid.preset": "square", "grid.nx": 20, "grid.ny": 14},
    {"grid.preset": "square", "grid.nx": 20, "grid.ny": 14, "grid.boundary": "open"},
    {"grid.preset": "arctic", "grid.nx": 64, "grid.ny": 48, "grid.resolution": 25e3},
    {"grid.preset": "", "grid.nx": 16, "grid.ny": 16},  # mesh file name -> arctic
    {"grid.preset": "arctic_etopo", "grid.nx": 48, "grid.ny": 40, "grid.resolution": 80e3},
])
def test_grid_copy_is_pinned(over, tmp_path, monkeypatch):
    if over["grid.preset"] == "arctic_etopo":
        write_etopo(str(tmp_path))
        monkeypatch.setenv("NEXTSIM_DATA_DIR", str(tmp_path))
    jg = JGrid.from_config(JConfig(overrides=over))
    tg = PGrid.from_config(PConfig(overrides=over))
    assert (tg.nx, tg.ny, tg.dx, tg.x0, tg.y0) == (jg.nx, jg.ny, jg.dx, jg.x0, jg.y0)
    for name in ("mask", "open_mask", "node_mask", "node_dirichlet"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name), err_msg=name)
    for a, b in zip(tg.node_latlon() + tg.cell_latlon() + tg.node_xy(),
                    jg.node_latlon() + jg.cell_latlon() + jg.node_xy()):
        np.testing.assert_array_equal(a, b)
    assert math.isclose(tg.cell_area, jg.cell_area)
