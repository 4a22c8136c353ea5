"""The wave path of the PyTorch port as a whole against the JAX package, on
the CPU: a toy 24 x 14 grid at 10 km, a 5 x 8 spectrum and 6 floe-size bins.

Both Simulators start from the JAX package's initial state (the same random
cohesion field) and step side by side. Tolerances:

* float64, under the scoped ``jax.enable_x64(True)``: every state field, the
  WIM's ice fields and diagnostics and the spectrum within 1e-9 of the
  field's magnitude, ``broken`` equal (measured: 1e-15 to 7e-10, the largest
  in ridge_ratio as on the thermo path).
* float32, tiered as the momentum tests are: ulps flip single cells at the
  breaking front and at the BBM failure threshold. Every field is finite,
  the concentration, thickness and the bins agree within 1e-3 of their
  magnitude on at least 98% of the cells, ``broken`` differs on at most 2%,
  and the mean speed and mean damage agree (rtol 1e-3, atol 1e-3).

The cadence tests hold ``_wim_due`` and the chunk clamp to the step numbers
of tests/test_wim.py.
"""

import dataclasses
import inspect
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu.output.restart import read_restart as jread_restart
from nextsim_tpu.output.restart import write_restart as jwrite_restart
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy, state_to_numpy
from nextsim_tpu_torch.core import state as pstate_mod
from nextsim_tpu_torch.output.restart import write_restart as pwrite_restart
from nextsim_tpu_torch.wim import Wim as PWim
from test_torch_momentum import jax_to_numpy

# one thread a test process: the suite runs several processes side by side, and
# torch's worker threads would fight over the cores
torch.set_num_threads(1)

BASE = {
    "simul.time_init": "2008-03-01", "simul.timestep": 600, "simul.duration": 4 * 600 / 86400.0,
    "simul.spinup_duration": 0.0, "dynamics.substeps": 60,  # dte = 10 s < dx / 800
    "grid.preset": "square", "grid.nx": 24, "grid.ny": 14, "grid.resolution": 10e3,
    "setup.ice-type": "constant_partial", "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "setup.dynamics-type": "bbm", "ideal_simul.constant_wind_u": 5.0, "ideal_simul.constant_wind_v": 2.0,
    "thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0, "ideal_simul.constant_tair": -15.0,
    "nextwim.use_wim": True, "nextwim.couplingfreq": 2, "wimsetup.nwavefreq": 5, "wimsetup.nwavedirn": 8,
    "wim.steady": False, "wim.dfloepackinit": 250.0,
    "wave_coupling.num_fsd_bins": 6, "wave_coupling.fsd_bin_cst_width": 40.0, "wave_coupling.welding_type": "roach",
    "wave_coupling.fsd_damage_type": 1, "thermo.melt_type": 3,
    "tpu.donate_state": False, "restart.datetime_in_filename": False,
}
MOORINGS = {"moorings.use_moorings": True, "moorings.output_timestep": 2, "moorings.output_time_step_units": "time_steps",
            "moorings.spacing": 20.0}
MOORING_VARS = ["conc", "damage", "dmax", "dmean", "tauwix", "tauwiy"]


def pair(tmp_path, dtype_name="float64", **over):
    """(jsim, psim) of one configuration, the port on the CPU and on the
    JAX package's initial state. Call inside the x64 scope for float64."""
    cfg = dict(BASE, **over, **{"tpu.dtype": dtype_name})
    jcfg = JConfig(overrides=dict(cfg, **{"output.exporter_path": str(tmp_path / "j")}))
    pcfg = PConfig(overrides=dict(cfg, **{"output.exporter_path": str(tmp_path / "p")}))
    if cfg.get("moorings.use_moorings"):
        for c in (jcfg, pcfg):
            c._values["moorings.variables"] = list(MOORING_VARS)
    jsim, psim = JSimulator(jcfg), PSimulator(pcfg, device="cpu")
    psim.state = state_from_numpy(jax_to_numpy(jsim.state), device="cpu")
    return jsim, psim


def rel_err(ref, out):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape and out.dtype == ref.dtype, (out.shape, ref.shape, out.dtype, ref.dtype)
    assert np.isfinite(out).all()
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300))


def assert_tight(jsim, psim, tol=1e-9):
    ref, got = jax_to_numpy(jsim.state), state_to_numpy(psim.state)
    assert set(ref) == set(got)
    for k in ref:
        assert rel_err(ref[k], got[k]) <= tol, k
    if jsim.wim is not None:
        np.testing.assert_array_equal(psim.wim.ice["broken"].numpy(), np.asarray(jsim.wim.ice["broken"]))
        for k, v in jsim.wim.ice.items():
            assert rel_err(v, psim.wim.ice[k]) <= tol, k
        for k, v in jsim.wim_diag.items():
            pairk = k[:-1] + "x" if k.endswith("_y") else k  # hold a vector to its magnitude
            scale = max(np.abs(np.asarray(v)).max(), np.abs(np.asarray(jsim.wim_diag[pairk])).max(), 1e-300)
            assert np.abs(psim.wim_diag[k].numpy() - np.asarray(v)).max() <= tol * scale, k
        assert rel_err(jsim.wim.sdf, psim.wim.sdf) <= tol
        assert rel_err(jsim._wim_nfloes, psim._wim_nfloes) <= tol


def assert_tiered(jsim, psim):
    ref, got = jax_to_numpy(jsim.state), state_to_numpy(psim.state)
    for k in ref:
        assert np.isfinite(got[k]).all() and got[k].dtype == ref[k].dtype, k
    for k in ("conc", "thick", "conc_young", "conc_fsd", "sst"):
        off = np.abs(got[k] - ref[k]) > 1e-3 * np.abs(ref[k]).max()
        assert off.mean() <= 0.02, (k, off.mean())
    assert (psim.wim.ice["broken"].numpy() != np.asarray(jsim.wim.ice["broken"])).mean() <= 0.02
    speed = lambda s: np.hypot(s["vt_u"], s["vt_v"]).mean()  # noqa: E731
    np.testing.assert_allclose(speed(got), speed(ref), rtol=1e-3)
    np.testing.assert_allclose(got["damage"].mean(), ref["damage"].mean(), atol=1e-3)
    np.testing.assert_allclose(psim.wim_diag["hs"].numpy().mean(), np.asarray(jsim.wim_diag["hs"]).mean(), rtol=1e-3)


# ---------------------------------------------------------------------------
# the wave path, per step: WIM -> stress and breakup -> FSD -> dynamics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stepped64(tmp_path_factory):
    """The base configuration with moorings, 4 steps side by side in
    float64; kept for the restart and moorings tests."""
    tmp = tmp_path_factory.mktemp("waves64")
    with jax.enable_x64(True):  # left again before the fixture hands over: the flag is the process's
        jsim, psim = pair(tmp, "float64", **MOORINGS)
        init = jax_to_numpy(jsim.state)
        fired = []
        orig = psim._wim_exchange
        psim._wim_exchange = lambda f=None: (fired.append(psim.pcpt), orig(f))[1]
        for _ in range(4):
            jsim.step()
            psim.step()
    # the JAX run as it stands after the 4 steps (its arrays are immutable)
    j4 = SimpleNamespace(state=jsim.state, wim=SimpleNamespace(ice=dict(jsim.wim.ice), sdf=jsim.wim.sdf),
                         wim_diag=dict(jsim.wim_diag), _wim_nfloes=jsim._wim_nfloes)
    return SimpleNamespace(jsim=jsim, psim=psim, tmp=tmp, fired=fired, init=init, j4=j4)


def test_wave_coupled_run_matches_jax_float64(stepped64):
    s = stepped64
    with jax.enable_x64(True):
        assert s.fired == [0, 2] and s.psim.pcpt == 4
        assert_tight(s.jsim, s.psim)
    p = s.psim
    # the WIM fed the FSD breakup and the momentum forcing
    broken = p.wim.ice["broken"] > 0.5
    assert 5 < int(broken.sum()) < 0.7 * broken.numel()
    assert p.last_forcing.wlbk is not None and bool((p.last_forcing.wlbk[broken] < 500.0).all())
    assert bool((p.last_forcing.wlbk[~broken] == 500.0).all())
    # a breaking wavelength below 300 m is felt by the bins (centres up to 230 m)
    hit = broken & (p.last_forcing.wlbk < 300.0)
    assert int(hit.sum()) >= 2
    assert float(p.state.conc_fsd[:-1].sum(0)[hit].min()) > 1e-3  # area below the unbroken bin
    # (outside the broken zone only what the advection carried there)
    assert float(p.state.conc_fsd[:-1].sum(0)[~broken].max()) < 1e-2
    assert float(torch.hypot(p.last_forcing.tau_wi_u, p.last_forcing.tau_wi_v).max()) > 0.0
    assert float(p.state.damage[hit].min()) > 0.0  # fsd_damage_type=1
    torch.testing.assert_close(p.state.conc_fsd.sum(0), p.state.conc + p.state.conc_young, rtol=0, atol=1e-12)
    torch.testing.assert_close(p.state.conc_mech_fsd, p.state.conc_fsd, rtol=0, atol=0)


def test_moorings_carry_floe_size_and_wave_stress(stepped64):
    s = stepped64
    files = sorted(os.listdir(s.tmp / "p"))
    name = next(f for f in files if f.startswith("Moorings"))
    with netcdf_file(str(s.tmp / "j" / name), "r", mmap=False) as a, netcdf_file(str(s.tmp / "p" / name), "r", mmap=False) as b:
        assert set(b.variables) == set(a.variables) >= {"dmax", "dmean", "tauwix", "tauwiy", "sic"}
        for k in ("dmax", "dmean", "tauwix", "tauwiy", "sic", "damage"):
            ra, rb = np.array(a.variables[k][:]), np.array(b.variables[k][:])
            assert rb.shape == ra.shape and rb.shape[0] == 2, k
            fin = np.isfinite(ra)  # land is the fill value
            np.testing.assert_array_equal(np.isfinite(rb), fin, err_msg=k)
            np.testing.assert_allclose(rb[fin], ra[fin], rtol=1e-6, atol=1e-6 * np.abs(ra[fin]).max(), err_msg=k)
        tauwix, dmax = np.array(b.variables["tauwix"][:]), np.array(b.variables["dmax"][:])
        assert np.nanmax(np.abs(tauwix)) > 0 and len(np.unique(dmax[np.isfinite(dmax)])) > 2


def test_restarts_with_waves_cross_between_packages(stepped64):
    """After the 4 steps both packages write a restart (``__wim_sdf``,
    ``__wim_nfloes``, the bins). The port resumes from the JAX package's and
    the JAX package from the port's; both then take two steps beside the
    port's run that went on (the exchange of step 4 runs on the restored
    spectrum). Two steps, since from the seventh on a float64 ulp flips a
    BBM failure branch and the runs part, as on the momentum path."""
    s = stepped64
    resume = {"restart.start_from_restart": True, "restart.basename": "x", "restart.type": "continue"}
    with jax.enable_x64(True):
        jwrite_restart(s.jsim, name="x")
        pwrite_restart(s.psim, name="x")
        keys = lambda d: set(np.load(d / "restart" / "restart_x.npz").files)  # noqa: E731
        assert keys(s.tmp / "p") == keys(s.tmp / "j") >= {"__wim_sdf", "__wim_nfloes", "conc_fsd", "conc_mech_fsd"}
        # JAX -> port
        pcfg = PConfig(overrides=dict(s.psim.cfg.as_dict(), **resume, **{"restart.input_path": str(s.tmp / "j" / "restart")}))
        back = PSimulator(pcfg, device="cpu")
        assert back.pcpt == 4 and back.state.conc_fsd.shape == (6, 14, 24)
        np.testing.assert_array_equal(back.wim.sdf.numpy(), np.asarray(s.jsim.wim.sdf))
        np.testing.assert_array_equal(back._wim_nfloes.numpy(), np.asarray(s.jsim._wim_nfloes))
        # port -> JAX, on the simulator already built (no second compile),
        # its spectrum and floe numbers wiped first
        s.jsim.cfg = JConfig(overrides=dict(s.jsim.cfg.as_dict(), **resume, **{"restart.input_path": str(s.tmp / "p" / "restart")}))
        s.jsim.wim.sdf = s.jsim.wim.sdf * 0.0
        s.jsim._wim_nfloes = s.jsim._wim_nfloes * 0.0
        jread_restart(s.jsim)
        assert s.jsim.pcpt == 4
        np.testing.assert_array_equal(np.asarray(s.jsim.wim.sdf), s.psim.wim.sdf.numpy())
        np.testing.assert_array_equal(np.asarray(s.jsim._wim_nfloes), s.psim._wim_nfloes.numpy())
        for k, v in state_to_numpy(s.psim.state).items():
            np.testing.assert_array_equal(np.asarray(getattr(s.jsim.state, k)), v, err_msg=k)
        for _ in range(2):
            s.jsim.step()
            s.psim.step()
            back.step()
        assert s.jsim.pcpt == s.psim.pcpt == back.pcpt == 6
        assert_tight(s.jsim, back)
        assert_tight(s.jsim, s.psim)


def test_wave_coupled_run_matches_jax_float32_tiered(tmp_path):
    jsim, psim = pair(tmp_path, "float32")
    for _ in range(4):
        jsim.step()
        psim.step()
    assert_tiered(jsim, psim)
    assert float(psim.wim.ice["broken"].sum()) > 5


# ---------------------------------------------------------------------------
# chunked stepping, the WIM's own grid, the coupler
# ---------------------------------------------------------------------------

def test_chunked_run_matches_per_step_and_jax(tmp_path, stepped64):
    """``run`` with tpu.steps_per_call=2 (it divides couplingfreq=2: no
    clamp): the exchanges fire at the per-step schedule's steps, and the
    state is the port's own per-step run's, bitwise, and the JAX package's
    after its 4 steps (the fixture's run; its moorings change no field)."""
    def port(k):
        cfg = dict(BASE, **{"tpu.dtype": "float64", "tpu.steps_per_call": k, "output.exporter_path": str(tmp_path / f"p{k}")})
        sim = PSimulator(PConfig(overrides=cfg), device="cpu")
        sim.state = state_from_numpy(stepped64.init, device="cpu")
        return sim

    psim = port(2)
    fired = []
    orig = psim._wim_exchange
    psim._wim_exchange = lambda f=None: (fired.append(psim.pcpt), orig(f))[1]
    psim.run()
    assert psim._chunk_k == 2 and fired == [0, 2] and psim.pcpt == 4
    with jax.enable_x64(True):
        assert_tight(stepped64.j4, psim)
    per_step = port(1)
    per_step.run()
    for k, v in state_to_numpy(per_step.state).items():
        np.testing.assert_array_equal(state_to_numpy(psim.state)[k], v, err_msg=k)
    assert torch.equal(per_step.wim.sdf, psim.wim.sdf)


def test_wim_on_its_own_grid_matches_jax(tmp_path):
    """coupling-option=naive: the WIM on a 7 km grid of its own, regridded
    both ways each exchange; no FSD, so breakage raises the damage."""
    with jax.enable_x64(True):
        jsim, psim = pair(tmp_path, "float64", **{
            "nextwim.coupling-option": "naive", "wimgrid.dx": 7e3, "wave_coupling.num_fsd_bins": 0, "thermo.melt_type": 2})
        assert psim.wim.grid.shape == jsim.wim.grid.shape == (20, 35) and psim._wim_regrid is not None
        for _ in range(3):
            jsim.step()
            psim.step()
        assert_tight(jsim, psim)
        assert rel_err(jsim.diag["dmax"], psim.diag["dmax"]) <= 1e-9
    broken = psim._wim_regrid.to_model(psim.wim.ice["broken"]) > 0.5
    # nextwim.wim_damage_value, but for the cells that lost their ice since the exchange
    assert int(broken.sum()) > 5 and float((psim.state.damage[broken] > 0.9).double().mean()) > 0.9


def write_cpl_in(directory, ny, nx, rng):
    """A prescribed cpl_in.nc under ``directory``/coupler: wlbk broken (90-150
    m) on the western 14 columns, the wave stress random; its fields."""
    recv = {"wlbk": np.where(np.arange(nx)[None, :] < 14, 90.0 + 60.0 * rng.uniform(0, 1, (ny, nx)), 500.0).astype(np.float32),
            "tauwix": (0.02 * rng.standard_normal((ny, nx))).astype(np.float32),
            "tauwiy": (0.02 * rng.standard_normal((ny, nx))).astype(np.float32)}
    os.makedirs(directory / "coupler")
    with netcdf_file(str(directory / "coupler" / "cpl_in.nc"), "w", version=2) as nc:
        nc.createDimension("y", ny)
        nc.createDimension("x", nx)
        for k, v in recv.items():
            nc.createVariable(k, "f4", ("y", "x"))[:] = v
    return recv


def test_coupled_run_with_received_wlbk_matches_jax(tmp_path):
    """coupler.with_waves, no WIM: the prescribed cpl_in.nc carries wlbk and
    the wave stress; the put files are equal and the received wlbk breaks
    floes from the step after the first window on."""
    ny, nx = 14, 24
    for d in ("j", "p"):
        recv = write_cpl_in(tmp_path / d, ny, nx, np.random.default_rng(0))
    # per step (one JAX compile); the chunk's sums are test_torch_coupling's
    over = {"nextwim.use_wim": False, "coupler.with_waves": True, "coupler.timestep": 1200}
    with jax.enable_x64(True):
        jsim, psim = pair(tmp_path, "float64", **over)
        jsim.run()
        psim.run()
        assert psim.pcpt == jsim.pcpt == 4 and psim._chunk_k == 1
        assert_tight(jsim, psim)
    puts = sorted(f for f in os.listdir(tmp_path / "p" / "coupler") if f.startswith("cpl_out"))
    assert puts == sorted(f for f in os.listdir(tmp_path / "j" / "coupler") if f.startswith("cpl_out")) and len(puts) == 2
    for f in puts:
        with netcdf_file(str(tmp_path / "j" / "coupler" / f), "r", mmap=False) as a, \
                netcdf_file(str(tmp_path / "p" / "coupler" / f), "r", mmap=False) as b:
            assert set(a.variables) == set(b.variables)
            for k in a.variables:
                ra, rb = np.array(a.variables[k][:]), np.array(b.variables[k][:])
                np.testing.assert_allclose(rb, ra, rtol=1e-6, atol=1e-7 * max(np.abs(ra).max(), 1e-30), err_msg=f"{f}:{k}")
    f = psim.last_forcing
    np.testing.assert_array_equal(f.wlbk.numpy(), recv["wlbk"].astype(np.float64))
    assert tuple(f.tau_wi_u.shape) == (ny + 1, nx + 1)
    ice = (psim.state.conc + psim.state.conc_young) > 0.05
    hit = ice & (f.wlbk < 499.0)
    assert int(hit.sum()) > 10 and float(psim.state.conc_fsd[:-1].sum(0)[hit].min()) > 1e-3
    assert float(psim.state.conc_fsd[:-1].sum(0)[ice & ~hit].max()) < 1e-2  # what the advection carried there


def test_overlay_order_of_each_path_matches_jax(tmp_path):
    """The WIM and coupler.with_waves both on, a prescribed cpl_in.nc whose
    wlbk and wave stress differ from the WIM's. The JAX ``step`` overlays the
    WIM's fields after the received ones, its ``step_chunk`` before them:
    the port's per-step run matches the JAX per-step run, its chunked run
    (tpu.steps_per_call=2) the JAX chunked run, and the two paths part in
    wlbk once the first coupler window has closed."""
    runs = {}
    with jax.enable_x64(True):
        for k in (1, 2):
            d = tmp_path / f"k{k}"
            for side in ("j", "p"):
                recv = write_cpl_in(d / side, 14, 24, np.random.default_rng(0))
            # thermo off: the JAX chunk compiles in a third of the time
            jsim, psim = pair(d, "float64", **{"coupler.with_waves": True, "coupler.timestep": 1200,
                                               "tpu.steps_per_call": k, "thermo.use_thermo_forcing": False,
                                               "thermo.melt_type": 2, "wave_coupling.welding_type": "none"})
            jsim.run()
            psim.run()
            assert psim.pcpt == jsim.pcpt == 4 and psim._chunk_k == jsim._chunk_k == k
            assert_tight(jsim, psim)
            # (the JAX package keeps a received field in float32)
            assert rel_err(np.asarray(jsim.last_forcing.wlbk, np.float64), psim.last_forcing.wlbk) <= 1e-9
            runs[k] = psim
    per_step, chunked = runs[1].last_forcing, runs[2].last_forcing
    # per step the WIM's wlbk wins, in a chunk the received one
    torch.testing.assert_close(per_step.wlbk, runs[1]._wim_wlbk, rtol=0, atol=0)
    np.testing.assert_array_equal(chunked.wlbk.numpy(), recv["wlbk"].astype(np.float64))
    assert not torch.equal(per_step.wlbk, chunked.wlbk)


def test_wave_forcing_dataset_reaches_the_wim(tmp_path, monkeypatch):
    """wimsetup.wave-type=eraiw_1deg: the planes that the erai_waves_1deg
    reader gives are the ones ``Wim.set_wave_fields`` is handed."""
    from test_torch_datasets import _write_for

    data = tmp_path / "data"
    data.mkdir()
    for name in ("era5", "erai_waves_1deg"):
        _write_for(name, data)
    monkeypatch.setenv("NEXTSIM_DATA_DIR", str(data))
    over = dict(BASE, **{"wimsetup.wave-type": "eraiw_1deg", "setup.atmosphere-type": "era5",
                         "simul.time_init": "2015-10-16 00:00:00", "grid.preset": "arctic", "grid.nx": 32, "grid.ny": 32,
                         "output.exporter_path": str(tmp_path / "p")})
    sim = PSimulator(PConfig(overrides=over), device="cpu")
    reader = next(r for r in sim.forcing_provider.sources if r.spec.name == "erai_waves_1deg")
    seen = []
    orig = PWim.set_wave_fields
    monkeypatch.setattr(PWim, "set_wave_fields", lambda self, *a, **k: (seen.append(a), orig(self, *a, **k))[1])
    sim.step()
    assert len(seen) == 1
    want = reader.fields_at(sim.time_init + sim.dt / 86400.0)
    # the direction is interpolated through its unit components
    want["mwd"] = np.degrees(np.arctan2(want["_mwd_sin"], want["_mwd_cos"]))
    for got, name in zip(seen[0], ("swh", "mwp", "mwd")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name], np.float32), err_msg=name)
        assert got is getattr(sim.last_forcing, name) and float(got.std()) > 0.0
    assert float(sim.wim_diag["hs"].max()) > 0.1


# ---------------------------------------------------------------------------
# cadences
# ---------------------------------------------------------------------------

def test_wim_chunk_gate_never_denser_than_cadence(tmp_path):
    """tests/test_wim.py's case: direct step_chunk calls with k=4 against
    couplingfreq=10 exchange at steps 0, 12, 24."""
    over = dict(BASE, **{"setup.dynamics-type": "free_drift", "thermo.use_thermo_forcing": False, "thermo.melt_type": 2,
                         "wave_coupling.num_fsd_bins": 0, "nextwim.couplingfreq": 10, "wimsetup.nwavefreq": 2,
                         "wimsetup.nwavedirn": 4, "tpu.steps_per_call": 4, "output.exporter_path": str(tmp_path)})
    sim = PSimulator(PConfig(overrides=over), device="cpu")
    fired = []
    orig = sim._wim_exchange
    sim._wim_exchange = lambda f=None: (fired.append(sim.pcpt), orig(f))[1]
    for _ in range(7):  # 28 steps in chunks of 4
        sim.step_chunk()
    assert fired == [0, 12, 24]


def test_wim_due_anchors_on_absolute_grid():
    """tests/test_wim.py's step numbers, on the port's ``_wim_due``."""
    ns = SimpleNamespace(wim_couplingfreq=10, pcpt=0)
    assert [p for p in range(0, 31) if (setattr(ns, "pcpt", p) or PSimulator._wim_due(ns))] == [0, 10, 20, 30]
    ns2 = SimpleNamespace(wim_couplingfreq=10, pcpt=1073)
    assert [p for p in range(1073, 1101) if (setattr(ns2, "pcpt", p) or PSimulator._wim_due(ns2))] == [1080, 1090, 1100]


@pytest.mark.parametrize("over,expect", [
    ({"nextwim.couplingfreq": 6, "tpu.steps_per_call": 4}, 3),
    ({"nextwim.couplingfreq": 6, "tpu.steps_per_call": 4, "nextwim.use_wim": False, "coupler.with_waves": True,
      "coupler.timestep": 1200}, 2),
    ({"nextwim.couplingfreq": 6, "tpu.steps_per_call": 6, "coupler.with_waves": True, "coupler.timestep": 2400}, 2),
], ids=["wim", "coupler", "both"])
def test_run_clamps_the_chunk_to_the_wave_cadences(over, expect, tmp_path):
    jcfg = JConfig(overrides=dict(BASE, **over, **{"output.exporter_path": str(tmp_path / "j")}))
    sim = PSimulator(PConfig(overrides=dict(BASE, **over, **{"output.exporter_path": str(tmp_path / "p")})), device="cpu")
    assert sim._clamped_chunk(sim._chunk_k) == expect
    # the JAX package's clamp, from its own cadences: the gcd rule of its run()
    import math

    cad = []
    if jcfg["nextwim.use_wim"]:
        cad.append(jcfg["nextwim.couplingfreq"])
    if jcfg["coupler.with_waves"]:
        cad.append(round(jcfg["coupler.timestep"] / jcfg["simul.timestep"]))
    g = math.gcd(*cad) if len(cad) > 1 else cad[0]
    k = min(jcfg["tpu.steps_per_call"], g)
    while g % k:
        k -= 1
    assert k == expect


# ---------------------------------------------------------------------------
# the defaults: on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_no_helper_to_cpu():
    from nextsim_tpu_torch.coupling.exchange import Coupler
    from nextsim_tpu_torch.forcing import datasets, providers
    from nextsim_tpu_torch.model import init_state, nesting_source
    from nextsim_tpu_torch.wim.regrid import Regridder

    default = lambda fn: inspect.signature(fn).parameters["device"].default  # noqa: E731
    for entry in (PSimulator.__init__, PWim.__init__, state_from_numpy):
        assert default(entry) == "cuda", entry
    helpers = (init_state.init_state, providers.make_provider, providers.ConstantForcing.__init__,
               datasets.DatasetForcing.__init__, nesting_source.make_nesting_source,
               nesting_source.NestingSource.__init__, nesting_source.NestingNetCDFSource.__init__,
               pstate_mod.State.zeros, Coupler.__init__, Regridder.__init__)
    for fn in helpers:
        assert default(fn) is inspect.Parameter.empty, fn  # the caller names the device
    # and nowhere in the package is "cpu" a parameter's default
    import importlib
    import pkgutil

    import nextsim_tpu_torch

    for mod in pkgutil.walk_packages(nextsim_tpu_torch.__path__, "nextsim_tpu_torch."):
        if mod.name.endswith("__main__"):
            continue
        for _, obj in inspect.getmembers(importlib.import_module(mod.name)):
            fns = [obj] if inspect.isfunction(obj) else [m for _, m in inspect.getmembers(obj, inspect.isfunction)] \
                if inspect.isclass(obj) else []
            for fn in fns:
                if getattr(fn, "__module__", "").startswith("nextsim_tpu_torch"):
                    for name, prm in inspect.signature(fn).parameters.items():
                        assert not (name == "device" and prm.default == "cpu"), (mod.name, fn.__qualname__)
    assert dataclasses.is_dataclass(pstate_mod.State)
