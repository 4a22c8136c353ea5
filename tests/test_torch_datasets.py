"""The port's forcing datasets and bathymetry against the JAX package's, on
the CPU.

Synthetic NetCDF files with random planes (numpy, from a seed) go through
``nextsim_tpu.forcing.datasets`` and ``nextsim_tpu_torch.forcing.datasets``:

* ``REGISTRY`` is pinned spec by spec;
* the interpolator weights and outputs, the rotation angles, the time
  parsing and ``_DatasetReader.fields_at`` are **bitwise** equal, for every
  grid kind (regular cyclic lat/lon, polar stereo, curvilinear and
  grid-oriented vectors), ensemble-member selection, the ``inv`` and
  ``wave_dir_from`` transforms and static files: the ingest is the same
  host numpy in both packages;
* ``DatasetForcing`` tensors are **bitwise** equal to the JAX arrays in
  float32 and float64 (every plane is rounded to float32 before the cast in
  both), over the spin-up ramp, the forecast air-temperature correction,
  ``*_atrest`` oceans, ``cfsr_hi`` layering, ETOPO depth and the default
  ``asr`` atmosphere without files (the constant forcing);
* ETOPO depth, masks and the ``arctic_etopo`` grid are **bitwise** equal,
  and the port's synthetic ETOPO equals tools/make_synthetic_etopo.py's.

The writers here are shared with the other dataset tests of the port.
"""

import dataclasses
import datetime
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.forcing import bathymetry as jbathy
from nextsim_tpu.forcing import datasets as jds
from nextsim_tpu.grid.grid import Grid as JGrid
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch.forcing import bathymetry as pbathy
from nextsim_tpu_torch.forcing import datasets as pds
from nextsim_tpu_torch.forcing.providers import ConstantForcing, make_provider
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.grid.projection import PolarStereo
from nextsim_tpu_torch.tools import synthetic_etopo
from nextsim_tpu_torch.utils.dates import string_to_datenum

REPO = pathlib.Path(__file__).resolve().parent.parent
T0 = "2015-10-16 00:00:00"
EPOCH = datetime.datetime(1900, 1, 1)

# a pole-side box of the model grid, in both packages
BOX = dict(nx=12, ny=10, dx=50e3, x0=-300e3, y0=-1800e3)


def grids(**kw):
    kw = dict(BOX, **kw)
    return JGrid.square(**kw), PGrid.square(**kw)


# ---------------------------------------------------------------------------
# synthetic NetCDF writers (random planes from a seed)
# ---------------------------------------------------------------------------

def write_nc(path, dims, variables, version=2):
    """dims: {name: size}; variables: {name: (dims, array, attrs)}."""
    from scipy.io import netcdf_file

    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with netcdf_file(str(path), "w", version=version) as nc:
        for d, n in dims.items():
            nc.createDimension(d, n)
        for name, (vdims, arr, attrs) in variables.items():
            arr = np.asarray(arr)
            v = nc.createVariable(name, "f8" if arr.dtype == np.float64 else "f4", vdims)
            v[:] = arr
            for k, val in attrs.items():
                setattr(v, k, val)


def hours_since_1900(*stamps):
    return np.array([(datetime.datetime.fromisoformat(s) - EPOCH).total_seconds() / 3600.0
                     for s in stamps])


def write_regular(path, rng, var_names, times_h, lat_name="latitude", lon_name="longitude",
                  lats=None, lons=None, time_name="time", ranges=None, planes=None):
    """A regular lat/lon file with one random record per time (or the given
    ``planes`` {name: (time, lat, lon) array})."""
    lats = np.arange(40.0, 90.1, 2.0) if lats is None else lats
    lons = np.arange(-180.0, 180.0, 4.0) if lons is None else lons
    shape = (len(times_h), len(lats), len(lons))
    variables = {
        time_name: ((time_name,), np.asarray(times_h, np.float64),
                    {"units": b"hours since 1900-01-01 00:00:00"}),
        lat_name: ((lat_name,), lats.astype(np.float32), {}),
        lon_name: ((lon_name,), lons.astype(np.float32), {}),
    }
    for v in var_names:
        lo, hi = (ranges or {}).get(v, (-10.0, 10.0))
        arr = (planes or {}).get(v)
        variables[v] = ((time_name, lat_name, lon_name),
                        rng.uniform(lo, hi, shape).astype(np.float32) if arr is None else arr, {})
    write_nc(path, {time_name: len(times_h), lat_name: len(lats), lon_name: len(lons)}, variables)


def curvilinear_latlon(ny=14, nx=15, dx=90e3, lon0=0.0, x0=-1400e3, y0=-1600e3):
    """lat/lon of a polar-stereographic grid of another meridian than the
    model's: curvilinear in the model projection. The default one covers
    most of BOX, not all of it (outside queries take the nearest point)."""
    proj = PolarStereo(lat0=90.0, lat_ts=60.0, lon0=lon0)
    x = x0 + dx * np.arange(nx)
    y = y0 + dx * np.arange(ny)
    lat, lon = proj.inverse(*np.meshgrid(x, y))
    return np.asarray(lat), np.asarray(lon)


def write_curvilinear(path, rng, var_names, times_h=None, lat_name="latitude",
                      lon_name="longitude", member_dim=None, n_members=3, ranges=None,
                      latlon=None, time_units=b"hours since 1900-01-01 00:00:00"):
    """A curvilinear file with random records (static when ``times_h`` is
    None); ``member_dim`` adds an ensemble dimension after time."""
    lat2d, lon2d = curvilinear_latlon() if latlon is None else latlon
    ny, nx = lat2d.shape
    dims = {"y": ny, "x": nx}
    variables = {lat_name: (("y", "x"), lat2d, {}), lon_name: (("y", "x"), lon2d, {})}
    lead = ()
    if times_h is not None:
        dims["time"] = len(times_h)
        variables["time"] = (("time",), np.asarray(times_h, np.float64), {"units": time_units})
        lead = ("time",)
    if member_dim:
        dims[member_dim] = n_members
        lead = lead + (member_dim,)
    shape = tuple(dims[d] for d in lead) + (ny, nx)
    for v in var_names:
        lo, hi = (ranges or {}).get(v, (-1.0, 1.0))
        variables[v] = (lead + ("y", "x"), rng.uniform(lo, hi, shape).astype(np.float32), {})
    write_nc(path, dims, variables)


def write_polar_stereo(path, rng, var_names, times_h, proj):
    """A file on a polar-stereographic x/y grid of ``proj`` covering BOX."""
    lat_c, lon_c = JGrid.square(**BOX).cell_latlon()
    x, y = proj.forward(lat_c, lon_c)
    xs = np.linspace(np.min(x) - 80e3, np.max(x) + 80e3, 13)
    ys = np.linspace(np.min(y) - 80e3, np.max(y) + 80e3, 11)
    shape = (len(times_h), len(ys), len(xs))
    variables = {
        "time": (("time",), np.asarray(times_h, np.float64),
                 {"units": b"hours since 1900-01-01 00:00:00"}),
        "x": (("x",), xs, {}), "y": (("y",), ys, {}),
    }
    for v in var_names:
        variables[v] = (("time", "y", "x"), rng.uniform(-5.0, 5.0, shape).astype(np.float32), {})
    write_nc(path, {"time": len(times_h), "y": len(ys), "x": len(xs)}, variables)


# physically consistent ranges: a dew point below the air temperature, snow
# thinner than the ice (random but plausible planes keep the float32 physics
# away from the regimes where one rounding flips a branch)
ERA5_RANGES = {"u10": (-15.0, 15.0), "v10": (-15.0, 15.0), "t2m": (250.0, 272.0),
               "d2m": (0.5, 4.0), "msl": (98e3, 104e3), "msdwswrf": (0.0, 80.0),
               "msdwlwrf": (180.0, 320.0), "mtpr": (0.0, 3e-5), "msr": (0.0, 2e-5)}
TOPAZ_RANGES = {"uo": (-0.3, 0.3), "vo": (-0.3, 0.3), "zos": (-0.4, 0.4), "thetao": (-1.8, 4.0),
                "so": (30.0, 35.0), "mlotst": (10.0, 60.0), "siconc": (0.0, 1.0),
                "sithick": (0.5, 3.5), "sisnthick": (0.02, 0.3)}
ERA5_TIMES = ("2015-10-15 23:00:00", "2015-10-16 00:00:00", "2015-10-16 01:00:00",
              "2015-10-16 02:00:00", "2015-10-16 03:00:00")
TOPAZ_TIMES = ("2015-10-15 12:00:00", "2015-10-16 12:00:00", "2015-10-17 12:00:00")


def write_era5(d, seed=1):
    """ERA5's nine per-variable yearly files, hourly records around T0; the
    dew point is the air temperature less a random 0.5-4 K."""
    rng = np.random.default_rng(seed)
    t2m = rng.uniform(*ERA5_RANGES["t2m"], (len(ERA5_TIMES), 26, 90)).astype(np.float32)
    d2m = t2m - rng.uniform(*ERA5_RANGES["d2m"], t2m.shape).astype(np.float32)
    for v in ERA5_RANGES:
        write_regular(os.path.join(d, f"ERA5_{v}_y2015.nc"), rng, [v], hours_since_1900(*ERA5_TIMES),
                      ranges=ERA5_RANGES, planes={"t2m": t2m, "d2m": d2m})


def write_topaz(d, seed=2, fname="2015/topaz_rean_201510.nc", latlon=None, names=None):
    """A TOPAZ4 reanalysis monthly file: ocean and ice fields, daily records."""
    write_curvilinear(os.path.join(d, fname), np.random.default_rng(seed),
                      list(names or TOPAZ_RANGES), hours_since_1900(*TOPAZ_TIMES),
                      ranges=TOPAZ_RANGES, latlon=latlon)


def write_etopo(d, seed=3, fname="ETOPO_Arctic_2arcmin.nc"):
    """An ETOPO-style static file: random elevation over a basin, with land."""
    rng = np.random.default_rng(seed)
    lats = np.arange(55.0, 90.01, 0.5)
    lons = np.arange(-180.0, 180.0, 1.0)
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    z = rng.uniform(-4000.0, -5.0, lat2.shape)
    z[(lon2 > 20.0) & (lon2 < 120.0) & (lat2 < 80.0)] = 500.0  # a continent
    z[(lon2 > -60.0) & (lon2 < -50.0) & (lat2 > 74.0) & (lat2 < 76.0)] = 300.0  # an island
    z[(lon2 > 60.0) & (lon2 < 70.0) & (lat2 > 65.0) & (lat2 < 68.0)] = -50.0  # a lake
    write_nc(os.path.join(d, fname), {"lat": len(lats), "lon": len(lons)}, {
        "lat": (("lat",), lats.astype(np.float32), {}),
        "lon": (("lon",), lons.astype(np.float32), {}),
        "z": (("lat", "lon"), z.astype(np.float32), {}),
    })


def assert_fields_equal(got, ref, what=""):
    assert sorted(got) == sorted(ref), (what, sorted(got), sorted(ref))
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# registry, interpolators, time handling
# ---------------------------------------------------------------------------

def test_registry_is_pinned_spec_by_spec():
    assert list(pds.REGISTRY) == list(jds.REGISTRY)
    for name, jspec in jds.REGISTRY.items():
        assert dataclasses.asdict(pds.REGISTRY[name]) == dataclasses.asdict(jspec), name


def _interp_pair(kind, jg, pg, node):
    if kind == "regular_cyclic":
        lats, lons = np.arange(40.0, 90.1, 2.0)[::-1], np.arange(-180.0, 180.0, 4.0)
        args = (lats, lons)
    elif kind == "regular":
        lats, lons = np.arange(55.0, 90.01, 0.5), np.arange(-180.0, 180.0, 1.0)
        args = (lats, lons)
    jq = jg.node_latlon() if node else jg.cell_latlon()
    pq = pg.node_latlon() if node else pg.cell_latlon()
    if kind.startswith("regular"):
        cyc = kind == "regular_cyclic"
        return (jds._RegularLatLonInterp(*args, *jq, cyc), pds._RegularLatLonInterp(*args, *pq, cyc),
                (len(args[0]), len(args[1])))
    if kind == "polar_stereo":
        from nextsim_tpu.grid.projection import NPS_ASR as J_ASR
        from nextsim_tpu_torch.grid.projection import NPS_ASR as P_ASR

        xs, ys = np.linspace(-1.5e6, 1.5e6, 40), np.linspace(-3.5e6, 0.5e6, 50)
        return (jds._PolarStereoInterp(xs, ys, J_ASR, *jq), pds._PolarStereoInterp(xs, ys, P_ASR, *pq),
                (len(ys), len(xs)))
    lat2d, lon2d = curvilinear_latlon()
    return (jds._CurvilinearInterp(lat2d, lon2d, jg.projection, *jq),
            pds._CurvilinearInterp(lat2d, lon2d, pg.projection, *pq), lat2d.shape)


@pytest.mark.parametrize("node", [False, True])
@pytest.mark.parametrize("kind", ["regular_cyclic", "regular", "polar_stereo", "curvilinear"])
def test_interpolators_are_bitwise(kind, node):
    jg, pg = grids()
    ji, pi, src_shape = _interp_pair(kind, jg, pg, node)
    names = (("inside", "weights", "verts", "nearest") if kind == "curvilinear"
             else ("i0", "i1", "j0", "j1", "wx", "wy"))
    for n in names + ("out_shape",):
        np.testing.assert_array_equal(getattr(pi, n), getattr(ji, n), err_msg=n)
    if kind == "curvilinear":
        assert 0 < pi.inside.sum() < pi.inside.size  # both branches are taken
    field = np.random.default_rng(4).uniform(-3.0, 3.0, src_shape)
    np.testing.assert_array_equal(pi(field), ji(field))


def test_shared_source_mesh_gives_the_weights_of_separate_builds():
    """One Delaunay per reader, shared by its cell and node interpolators,
    gives the weights of two separate builds."""
    _, pg = grids()
    lat2d, lon2d = curvilinear_latlon()
    mesh = pds._source_mesh(lat2d, lon2d, pg.projection)
    for q in (pg.cell_latlon(), pg.node_latlon()):
        a = pds._CurvilinearInterp(lat2d, lon2d, pg.projection, *q, mesh)
        b = pds._CurvilinearInterp(lat2d, lon2d, pg.projection, *q)
        for n in ("inside", "weights", "verts", "nearest"):
            np.testing.assert_array_equal(getattr(a, n), getattr(b, n))


def test_rotation_time_units_and_file_dates_match():
    lon = np.random.default_rng(5).uniform(-180.0, 180.0, (7, 9))
    for a, b in zip(pds._rotation_angles(-45.0, lon), jds._rotation_angles(-45.0, lon)):
        np.testing.assert_array_equal(a, b)
    for u in ("hours since 1950-01-01 00:00:00", "seconds since 1970-01-01",
              "days since 1900-01-01 00:00:00.0", "hour since 2015-10-16T06:00:00Z"):
        assert pds._parse_time_units(u) == jds._parse_time_units(u)
    with pytest.raises(ValueError, match="cannot parse"):
        pds._parse_time_units("fortnights")
    t = string_to_datenum("2015-10-16 06:30:00")
    for freq in ("static", "yearly", "monthly", "daily"):
        assert pds._file_dates(freq, t) == jds._file_dates(freq, t)


# ---------------------------------------------------------------------------
# _DatasetReader.fields_at, every grid kind
# ---------------------------------------------------------------------------

def _readers(name, d, jg, pg, member=1):
    return (jds._DatasetReader(jds.REGISTRY[name], jg, str(d), member=member),
            pds._DatasetReader(pds.REGISTRY[name], pg, str(d), member=member))


READER_TIMES = ("2015-10-16 00:00:00", "2015-10-16 00:20:00", "2015-10-16 01:59:59",
                "2015-10-16 03:00:00", "2015-10-17 06:00:00")


def _write_for(name, d):
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    ref_h = hours_since_1900(*ERA5_TIMES)
    if name == "era5":
        write_era5(d)
    elif name == "cfsr":
        write_regular(os.path.join(d, "cfsr.6h.201510.nc"), rng,
                      [v.file_var for v in jds.REGISTRY["cfsr"].variables], ref_h)
    elif name == "cfsr_hi":
        write_regular(os.path.join(d, "cfsr_h.sh.201510.nc"), rng, ["U_GRD_L103", "V_GRD_L103"],
                      ref_h, lat_name="lat", lon_name="lon", time_name="time0")
    elif name == "asr":
        from nextsim_tpu_torch.grid.projection import NPS_ASR

        write_polar_stereo(os.path.join(d, "asr30km.comb.2D.201510.nc"), rng,
                           [v.file_var for v in jds.REGISTRY["asr"].variables], ref_h, NPS_ASR)
    elif name == "generic_ps":
        from nextsim_tpu_torch.grid.projection import NPS_NEXTSIM

        write_polar_stereo(os.path.join(d, "generic_ps_atm_20151016.nc"), rng,
                           [v.file_var for v in jds.REGISTRY["generic_ps"].variables], ref_h,
                           NPS_NEXTSIM)
    elif name == "topaz4r":
        write_topaz(d)
    elif name == "ecmwf_nrt_arome":
        write_curvilinear(os.path.join(d, "ecmwf_nrt_arome_blended_20151016.nc"), rng,
                          [v.file_var for v in jds.REGISTRY[name].variables],
                          (ref_h - hours_since_1900("1970-01-01T00:00:00")[0]) * 3600.0,
                          time_units=b"seconds since 1970-01-01 00:00:00")
    elif name == "ecmwf_nrt_arome_ensemble":
        write_curvilinear(os.path.join(d, "ecmwf_nrt_arome_blended_ensemble_20151016.nc"), rng,
                          [v.file_var for v in jds.REGISTRY[name].variables],
                          (ref_h - hours_since_1900("1970-01-01T00:00:00")[0]) * 3600.0,
                          member_dim="ensemble_member",
                          time_units=b"seconds since 1970-01-01 00:00:00")
    elif name == "ocean_currents":
        write_curvilinear(os.path.join(d, "current_2015.nc"), rng, ["U", "V", "SSH"], ref_h)
    elif name == "erai_waves_1deg":
        write_regular(os.path.join(d, "erai_waves_1deg_2015.nc"), rng, ["swh", "mwp", "mwd"], ref_h,
                      ranges={"swh": (0.0, 5.0), "mwp": (2.0, 15.0), "mwd": (0.0, 360.0)})
    elif name == "ww3a":
        for day in ("20151016", "20151017"):
            write_curvilinear(os.path.join(d, f"SWARP_WW3_ARCTIC-12K_{day}.nc"), rng, ["hs", "fp", "dir"],
                              ref_h + (24.0 if day == "20151017" else 0.0),
                              ranges={"hs": (0.0, 5.0), "fp": (-0.2, 0.4), "dir": (0.0, 360.0)})
    elif name == "etopo":
        write_etopo(d)
    elif name == "ice_icesat":
        write_curvilinear(os.path.join(d, "icesat_icethk_ON06_filled.nc"), rng, ["icethk"])
    elif name == "dist2coast":
        write_nc(os.path.join(d, "dist2coast_4deg.nc"), {"lat": 26, "lon": 90}, {
            "lat": (("lat",), np.arange(40.0, 90.1, 2.0).astype(np.float32), {}),
            "lon": (("lon",), np.arange(-180.0, 180.0, 4.0).astype(np.float32), {}),
            "dist": (("lat", "lon"), rng.uniform(0.0, 500.0, (26, 90)).astype(np.float32), {}),
        })
    else:
        raise KeyError(name)


# regular cyclic, regular non-cyclic (static), polar stereo, curvilinear,
# grid-oriented vectors, member selection, inv + wave_dir_from
READER_CASES = ["era5", "cfsr", "cfsr_hi", "asr", "generic_ps", "topaz4r", "ecmwf_nrt_arome",
                "ecmwf_nrt_arome_ensemble", "ocean_currents", "erai_waves_1deg", "ww3a", "etopo",
                "ice_icesat", "dist2coast"]


@pytest.mark.parametrize("name", READER_CASES)
def test_reader_fields_are_bitwise(name, tmp_path):
    _write_for(name, tmp_path)
    jg, pg = grids()
    members = (1, 3) if name.endswith("_ensemble") else (1,)
    for member in members:
        jr, pr = _readers(name, tmp_path, jg, pg, member=member)
        seen = set()
        for stamp in READER_TIMES:
            t = string_to_datenum(stamp)
            ref = jr.fields_at(t)
            got = pr.fields_at(t)
            assert ref, (name, stamp)
            assert_fields_equal(got, ref, f"{name} member {member} at {stamp}")
            seen |= set(ref)
        spec = jds.REGISTRY[name]
        assert seen >= {v.target for v in spec.variables if v.transform is None}, seen
        if name.endswith("_ensemble"):
            # the member's own record (air temperature differs per member)
            assert float(np.abs(ref["tair"]).max()) > 0.0
    if name == "ww3a":
        assert "_mwd_cos" in ref and "mwp" in ref


def test_reader_member_selection_differs_by_member(tmp_path):
    _write_for("ecmwf_nrt_arome_ensemble", tmp_path)
    _, pg = grids()
    t = string_to_datenum("2015-10-16 00:30:00")
    a = pds._DatasetReader(pds.REGISTRY["ecmwf_nrt_arome_ensemble"], pg, str(tmp_path), member=1)
    b = pds._DatasetReader(pds.REGISTRY["ecmwf_nrt_arome_ensemble"], pg, str(tmp_path), member=2)
    assert not np.array_equal(a.fields_at(t)["tair"], b.fields_at(t)["tair"])


def test_reader_prefetch_and_plane_cache(tmp_path):
    """The background prefetch loads the entry after the bracketing pair
    into the plane cache, on the host: numpy planes, no tensor. With
    per-variable files (ERA5) every record is indexed once per file, so that
    entry is the same record from another variable's file, as in the JAX
    package."""
    _write_for("era5", tmp_path)
    _, pg = grids()
    r = pds._DatasetReader(pds.REGISTRY["era5"], pg, str(tmp_path))
    r.fields_at(string_to_datenum("2015-10-16 00:30:00"))
    r._prefetch_thread.join()
    assert len(r._time_index) == 9 * len(ERA5_TIMES)
    assert len(r._plane_cache) == 3, list(r._plane_cache)
    for fields in r._plane_cache.values():
        assert all(isinstance(v, np.ndarray) for v in fields.values())


# ---------------------------------------------------------------------------
# DatasetForcing: tensors bitwise equal to the JAX arrays
# ---------------------------------------------------------------------------

def _forcing_cfg(d, **over):
    base = {"setup.atmosphere-type": "era5", "setup.ocean-type": "topaz4_rean",
            "setup.bathymetry-type": "etopo", "simul.time_init": T0,
            "setup.atmospheric_forcing_input_path": str(d),
            "setup.oceanic_forcing_input_path": str(d), "simul.spinup_duration": 0.1}
    base.update(over)
    return base


FORCING_CASES = {
    "era5_topaz_etopo": {},
    "tair_correction": {"forecast.air_temperature_correction": 2.5},
    "atrest": {"setup.ocean-type": "topaz4_rean_atrest", "ideal_simul.constant_ocean_u": 0.05},
    "altimeter": {"setup.ocean-type": "topaz4_rean-altimeter"},
    "cfsr_hi": {"setup.atmosphere-type": "cfsr_hi", "setup.ocean-type": "constant"},
    "waves": {"wimsetup.wave-type": "eraiw_1deg", "setup.ocean-type": "constant"},
    "asr_no_files": {"setup.atmosphere-type": "asr", "setup.ocean-type": "constant",
                     "setup.bathymetry-type": "constant"},
}


def _forcing_pair(case, d, dtype_name, monkeypatch):
    monkeypatch.setenv("NEXTSIM_DATA_DIR", str(d))
    for name in ("era5", "topaz4r", "etopo", "cfsr", "cfsr_hi", "ocean_currents", "erai_waves_1deg"):
        _write_for(name, d)
    over = _forcing_cfg(d, **FORCING_CASES[case])
    if case == "asr_no_files":
        over["setup.atmospheric_forcing_input_path"] = str(d / "empty")
    jg, pg = grids()
    jdt = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    pdt = {"float32": torch.float32, "float64": torch.float64}[dtype_name]
    jf = jds.DatasetForcing(JConfig(overrides=over), jg, jdt)
    pf = make_provider(PConfig(overrides=over), pg, pdt)
    assert isinstance(pf, pds.DatasetForcing)
    return jf, pf


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(FORCING_CASES))
def test_dataset_forcing_is_bitwise(case, dtype_name, tmp_path, monkeypatch):
    t_init = string_to_datenum(T0)
    with jax.enable_x64(dtype_name == "float64"):
        jf, pf = _forcing_pair(case, tmp_path, dtype_name, monkeypatch)
        # inside the spin-up ramp, at and between records, after it
        for dt_h in (0.0, 0.5, 1.25, 3.0):
            t = t_init + dt_h / 24.0
            ref, got = jf(t, t_init), pf(t, t_init)
            for f in dataclasses.fields(ref):
                r, g = getattr(ref, f.name), getattr(got, f.name)
                if r is None:
                    assert g is None, f.name
                    continue
                assert g.dtype == {"float32": torch.float32, "float64": torch.float64}[dtype_name], f.name
                assert np.asarray(r).dtype == g.numpy().dtype, f.name
                np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f"{case} {f.name} {dt_h} h")
    if case == "asr_no_files":
        cf = ConstantForcing(PConfig(overrides=_forcing_cfg(tmp_path)), grids()[1])
        assert torch.equal(got.wind_u, cf(t, t_init).wind_u)
    else:
        assert float(got.wind_u.abs().max()) > 0.0


def test_static_plane_is_uploaded_once(tmp_path, monkeypatch):
    """The ETOPO depth plane is the same tensor every call (the device cache
    is keyed on the host plane's identity)."""
    jf, pf = _forcing_pair("era5_topaz_etopo", tmp_path, "float32", monkeypatch)
    t0 = string_to_datenum(T0)
    a, b = pf(t0 + 0.01, t0), pf(t0 + 0.02, t0)
    assert a.depth is b.depth
    assert a.wind_u is not b.wind_u


# ---------------------------------------------------------------------------
# bathymetry and the arctic_etopo grid
# ---------------------------------------------------------------------------

def test_load_depth_and_mask_are_bitwise(tmp_path):
    write_etopo(tmp_path)
    jg, pg = grids(nx=40, ny=40, dx=100e3, x0=-2000e3, y0=-2000e3)
    d_j = jbathy.load_depth(jg, data_dir=str(tmp_path))
    d_p = pbathy.load_depth(pg, data_dir=str(tmp_path))
    np.testing.assert_array_equal(d_p, d_j)
    for keep in (True, False):
        np.testing.assert_array_equal(pbathy.mask_from_depth(d_p, 10.0, keep),
                                      jbathy.mask_from_depth(d_j, 10.0, keep))
    assert pbathy.etopo_path(None, str(tmp_path)) == jbathy.etopo_path(None, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="bathymetry"):
        pbathy.load_depth(pg, data_dir=str(tmp_path / "none"))


@pytest.mark.parametrize("lat_min", [0.0, 70.0])
def test_arctic_etopo_grid_is_bitwise(lat_min, tmp_path):
    write_etopo(tmp_path)
    kw = dict(dx=150e3, nx=40, ny=40, data_dir=str(tmp_path), lat_min=lat_min)
    jg, jd = jbathy.arctic_etopo_grid(**kw)
    pg, pd = pbathy.arctic_etopo_grid(**kw)
    np.testing.assert_array_equal(pd, jd)
    for n in ("mask", "open_mask", "node_mask", "node_dirichlet"):
        np.testing.assert_array_equal(getattr(pg, n), getattr(jg, n), err_msg=n)
    assert (pg.nx, pg.ny, pg.dx, pg.x0, pg.y0) == (jg.nx, jg.ny, jg.dx, jg.x0, jg.y0)
    assert 0.2 < pg.mask.mean() < 0.95


def test_synthetic_etopo_equals_the_original_tool(tmp_path):
    """The port's stand-in (numpy even-odd test) equals
    tools/make_synthetic_etopo.py's (matplotlib) bitwise, file included."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import make_synthetic_etopo as original
    finally:
        sys.path.remove(str(REPO / "tools"))
    for a, b in zip(synthetic_etopo.build(), original.build()):
        np.testing.assert_array_equal(a, b)
    lats = np.arange(60.0, 85.0, 0.7)
    lons = np.arange(-180.0, 180.0, 1.3)
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    np.testing.assert_array_equal(synthetic_etopo.land_mask(lon2, lat2), original.land_mask(lon2, lat2))
    p = synthetic_etopo.write(str(tmp_path / "ETOPO_Arctic_2arcmin.nc"))
    with pds.NCFile(p) as nc:
        assert nc.variables["z"].shape == (161, 720)
