"""The benchmark's input files: ERA5, TOPAZ4 and the ETOPO stand-in, at the
products' own grid sizes, written once into a cache inside the checkout and
read by the program and the reference alike.

The writers are those of the repository's ``chip_smoke.py`` with a span:
ERA5 hourly records from the hour before ``first_day`` to ``days`` days
later, TOPAZ4 daily records at 12:00 from the day before to the day after.
The fields are analytic (moving wind patterns, a travelling pressure wave,
hydrography by latitude) and do not depend on the seed. A set is written
into ``<cache>/<key>/`` and marked complete by ``complete.json`` (its bytes
and seconds) once every file is there, so a run that was cut off leaves no
half set behind that a later run would read.

A dataset that is none of these is written by a module of its own,
``inputs/<name>.py``, whose ``write(dir, first_day, days)`` writes its files
into ``dir``: a later cell adds its dataset as a new file.
"""

from __future__ import annotations

import datetime
import importlib
import json
import shutil
import time
from pathlib import Path

import numpy as np

#: ERA5's own grid: 0.25 degree, 90-40N x 360 degrees, north to south
ERA5_SHAPE = (201, 1440)
ERA5_VARS = ("u10", "v10", "t2m", "d2m", "msl", "msdwswrf", "msdwlwrf", "mtpr", "msr")
#: a TOPAZ4-sized curvilinear grid: 800 x 880 points at 12.5 km
TOPAZ_SHAPE = (800, 880)
TOPAZ_VARS = ("uo", "vo", "zos", "thetao", "so", "mlotst", "siconc", "sithick", "sisnthick")
ETOPO_FILE = "ETOPO_Arctic_2arcmin.nc"


def hours_since_1900(stamp: datetime.datetime) -> float:
    return (stamp - datetime.datetime(1900, 1, 1)).total_seconds() / 3600.0


def write_nc(path: Path, dims: dict, variables: dict) -> None:
    """A NetCDF3 (64-bit offset) file: variables {name: (dims, array, units)}."""
    from scipy.io import netcdf_file

    path.parent.mkdir(parents=True, exist_ok=True)
    with netcdf_file(str(path), "w", version=2) as nc:
        for d, n in dims.items():
            nc.createDimension(d, n)
        for name, (vdims, arr, units) in variables.items():
            v = nc.createVariable(name, "f8" if arr.dtype == np.float64 else "f4", vdims)
            v[:] = arr
            if units:
                v.units = units.encode()


def era5_fields(lam, phi, lat2, h: float) -> dict:
    """The nine ERA5 fields ``h`` hours after the first day's 00:00."""
    speed = 10.0 + 5.0 * np.sin(3.0 * lam + 0.25 * h) * np.cos(2.0 * phi)
    theta = lam + 0.1 * h + 0.5 * np.sin(2.0 * phi)
    t2m = 273.15 - 25.0 * (lat2 - 40.0) / 50.0 + 3.0 * np.sin(lam + 0.05 * h)
    mtpr = 1e-5 * (1.0 + np.sin(2.0 * lam + 0.2 * h))
    return {"u10": speed * np.cos(theta), "v10": speed * np.sin(theta), "t2m": t2m,
            "d2m": t2m - 2.0 - np.cos(lam),
            "msl": 101300.0 + 1500.0 * np.cos(2.0 * lam - 0.1 * h) * np.cos(phi),
            "msdwswrf": 40.0 * np.clip((70.0 - lat2) / 30.0, 0.0, 1.0),
            "msdwlwrf": 180.0 + 80.0 * (90.0 - lat2) / 50.0, "mtpr": mtpr, "msr": 0.7 * mtpr}


def write_era5(d: Path, first_day: datetime.datetime, days: int) -> None:
    """ERA5 on its own grid, nine per-variable yearly files
    (``ERA5_<var>_y<year>.nc``), hourly records from ``first_day`` - 1 h to
    ``first_day`` + ``days`` days, one record computed at a time."""
    lats = np.linspace(90.0, 40.0, ERA5_SHAPE[0])
    lons = np.arange(ERA5_SHAPE[1]) * 0.25
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    lam, phi = np.deg2rad(lon2), np.deg2rad(lat2)
    rel = np.arange(-1, 24 * days + 1, dtype=np.float64)
    hours = hours_since_1900(first_day) + rel
    planes = {v: np.empty((rel.size,) + ERA5_SHAPE, np.float32) for v in ERA5_VARS}
    for i, h in enumerate(rel):
        for v, a in era5_fields(lam, phi, lat2, h).items():
            planes[v][i] = a
    for v in ERA5_VARS:
        write_nc(d / f"ERA5_{v}_y{first_day.year}.nc",
                 {"time": rel.size, "latitude": ERA5_SHAPE[0], "longitude": ERA5_SHAPE[1]}, {
                     "time": (("time",), hours, "hours since 1900-01-01 00:00:00.0"),
                     "latitude": (("latitude",), lats.astype(np.float32), None),
                     "longitude": (("longitude",), lons.astype(np.float32), None),
                     v: (("time", "latitude", "longitude"), planes[v], None),
                 })


def write_topaz(d: Path, first_day: datetime.datetime, days: int) -> None:
    """A TOPAZ4 reanalysis monthly file on a TOPAZ4-sized curvilinear grid
    (12.5 km polar-stereographic on another meridian than the model's),
    daily records at 12:00 from the day before ``first_day`` to the day
    after the span: currents of ~0.1 m/s, an SSH of +-0.3 m, hydrography,
    and ice north of 66N (conc 0.98 from 74N, 0.5-3 m thick)."""
    from benchmark.reference.plain.grid.projection import PolarStereo

    proj = PolarStereo(lat0=90.0, lat_ts=60.0, lon0=-135.0)
    step = 12.5e3 * 880 / TOPAZ_SHAPE[1]  # 12.5 km at TOPAZ4's own size
    x = -5500e3 + step * np.arange(TOPAZ_SHAPE[1])
    y = -5000e3 + step * np.arange(TOPAZ_SHAPE[0])
    lat2, lon2 = (np.asarray(a) for a in proj.inverse(*np.meshgrid(x, y)))
    lam, phi = np.deg2rad(lon2), np.deg2rad(lat2)
    north = np.clip((lat2 - 66.0) / 20.0, 0.0, 1.0)
    ks = np.arange(days + 2)
    noon = first_day - datetime.timedelta(days=1) + datetime.timedelta(hours=12)
    hours = np.array([hours_since_1900(noon + datetime.timedelta(days=int(k))) for k in ks])
    planes = {v: np.empty((ks.size,) + TOPAZ_SHAPE, np.float32) for v in TOPAZ_VARS}
    for k in ks:
        rec = {
            "uo": 0.1 * np.sin(lam + 0.2 * k) * np.cos(phi), "vo": 0.1 * np.cos(2.0 * lam - 0.2 * k),
            "zos": 0.3 * np.cos(lam + 0.1 * k) * np.cos(2.0 * phi),
            "thetao": -1.8 + 5.0 * np.clip((72.0 - lat2) / 12.0, 0.0, 1.0),
            "so": 34.5 - 3.0 * north, "mlotst": 25.0 + 15.0 * np.sin(lam) ** 2,
            "siconc": 0.98 * np.clip((lat2 - 66.0) / 8.0, 0.0, 1.0),
            "sithick": 0.5 + 2.5 * north + 0.05 * k, "sisnthick": 0.05 + 0.2 * north,
        }
        for v in TOPAZ_VARS:
            planes[v][k] = rec[v]
    if noon.month != (noon + datetime.timedelta(days=int(ks[-1]))).month:
        raise ValueError("write_topaz: the span crosses a month, and TOPAZ4 files are monthly")
    write_nc(d / f"{noon.year}" / f"topaz_rean_{noon:%Y%m}.nc", {"time": ks.size, "y": TOPAZ_SHAPE[0],
                                                                  "x": TOPAZ_SHAPE[1]}, {
        "time": (("time",), hours, "hours since 1900-01-01 00:00:00"),
        "latitude": (("y", "x"), lat2.astype(np.float32), None),
        "longitude": (("y", "x"), lon2.astype(np.float32), None),
        **{v: (("time", "y", "x"), planes[v], None) for v in TOPAZ_VARS},
    })


def write_etopo(d: Path) -> None:
    from benchmark.inputs import etopo

    d.mkdir(parents=True, exist_ok=True)
    etopo.write(str(d / ETOPO_FILE))


WRITERS = {"era5": write_era5, "topaz4_rean": write_topaz}


def ensure(cache: Path, datasets, first_day: datetime.datetime, days: int) -> dict:
    """The directory holding ``datasets`` (``"etopo"``, names of ``WRITERS``
    and of ``inputs/<name>.py`` modules) over ``days`` days from
    ``first_day``: written unless a complete set is there. Returns {"dir",
    "bytes_written", "seconds"}, the bytes and seconds 0 where the set was
    there already."""
    datasets = sorted(datasets)
    key = "_".join(datasets) + f"_{first_day:%Y%m%d}_{days}d_topaz{TOPAZ_SHAPE[0]}x{TOPAZ_SHAPE[1]}"
    d = cache / key
    done = d / "complete.json"
    if done.exists():
        return {"dir": d, "bytes_written": 0, "seconds": 0.0}
    t0 = time.perf_counter()
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    for name in datasets:
        if name == "etopo":
            write_etopo(d)
        elif name in WRITERS:
            WRITERS[name](d, first_day, days)
        else:
            importlib.import_module(f"{__name__}.{name}").write(d, first_day, days)
    n_bytes = sum(p.stat().st_size for p in d.rglob("*") if p.is_file())
    seconds = time.perf_counter() - t0
    done.write_text(json.dumps({"bytes": n_bytes, "seconds": seconds}))
    return {"dir": d, "bytes_written": n_bytes, "seconds": seconds}
