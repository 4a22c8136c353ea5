"""The port's dataset ice initialisation and assimilation against the JAX
package's, on the CPU.

Every product a scheme reads is written as a synthetic NetCDF file with
random planes (numpy, from a seed); the same files go through
``nextsim_tpu.model`` and ``nextsim_tpu_torch.model``.

* ``init_state`` for each of the 20 dataset ice-type names (and the slab
  ocean that dataset oceans leave at ``State.zeros``' values): every field
  **bitwise** equal in float32, and in float64 for the TOPAZ family, whose
  blend is torch (``jnp`` in the JAX package) rather than host numpy.
* Every assimilation routine (``assimilate_conc``,
  ``assimilate_topaz_amsr2_osisaf``, ``assimilate_topaz_amsr2_osisaf_nic``
  daily and weekly, with and without young ice, ``assimilate_ice``'s
  dispatch and ``assimilate_slab_ocean``) on a random state: **bitwise** in
  float32 and float64. ``conc_bins_nic`` and ``warren_snow`` are equal.

Bitwise is the stated tolerance throughout: the host blends are the same
float64 numpy, and the torch blends round each operation like ``jnp``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.core.state import State as JState
from nextsim_tpu.model import init_ice_datasets as jiid
from nextsim_tpu.model import init_state as jinit
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import state_from_numpy, state_to_numpy
from nextsim_tpu_torch.model import init_ice_datasets as piid
from nextsim_tpu_torch.model import init_state as pinit
from nextsim_tpu_torch.utils.dates import string_to_datenum
from test_torch_datasets import (
    TOPAZ_RANGES,
    grids,
    write_curvilinear,
    write_nc,
    write_regular,
    write_topaz,
)
from test_torch_momentum import jax_to_numpy

T0 = "2015-10-16 00:00:00"
DAYS = ("20151015", "20151016", "20151017")


def _days_since_1900(day: str) -> float:
    return string_to_datenum(f"{day[:4]}-{day[4:6]}-{day[6:]} 12:00:00")


def write_ice_products(d, seed=11, latlon=None):
    """Every ice product the schemes read, around T0 (random planes), on the
    curvilinear grid ``latlon`` (default: test_torch_datasets' one)."""
    rng = np.random.default_rng(seed)
    pct = (0.0, 100.0)
    write_topaz(d, seed=seed, latlon=latlon)
    for day in DAYS:
        t = np.array([_days_since_1900(day)]) * 24.0  # one record at 12:00, in hours
        cur = lambda fname, names, ranges=None, **kw: write_curvilinear(  # noqa: E731
            os.path.join(d, fname.format(day=day)), rng, names, t, ranges=ranges or {},
            latlon=latlon, **kw)
        cur("topaz_nrt_{day}.nc", list(TOPAZ_RANGES), TOPAZ_RANGES)
        cur("ice_conc_nh_polstere-100_multi_{day}1200.nc", ["ice_conc"], {"ice_conc": pct},
            lat_name="lat", lon_name="lon")
        cur("ice_type_nh_polstere-100_multi_{day}1200.nc", ["ice_type"], {"ice_type": (0.5, 4.5)},
            lat_name="lat", lon_name="lon")
        cur("Arc_{day}_res3.125_pyres.nc", ["sea_ice_concentration"], {"sea_ice_concentration": pct})
        cur("asi-n6250-{day}-v5i.nc", ["sea_ice_concentration"], {"sea_ice_concentration": pct})
        cur("NIC_{day}_res3.125_pyres.nc", ["sea_ice_concentration"], {"sea_ice_concentration": (0.0, 110.0)})
        cur("NIC_weekly_{day}_res3.125_pyres.nc", ["sea_ice_concentration"],
            {"sea_ice_concentration": (0.0, 110.0)})
        cur("SMOS_Icethickness_v3.1_north_{day}.nc", ["sea_ice_thickness"], {"sea_ice_thickness": (-0.1, 1.0)})
        cur("cs2_smos_ice_thickness_{day}.nc", ["analysis_sea_ice_thickness", "sea_ice_concentration"],
            {"analysis_sea_ice_thickness": (-0.1, 4.0), "sea_ice_concentration": pct},
            lat_name="lat", lon_name="lon")
        write_regular(os.path.join(d, f"GLORYS12V1_{day}.nc"), rng,
                      ["uo", "vo", "zos", "thetao", "so", "mlotst", "siconc", "sithick"], t,
                      ranges=TOPAZ_RANGES)
    monthly = np.array([_days_since_1900(day) for day in DAYS]) * 24.0
    write_curvilinear(os.path.join(d, "PIOMAS_2015.nc"), rng, ["area", "heff", "snow"], monthly,
                      ranges={"area": (-0.1, 1.1), "heff": (-0.2, 4.0), "snow": (-0.1, 0.5)})
    write_curvilinear(os.path.join(d, "CICE_201510.nc"), rng, ["aice", "hi", "hs"], monthly,
                      ranges={"aice": (-0.1, 1.1), "hi": (-0.2, 4.0), "hs": (-0.1, 0.5)},
                      lat_name="lat", lon_name="lon")
    write_curvilinear(os.path.join(d, "NEMO_icemod.nc"), rng, ["frld", "hicif", "hsnif"],
                      ranges={"frld": (0.0, 1.0), "hicif": (0.0, 4.0), "hsnif": (0.0, 0.5)},
                      lat_name="nav_lat", lon_name="nav_lon")
    write_curvilinear(os.path.join(d, "icesat_icethk_ON06_filled.nc"), rng, ["icethk"],
                      ranges={"icethk": (0.0, 500.0)})
    write_nc(os.path.join(d, "dist2coast_4deg.nc"), {"lat": 26, "lon": 90}, {
        "lat": (("lat",), np.arange(40.0, 90.1, 2.0).astype(np.float32), {}),
        "lon": (("lon",), np.arange(-180.0, 180.0, 4.0).astype(np.float32), {}),
        "dist": (("lat", "lon"), rng.uniform(0.0, 60.0, (26, 90)).astype(np.float32), {}),
    })


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    d = tmp_path_factory.mktemp("ice_products")
    write_ice_products(str(d))
    return d


# every dataset name of the JAX package's initIce dispatch
ICE_TYPES = [
    "topaz4_rean", "topaz4", "topaz", "topaz4_nrt", "topaz5_nrt", "glorys12",
    "topaz4_nrt-amsr2", "topaz4_nrt-amsr2-osisaf", "topaz4_nrt-amsr2-osisaf-nic",
    "topaz4_nrt-amsr2-osisaf-nic_weekly", "cs2-smos", "cs2-smos-amsr2", "amsr2",
    "amsr2-cst_thick", "amsre", "piomas", "smos", "nemo", "cice", "topaz4_rean-osisaf-icesat",
]


def _cfg(d, ice_type, **over):
    return dict({"setup.ice-type": ice_type, "setup.oceanic_forcing_input_path": str(d),
                 "simul.time_init": T0, "setup.ocean-type": "topaz4_rean",
                 "setup.atmosphere-type": "constant", "thermo.use_thermo_forcing": True}, **over)


def _init_pair(d, over, dtype_name="float32"):
    jg, pg = grids()
    jdt = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    pdt = {"float32": torch.float32, "float64": torch.float64}[dtype_name]
    j = jinit.init_state(JConfig(overrides=over), jg, dtype=jdt)
    p = pinit.init_state(PConfig(overrides=over), pg, dtype=pdt,
                         random_number=np.asarray(j.random_number))
    return jax_to_numpy(j), state_to_numpy(p)


def assert_states_equal(got, ref, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for f in ref:
        assert got[f].dtype == ref[f].dtype, (what, f)
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f"{what}: {f}")


def test_the_dispatch_covers_twenty_dataset_names():
    assert len(set(ICE_TYPES)) == 20


@pytest.mark.parametrize("ice_type", ICE_TYPES)
def test_init_state_is_bitwise(ice_type, products):
    ref, got = _init_pair(products, _cfg(products, ice_type))
    assert_states_equal(got, ref, ice_type)
    assert got["conc"].max() > 0.0, ice_type  # the product reached the ice
    # a dataset ocean leaves State.zeros' slab values (sst=-1.8, sss=32)
    assert (got["sst"] == np.float32(-1.8)).all() and (got["sss"] == 32.0).all()


@pytest.mark.parametrize("ice_type", ["topaz4_rean", "topaz4_nrt", "glorys12"])
def test_topaz_family_is_bitwise_in_float64(ice_type, products):
    with jax.enable_x64(True):
        ref, got = _init_pair(products, _cfg(products, ice_type, **{"tpu.dtype": "float64"}), "float64")
    assert got["conc"].dtype == np.float64
    assert_states_equal(got, ref, ice_type)


def test_topaz_snow_from_warren_without_snow_field(products, tmp_path):
    """glorys12 has no snow: the Warren climatology times conc."""
    ref, got = _init_pair(products, _cfg(products, "glorys12"))
    assert got["snow_thick"].max() > 0.0
    np.testing.assert_array_equal(got["snow_thick"], ref["snow_thick"])


def test_missing_product_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="no data found"):
        pinit.init_state(PConfig(overrides=_cfg(tmp_path, "topaz4_rean")), grids()[1])
    with pytest.raises(NotImplementedError, match="unknown ice init scheme"):
        pinit.init_state(PConfig(overrides=_cfg(tmp_path, "arbitrary")), grids()[1])


def test_warren_and_nic_bins_match():
    _, pg = grids()
    for t in (36526.0 + 15, 36526.0 + 212, string_to_datenum(T0)):
        np.testing.assert_array_equal(piid.warren_snow(pg, t), jiid.warren_snow(grids()[0], t))
    ci = np.random.default_rng(0).uniform(-0.1, 1.2, 500)
    for weekly in (False, True):
        for a, b in zip(piid.conc_bins_nic(ci, weekly), jiid.conc_bins_nic(ci, weekly)):
            np.testing.assert_array_equal(a, b)
    c, h = np.full(7, 0.3), np.linspace(-0.1, 0.5, 7)
    np.testing.assert_array_equal(piid._young_h_clamp(c, h, 0.05, 0.5), jiid._young_h_clamp(c, h, 0.05, 0.5))


# ---------------------------------------------------------------------------
# assimilation
# ---------------------------------------------------------------------------

def random_state_pair(dtype_name="float32", seed=3):
    """A random ice state in both packages (same planes)."""
    jg, _ = grids()
    rng = np.random.default_rng(seed)
    dt = np.float32 if dtype_name == "float32" else np.float64
    m = jg.mask.astype(dt)
    planes = {
        "conc": rng.uniform(0.0, 1.0, jg.shape), "thick": rng.uniform(0.0, 3.0, jg.shape),
        "snow_thick": rng.uniform(0.0, 0.3, jg.shape), "ridge_ratio": rng.uniform(0.0, 0.5, jg.shape),
        "damage": rng.uniform(0.0, 0.9, jg.shape), "conc_young": rng.uniform(0.0, 0.2, jg.shape),
        "h_young": rng.uniform(0.0, 0.05, jg.shape), "conc_upd": rng.uniform(-0.1, 0.1, jg.shape),
        "sst": rng.uniform(-1.8, 3.0, jg.shape), "sss": rng.uniform(28.0, 35.0, jg.shape),
    }
    planes = {k: (v * m).astype(dt) if k not in ("sst", "sss") else v.astype(dt) for k, v in planes.items()}
    planes["conc"][2, 3] = 0.005  # below the 0.01 threshold
    planes["conc"][4, 4] = 0.0
    jdt = jnp.float32 if dtype_name == "float32" else jnp.float64
    j = JState.zeros(jg, dtype=jdt).replace(**{k: jnp.asarray(v) for k, v in planes.items()})
    p = state_from_numpy(jax_to_numpy(j))
    return j, p, m


ASSIM_CASES = {
    "osisaf_amsr2_young": ("topaz4_nrt-amsr2-osisaf", 4),
    "osisaf_amsr2": ("topaz4_nrt-amsr2-osisaf", 0),
    "nic_young": ("topaz4_nrt-amsr2-osisaf-nic", 4),
    "nic": ("topaz4_nrt-amsr2-osisaf-nic", 0),
    "nic_weekly_young": ("topaz4_nrt-amsr2-osisaf-nic_weekly", 4),
    "nic_weekly": ("topaz4_nrt-amsr2-osisaf-nic_weekly", 0),
}


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(ASSIM_CASES))
def test_assimilate_ice_is_bitwise(case, dtype_name, products):
    ice_type, newice = ASSIM_CASES[case]
    over = _cfg(products, ice_type, **{"thermo.newice_type": newice})
    t0 = string_to_datenum(T0)
    with jax.enable_x64(dtype_name == "float64"):
        j, p, m = random_state_pair(dtype_name)
        jg, pg = grids()
        ref = jiid.assimilate_ice(JConfig(overrides=over), jg, j, m, t0)
        got = piid.assimilate_ice(PConfig(overrides=over), pg, p, torch.as_tensor(m), t0)
        ref = jax_to_numpy(ref)
    got = state_to_numpy(got)
    assert_states_equal(got, ref, case)
    assert not np.array_equal(got["conc"], state_to_numpy(p)["conc"])  # the blend changed conc


def test_assimilate_ice_rejects_other_types(products):
    j, p, m = random_state_pair()
    with pytest.raises(ValueError, match="invalid choice"):
        piid.assimilate_ice(PConfig(overrides=_cfg(products, "topaz4_rean")), grids()[1], p,
                            torch.as_tensor(m), string_to_datenum(T0))


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_assimilate_conc_is_bitwise(dtype_name):
    with jax.enable_x64(dtype_name == "float64"):
        j, p, m = random_state_pair(dtype_name, seed=5)
        obs = np.random.default_rng(6).uniform(-0.1, 1.1, m.shape)
        ref = jax_to_numpy(jiid.assimilate_conc(j, obs, jnp.asarray(m), min_h=0.07))
    got = state_to_numpy(piid.assimilate_conc(p, obs, torch.as_tensor(m), min_h=0.07))
    assert_states_equal(got, ref, "assimilate_conc")


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("ocean", ["constant", "topaz4_rean"])
def test_assimilate_slab_ocean_is_bitwise(ocean, dtype_name):
    mu = 0.055
    with jax.enable_x64(dtype_name == "float64"):
        j, p, m = random_state_pair(dtype_name, seed=7)
        rng = np.random.default_rng(8)
        temp = rng.uniform(-2.5, 4.0, m.shape).astype(m.dtype)
        salt = rng.uniform(2.0, 36.0, m.shape).astype(m.dtype)
        cfg = {"setup.ocean-type": ocean}
        ref = jax_to_numpy(jiid.assimilate_slab_ocean(JConfig(overrides=cfg), j, jnp.asarray(temp),
                                                      jnp.asarray(salt), lambda s: -mu * s))
    got = state_to_numpy(piid.assimilate_slab_ocean(PConfig(overrides=cfg), p, torch.as_tensor(temp),
                                                    torch.as_tensor(salt), lambda s: -mu * s))
    assert_states_equal(got, ref, ocean)
    with pytest.raises(ValueError, match="invalid ocean data assimilation"):
        piid.assimilate_slab_ocean(PConfig(overrides={"setup.ocean-type": "coupled"}), p, None, None, None)
