"""Data-driven ice initialisation schemes + assimilation (the counterpart
of nextsim_tpu/model/init_ice_datasets.py).

The reference dispatches 25 IceType schemes (reference: initIce,
model/finiteelement.cpp:11396-11515; enums.hpp:42-69), all variations of:
read concentration/thickness/snow (and young-ice / obs products) from NetCDF
through ExternalData, blend, and enforce consistency. Here the same schemes
are built from small pure functions over fields the dataset layer delivers:

* ``topaz`` family (topazIce, fe.cpp:11753-11798): model reanalysis fields,
  TOPAZ's tiny-value flooring, absolute->effective thickness.
* ``glorys12`` (glorys12Ice fe.cpp:13376): same pattern, GLORYS variables.
* obs blends (amsr2/osisaf/cs2_smos/smos/nic...): model background blended
  with observed concentration; thin-ice products reshape thin ice.
* ``warren_climatology`` (fe.cpp:13427-13565): Warren et al. (1999) snow
  depth fit — analytic, implemented exactly here.

Schemes read through the forcing dataset registry; products whose files
aren't present raise with the missing filename (same failure the reference
gives from NetCDF).

Assimilation (reference: assimilateIce fe.cpp:11634-11662,
assimilate_topazForecastAmsr2OsisafIce fe.cpp:12124-12404): replace
concentration with the observed analysis, track the applied update in
``conc_upd`` (consumed by thermo's compensating heat flux), adjust thickness
proportionally, and re-run checkConsistency.

Each blend keeps the JAX package's precision and order: the ones written
with ``jnp`` there are torch in the state's dtype here (`topaz_like_ice`,
`assimilate_conc`, `assimilate_slab_ocean`); the ones written in float64
numpy there are float64 numpy here, cast to the state's dtype at the end.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.plain.core.state import host_array
from benchmark.reference.plain.utils import dates

# Warren et al. (1999) snow-depth fit coefficients, cm
# (reference: warrenClimatology, fe.cpp:13431-13515)
WARREN_COEFFS = np.array(
    [
        [28.01, 0.1270, -1.1833, -0.1164, -0.0051, 0.0243],
        [30.28, 0.1056, -0.5908, -0.0263, -0.0049, 0.0044],
        [33.89, 0.5486, -0.1996, 0.0280, 0.0216, -0.0176],
        [36.80, 0.4046, -0.4005, 0.0256, 0.0024, -0.0641],
        [36.93, 0.0214, -1.1795, -0.1076, -0.0244, -0.0142],
        [36.59, 0.7021, -1.4819, -0.1195, -0.0009, -0.0603],
        [11.02, 0.3008, -1.2591, -0.0811, -0.0043, -0.0959],
        [4.64, 0.3100, -0.6350, -0.0655, 0.0059, -0.0005],
        [15.81, 0.2119, -1.0292, -0.0868, -0.0177, -0.0723],
        [22.66, 0.3594, -1.3483, -0.1063, 0.0051, -0.0577],
        [25.57, 0.1496, -1.4643, -0.1409, -0.0079, -0.0258],
        [26.67, -0.1876, -1.4229, -0.1413, -0.0316, -0.0029],
    ]
)


def _host(x) -> np.ndarray:
    """A tensor (or array) as host numpy (``np.asarray`` of a jax array)."""
    if isinstance(x, torch.Tensor):
        return host_array(x)
    return np.asarray(x)


def _to(arr, like: torch.Tensor) -> torch.Tensor:
    """``arr`` (host array or tensor) as a tensor of ``like``'s dtype on its
    device (``jnp.asarray(arr, dtype)``)."""
    return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)


def warren_snow(grid, time_init: float) -> np.ndarray:
    """Warren et al. (1999) climatological snow depth [m] at cell centers
    (reference: warrenClimatology, fe.cpp:13427-13565, including its
    half-month linear time interpolation)."""
    import calendar

    d = dates.datenum_to_datetime(time_init)
    month = d.month
    day = d.day
    eomday = calendar.monthrange(d.year, d.month)[1]
    if day < eomday / 2.0:
        month2 = 12 if month == 1 else month - 1
        dt = eomday / 2.0 + day
    else:
        month2 = 1 if month == 12 else month + 1
        dt = eomday / 2.0 + eomday - day

    lat, lon = grid.cell_latlon()
    x = (90.0 - lat) * np.cos(np.deg2rad(lon))
    y = (90.0 - lat) * np.sin(np.deg2rad(lon))

    def fit(m):
        c = WARREN_COEFFS[m - 1]
        return np.maximum(
            0.0, c[0] + c[1] * x + c[2] * y + c[3] * x * y + c[4] * x * x + c[5] * y * y
        )

    return (1e-2 * dt / eomday * fit(month) + 1e-2 * (eomday - dt) / eomday * fit(month2)).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# dataset-backed schemes
# ---------------------------------------------------------------------------

#: ice products (reference: dataset.cpp ice_* descriptors; TOPAZ ice fields
#: ride in the same reanalysis/forecast files as the ocean fields)
ICE_DATASETS = {
    "topaz": dict(dataset="topaz4r", conc="siconc", thick="sithick", snow="sisnthick"),
    "topaz_nrt": dict(dataset="topaz4nrt", conc="siconc", thick="sithick", snow="sisnthick"),
    "glorys12": dict(dataset="glorys12", conc="siconc", thick="sithick", snow=None),
}


def _read_ice_fields(cfg, grid, scheme: str, time_init: float) -> Dict[str, np.ndarray]:
    import dataclasses as _dc
    import os

    from benchmark.reference.plain.forcing.datasets import REGISTRY, DataVar, _DatasetReader

    meta = ICE_DATASETS[scheme]
    base = REGISTRY[meta["dataset"]]
    variables = []
    for role in ("conc", "thick", "snow"):
        fv = meta.get(role)
        if fv:
            variables.append(DataVar(fv, role))
    spec = _dc.replace(base, name=f"ice_{scheme}", variables=tuple(variables), vectors=(), nodal_targets=())
    dirname = cfg["setup.oceanic_forcing_input_path"] or os.environ.get("NEXTSIM_DATA_DIR", ".")
    reader = _DatasetReader(spec, grid, dirname)
    fields = reader.fields_at(time_init)
    if not fields:
        raise FileNotFoundError(
            f"ice init scheme {scheme!r}: no data found under {dirname!r} "
            f"matching {spec.filename_mask!r}"
        )
    return fields


def topaz_like_ice(cfg, grid, state, mask, scheme: str, time_init: float):
    """(reference: topazIce, fe.cpp:11753-11798): floor TOPAZ's tiny values,
    convert absolute to effective thickness, zero mutually-empty fields."""
    fields = _read_ice_fields(cfg, grid, scheme, time_init)
    conc = torch.clamp(_to(fields["conc"], state.conc), max=1.0)
    conc = torch.where(conc > 1e-14, conc, 0.0)
    thick_abs = _to(fields.get("thick", np.zeros(grid.shape)), state.conc)
    thick = torch.where(thick_abs > 1e-14, thick_abs * conc, 0.0)
    if fields.get("snow") is not None:
        snow_abs = _to(fields["snow"], state.conc)
        snow = torch.where(snow_abs > 1e-14, snow_abs * conc, 0.0)
    else:
        snow = torch.as_tensor(warren_snow(grid, time_init), device=conc.device) * conc

    empty = (conc <= 0.0) | (thick <= 0.0)
    conc = torch.where(empty, 0.0, conc) * mask
    thick = torch.where(empty, 0.0, thick) * mask
    snow = torch.where(empty, 0.0, snow) * mask
    return state.replace(
        conc=conc, thick=thick, snow_thick=snow,
        damage=torch.zeros_like(conc), ridge_ratio=torch.zeros_like(conc),
    )


# ---------------------------------------------------------------------------
# assimilation
# ---------------------------------------------------------------------------


def assimilate_conc(state, obs_conc, mask, min_h: float = 0.05):
    """Concentration assimilation (simplified form of the reference's
    assimilate_topazForecastAmsr2OsisafIce, fe.cpp:12124-12404): replace
    conc with the observed analysis, scale volume proportionally for
    reductions, give new ice min_h thickness, and record the applied update
    in conc_upd (consumed by thermo.use_assim_flux, fe.cpp:5433-5447)."""
    obs = torch.clamp(_to(obs_conc, state.conc), 0.0, 1.0) * mask
    old_conc = state.conc
    upd = obs - old_conc

    # reductions scale the volume; additions get min_h-thick new ice
    ratio = obs / torch.clamp(old_conc, min=1e-12)
    thick = torch.where(
        upd < 0.0, state.thick * ratio,
        state.thick + torch.clamp(upd, min=0.0) * min_h,
    )
    snow = torch.where(upd < 0.0, state.snow_thick * ratio, state.snow_thick)
    return state.replace(
        conc=obs,
        thick=torch.clamp(thick, min=0.0),
        snow_thick=torch.clamp(snow, min=0.0),
        conc_upd=state.conc_upd + upd,
    )


def _read_obs(cfg, grid, dataset_name: str, t: float) -> Dict[str, np.ndarray]:
    """Read one obs ice product through the dataset registry."""
    import os

    from benchmark.reference.plain.forcing.datasets import REGISTRY, _DatasetReader

    dirname = cfg["setup.oceanic_forcing_input_path"] or os.environ.get(
        "NEXTSIM_DATA_DIR", "."
    )
    reader = _DatasetReader(REGISTRY[dataset_name], grid, dirname)
    return reader.fields_at(t)


def topaz_amsr2_osisaf_ice(cfg, grid, state, mask, time_init: float, scheme: str = "topaz_nrt"):
    """TOPAZ forecast background blended with OSISAF conc/type and AMSR2
    conc (reference: topazForecastAmsr2OsisafIce, fe.cpp:12404-12600):

    * conc: OSISAF where TOPAZ has ice, lowered to AMSR2 where AMSR2 < OSISAF
    * thickness: TOPAZ absolute thickness scaled by the OSISAF ice-type
      factor (FYI x1, MYI x1.5, mixed x1.25) and converted to effective
    * ridge_ratio from the ice-type (0 / 0.3 / 0.9 / 0.6)
    """
    bg = _read_ice_fields(cfg, grid, scheme, time_init)
    # obs are read half a day back, as the reference does (fe.cpp:12409-12412)
    t_obs = time_init - 0.5
    osisaf = _read_obs(cfg, grid, "ice_osisaf", t_obs)
    osisaf_type = _read_obs(cfg, grid, "ice_osisaf_type", t_obs)
    amsr2 = _read_obs(cfg, grid, "ice_amsr2", t_obs)

    hi = np.where(bg["thick"] > 1e-14, bg["thick"], 0.0)  # absolute
    hs = np.where(bg.get("snow", np.zeros(grid.shape)) > 1e-14, bg.get("snow", 0.0), 0.0)
    conc = np.minimum(1.0, bg["conc"])
    conc = np.where(conc > 1e-14, conc, 0.0)
    if "obs_conc" in osisaf:
        conc = np.where(conc > 0.0, osisaf["obs_conc"], conc)
    if "obs_conc" in amsr2:
        conc = np.where(amsr2["obs_conc"] < conc, amsr2["obs_conc"], conc)

    ice_type = osisaf_type.get("obs_type", np.full(grid.shape, 2.0))
    ratio_fyi, ratio_myi = 0.3, 0.9
    ratio_mixed = 0.5 * (ratio_fyi + ratio_myi)
    tf_fyi, tf_myi = 1.0, 1.5
    tf_mixed = 0.5 * (tf_fyi + tf_myi)
    ridge = np.select(
        [ice_type < 1.5, ice_type < 2.5, ice_type < 3.5],
        [0.0, ratio_fyi, ratio_myi], default=ratio_mixed,
    )
    thickfac = np.select(
        [ice_type < 1.5, ice_type < 2.5, ice_type < 3.5],
        [tf_fyi, tf_fyi, tf_myi], default=tf_mixed,
    )
    has_ice = (hi > 0.0) & (conc > 0.2)
    hi = np.where(has_ice, hi * thickfac, 0.0)
    ridge = np.where(has_ice, ridge, 0.0)

    gone = (conc < 0.01) | (hi < phys_hmin())
    conc = np.where(gone, 0.0, conc)
    hi = np.where(gone, 0.0, hi)
    hs = np.where(gone, 0.0, hs)
    ridge = np.where(gone, 0.0, ridge)

    m = _host(mask)
    return state.replace(
        conc=_to(conc * m, state.conc),
        thick=_to(hi * conc * m, state.conc),  # absolute -> effective
        snow_thick=_to(hs * conc * m, state.conc),
        ridge_ratio=_to(ridge * m, state.conc),
        damage=torch.zeros_like(state.conc),
    )


def cs2_smos_ice(cfg, grid, state, mask, time_init: float):
    """CS2-SMOS merged thickness analysis + its concentration (reference:
    cs2SmosIce, fe.cpp:13100-13270): conc and absolute thickness from the
    product, snow from the Warren climatology."""
    obs = _read_obs(cfg, grid, "ice_cs2_smos", time_init)
    conc = np.clip(obs.get("obs_conc", np.zeros(grid.shape)), 0.0, 1.0)
    hi = np.maximum(obs.get("obs_thick", np.zeros(grid.shape)), 0.0)
    gone = (conc < 0.01) | (hi < phys_hmin())
    conc = np.where(gone, 0.0, conc)
    hi = np.where(gone, 0.0, hi)
    snow = warren_snow(grid, time_init) * conc
    m = _host(mask)
    return state.replace(
        conc=_to(conc * m, state.conc),
        thick=_to(hi * conc * m, state.conc),
        snow_thick=_to(snow * m, state.conc),
        damage=torch.zeros_like(state.conc),
        ridge_ratio=torch.zeros_like(state.conc),
    )


def obs_conc_ice(cfg, grid, state, mask, time_init: float, product: str,
                 const_thick: Optional[float] = None):
    """Concentration-only products (AMSR2/AMSRE/NIC): conc from the product,
    thickness constant or from ideal_simul.init_thickness (reference:
    AMSR2_CSTTHICK etc.)."""
    obs = _read_obs(cfg, grid, product, time_init)
    conc = np.clip(obs.get("obs_conc", np.zeros(grid.shape)), 0.0, 1.0)
    h = const_thick if const_thick is not None else cfg["ideal_simul.init_thickness"]
    hi = np.where(conc > 0.01, h, 0.0)
    snow = warren_snow(grid, time_init) * conc
    m = _host(mask)
    return state.replace(
        conc=_to(conc * m, state.conc),
        thick=_to(hi * conc * m, state.conc),
        snow_thick=_to(snow * m, state.conc),
        damage=torch.zeros_like(state.conc),
        ridge_ratio=torch.zeros_like(state.conc),
    )


def piomas_ice(cfg, grid, state, mask, time_init: float):
    """PIOMAS reanalysis conc/thickness/snow (reference: piomasIce)."""
    obs = _read_obs(cfg, grid, "ice_piomas", time_init)
    conc = np.clip(obs.get("obs_conc", np.zeros(grid.shape)), 0.0, 1.0)
    vol = np.maximum(obs.get("obs_thick", np.zeros(grid.shape)), 0.0)  # effective
    snow = np.maximum(obs.get("obs_snow", np.zeros(grid.shape)), 0.0)
    gone = conc < 0.01
    conc = np.where(gone, 0.0, conc)
    vol = np.where(gone, 0.0, vol)
    snow = np.where(gone, 0.0, snow)
    m = _host(mask)
    return state.replace(
        conc=_to(conc * m, state.conc),
        thick=_to(vol * m, state.conc),
        snow_thick=_to(snow * m, state.conc),
        damage=torch.zeros_like(state.conc),
        ridge_ratio=torch.zeros_like(state.conc),
    )


def phys_hmin() -> float:
    from benchmark.reference.plain.core import constants as phys

    return phys.hmin


def smos_ice(cfg, grid, state, mask, time_init: float):
    """SMOS thin-ice init (reference: smosIce, fe.cpp:13326-13376): conc and
    snow from the TOPAZ background, thickness directly from the SMOS
    product."""
    bg = _read_ice_fields(cfg, grid, "topaz", time_init)
    obs = _read_obs(cfg, grid, "ice_smos", time_init)
    conc = np.minimum(1.0, bg["conc"])
    conc = np.where(conc > 1e-14, conc, 0.0)
    hi = np.maximum(obs.get("obs_thick", np.zeros(grid.shape)), 0.0)
    snow = np.where(bg.get("snow", np.zeros(grid.shape)) > 1e-14, bg.get("snow", 0.0), 0.0)
    empty = (conc <= 0.0) | (hi <= 0.0)
    conc = np.where(empty, 0.0, conc)
    hi = np.where(empty, 0.0, hi)
    snow = np.where(empty, 0.0, snow)
    m = _host(mask)
    return state.replace(
        conc=_to(conc * m, state.conc),
        thick=_to(hi * m, state.conc),
        snow_thick=_to(snow * m, state.conc),
        damage=torch.zeros_like(state.conc),
        ridge_ratio=torch.zeros_like(state.conc),
    )


def model_output_ice(cfg, grid, state, mask, time_init: float, product: str):
    """NEMO / CICE model-output ice init (reference: nemoIce fe.cpp:12792,
    ciceIce fe.cpp:12843): conc/effective thickness/snow straight from the
    model file."""
    obs = _read_obs(cfg, grid, product, time_init)
    conc = np.clip(obs.get("obs_conc", np.zeros(grid.shape)), 0.0, 1.0)
    vol = np.maximum(obs.get("obs_thick", np.zeros(grid.shape)), 0.0)
    snow = np.maximum(obs.get("obs_snow", np.zeros(grid.shape)), 0.0)
    empty = (conc <= 0.0) | (vol <= 0.0)
    conc = np.where(empty, 0.0, conc)
    vol = np.where(empty, 0.0, vol)
    snow = np.where(empty, 0.0, snow)
    m = _host(mask)
    return state.replace(
        conc=_to(conc * m, state.conc),
        thick=_to(vol * m, state.conc),
        snow_thick=_to(snow * m, state.conc),
        damage=torch.zeros_like(state.conc),
        ridge_ratio=torch.zeros_like(state.conc),
    )


def topaz_osisaf_icesat_ice(cfg, grid, state, mask, time_init: float):
    """TOPAZ reanalysis + OSISAF conc/type + ICESat MYI thickness + AMSR-E
    young ice (reference: topazIceOsisafIcesat, fe.cpp:11798-11925):
    MYI cells take max(icesat, topaz) absolute thickness; ridge_ratio is the
    type ratio *scaled by conc* (unlike the AMSR2 blend); AMSR-E excess conc
    becomes young ice."""
    bg = _read_ice_fields(cfg, grid, "topaz", time_init)
    osisaf = _read_obs(cfg, grid, "ice_osisaf", time_init)
    osisaf_type = _read_obs(cfg, grid, "ice_osisaf_type", time_init)
    amsre = _read_obs(cfg, grid, "ice_amsre", time_init)
    icesat = _read_obs(cfg, grid, "ice_icesat", time_init)

    hi = np.where(bg["thick"] > 1e-14, bg["thick"], 0.0)  # absolute
    hs = np.where(bg.get("snow", np.zeros(grid.shape)) > 1e-14, bg.get("snow", 0.0), 0.0)
    conc = np.minimum(1.0, bg["conc"])
    conc = np.where(conc > 1e-14, conc, 0.0)
    if "obs_conc" in osisaf:
        conc = np.where(conc > 0.0, osisaf["obs_conc"], conc)

    ice_type = osisaf_type.get("obs_type", np.full(grid.shape, 2.0))
    icesat_h = icesat.get("obs_thick", np.zeros(grid.shape))
    ratio_fyi, ratio_myi = 0.3, 0.9
    ratio_mixed = 0.5 * (ratio_fyi + ratio_myi)
    thick_fyi = hi
    thick_myi = np.maximum(icesat_h, hi)
    thick_mixed = 0.5 * (thick_fyi + thick_myi)
    ridge = np.select(
        [ice_type < 1.5, ice_type < 2.5, ice_type < 3.5],
        [0.0, ratio_fyi, ratio_myi], default=ratio_mixed,
    )
    hi_typed = np.select(
        [ice_type < 1.5, ice_type < 2.5, ice_type < 3.5],
        [thick_fyi, thick_fyi, thick_myi], default=thick_mixed,
    )
    has_ice = (hi > 0.0) & (conc > 0.2)
    hi = np.where(has_ice, hi_typed, hi)
    ridge = np.where(has_ice, ridge, 0.0)

    gone = (conc < 0.01) | (hi < phys_hmin())
    conc = np.where(gone, 0.0, conc)
    hi = np.where(gone, 0.0, hi)
    hs = np.where(gone, 0.0, hs)
    # this scheme scales ridge_ratio by conc (fe.cpp:11911)
    ridge = np.where(gone, 0.0, ridge * conc)

    m = _host(mask)
    updates = dict(
        conc=_to(conc * m, state.conc),
        thick=_to(hi * conc * m, state.conc),
        snow_thick=_to(hs * conc * m, state.conc),
        ridge_ratio=_to(ridge * m, state.conc),
        damage=torch.zeros_like(state.conc),
    )
    # AMSR-E excess concentration becomes young ice (fe.cpp:11917-11921)
    if cfg["thermo.newice_type"] == 4 and "obs_conc" in amsre:
        cy = np.clip(amsre["obs_conc"] - conc, 0.0, 1.0)
        h_young_min = cfg["thermo.h_young_min"]
        h_young_max = cfg["thermo.h_young_max"]
        updates["conc_young"] = _to(cy * m, state.conc)
        updates["h_young"] = _to(
            cy * (h_young_min + 0.5 * (h_young_max - h_young_min)) * m, state.conc
        )
    return state.replace(**updates)


# ---------------------------------------------------------------------------
# full assimilation blends (reference: assimilateIce dispatch fe.cpp:11634-
# 11662; assimilate_topazForecastAmsr2Osisaf[Nic]Ice fe.cpp:12124-12404)
# ---------------------------------------------------------------------------


def conc_bins_nic(ci: np.ndarray, weekly: bool):
    """NIC ice-chart concentration bins -> (min, max) observed total-conc
    bounds (reference: concBinsNic, fe.cpp:12062-12117). ci<=0 and the
    uncovered non-weekly ci>0.9 case give (0, 0), exactly as the reference's
    zero-initialised outputs do."""
    ci = np.asarray(ci)
    if not weekly:
        lo = np.select([ci <= 0.0, ci <= 0.45, ci <= 0.9], [0.0, 0.1, 0.8], 0.0)
        hi = np.select([ci <= 0.0, ci <= 0.45, ci <= 0.9], [0.0, 0.8, 1.0], 0.0)
    else:
        conds = [ci <= 0.0, ci <= 0.2, ci <= 0.3, ci <= 0.5, ci <= 0.7, ci <= 0.9, ci <= 1.0]
        lo = np.select(conds, [0.0, 0.1, 0.2, 0.4, 0.6, 0.8, 0.9], 0.0)
        hi = np.select(conds, [0.0, 0.3, 0.4, 0.6, 0.8, 1.0, 1.0], 0.0)
    return lo, hi


def _young_h_clamp(cy, h_young, h_young_min, h_young_max):
    """Clamp young-ice volume between the bin's min/max mean thickness
    (reference: fe.cpp:12250-12257, 12391-12398)."""
    min_h = h_young_min * cy
    max_h = (h_young_min + 0.5 * (h_young_max + h_young_min)) * cy
    return np.clip(h_young, min_h, max_h)


def assimilate_topaz_amsr2_osisaf(cfg, grid, state, mask, time_init: float):
    """Full OSISAF+AMSR2 concentration assimilation onto the restart state
    (reference: assimilate_topazForecastAmsr2OsisafIce, fe.cpp:12283-12404).

    * OSISAF replaces conc with the (2*model + 1*obs)/3 blend where the
      model or TOPAZ background has ice, OSISAF conc > 0.15 and the cell is
      > 25 km from the coast.
    * AMSR2 (higher resolution) lowers conc where it sees openings
      (amsr2 < conc and amsr2 > 0.15).
    * thickness / ridge_ratio / damage scale with the conc change; cells
      ending with conc<0.01 or mean thickness < hmin are cleared.
    * young ice: obs young conc = max(amsr2-conc, 0), blended with the
      reference's (sigma_osisaf*model + sigma_mod*obs)/(sigma_amsr2+
      sigma_mod) weights (kept verbatim, fe.cpp:12384-12386), volume
      clamped to the young thickness window.

    The reference also loads OSISAF ice type and TOPAZ thickness/snow but
    never uses them in this blend (the snow lines are commented out,
    fe.cpp:12352-12355) — not read here. The applied conc delta accumulates
    into conc_upd for thermo.use_assim_flux.
    """
    t_obs = time_init - 0.5
    osisaf = _read_obs(cfg, grid, "ice_osisaf", t_obs)
    amsr2 = _read_obs(cfg, grid, "ice_amsr2", t_obs)
    d2c = _read_obs(cfg, grid, "dist2coast", time_init)
    bg = _read_ice_fields(cfg, grid, "topaz_nrt", time_init)

    m = _host(mask)
    c_model = _host(state.conc)
    h_model = _host(state.thick)
    snow = _host(state.snow_thick)
    ridge = _host(state.ridge_ratio)
    damage = _host(state.damage)

    sigma_mod, sigma_amsr2, sigma_osisaf = 1.0, 0.5, 2.0

    topaz_conc = np.where(bg["conc"] > 1e-14, bg["conc"], 0.0)
    osisaf_conc = osisaf.get("obs_conc", np.zeros(grid.shape))
    amsr2_conc = amsr2.get("obs_conc", np.zeros(grid.shape))
    dist = d2c.get("dist", np.full(grid.shape, np.inf))

    conc = c_model.copy()
    use_osisaf = (
        ((topaz_conc > 0.0) | (c_model > 0.0))
        & (osisaf_conc > 0.15)
        & (dist > 25.0e3)
    )
    conc = np.where(
        use_osisaf,
        (sigma_osisaf * conc + sigma_mod * osisaf_conc) / (sigma_osisaf + sigma_mod),
        conc,
    )
    conc = np.where((amsr2_conc < conc) & (amsr2_conc > 0.15), amsr2_conc, conc)

    # scale extensive/intensive fields with the conc change (fe.cpp:12359-12369)
    had_ice = c_model > 0.01
    ratio = np.where(had_ice, conc / np.maximum(c_model, 1e-12), 0.0)
    thick = np.where(had_ice, h_model * ratio, 0.0)
    ridge = np.where(had_ice, ridge * ratio, 0.0)
    damage = np.where(had_ice, damage * ratio, damage)

    gone = (conc < 0.01) | (thick < conc * phys_hmin())
    conc = np.where(gone, 0.0, conc)
    thick = np.where(gone, 0.0, thick)
    snow = np.where(gone, 0.0, snow)
    ridge = np.where(gone, 0.0, ridge)

    updates = dict(
        conc=_to(conc * m, state.conc),
        thick=_to(thick * m, state.conc),
        snow_thick=_to(snow * m, state.conc),
        ridge_ratio=_to(ridge * m, state.conc),
        damage=_to(damage * m, state.conc),
        conc_upd=state.conc_upd + _to((conc - c_model) * m, state.conc),
    )

    if cfg["thermo.newice_type"] == 4:
        cy = _host(state.conc_young)
        hy = _host(state.h_young)
        young_obs = np.maximum(amsr2_conc - conc, 0.0)
        cy_new = (sigma_osisaf * cy + sigma_mod * young_obs) / (sigma_amsr2 + sigma_mod)
        hy_new = _young_h_clamp(
            cy_new, hy, cfg["thermo.h_young_min"], cfg["thermo.h_young_max"]
        )
        updates["conc_young"] = _to(cy_new * m, state.conc)
        updates["h_young"] = _to(hy_new * m, state.conc)

    return state.replace(**updates)


def assimilate_topaz_amsr2_osisaf_nic(cfg, grid, state, mask, time_init: float,
                                      weekly: bool = False):
    """NIC ice-chart assimilation (reference:
    assimilate_topazForecastAmsr2OsisafNicIce, fe.cpp:12124-12283): clear
    sub-threshold cells, then force total concentration into the NIC chart's
    [min, max] bin, adding/removing young ice first (young-ice runs) or
    adjusting thick-ice conc directly. NIC conc > 1 means masked: the model
    is left unchanged there (fe.cpp:12184-12189)."""
    nic = _read_obs(
        cfg, grid, "ice_nic_weekly" if weekly else "ice_nic", time_init - 0.5
    )

    m = _host(mask)
    conc = _host(state.conc).copy()
    thick = _host(state.thick).copy()
    snow = _host(state.snow_thick).copy()
    ridge = _host(state.ridge_ratio).copy()
    conc0 = conc.copy()

    nic_conc = nic.get("obs_conc", np.full(grid.shape, 2.0))

    # mean thickness used for added ice (fe.cpp:12169-12172)
    hi = np.where(conc >= 0.1, thick / np.maximum(conc, 1e-12), thick)

    gone = (conc < 0.01) | (hi < phys_hmin())
    conc = np.where(gone, 0.0, conc)
    thick = np.where(gone, 0.0, thick)
    snow = np.where(gone, 0.0, snow)
    ridge = np.where(gone, 0.0, ridge)

    masked_obs = nic_conc > 1.0
    lo, hi_bin = conc_bins_nic(nic_conc, weekly)

    updates = {}
    if cfg["thermo.newice_type"] == 4:
        cy = _host(state.conc_young).copy()
        hy = _host(state.h_young).copy()
        h_young_min = cfg["thermo.h_young_min"]
        h_young_max = cfg["thermo.h_young_max"]
        h_new_mean = h_young_min + (h_young_max / 2.0 - h_young_min) * 0.5

        total = conc + cy
        # below the bin: raise young ice to lo-conc (fe.cpp:12200-12226)
        below = (~masked_obs) & (total < lo)
        tgt_b = np.maximum(lo - conc, 0.0)
        grow = tgt_b > cy
        hy_b = np.where(grow, hy + h_new_mean * (tgt_b - cy),
                        hy * tgt_b / np.maximum(cy, 1e-12))
        cy = np.where(below, tgt_b, cy)
        hy = np.where(below, hy_b, hy)

        # above the bin: shrink young ice toward hi_bin; if even zero young
        # ice overshoots, reduce thick ice (fe.cpp:12227-12249)
        above = (~masked_obs) & (conc + cy > hi_bin) & (~below)
        tgt_a = hi_bin - conc  # may be negative
        some_young = tgt_a >= 0.0
        grow_a = tgt_a > cy
        hy_a = np.where(grow_a, hy + h_new_mean * (tgt_a - cy),
                        hy * np.maximum(tgt_a, 0.0) / np.maximum(cy, 1e-12))
        cy = np.where(above & some_young, tgt_a, cy)
        hy = np.where(above & some_young, hy_a, hy)
        # no young ice fits: clear it and cap thick ice
        kill = above & (~some_young)
        thick = np.where(kill, thick * np.maximum(conc + tgt_a, 0.0)
                         / np.maximum(conc, 1e-12), thick)
        conc = np.where(kill, np.maximum(conc + tgt_a, 0.0), conc)
        cy = np.where(kill, 0.0, cy)
        hy = np.where(kill, 0.0, hy)

        hy = np.where(masked_obs, hy, _young_h_clamp(cy, hy, h_young_min, h_young_max))
        updates["conc_young"] = _to(cy * m, state.conc)
        updates["h_young"] = _to(hy * m, state.conc)
    else:
        # no young-ice category: move thick-ice conc into the bin
        # (fe.cpp:12261-12279)
        below = (~masked_obs) & (conc < lo)
        tgt_b = (lo + 0.5 * (lo + hi_bin)) / 2.0
        thick = np.where(below, thick + np.maximum(hi, 0.5) * (tgt_b - conc), thick)
        conc = np.where(below, tgt_b, conc)

        above = (~masked_obs) & (conc > hi_bin) & (~below)
        tgt_a = (hi_bin + 0.5 * (lo + hi_bin)) / 2.0
        thick = np.where(above, thick * tgt_a / np.maximum(conc, 1e-12), thick)
        conc = np.where(above, tgt_a, conc)

    return state.replace(
        conc=_to(conc * m, state.conc),
        thick=_to(thick * m, state.conc),
        snow_thick=_to(snow * m, state.conc),
        ridge_ratio=_to(ridge * m, state.conc),
        conc_upd=state.conc_upd + _to((conc - conc0) * m, state.conc),
        **updates,
    )


def assimilate_ice(cfg, grid, state, mask, time_init: float):
    """Dispatch per ice-type (reference: assimilateIce, fe.cpp:11634-11662).
    Only the TOPAZ-forecast blend families support assimilation."""
    ice_type = cfg["setup.ice-type"]
    if ice_type == "topaz4_nrt-amsr2-osisaf":
        return assimilate_topaz_amsr2_osisaf(cfg, grid, state, mask, time_init)
    if ice_type == "topaz4_nrt-amsr2-osisaf-nic":
        return assimilate_topaz_amsr2_osisaf_nic(cfg, grid, state, mask, time_init, False)
    if ice_type == "topaz4_nrt-amsr2-osisaf-nic_weekly":
        return assimilate_topaz_amsr2_osisaf_nic(cfg, grid, state, mask, time_init, True)
    raise ValueError(
        f"invalid choice for data assimilation of the ice: {ice_type!r}"
    )


def assimilate_slab_ocean(cfg, state, ocean_temp, ocean_salt, freezing_point_fn):
    """Slab-ocean assimilation at restart (reference: assimilateSlabOcean,
    fe.cpp:11351-11396): equal-weight blend of model SST/SSS with the
    forcing analysis (constant ocean: SSS toward 1.8/mu, SST toward +1)."""
    sigma_mod = sigma_obs = 1.0
    ocean_type = cfg["setup.ocean-type"]
    if ocean_type == "constant":
        mu = cfg["thermo.freezingpoint_mu"]
        sss = (sigma_obs * state.sss + sigma_mod * (1.8 / mu)) / (sigma_obs + sigma_mod)
        sst = (sigma_obs * state.sst + sigma_mod * 1.0) / (sigma_obs + sigma_mod)
        return state.replace(sss=sss, sst=sst)
    if ocean_type == "coupled":
        raise ValueError("invalid ocean data assimilation")  # fe.cpp:11391
    from benchmark.reference.plain.core import constants as phys

    sss_obs = torch.clamp(_to(ocean_salt, state.sss), min=phys.si)
    sst_obs = torch.maximum(freezing_point_fn(sss_obs), _to(ocean_temp, state.sst))
    sss = (sigma_obs * state.sss + sigma_mod * sss_obs) / (sigma_obs + sigma_mod)
    sst = (sigma_obs * state.sst + sigma_mod * sst_obs) / (sigma_obs + sigma_mod)
    sst = torch.maximum(freezing_point_fn(sss), sst)
    return state.replace(sss=sss, sst=sst)
