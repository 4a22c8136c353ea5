"""Forcing field container.

The set of external fields the model consumes each step — the union of what
the reference wires up in forcingAtmosphere/forcingOcean (reference:
model/finiteelement.cpp:10835-11130) — with the same field names as
``nextsim_tpu.forcing.base.Forcing``:

* nodal (ny+1, nx+1): wind u/v, ocean current u/v, SSH
* cell (ny, nx): air temperature, dew point / humidity, pressure, radiation,
  precipitation, ocean temperature/salinity nudging targets, mixed-layer
  depth, bathymetry, wave stress (coupled).

Fields a provider does not supply are None, and consumers branch on that.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class Forcing:
    # --- nodal dynamics forcing ------------------------------------------
    wind_u: Any  # 10 m wind [m/s]
    wind_v: Any
    ocean_u: Any  # surface current [m/s]
    ocean_v: Any
    ssh: Any  # sea-surface height [m]
    # --- cell atmosphere (thermo) ----------------------------------------
    tair: Any  # 2 m air temperature [C]
    dair: Optional[Any]  # 2 m dew point [C] (or None if sphuma/mixrat given)
    sphuma: Optional[Any]  # specific humidity of air [kg/kg]
    mixrat: Optional[Any]  # mixing ratio
    mslp: Any  # sea-level pressure [Pa]
    qsw_in: Any  # incoming shortwave [W/m2]
    qlw_in: Optional[Any]  # incoming longwave [W/m2] (else parameterised w/ tcc)
    tcc: Optional[Any]  # total cloud cover [0..1]
    precip: Any  # total precipitation [kg/m2/s]
    snowfr: Optional[Any]  # snow fraction of precip
    snowfall: Optional[Any]  # direct snowfall [kg/m2/s]
    # --- cell ocean -------------------------------------------------------
    ocean_temp: Any  # SST nudging target [C]
    ocean_salt: Any  # SSS nudging target [g/kg]
    mld: Optional[Any]  # mixed-layer depth [m] (None -> constant_mld)
    qdw: Optional[Any]  # nudging heat flux override (constant ocean)
    fdw: Optional[Any]  # nudging freshwater flux override
    # --- static-ish -------------------------------------------------------
    depth: Any  # bathymetry at cells [m]
    # --- coupled waves (None unless wave coupling active) ----------------
    tau_wi_u: Optional[Any]  # wave-to-ice stress at nodes [N/m2]
    tau_wi_v: Optional[Any]
    wlbk: Optional[Any]  # wave breaking probability (FSD)
    # --- wave forcing for the WIM ----------------------------------------
    swh: Optional[Any] = None  # significant wave height [m]
    mwp: Optional[Any] = None  # peak/mean wave period [s]
    mwd: Optional[Any] = None  # wave-from direction [deg]
    # fraction of shortwave absorbed in the ocean mixed layer (coupled ocean)
    qsrml: Optional[Any] = None

    def replace(self, **kw) -> "Forcing":
        return dataclasses.replace(self, **kw)
