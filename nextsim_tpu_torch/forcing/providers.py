"""Forcing providers.

A provider produces one ``Forcing`` per model step (already
time-interpolated). The constant provider mirrors the reference's
constant-forcing ExternalData path (reference: forcingAtmosphere CONSTANT,
model/finiteelement.cpp:10841-10858; forcingOcean CONSTANT, fe.cpp:11146-11162)
including the linear spin-up factor applied to the *dynamic* fields (wind,
currents, SSH) over ``simul.spinup_duration`` days (reference:
model/externaldata.cpp:366-404).

The NetCDF dataset providers are not ported yet: ``make_provider`` raises
for any configuration that needs them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.forcing.base import Forcing


class ConstantForcing:
    """Idealised constant forcing from ideal_simul.* options."""

    def __init__(self, cfg, grid, dtype=torch.float32, device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.dtype = dtype
        self.spinup_days = cfg["simul.spinup_duration"]
        ny, nx = grid.shape
        kw = dict(dtype=dtype, device=device)
        cell = lambda v: torch.full((ny, nx), v, **kw)  # noqa: E731
        node = lambda v: torch.full((ny + 1, nx + 1), v, **kw)  # noqa: E731
        mu = cfg["thermo.freezingpoint_mu"]

        self._wind_u = node(cfg["ideal_simul.constant_wind_u"])
        self._wind_v = node(cfg["ideal_simul.constant_wind_v"])
        self._ocean_u = node(cfg["ideal_simul.constant_ocean_u"])
        self._ocean_v = node(cfg["ideal_simul.constant_ocean_v"])
        self._ssh = node(cfg["ideal_simul.constant_ssh"])

        self._static = dict(
            tair=cell(cfg["ideal_simul.constant_tair"]),
            dair=cell(cfg["ideal_simul.constant_dair"]),
            sphuma=None,
            mixrat=cell(cfg["ideal_simul.constant_mixrat"]),
            mslp=cell(cfg["ideal_simul.constant_mslp"]),
            qsw_in=cell(cfg["ideal_simul.constant_Qsw_in"]),
            qlw_in=(
                None
                if cfg["thermo.use_parameterised_long_wave_radiation"]
                else cell(cfg["ideal_simul.constant_Qlw_in"])
            ),
            tcc=None,
            precip=cell(cfg["ideal_simul.constant_precip"]),
            snowfr=cell(cfg["ideal_simul.constant_snowfr"]),
            snowfall=None,
            # constant ocean: nudging targets at freezing (fe.cpp:11156-11159)
            ocean_temp=cell(phys.ocean_freezing_temp),
            ocean_salt=cell(phys.ocean_freezing_temp / mu),
            mld=cell(cfg["ideal_simul.constant_mld"]),
            qdw=cell(cfg["ideal_simul.constant_Qdw"]),
            fdw=cell(cfg["ideal_simul.constant_Fdw"]),
            depth=cell(cfg["ideal_simul.constant_bathymetry"]),
            tau_wi_u=None,
            tau_wi_v=None,
            wlbk=None,
        )
        self._cache = None

    def spinup_factor(self, t_days: float, time_init_days: float) -> float:
        """Linear 0->1 ramp over the spin-up window (reference:
        externaldata.cpp:392-404)."""
        if self.spinup_days <= 0:
            return 1.0
        frac = (t_days - time_init_days) / self.spinup_days
        return float(np.clip(frac, 0.0, 1.0))

    def __call__(self, t_days: float, time_init_days: float) -> Forcing:
        f = self.spinup_factor(t_days, time_init_days)
        if self._cache is not None and self._cache[0] == f:
            return self._cache[1]
        forcing = Forcing(
            wind_u=self._wind_u * f,
            wind_v=self._wind_v * f,
            ocean_u=self._ocean_u * f,
            ocean_v=self._ocean_v * f,
            ssh=self._ssh * f,
            **self._static,
        )
        self._cache = (f, forcing)
        return forcing


def make_provider(cfg, grid, dtype=torch.float32, device="cpu"):
    atm = cfg["setup.atmosphere-type"]
    ocn = cfg["setup.ocean-type"]
    # ETOPO bathymetry rides the dataset provider; with the file absent the
    # constant depth is the documented fallback (same rule and same path as
    # nextsim_tpu.forcing.bathymetry.etopo_path)
    etopo_active = cfg["setup.bathymetry-type"] == "etopo" and os.path.exists(
        os.path.join(
            os.environ.get("NEXTSIM_DATA_DIR", "."), cfg["setup.bathymetry-file"]
        )
    )
    if atm == "constant" and ocn == "constant" and not etopo_active:
        return ConstantForcing(cfg, grid, dtype, device)
    raise NotImplementedError(
        f"forcing atmosphere-type={atm!r}, ocean-type={ocn!r}"
        + (" with ETOPO bathymetry" if etopo_active else "")
        + " needs the NetCDF dataset providers, which the PyTorch port has "
        "not ported yet (ROADMAP A.9); use constant forcing"
    )
