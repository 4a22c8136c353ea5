"""Thermodynamics parameter bundle (from config); the counterpart of
nextsim_tpu/model/params_thermo.py.

Transcribes the constants the reference reads in thermo()/IABulkFluxes/
OWBulkFluxes/thermoIce0/thermoWinton (reference: model/finiteelement.cpp:
5170-5215, 6148-6215, plus initOptAndParam 1047-1491).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ThermoParams:
    thermo_type: str = "winton"  # zero-layer | winton
    qio_type: str = "basic"  # basic | exchange
    freezingpoint_type: str = "linear"
    freezingpoint_mu: float = 0.055
    ocean_albedo: float = 0.07  # thermo.albedoW
    alb_scheme: int = 3
    alb_ice: float = 0.538
    alb_sn: float = 0.8256
    alb_ponds: float = 0.30
    I_0: float = 0.30
    flooding: bool = True
    newice_type: int = 4
    melt_type: int = 2
    hnull: float = 0.25
    PhiF: float = 4.0
    PhiM: float = 0.5
    h_young_max: float = 0.5
    h_young_min: float = 0.05
    h_young_max_sharp: float = 0.275  # 0.5*(h_young_min + h_young_max)
    snow_cond: float = 0.3096  # M_ks
    drag_ice_t: float = 1.3e-3
    drag_ocean_u: float = 1.1e-3
    drag_ocean_t: float = 0.83e-3
    drag_ocean_q: float = 1.5e-3
    Csens_io: float = 1.0e-3
    ocean_nudge_timeT: float = 30.0 * 86400.0  # [s]
    ocean_nudge_timeS: float = 30.0 * 86400.0
    Qdw_const: float = 0.0  # ideal_simul.constant_Qdw
    Fdw_const: float = 0.0
    constant_mld: float = 9.0
    use_assim_flux: bool = False
    assim_flux_exponent: float = 1.0
    zref_wind: float = 10.0
    zref_temp: float = 2.0
    force_neutral_atmosphere: bool = False
    limiting_lengthscale: float = 1.0
    quad_drag_coef_air: float = 0.0020  # neutral drag (z0 base)
    use_meltponds: bool = False
    meltponds_roff: float = 0.2
    meltponds_dep2frac: float = 0.8
    use_young_ice: bool = True
    ocean_type: str = "constant"
    temp_dep_healing: bool = False
    time_relaxation_damage: float = 25.0 * 86400.0  # [s]
    deltaT_relaxation_damage: float = 20.0
    # age/MYI options (reference: options.cpp:545-556)
    include_young_ice: bool = True
    reset_by_date: bool = False
    reset_freeze_days: float = 3.0
    equal_melting: bool = True
    use_parameterised_lw: bool = False
    # nextsim | coare3.0 | coare3.6 | ncar | ecmwf | andreas (AeroBulk family,
    # reference fe.cpp:1254-1263)
    ocean_bulk_formula: str = "nextsim"


def thermo_params(cfg) -> ThermoParams:
    from benchmark.reference.plain.core.state import _quad_drag_air

    h_young_min = cfg["thermo.h_young_min"]
    h_young_max = cfg["thermo.h_young_max"]
    return ThermoParams(
        thermo_type=cfg["setup.thermo-type"],
        qio_type=cfg["thermo.Qio-type"],
        freezingpoint_type=cfg["thermo.freezingpoint-type"],
        freezingpoint_mu=cfg["thermo.freezingpoint_mu"],
        ocean_albedo=cfg["thermo.albedoW"],
        alb_scheme=cfg["thermo.alb_scheme"],
        alb_ice=cfg["thermo.alb_ice"],
        alb_sn=cfg["thermo.alb_sn"],
        alb_ponds=cfg["thermo.alb_ponds"],
        I_0=cfg["thermo.I_0"],
        flooding=cfg["thermo.flooding"],
        newice_type=cfg["thermo.newice_type"],
        melt_type=cfg["thermo.melt_type"],
        hnull=cfg["thermo.hnull"],
        PhiF=cfg["thermo.PhiF"],
        PhiM=cfg["thermo.PhiM"],
        h_young_max=h_young_max,
        h_young_min=h_young_min,
        h_young_max_sharp=0.5 * (h_young_min + h_young_max),
        snow_cond=cfg["thermo.snow_cond"],
        drag_ice_t=cfg["thermo.drag_ice_t"],
        drag_ocean_u=cfg["thermo.drag_ocean_u"],
        drag_ocean_t=cfg["thermo.drag_ocean_t"],
        drag_ocean_q=cfg["thermo.drag_ocean_q"],
        Csens_io=cfg["thermo.Csens_io"],
        ocean_nudge_timeT=cfg["thermo.ocean_nudge_timeT_days"] * 86400.0,
        ocean_nudge_timeS=cfg["thermo.ocean_nudge_timeS_days"] * 86400.0,
        Qdw_const=cfg["ideal_simul.constant_Qdw"],
        Fdw_const=cfg["ideal_simul.constant_Fdw"],
        constant_mld=cfg["ideal_simul.constant_mld"],
        use_assim_flux=cfg["thermo.use_assim_flux"],
        assim_flux_exponent=cfg["thermo.assim_flux_exponent"],
        zref_wind=cfg["thermo.zref_wind"],
        zref_temp=cfg["thermo.zref_temp"],
        force_neutral_atmosphere=cfg["thermo.force_neutral_atmosphere"],
        limiting_lengthscale=cfg["thermo.limiting_lengthscale"],
        quad_drag_coef_air=_quad_drag_air(cfg),
        use_meltponds=cfg["thermo.use_meltponds"],
        meltponds_roff=cfg["thermo.meltpond_runoff_fraction"],
        meltponds_dep2frac=cfg["thermo.meltpond_depth_to_fraction"],
        use_young_ice=cfg["thermo.newice_type"] == 4,
        ocean_type=cfg["setup.ocean-type"],
        temp_dep_healing=cfg["dynamics.use_temperature_dependent_healing"],
        time_relaxation_damage=cfg["dynamics.time_relaxation_damage"] * 86400.0,
        deltaT_relaxation_damage=cfg["dynamics.deltaT_relaxation_damage"],
        include_young_ice=cfg["age.include_young_ice"],
        reset_by_date=cfg["age.reset_by_date"],
        reset_freeze_days=cfg["age.reset_freeze_days"],
        equal_melting=cfg["age.equal_melting"],
        use_parameterised_lw=cfg["thermo.use_parameterised_long_wave_radiation"],
        ocean_bulk_formula=cfg["thermo.ocean_bulk_formula"],
    )
