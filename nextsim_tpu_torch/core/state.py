"""The model state as frozen dataclasses of tensors.

``State`` carries every prognostic field of the reference's variable set
(reference: model/model_variable.hpp:51-90) on the structured grid, with the
same field names as ``nextsim_tpu.core.state.State``: cell-centered tracers
(ny, nx), stacked multi-layer fields (3, ny, nx) and node-staggered velocity
(ny+1, nx+1). ``Diag`` carries the D_* diagnostic fields (reference:
model/model_variable.hpp:91-134).

Both are immutable: a step builds a new ``State`` with ``replace``, as the
JAX package does. ``state_from_numpy`` / ``state_to_numpy`` move a state
across the framework boundary as a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class State:
    # --- cell tracers (ny, nx) -------------------------------------------
    conc: Any  # ice concentration of thick ("old") ice [0..1]
    thick: Any  # ice volume per cell area (effective thickness) [m]
    snow_thick: Any  # snow volume per cell area [m]
    damage: Any  # BBM damage [0..1]
    ridge_ratio: Any  # ridged-ice volume fraction [0..1]
    tice: Any  # (3, ny, nx) ice temperatures: surface, mid (Winton T1), bottom (T2) [C]
    sigma: Any  # (3, ny, nx) stress components sxx, syy, sxy [Pa]
    sst: Any  # slab-ocean temperature [C]
    sss: Any  # slab-ocean salinity [g/kg]
    tsurf_young: Any  # young-ice surface temperature [C]
    h_young: Any  # young-ice volume per cell area [m]
    hs_young: Any  # young-ice snow volume [m]
    conc_young: Any  # young-ice concentration [0..1]
    random_number: Any  # per-cell uniform random for cohesion
    fyi_fraction: Any  # first-year-ice fraction
    age_det: Any  # observable (detectable) ice age [s]
    age: Any  # volume-weighted ice age [s]
    conc_upd: Any  # concentration update from assimilation
    conc_myi: Any  # multiyear-ice concentration
    thick_myi: Any  # multiyear-ice volume
    conc_summer: Any  # summer-minimum concentration tracker
    thick_summer: Any  # summer-minimum volume tracker
    freeze_days: Any  # consecutive freezing days counter
    freeze_onset: Any  # freeze-onset flag (0/1)
    del_vi_tend: Any  # daily ice-volume tendency accumulator [m]
    pond_volume: Any  # melt pond volume [m water]
    lid_volume: Any  # melt pond lid volume [m water]
    drag_ui: Any  # ice-atmosphere momentum drag coef (stability-adjusted)
    drag_ti: Any  # ice-atmosphere thermo drag coef
    drag_ui_young: Any
    drag_ti_young: Any
    time_relaxation_damage: Any  # damage healing time [s]
    # --- node fields (ny+1, nx+1) ----------------------------------------
    vt_u: Any  # ice velocity x [m/s]
    vt_v: Any  # ice velocity y [m/s]
    ut_u: Any  # time-integrated velocity x [m]
    ut_v: Any
    # --- optional FSD bins: always None until the FSD slice is ported ----
    conc_fsd: Any = None
    conc_mech_fsd: Any = None

    @staticmethod
    def zeros(grid, dtype=torch.float32, cfg=None, device="cpu") -> "State":
        ny, nx = grid.shape
        kw = dict(dtype=dtype, device=device)
        cell = lambda: torch.zeros((ny, nx), **kw)  # noqa: E731
        node = lambda: torch.zeros((ny + 1, nx + 1), **kw)  # noqa: E731
        full = lambda shape, v: torch.full(shape, v, **kw)  # noqa: E731
        quad_drag_coef_air = 0.0020 if cfg is None else _quad_drag_air(cfg)
        drag_ice_t = 1.3e-3 if cfg is None else cfg["thermo.drag_ice_t"]
        t_relax = 25.0 * 86400.0 if cfg is None else cfg["dynamics.time_relaxation_damage"] * 86400.0
        mu = 0.055 if cfg is None else cfg["thermo.freezingpoint_mu"]
        tfr_ice = -mu * 5.0  # freezing point of ice (si=5 g/kg)
        return State(
            conc=cell(), thick=cell(), snow_thick=cell(),
            damage=cell(), ridge_ratio=cell(),
            tice=full((3, ny, nx), tfr_ice),
            sigma=torch.zeros((3, ny, nx), **kw),
            sst=cell() - 1.8, sss=cell() + 32.0,
            tsurf_young=full((ny, nx), tfr_ice),
            h_young=cell(), hs_young=cell(), conc_young=cell(),
            random_number=cell(),
            fyi_fraction=cell(), age_det=cell(), age=cell(), conc_upd=cell(),
            conc_myi=cell(), thick_myi=cell(), conc_summer=cell(), thick_summer=cell(),
            freeze_days=cell(), freeze_onset=cell(), del_vi_tend=cell(),
            pond_volume=cell(), lid_volume=cell(),
            drag_ui=full((ny, nx), quad_drag_coef_air),
            drag_ti=full((ny, nx), drag_ice_t),
            drag_ui_young=full((ny, nx), quad_drag_coef_air),
            drag_ti_young=full((ny, nx), drag_ice_t),
            time_relaxation_damage=full((ny, nx), t_relax),
            vt_u=node(), vt_v=node(), ut_u=node(), ut_v=node(),
        )

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Diag:
    """Per-step diagnostic fields (reference D_* variables)."""

    # nodal
    tau_ax: Any  # atmosphere->ice stress x at nodes [N/m2]
    tau_ay: Any
    tau_wx: Any  # ice->ocean stress x at nodes [N/m2]
    tau_wy: Any
    # cell
    tau_ow: Any  # open-water atm drag bulk coefficient
    qa: Any; qsw: Any; qlw: Any; qsh: Any; qlh: Any  # noqa: E702
    qo: Any; qnosun: Any; qsw_ocean: Any; qassim: Any  # noqa: E702
    dels: Any; fwflux: Any; fwflux_ice: Any; brine: Any  # noqa: E702
    evap: Any; rain: Any  # noqa: E702
    vice_melt: Any; del_vi_young: Any; del_hi: Any; del_hi_young: Any  # noqa: E702
    newice: Any; mlt_top: Any; mlt_bot: Any; snow2ice: Any  # noqa: E702
    albedo: Any; sialb: Any; pond_fraction: Any  # noqa: E702
    divergence: Any
    del_ci_ridge_myi: Any; del_vi_mlt_myi: Any; del_ci_mlt_myi: Any  # noqa: E702
    del_vi_rplnt_myi: Any; del_ci_rplnt_myi: Any  # noqa: E702

    def replace(self, **kw) -> "Diag":
        return dataclasses.replace(self, **kw)


def _quad_drag_air(cfg) -> float:
    """Atmosphere quadratic drag coefficient by forcing source (reference:
    model/finiteelement.cpp:1094-1160 selects per atmosphere-type)."""
    atm = cfg["setup.atmosphere-type"]
    table = {
        "asr": cfg["dynamics.ASR_quad_drag_coef_air"],
        "era5": cfg["dynamics.ERA5_quad_drag_coef_air"],
        "generic_ps": cfg["dynamics.ERA5_quad_drag_coef_air"],
        "cfsr": cfg["dynamics.CFSR_quad_drag_coef_air"],
        "cfsr_hi": cfg["dynamics.CFSR_quad_drag_coef_air"],
        "ecmwf_nrt": cfg["dynamics.ECMWF_quad_drag_coef_air"],
        "ecmwf_nrt_arome": cfg["dynamics.ECMWF_quad_drag_coef_air"],
        "ecmwf_nrt_arome_ensemble": cfg["dynamics.ECMWF_quad_drag_coef_air"],
        # CONSTANT uses the ASR coefficient (reference: finiteelement.cpp:1286)
        "constant": cfg["dynamics.ASR_quad_drag_coef_air"],
    }
    return table.get(atm, cfg["dynamics.ECMWF_quad_drag_coef_air"])


def state_from_numpy(
    arrays: Dict[str, np.ndarray], device="cpu", dtype: Optional[torch.dtype] = None
) -> State:
    """Build a ``State`` from a dict of numpy arrays keyed by field name
    (e.g. a JAX ``State`` converted leaf by leaf). Fields that are absent or
    None stay None; ``dtype`` (default: each array's own) casts every leaf."""
    kw = {}
    for f in dataclasses.fields(State):
        a = arrays.get(f.name)
        if a is not None:
            t = torch.from_numpy(np.array(a))  # a copy: the state owns its planes
            a = t.to(device=device, dtype=dtype or t.dtype).contiguous()
        kw[f.name] = a
    return State(**kw)


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_numpy``: every non-None field as a host
    numpy array."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(State)
        if getattr(state, f.name) is not None
    }
