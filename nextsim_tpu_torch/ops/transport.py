"""Transport of all prognostic tracers + mechanical redistribution (ridging)
(the counterpart of nextsim_tpu/ops/transport.py).

The Eulerian replacement of the reference's Lagrangian cycle (mesh motion ->
area scaling -> ridging in FiniteElement::update, reference:
model/finiteelement.cpp:3919-4131):

1. advect conservative densities (conc, volumes, ...) and weighted tracers
   (age x thick, Tice enthalpy x thick ..., matching the reference's interp
   transforms, collectVariables fe.cpp:2120-2158);
2. advect intensive tracers (damage, stress, SST/SSS, surface temperatures)
   in upwind advective form;
3. mechanical redistribution: young-ice ridging transfer (aspect ratio 10)
   and concentration capping, per update() (fe.cpp:4032-4115);
4. SST/SSS diffusion (reference: diffuse, fe.cpp:2760-2815) when enabled.
"""

from __future__ import annotations

import dataclasses

import torch

from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.ops import advection, stencil
from nextsim_tpu_torch.ops.rheology import rdiv


@dataclasses.dataclass(frozen=True)
class TransportParams:
    second_order: bool = True
    min_h: float = 0.05  # dynamics.min_h
    min_c: float = 0.01  # dynamics.min_c
    use_young_ice: bool = True
    freezingpoint_mu: float = 0.055
    equal_ridging: bool = False  # age.equal_ridging
    include_young_ice: bool = True  # age.include_young_ice
    newice_type: int = 4
    diffusivity_sst: float = 0.0
    diffusivity_sss: float = 0.0
    max_true_thickness: float = 50.0  # fe.cpp:4100
    ridge_young_aspect: float = 10.0  # fe.cpp:4056

    @staticmethod
    def from_config(cfg) -> "TransportParams":
        return TransportParams(
            second_order=cfg["numerics.advection_scheme"] == "upwind2",
            min_h=cfg["dynamics.min_h"],
            min_c=cfg["dynamics.min_c"],
            use_young_ice=cfg["thermo.newice_type"] == 4,
            freezingpoint_mu=cfg["thermo.freezingpoint_mu"],
            equal_ridging=cfg["age.equal_ridging"],
            include_young_ice=cfg["age.include_young_ice"],
            newice_type=cfg["thermo.newice_type"],
            diffusivity_sst=cfg["thermo.diffusivity_sst"],
            diffusivity_sss=cfg["thermo.diffusivity_sss"],
        )


def transport_and_ridge(state, grid_arrays, dt: float, p: TransportParams):
    if state.conc_fsd is not None:
        raise NotImplementedError(
            "transport of the floe-size-distribution bins is not ported yet "
            "(ROADMAP A.10, waves)"
        )
    mask = grid_arrays["mask"]
    open_mask = grid_arrays["open_mask"]
    dx = grid_arrays["delta_x"]
    # cells that are actually updated: ocean, not open-boundary
    # (reference skips elements touching Neumann nodes, fe.cpp:3958-3962)
    upd = mask * (1.0 - open_mask)

    u_face, v_face = advection.face_velocities(state.vt_u, state.vt_v)
    div = advection.divergence(u_face, v_face, dx)

    so = p.second_order

    def cons(q):
        q2 = advection.advect_conservative(q, u_face, v_face, dt, dx, mask, so)
        return torch.where(upd > 0.5, q2, q)

    def intens(q):
        q2 = advection.advect_intensive(q, u_face, v_face, dt, dx, mask, so)
        return torch.where(upd > 0.5, q2, q)

    old_conc = state.conc
    old_thick = state.thick

    # ---- 1) conservative densities --------------------------------------
    conc = cons(state.conc)
    thick = cons(state.thick)
    snow = cons(state.snow_thick)
    h_young = cons(state.h_young) if p.use_young_ice else state.h_young
    hs_young = cons(state.hs_young) if p.use_young_ice else state.hs_young
    conc_young = cons(state.conc_young) if p.use_young_ice else state.conc_young
    conc_myi = cons(state.conc_myi)
    thick_myi = cons(state.thick_myi)
    conc_summer = cons(state.conc_summer)
    thick_summer = cons(state.thick_summer)
    fyi_fraction = cons(state.fyi_fraction)
    conc_upd = cons(state.conc_upd)
    pond_volume = cons(state.pond_volume)
    lid_volume = cons(state.lid_volume)

    # weighted tracers (transforms per collectVariables, fe.cpp:2131-2147)
    age_det_r = cons(state.age_det * old_conc)
    age_r = cons(state.age * old_thick)
    mu_si_lf_c = p.freezingpoint_mu * phys.si * phys.Lf / phys.C
    t1 = state.tice[1]
    enth_density = (t1 - rdiv(mu_si_lf_c, torch.clamp(t1, max=-1e-12))) * old_thick
    enth_r = cons(enth_density)
    t2_r = cons(state.tice[2] * old_thick)

    # inverse transforms (redistributeVariables, fe.cpp:2219-2248), gated on
    # a small but non-denormal thickness as in the JAX package (dividing by
    # float32-tiny advected volumes overflows enth^2)
    tfr_ice = -p.freezingpoint_mu * phys.si
    has_c = conc > 1e-6
    has_h = thick > 1e-6
    age_det = torch.where(has_c, age_det_r / torch.clamp(conc, min=1e-6), 0.0)
    age = torch.where(has_h, age_r / torch.clamp(thick, min=1e-6), 0.0)
    enth = enth_r / torch.clamp(thick, min=1e-6)
    t1_new = 0.5 * (enth - torch.sqrt(enth * enth + 4.0 * mu_si_lf_c))
    t1_new = torch.clamp(torch.where(has_h, t1_new, tfr_ice), -100.0, tfr_ice)
    t2_new = torch.where(has_h, t2_r / torch.clamp(thick, min=1e-6), tfr_ice)
    t2_new = torch.clamp(t2_new, -100.0, 0.0)

    # ---- 2) intensive tracers -------------------------------------------
    damage = torch.clamp(intens(state.damage), 0.0, 1.0)
    ridge_ratio = torch.clamp(intens(state.ridge_ratio), 0.0, 1.0)
    t0_new = torch.clamp(intens(state.tice[0]), max=0.0)
    tsurf_young = torch.clamp(intens(state.tsurf_young), max=0.0)
    sst = intens(state.sst)
    sss = intens(state.sss)
    sxx = intens(state.sigma[0])
    syy = intens(state.sigma[1])
    sxy = intens(state.sigma[2])

    # SST/SSS diffusion (reference: diffuse() called in update, fe.cpp:3938)
    if p.diffusivity_sst > 0.0:
        sst = sst + dt * p.diffusivity_sst * stencil.laplacian_cells(sst, mask, dx)
    if p.diffusivity_sss > 0.0:
        sss = sss + dt * p.diffusivity_sss * stencil.laplacian_cells(sss, mask, dx)

    # ---- 3) mechanical redistribution (reference: fe.cpp:4032-4115) ------
    conc_before = conc
    open_water = torch.clamp(1.0 - conc - conc_young, 0.0, 1.0)

    newice = torch.zeros_like(conc)
    newsnow = torch.zeros_like(conc)
    del_c = torch.zeros_like(conc)
    new_conc_young = torch.zeros_like(conc)

    if p.use_young_ice:
        has_young = conc_young > 0.0
        new_conc_young = torch.clamp(1.0 - conc - open_water, 0.0, 1.0)
        ridging_young = (
            has_young
            & (conc > p.min_c)
            & (thick > p.min_h)
            & (new_conc_young < conc_young)
        )
        ratio = new_conc_young / torch.clamp(conc_young, min=1e-15)
        new_h_young = torch.where(ridging_young, ratio * h_young, h_young)
        new_hs_young = torch.where(ridging_young, ratio * hs_young, hs_young)
        newice = torch.where(ridging_young, h_young - new_h_young, 0.0)
        del_c = torch.where(
            ridging_young, (conc_young - new_conc_young) / p.ridge_young_aspect, 0.0
        )
        newsnow = torch.where(ridging_young, hs_young - new_hs_young, 0.0)
        h_young = torch.where(has_young, new_h_young, 0.0)
        hs_young = torch.where(has_young, new_hs_young, 0.0)
        new_conc_young = torch.where(has_young, new_conc_young, 0.0)
        # young ridging: conserve level volume at constant area (fe.cpp:4077)
        ridge_ratio = torch.where(
            ridging_young,
            1.0 - (1.0 - ridge_ratio) * thick / torch.clamp(thick + newice, min=1e-15),
            ridge_ratio,
        )
        thick = thick + newice
        snow = snow + newsnow

    conc_capped = torch.clamp(1.0 - new_conc_young - open_water + del_c, 0.0, 1.0)
    # thick-ice ridging ratio from the cap (fe.cpp:3983: surf_ratio analog)
    ridge_ratio = torch.where(
        conc_before > 0.0,
        1.0
        - (1.0 - ridge_ratio)
        * torch.clamp(conc_capped, max=1.0)
        / torch.clamp(conc_before, min=1e-15),
        ridge_ratio,
    )
    ridge_ratio = torch.clamp(ridge_ratio, 0.0, 1.0)
    conc = conc_capped

    if p.use_young_ice:
        new_conc_young = torch.minimum(torch.clamp(new_conc_young, min=0.0), 1.0 - conc)
        conc_young = new_conc_young

    # thickness-limit "fix" (fe.cpp:4097-4105)
    has_ice = conc > 0.0
    true_h = torch.where(has_ice, thick / torch.clamp(conc, min=1e-15), 0.0)
    true_h = torch.clamp(true_h, max=p.max_true_thickness)
    conc = torch.where(
        has_ice,
        torch.minimum(1.0 - conc_young, thick / torch.clamp(true_h, min=1e-15)),
        conc,
    )
    ridge_ratio = torch.where(has_ice, ridge_ratio, 0.0)
    thick = torch.where(has_ice, thick, 0.0)
    snow = torch.where(has_ice, snow, 0.0)

    # lower bounds (fe.cpp:4118-4123)
    conc = torch.clamp(conc, min=0.0)
    thick = torch.clamp(thick, min=0.0)
    thick_myi = torch.clamp(thick_myi, min=0.0)
    snow = torch.clamp(snow, min=0.0)

    # myi capping (fe.cpp:4124-4130)
    del_ci_ridge_myi = -conc_myi
    if p.newice_type == 4 and p.include_young_ice:
        conc_myi = torch.minimum(torch.clamp(conc_myi, min=0.0), conc + conc_young)
    else:
        conc_myi = torch.minimum(torch.clamp(conc_myi, min=0.0), conc)
    del_ci_ridge_myi = (del_ci_ridge_myi + conc_myi) * phys.days_in_sec / dt

    state = state.replace(
        conc=conc,
        thick=thick,
        snow_thick=snow,
        damage=damage,
        ridge_ratio=ridge_ratio,
        tice=torch.stack([t0_new, t1_new, t2_new]),
        sigma=torch.stack([sxx, syy, sxy]),
        sst=sst,
        sss=sss,
        tsurf_young=tsurf_young,
        h_young=h_young,
        hs_young=hs_young,
        conc_young=conc_young,
        fyi_fraction=torch.clamp(fyi_fraction, 0.0, 1.0),
        age_det=age_det,
        age=age,
        conc_upd=conc_upd,
        conc_myi=conc_myi,
        thick_myi=thick_myi,
        conc_summer=torch.clamp(conc_summer, 0.0, 1.0),
        thick_summer=torch.clamp(thick_summer, min=0.0),
        pond_volume=torch.clamp(pond_volume, min=0.0),
        lid_volume=torch.clamp(lid_volume, min=0.0),
    )
    diag = {"divergence": div, "del_ci_ridge_myi": del_ci_ridge_myi}
    return state, diag
