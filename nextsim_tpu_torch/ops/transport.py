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

``transport_and_ridge`` sends a state on the card to the CUDA kernel
(ops/transport_cuda.py, csrc/transport_ridge.cu: one launch a call, one more
a stack of floe-size bins), or raises: nothing falls back to the plain
version there. A state on the CPU takes the plain version,
``transport_and_ridge_reference``, which is also the kernel's oracle.
"""

from __future__ import annotations

import dataclasses

import torch

from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.core import ties
from nextsim_tpu_torch.ops import advection, stencil
from nextsim_tpu_torch.ops import fsd as fsd_ops
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
    """Transport and ridging of ``state`` over ``dt``: (state, diag). On
    any device but the CPU the kernel (``transport_cuda``), else the plain
    version."""
    if not _kernel_for(state.conc):
        return transport_and_ridge_reference(state, grid_arrays, dt, p)
    from nextsim_tpu_torch.ops import transport_cuda

    return transport_cuda.transport_and_ridge(state, grid_arrays, dt, p)


def _kernel_for(t) -> bool:
    """Whether ``transport_and_ridge`` takes the kernel for this state: on
    any device but the CPU."""
    return t.device.type != "cpu"


def scalars(p: TransportParams) -> dict:
    """The physics scalars of a call that ``p`` gives: ``mu_si_lf_c``
    (the enthalpy transform's constant), ``tfr_ice`` (the ice's freezing
    point) and ``myi_with_young`` (whether the myi cap counts young ice),
    for the plain version and the kernel alike."""
    return {"mu_si_lf_c": p.freezingpoint_mu * phys.si * phys.Lf / phys.C,
            "tfr_ice": -p.freezingpoint_mu * phys.si,
            "myi_with_young": p.newice_type == 4 and p.include_young_ice}


def _cons(q, u_face, v_face, dt: float, dx: float, mask, upd, so: bool):
    """Conservative advection of ``q``, kept where upd > 0.5."""
    q2 = advection.advect_conservative(q, u_face, v_face, dt, dx, mask, so)
    return torch.where(upd > 0.5, q2, q)


def advect_stack_reference(q, vt_u, vt_v, mask, open_mask, dt: float, dx: float, second_order: bool):
    """The plain version of a stack's advection (``transport_cuda.advect_stack``):
    the conservative advection of every plane of ``q`` (the floe-size bins),
    as ``transport_and_ridge_reference`` advects them."""
    u_face, v_face = advection.face_velocities(vt_u, vt_v)
    return _cons(q, u_face, v_face, dt, dx, mask, mask * (1.0 - open_mask), second_order)


def transport_and_ridge_reference(state, grid_arrays, dt: float, p: TransportParams):
    """The plain version of ``transport_and_ridge``."""
    mask = grid_arrays["mask"]
    open_mask = grid_arrays["open_mask"]
    dx = grid_arrays["delta_x"]
    # cells that are actually updated: ocean, not open-boundary
    # (reference skips elements touching Neumann nodes, fe.cpp:3958-3962)
    upd = mask * (1.0 - open_mask)

    u_face, v_face = advection.face_velocities(state.vt_u, state.vt_v)
    div = advection.divergence(u_face, v_face, dx)

    so = p.second_order
    k = scalars(p)

    def cons(q):
        return _cons(q, u_face, v_face, dt, dx, mask, upd, so)

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
    mu_si_lf_c = k["mu_si_lf_c"]
    t1 = state.tice[1]
    enth_density = (t1 - rdiv(mu_si_lf_c, ties.minimum(t1, -1e-12))) * old_thick
    enth_r = cons(enth_density)
    t2_r = cons(state.tice[2] * old_thick)

    # inverse transforms (redistributeVariables, fe.cpp:2219-2248), gated on
    # a small but non-denormal thickness as in the JAX package (dividing by
    # float32-tiny advected volumes overflows enth^2)
    tfr_ice = k["tfr_ice"]
    has_c = conc > 1e-6
    has_h = thick > 1e-6
    age_det = torch.where(has_c, age_det_r / ties.maximum(conc, 1e-6), 0.0)
    age = torch.where(has_h, age_r / ties.maximum(thick, 1e-6), 0.0)
    enth = enth_r / ties.maximum(thick, 1e-6)
    t1_new = 0.5 * (enth - torch.sqrt(enth * enth + 4.0 * mu_si_lf_c))
    t1_new = ties.clip(torch.where(has_h, t1_new, tfr_ice), -100.0, tfr_ice)
    t2_new = torch.where(has_h, t2_r / ties.maximum(thick, 1e-6), tfr_ice)
    t2_new = ties.clip(t2_new, -100.0, 0.0)

    # ---- 2) intensive tracers -------------------------------------------
    damage = ties.clip(intens(state.damage), 0.0, 1.0)
    ridge_ratio = ties.clip(intens(state.ridge_ratio), 0.0, 1.0)
    t0_new = ties.minimum(intens(state.tice[0]), 0.0)
    tsurf_young = ties.minimum(intens(state.tsurf_young), 0.0)
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
    open_water = ties.clip(1.0 - conc - conc_young, 0.0, 1.0)

    newice = torch.zeros_like(conc)
    newsnow = torch.zeros_like(conc)
    del_c = torch.zeros_like(conc)
    new_conc_young = torch.zeros_like(conc)

    if p.use_young_ice:
        has_young = conc_young > 0.0
        new_conc_young = ties.clip(1.0 - conc - open_water, 0.0, 1.0)
        ridging_young = (
            has_young
            & (conc > p.min_c)
            & (thick > p.min_h)
            & (new_conc_young < conc_young)
        )
        ratio = new_conc_young / ties.maximum(conc_young, 1e-15)
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
            1.0 - (1.0 - ridge_ratio) * thick / ties.maximum(thick + newice, 1e-15),
            ridge_ratio,
        )
        thick = thick + newice
        snow = snow + newsnow

    conc_capped = ties.clip(1.0 - new_conc_young - open_water + del_c, 0.0, 1.0)
    # thick-ice ridging ratio from the cap (fe.cpp:3983: surf_ratio analog)
    ridge_ratio = torch.where(
        conc_before > 0.0,
        1.0
        - (1.0 - ridge_ratio)
        * ties.minimum(conc_capped, 1.0)
        / ties.maximum(conc_before, 1e-15),
        ridge_ratio,
    )
    ridge_ratio = ties.clip(ridge_ratio, 0.0, 1.0)
    conc = conc_capped

    if p.use_young_ice:
        new_conc_young = torch.minimum(ties.maximum(new_conc_young, 0.0), 1.0 - conc)
        conc_young = new_conc_young

    # thickness-limit "fix" (fe.cpp:4097-4105)
    has_ice = conc > 0.0
    true_h = torch.where(has_ice, thick / ties.maximum(conc, 1e-15), 0.0)
    true_h = ties.minimum(true_h, p.max_true_thickness)
    conc = torch.where(
        has_ice,
        torch.minimum(1.0 - conc_young, thick / ties.maximum(true_h, 1e-15)),
        conc,
    )
    ridge_ratio = torch.where(has_ice, ridge_ratio, 0.0)
    thick = torch.where(has_ice, thick, 0.0)
    snow = torch.where(has_ice, snow, 0.0)

    # lower bounds (fe.cpp:4118-4123)
    conc = ties.maximum(conc, 0.0)
    thick = ties.maximum(thick, 0.0)
    thick_myi = ties.maximum(thick_myi, 0.0)
    snow = ties.maximum(snow, 0.0)

    # myi capping (fe.cpp:4124-4130)
    del_ci_ridge_myi = -conc_myi
    if k["myi_with_young"]:
        conc_myi = torch.minimum(ties.maximum(conc_myi, 0.0), conc + conc_young)
    else:
        conc_myi = torch.minimum(ties.maximum(conc_myi, 0.0), conc)
    del_ci_ridge_myi = (del_ci_ridge_myi + conc_myi) * phys.days_in_sec / dt

    # FSD bins: conservative transport then shape-preserving rescale to the
    # new total concentration (reference: conc_fsd scaling in update(),
    # fe.cpp:3991-3993, + updateFSD called from step())
    fsd_updates = {}
    if state.conc_fsd is not None:
        ctot_new = conc + conc_young if p.use_young_ice else conc
        for name in ("conc_fsd", "conc_mech_fsd"):
            bins = getattr(state, name)
            if bins is not None:
                # all bins in one stack: bitwise what bin after bin gives
                fsd_updates[name] = fsd_ops.update_fsd(cons(bins), ctot_new)

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
        fyi_fraction=ties.clip(fyi_fraction, 0.0, 1.0),
        age_det=age_det,
        age=age,
        conc_upd=conc_upd,
        conc_myi=conc_myi,
        thick_myi=thick_myi,
        conc_summer=ties.clip(conc_summer, 0.0, 1.0),
        thick_summer=ties.maximum(thick_summer, 0.0),
        pond_volume=ties.maximum(pond_volume, 0.0),
        lid_volume=ties.maximum(lid_volume, 0.0),
        **fsd_updates,
    )
    diag = {"divergence": div, "del_ci_ridge_myi": del_ci_ridge_myi}
    return state, diag
