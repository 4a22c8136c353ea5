"""Explicit momentum solver (the counterpart of nextsim_tpu/ops/momentum.py).

FiniteElement::explicitSolve (reference: model/finiteelement.cpp:10182-10643):
per model step, precompute element/node coefficients, then run
`dynamics.substeps` explicit sub-iterations of

  rheology stress update -> stress-divergence RHS -> pointwise 2x2
  implicit-in-drag node solve (Hunke & Dukowicz decoupling)

followed by the 50-sweep open-water velocity smoother and the ice-ocean drag
diagnostic. The substep loop goes through ``momentum_cuda.substep_loop``:
the hand-written CUDA kernel for tensors on the GPU, the plain loop over
``_build_substep`` for tensors on the CPU.

On a device mesh (``exchanger``, a ``parallel.seam.Seam``) the planes are a
rank's ext block: the substep loop runs H substeps between ring exchanges,
the smoother exchanges the velocity every H sweeps, and the planes the
step changed are exchanged before returning (parallel/seam.py).

Free drift (reference: updateFreeDriftVelocity, fe.cpp:10140-10176) is the
cheap alternative path.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import torch

from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.core import ties
from nextsim_tpu_torch.ops import momentum_cuda, rheology, stencil
from nextsim_tpu_torch.ops.rheology import BBMParams, EVPParams, rdiv
from nextsim_tpu_torch.utils.timer import phase


@dataclasses.dataclass(frozen=True)
class DynParams:
    """Static dynamics parameters (from config; reference: initOptAndParam)."""

    dynamics_type: str = "bbm"  # bbm | evp | mevp | free_drift | no_motion
    substeps: int = 120  # dynamics.substeps
    min_h: float = 0.05  # dynamics.min_h -> min slab mass = rhoi*min_h
    quad_drag_coef_water: float = 0.0055
    lin_drag_coef_water: float = 0.0
    quad_drag_coef_air: float = 0.0020
    lin_drag_coef_air: float = 0.0
    ocean_turning_angle_deg: float = 25.0  # 0 when coupled (fe.cpp:1173)
    use_coriolis: bool = True
    basal_stress: str = "lemieux"  # none | lemieux
    k1: float = 10.0  # dynamics.Lemieux_basal_k1
    k2: float = 15.0
    Cb: float = 20.0
    u0: float = 5e-5
    mevp_alpha: float = 500.0
    mevp_beta: float = 500.0
    nit_ow: int = 50  # numerics.nit_ow open-water smoother sweeps
    use_young_ice: bool = True  # thermo.newice_type == 4
    bbm: BBMParams = BBMParams()
    evp: EVPParams = EVPParams()


def slab_mass(state, p: DynParams):
    """Element slab mass per unit ice-covered area (reference:
    fe.cpp:10253-10269 — Connolley et al. 2004 slab mass)."""
    total_conc = state.conc
    total_thick = state.thick
    total_snow = state.snow_thick
    if p.use_young_ice:
        total_conc = total_conc + state.conc_young
        total_thick = total_thick + state.h_young
        total_snow = total_snow + state.hs_young
    # the 1e-15 division floor of the JAX package (its square stays
    # float32-normal); floored lanes are masked by the where
    mass = (phys.rhoi * total_thick + phys.rhos * total_snow) / ties.maximum(
        total_conc, 1e-15
    )
    return torch.where(total_conc > 0.0, mass, 0.0)


def _basal_cbu(state, forcing, ssh_cell, p: DynParams):
    """Element grounding coefficient C_bu (Lemieux et al. 2015 eq. 24
    numerator; reference: fe.cpp:10278-10311)."""
    if p.basal_stress == "none":
        return torch.zeros_like(state.conc)
    max_keel_depth = 28.0
    min_water_depth = 2.0
    depth_eff = ties.maximum(
        ssh_cell + ties.maximum(forcing.depth, min_water_depth), 0.0
    )
    mean_keel_depth = torch.minimum(p.k1 * state.thick, state.conc * max_keel_depth)
    critical_h = state.conc * depth_eff / p.k1
    critical_h_mod = mean_keel_depth / p.k1
    return (
        p.k2
        * ties.maximum(critical_h_mod - critical_h, 0.0)
        * torch.exp(-p.Cb * (1.0 - state.conc))
    )


def _build_substep(p: DynParams, dyn_type: str, dte: float, dt: float, dx, c):
    """The per-substep physics body: ``c`` is a namespace of loop-invariant
    planes, the carry is (vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage).
    The CUDA kernel (csrc/momentum_substep.cu) computes the same body in two
    stages, cell then node."""

    def substep(carry):
        vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage = carry

        # ---- rheology (reference: fe.cpp:10426-10441) --------------------
        eps11, eps22, eps12 = stencil.strain_rates(vt_u, vt_v, dx)
        if dyn_type == "bbm":
            sxx, syy, sxy, damage = rheology.bbm_update_planes(
                sxx, syy, sxy, damage, c.conc, c.thick,
                c.cohesion, c.time_relaxation_damage,
                eps11, eps22, eps12, dx, dte, p.bbm,
                expC=c.bbm_expC, Pmax=c.bbm_pmax,
                heal_rate=c.bbm_heal, rtd_coef=c.bbm_rtd,
            )
        elif dyn_type == "evp":
            T = dt / 3.0
            sxx, syy, sxy = rheology.vp_update_planes(
                sxx, syy, sxy, c.conc, c.thick, eps11, eps22, eps12,
                0.5 * dte / T, 0.5 * dte / T * p.evp.e * p.evp.e, p.evp,
                P=c.evp_P,
            )
        elif dyn_type == "mevp":
            ra = 1.0 / p.mevp_alpha
            sxx, syy, sxy = rheology.vp_update_planes(
                sxx, syy, sxy, c.conc, c.thick, eps11, eps22, eps12,
                ra, ra, p.evp, P=c.evp_P,
            )
        else:
            raise ValueError(dyn_type)

        # ---- gradient terms (reference: fe.cpp:10444-10468) --------------
        gsu, gsv = stencil.stress_divergence(sxx, syy, sxy, c.volume, dx)
        grad_u = c.grad_ssh_u + gsu
        grad_v = c.grad_ssh_v + gsv

        # ---- node solve (reference: fe.cpp:10472-10529) ------------------
        if dyn_type == "mevp":
            b_mevp = p.mevp_beta + 1.0
            delu = (c.vtm_u - vt_u) / b_mevp
            delv = (c.vtm_v - vt_v) / b_mevp
        else:
            delu = 0.0
            delv = 0.0

        uice, vice = vt_u, vt_v

        du = c.ocean_u - uice
        dv = c.ocean_v - vice
        # +1e-20 inside the norms, as in the JAX package
        c_prime = phys.rhow * p.quad_drag_coef_water * torch.sqrt(
            du * du + dv * dv + 1e-20
        )
        tau_b = c.c_bu / (torch.sqrt(uice * uice + vice * vice + 1e-20) + p.u0)
        dte_over_mass = c.dte_over_mass_const
        alpha = 1.0 + c.dom_cos * c_prime + dte_over_mass * tau_b
        beta = c.beta_cor_const + c.dom_sin * c_prime
        rdenom = rdiv(1.0, alpha * alpha + beta * beta)

        tau_x = c.tau_ax + c_prime * c.ocn_rot_x
        tau_y = c.tau_ay + c_prime * c.ocn_rot_y

        grad_x = grad_u * c.rlmass
        grad_y = grad_v * c.rlmass

        # 2x2 solve in the factored alpha*A + beta*B form (fe.cpp:10505-10529)
        A = uice + dte_over_mass * (grad_x + tau_x) + delu
        B = vice + dte_over_mass * (grad_y + tau_y) + delv
        new_u = (alpha * A + beta * B) * rdenom
        new_v = (alpha * B - beta * A) * rdenom

        vt_u = torch.where(c.solve, new_u, vt_u)
        vt_v = torch.where(c.solve, new_v, vt_v)

        # ---- total displacement (reference: fe.cpp:10539-10553) ----------
        if dyn_type != "mevp":
            ut_u = ut_u + dte * vt_u
            ut_v = ut_v + dte * vt_v

        return (vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage)

    return substep


def substep_setup(state, forcing, grid_arrays, dt: float, p: DynParams):
    """Element and node prep of one dynamics step (reference:
    fe.cpp:10235-10416). Returns (consts, carry): the namespace of
    loop-invariant planes the substep loop reads (plus ``has_mass`` and the
    wind-stress diagnostics, which only ``explicit_solve`` reads) and the
    loop's initial 8-plane carry.

    ``grid_arrays`` is a dict of static per-grid tensors: mask (cell),
    node_mask, node_dirichlet, node_lat, cohesion, and delta_x (a Python
    float [m]).
    """
    mask = grid_arrays["mask"]
    node_mask = grid_arrays["node_mask"]
    node_dirichlet = grid_arrays["node_dirichlet"]
    node_lat = grid_arrays["node_lat"]
    dx = grid_arrays["delta_x"]
    area = dx * dx

    steps = p.substeps
    dte = dt / steps
    ota = p.ocean_turning_angle_deg * (math.pi / 180.0)  # math.radians, bitwise
    cos_ota = ties.scalar("cos", ota)
    sin_ota = ties.scalar("sin", ota)
    min_m = phys.rhoi * p.min_h

    # ---- element prep (reference: fe.cpp:10235-10341) --------------------
    element_mass = slab_mass(state, p) * mask
    ssh_cell = stencil.cell_mean_of_nodes(forcing.ssh)
    element_cbu = _basal_cbu(state, forcing, ssh_cell, p) * mask

    # ---- node prep (reference: fe.cpp:10344-10416) -----------------------
    # lumped mass & nodal mean mass: area-weighted over adjacent ocean cells
    area_sum = stencil.cells_to_node_sum(mask) * area
    node_mass = stencil.cells_to_node_sum(element_mass * area) / ties.maximum(
        area_sum, 1.0
    )
    # reciprocal lumped mass matrix: quads lump A/4 per corner
    rlmass = rdiv(4.0, ties.maximum(area_sum, 1.0))

    c_bu = stencil.node_max_of_cells(element_cbu)

    # gradient of m*g*SSH (reference: fe.cpp:10323-10341), coef = m*g*A/4
    g4 = element_mass * area * (phys.gravity / 4.0)
    grad_ssh_u, grad_ssh_v = stencil.node_grad_scalar(g4, forcing.ssh, dx)

    # Coriolis parameter at nodes (reference: fe.cpp:10397)
    if p.use_coriolis:
        fcor = 2.0 * phys.omega * torch.sin(torch.deg2rad(node_lat))
    else:
        fcor = torch.zeros_like(node_lat)

    # atmospheric drag: area-weighted cell drag -> node, x rhoa|wind|
    # (reference: fe.cpp:10373-10394)
    if p.use_young_ice:
        tot_c = state.conc + state.conc_young
        dragp = torch.where(
            tot_c > 0.0,
            (state.drag_ui * state.conc + state.drag_ui_young * state.conc_young)
            / ties.maximum(tot_c, 1e-15),
            state.drag_ui,
        )
    else:
        dragp = state.drag_ui
    drag_node = stencil.node_mean_of_cells(dragp, mask)
    wspd_node = torch.sqrt(
        forcing.wind_u * forcing.wind_u + forcing.wind_v * forcing.wind_v + 1e-20
    )
    drag_node = drag_node * phys.rhoa * wspd_node
    tau_ax = drag_node * forcing.wind_u
    tau_ay = drag_node * forcing.wind_v

    # D_tau_a diagnostic excludes the wave stress (fe.cpp:10394 vs 10510-10517)
    tau_ax_diag, tau_ay_diag = tau_ax, tau_ay
    if forcing.tau_wi_u is not None:
        tau_ax = tau_ax + forcing.tau_wi_u
        tau_ay = tau_ay + forcing.tau_wi_v

    # zero velocity on ice-free nodes before sub-stepping (fe.cpp:10367-10371)
    has_mass = node_mass > 0.0
    vt_u = torch.where(has_mass, state.vt_u, 0.0) * node_mask
    vt_v = torch.where(has_mass, state.vt_v, 0.0) * node_mask
    vtm_u, vtm_v = vt_u, vt_v  # VTM copy (fe.cpp:10410-10411)

    # solve-mask: not dirichlet, has ice mass (fe.cpp:10475-10478)
    solve = (node_dirichlet < 0.5) & has_mass & (node_mask > 0.5)
    hemisphere = torch.where(node_lat >= 0.0, 1.0, -1.0).to(node_lat.dtype)
    sin_ota_signed = sin_ota * hemisphere

    dyn_type = p.dynamics_type

    # loop-invariant BBM transcendentals hoisted out of the substep loop
    if dyn_type == "bbm":
        bbm_expC = torch.exp(p.bbm.compaction_param * (1.0 - state.conc))
        bbm_pmax = (
            rheology._fast_pow(state.thick, p.bbm.exponent_compression_factor)
            * p.bbm.compression_factor * bbm_expC
        )
        bbm_heal = rdiv(dte, state.time_relaxation_damage) * bbm_expC
        bbm_rtd = torch.sqrt(p.bbm.young * bbm_expC) / (
            dx * ties.scalar("sqrt", 2.0 * (1.0 + p.bbm.nu0) * phys.rhoi)
        )
    else:
        bbm_expC = bbm_pmax = bbm_heal = bbm_rtd = None

    # loop-invariant node coefficients (node_mass, fcor are fixed)
    dtep_const = dte / (p.mevp_beta + 1.0) if dyn_type == "mevp" else dte
    dte_over_mass_const = rdiv(dtep_const, ties.maximum(node_mass, min_m))
    beta_cor_const = dtep_const * fcor
    dom_cos = dte_over_mass_const * cos_ota
    dom_sin = dte_over_mass_const * sin_ota_signed
    ocn_rot_x = forcing.ocean_u * cos_ota - forcing.ocean_v * sin_ota_signed
    ocn_rot_y = forcing.ocean_v * cos_ota + forcing.ocean_u * sin_ota_signed

    volume = state.thick * area * mask  # loop-invariant
    evp_P = (
        p.evp.Pstar * torch.exp(-p.evp.C * (1.0 - state.conc))
        if dyn_type in ("evp", "mevp")
        else None
    )

    consts = SimpleNamespace(
        # cell planes
        conc=state.conc,
        thick=state.thick,
        cohesion=grid_arrays["cohesion"],
        time_relaxation_damage=state.time_relaxation_damage,
        volume=volume,
        bbm_expC=bbm_expC,
        bbm_pmax=bbm_pmax,
        bbm_heal=bbm_heal,
        bbm_rtd=bbm_rtd,
        evp_P=evp_P,
        # node planes
        grad_ssh_u=grad_ssh_u,
        grad_ssh_v=grad_ssh_v,
        tau_ax=tau_ax,
        tau_ay=tau_ay,
        dte_over_mass_const=dte_over_mass_const,
        beta_cor_const=beta_cor_const,
        dom_cos=dom_cos,
        dom_sin=dom_sin,
        ocn_rot_x=ocn_rot_x,
        ocn_rot_y=ocn_rot_y,
        ocean_u=forcing.ocean_u,
        ocean_v=forcing.ocean_v,
        c_bu=c_bu,
        rlmass=rlmass,
        solve=solve,
        vtm_u=vtm_u,
        vtm_v=vtm_v,
        # read after the loop by explicit_solve only
        has_mass=has_mass,
        tau_ax_diag=tau_ax_diag,
        tau_ay_diag=tau_ay_diag,
    )

    carry = (
        vt_u, vt_v, state.ut_u, state.ut_v,
        state.sigma[0], state.sigma[1], state.sigma[2], state.damage,
    )
    return consts, carry


def explicit_solve(state, forcing, grid_arrays, dt: float, p: DynParams, exchanger=None):
    """One full dynamics step. Returns (state', diag_dict); ``grid_arrays``
    as for ``substep_setup``; ``exchanger`` a rank's ``seam.Seam`` on a
    device mesh, else None."""
    node_mask = grid_arrays["node_mask"]
    node_dirichlet = grid_arrays["node_dirichlet"]
    with phase("momentum.setup"):
        consts, carry = substep_setup(state, forcing, grid_arrays, dt, p)
    loop = momentum_cuda.substep_loop if exchanger is None else exchanger.substep_loop
    carry = loop(
        consts, carry, p.substeps, dt / p.substeps, dt, grid_arrays["delta_x"],
        p.dynamics_type, p,
    )
    # the substep loop's phases are momentum_cuda.substep_loop's
    with phase("momentum.smoother"):
        vt_u, vt_v, ut_u, ut_v, sxx, syy, sxy, damage = carry
        sigma = torch.stack([sxx, syy, sxy])

        if p.dynamics_type == "mevp":
            ut_u = ut_u + dt * vt_u
            ut_v = ut_v + dt * vt_v

        # ---- open-water velocity smoother (reference: fe.cpp:10576-10611) ----
        # u,v are zero on masked nodes, so the neighbour mean needs only the
        # loop-invariant weight denominator
        vtm_u, vtm_v = consts.vtm_u, consts.vtm_v
        ow = (node_mask > 0.5) & (node_dirichlet < 0.5) & torch.logical_not(consts.has_mass)
        mp = stencil.pad1(node_mask)
        nbr_rden = rdiv(1.0, ties.maximum(
            mp[..., :-2, 1:-1] + mp[..., 2:, 1:-1] + mp[..., 1:-1, :-2] + mp[..., 1:-1, 2:], 1.0
        ))
        for sweep in range(p.nit_ow):
            if exchanger is not None and sweep % exchanger.halo_depth == 0:
                vt_u, vt_v = exchanger.ring((vt_u, vt_v))
            up = stencil.pad1(vt_u)
            vp = stencil.pad1(vt_v)
            u_bar = (up[..., :-2, 1:-1] + up[..., 2:, 1:-1] + up[..., 1:-1, :-2] + up[..., 1:-1, 2:]) * nbr_rden
            v_bar = (vp[..., :-2, 1:-1] + vp[..., 2:, 1:-1] + vp[..., 1:-1, :-2] + vp[..., 1:-1, 2:]) * nbr_rden
            vt_u = torch.where(ow, u_bar, vt_u)
            vt_v = torch.where(ow, v_bar, vt_v)

        # ice-ocean drag diagnostic from mean speed (reference: fe.cpp:10616-10630)
        um_u = 0.5 * (vt_u + vtm_u)
        um_v = 0.5 * (vt_v + vtm_v)
        dou = forcing.ocean_u - um_u
        dov = forcing.ocean_v - um_v
        c_prime = (
            phys.rhow * p.quad_drag_coef_water * torch.sqrt(dou * dou + dov * dov + 1e-20)
        )
        tau_wx = c_prime * (um_u - forcing.ocean_u)
        tau_wy = c_prime * (um_v - forcing.ocean_v)

        # open-water displacement accumulation (reference: fe.cpp:10631-10637)
        ut_u = torch.where(ow, ut_u + dt * vt_u, ut_u)
        ut_v = torch.where(ow, ut_v + dt * vt_v, ut_v)

        state = state.replace(
            vt_u=vt_u * node_mask,
            vt_v=vt_v * node_mask,
            ut_u=ut_u,
            ut_v=ut_v,
            sigma=sigma,
            damage=damage,
        )
        if exchanger is not None:
            # transport reads these with a reach of 3 cells; the displacement
            # waits for the exchange at the end of the step
            vt_u, vt_v, sigma, damage = exchanger.ring((state.vt_u, state.vt_v, state.sigma,
                                                        state.damage if p.dynamics_type == "bbm" else None))
            state = state.replace(vt_u=vt_u, vt_v=vt_v, sigma=sigma,
                                  damage=state.damage if damage is None else damage)
        diag = {"tau_ax": consts.tau_ax_diag, "tau_ay": consts.tau_ay_diag,
                "tau_wx": tau_wx, "tau_wy": tau_wy}
        return state, diag


def free_drift(state, forcing, grid_arrays, dt: float, p: DynParams):
    """Free-drift velocity (reference: updateFreeDriftVelocity,
    fe.cpp:10140-10176): pointwise wind/current drag balance."""
    with phase("momentum.smoother"):
        node_dirichlet = grid_arrays["node_dirichlet"]
        node_mask = grid_arrays["node_mask"]

        duo = state.vt_u - forcing.ocean_u
        dvo = state.vt_v - forcing.ocean_v
        nvo = ties.maximum(torch.sqrt(duo * duo + dvo * dvo + 1e-20), 0.01)
        coef_voce = (p.lin_drag_coef_water + p.quad_drag_coef_water * nvo) * phys.rhow
        dua = state.vt_u - forcing.wind_u
        dva = state.vt_v - forcing.wind_v
        nva = ties.maximum(torch.sqrt(dua * dua + dva * dva + 1e-20), 0.01)
        coef_vair = (p.lin_drag_coef_air + p.quad_drag_coef_air * nva) * phys.rhoa

        new_u = (coef_vair * forcing.wind_u + coef_voce * forcing.ocean_u) / (
            coef_vair + coef_voce
        )
        new_v = (coef_vair * forcing.wind_v + coef_voce * forcing.ocean_v) / (
            coef_vair + coef_voce
        )
        upd = (node_dirichlet < 0.5) & (node_mask > 0.5)
        vt_u = torch.where(upd, new_u, state.vt_u)
        vt_v = torch.where(upd, new_v, state.vt_v)
        return state.replace(
            vt_u=vt_u,
            vt_v=vt_v,
            ut_u=torch.where(upd, state.ut_u + dt * vt_u, state.ut_u),
            ut_v=torch.where(upd, state.ut_v + dt * vt_v, state.ut_v),
        )
