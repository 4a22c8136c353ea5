"""Thermodynamics: bulk fluxes, ice growth/melt, slab ocean, tracers (the
counterpart of nextsim_tpu/ops/thermo.py).

Whole-grid elementwise transcription of the reference's per-element thermo
pipeline (reference: FiniteElement::thermo, model/finiteelement.cpp:
5170-6148):

* specific humidity schemes           (fe.cpp:4965-5020)
* open-water bulk fluxes              (OWBulkFluxes, fe.cpp:5032-5170)
* ice-atmosphere bulk fluxes with Monin-Obukhov stability (Grachev
  constants) and albedo schemes       (IABulkFluxes, fe.cpp:6148-6359;
  albedo, fe.cpp:6454-6538)
* zero-layer Semtner ice slab         (thermoIce0, fe.cpp:6860-6962)
* Winton 3-layer ice slab             (thermoWinton, fe.cpp:6633-6855)
* melt ponds                          (meltPonds, fe.cpp:6538-6633)
* the slab step: new-ice formation, lateral melt, young-ice category,
  slab-ocean SST/SSS update, MYI/age tracers, D_* diagnostics
  (fe.cpp:5283-6148)

Branch-free tensor code (``torch.where`` in place of if/else) with the JAX
package's term order and float32 guards: the Winton melt-denominator clamp,
the non-finite lane cleanup, the ``T1 <= -1e-6`` clamps and the 1e-12 /
1e-15 / 1e-20 floors. Python scalars divided by a tensor go through
``rheology.rdiv`` and integer powers through ``rheology._fast_pow`` (the
multiplies XLA expands them into).

The per-step time flags (``tinfo``) are host numbers or 0-dim tensors. A
host number selects a branch in Python, so an eager step copies nothing to
the device for it. A tensor (the captured step of ``model/captured.py``,
whose flags live in a device buffer that each replay refills) computes both
branches and selects with ``torch.where``, as the JAX package does with its
traced flags; the two forms give the same bits.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.plain.core import constants as phys
from benchmark.reference.plain.core import ties
from benchmark.reference.plain.model.params_thermo import ThermoParams
from benchmark.reference.plain.ops import fsd as fsd_ops
from benchmark.reference.plain.ops import stencil
from benchmark.reference.plain.ops.rheology import _fast_pow, rdiv

# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def _cbrt(x):
    """Cube root for x >= 1 (torch has no cbrt). ``pow(x, 1/3)`` in x's own
    dtype is within one ulp of the JAX package's ``jnp.cbrt`` and equal to
    it on about 99% of inputs; a correctly rounded cube root (float64 pow
    refined by a Newton step) differs from it on about 20%."""
    return ties.pow(x, 1.0 / 3.0)


def freezing_point(p: ThermoParams, sss):
    """(reference: fe.cpp freezingPoint)"""
    if p.freezingpoint_type == "unesco":
        return (-0.0575 + 1.710523e-3 * torch.sqrt(ties.maximum(sss, 1e-12))
                - 2.154996e-4 * sss) * sss
    return -p.freezingpoint_mu * sss


def specific_humidity_air(p: ThermoParams, forcing):
    """Atmosphere specific humidity (reference: fe.cpp:4979-5007,
    scheme ATMOSPHERE): priority sphuma > mixrat > dew point."""
    if forcing.sphuma is not None:
        return ties.maximum(forcing.sphuma, 0.0)
    if forcing.mixrat is not None:
        return forcing.mixrat / (1.0 + forcing.mixrat)
    A, B, C = 7.2e-4, 3.20e-6, 5.9e-10
    a, b, c, d = 6.1121e2, 18.729, 257.87, 227.3
    alpha, beta = 0.62197, 0.37803
    temp = forcing.dair
    f = 1.0 + A + forcing.mslp * 1e-2 * (B + C * temp * temp)
    est = a * torch.exp((b - temp / d) * temp / (temp + c))
    return alpha * f * est / (forcing.mslp - beta * f * est)


def specific_humidity_water(sst):
    """Saturation humidity at the ocean surface (reference: fe.cpp:4992-4995)."""
    return 640380.0 / phys.rhoa * torch.exp(rdiv(-5107.4, sst + phys.tfrwK))


def specific_humidity_ice(mslp, tsurf):
    """(sphum, dsphum/dT) at the ice surface (reference: fe.cpp:4996-5020)."""
    A, B, C = 2.2e-4, 3.83e-6, 6.4e-10
    a, b, c, d = 6.1115e2, 23.036, 279.82, 333.7
    alpha, beta = 0.62197, 0.37803
    temp = tsurf
    f = 1.0 + A + mslp * 1e-2 * (B + C * temp * temp)
    est = a * torch.exp((b - temp / d) * temp / (temp + c))
    sphum = alpha * f * est / (mslp - beta * f * est)
    dfdT = 2.0 * C * B * temp
    destdT = (b * c * d - temp * (2.0 * c + temp)) / (d * _fast_pow(c + temp, 2)) * est
    dsphumdT = alpha * mslp * (f * destdT + est * dfdT) / _fast_pow(mslp - beta * est * f, 2)
    return sphum, dsphumdT


def incoming_longwave(p: ThermoParams, forcing, tice0):
    """(reference: incomingLongwave, fe.cpp:6374-6394): measured QLW_IN or
    the Idso & Jackson (1969) cloud parameterisation."""
    if forcing.qlw_in is not None:
        return forcing.qlw_in
    taa = forcing.tair + phys.tfrwK
    return (
        phys.sigma_sb
        * _fast_pow(taa, 4)
        * (1.0 - 0.261 * torch.exp(-7.77e-4 * _fast_pow(taa - phys.tfrwK, 2)))
        * (1.0 + 0.275 * forcing.tcc)
    )


def wind_speed_cells(forcing):
    """Element wind speed = mean of node |wind| (reference:
    windSpeedElement, fe.cpp:6361-6373)."""
    u, v = forcing.wind_u, forcing.wind_v
    return stencil.cell_mean_of_nodes(torch.sqrt(u * u + v * v + 1e-20))


def air_density(mslp, tair, sphuma):
    """(reference: fe.cpp:5113, 6228)"""
    return (
        mslp
        / (phys.Ra_dry * (tair + phys.tfrwK))
        * (1.0 - sphuma * (1.0 - phys.Ra_vap / phys.Ra_dry))
    )


def _latent_heat_vap(sst):
    return phys.Lv0 - 2.36418e3 * sst + 1.58927 * _fast_pow(sst, 2) - 6.14342e-2 * _fast_pow(sst, 3)


# ---------------------------------------------------------------------------
# Open-water bulk fluxes (reference: OWBulkFluxes, fe.cpp:5032-5170)
# ---------------------------------------------------------------------------


def ow_bulk_fluxes(p: ThermoParams, state, forcing, wspeed, sphuma):
    sst = state.sst
    sphumw = specific_humidity_water(sst)
    rhoair = air_density(forcing.mslp, forcing.tair, sphuma)

    qsh = (
        p.drag_ocean_t
        * rhoair
        * (phys.cpa + sphuma * phys.cpv)
        * wspeed
        * (sst - forcing.tair)
    )
    lv = _latent_heat_vap(sst)
    # condensation capped at 0 (frost-flower trick, fe.cpp:5128-5131)
    qlh = ties.maximum(p.drag_ocean_q * phys.rhoa * lv * wspeed * (sphumw - sphuma), 0.0)
    evap = qlh / lv
    # Gill (1982)/Smith (1980) momentum drag (fe.cpp:5141-5143)
    drag_ocean_m = 1e-3 * ties.clip(0.61 + 0.063 * wspeed, 1.0, 2.0)
    tau_ow = rhoair * drag_ocean_m

    qsw = -forcing.qsw_in * (1.0 - p.ocean_albedo)
    qlw_out = phys.eps * phys.sigma_sb * _fast_pow(sst + phys.tfrwK, 4)
    qlw = qlw_out - incoming_longwave(p, forcing, state.tice[0])
    qow = qlw + qsh + qlh + _qsw_into_slab(forcing, qsw)
    return dict(qow=qow, qlw=qlw, qsw=qsw, qlh=qlh, qsh=qsh, evap=evap, tau_ow=tau_ow)


def _qsw_into_slab(forcing, qsw):
    """Shortwave entering the slab-ocean heat budget: coupled runs see only
    the share absorbed in the mixed layer (reference: Qow[i] +=
    Qsw[i]*M_qsrml[i], fe.cpp:5148-5156)."""
    if forcing.qsrml is None:
        return qsw
    return qsw * forcing.qsrml


# ---------------------------------------------------------------------------
# Albedo (reference: albedo, fe.cpp:6454-6538)
# ---------------------------------------------------------------------------


def albedo(p: ThermoParams, tsurf, hs, frac_pnd):
    scheme = p.alb_scheme
    if scheme in (1, 2):
        snow = hs > 0.0
        if scheme == 2:
            alb_s = ties.minimum(p.alb_ice + (p.alb_sn - p.alb_ice) * hs / 0.2, p.alb_sn)
        else:
            alb_s = torch.full_like(hs, p.alb_sn)
        alb = torch.where(snow, alb_s, p.alb_ice)
        pen_sw = torch.where(snow, 0.0, torch.full_like(hs, p.I_0))
        return alb, pen_sw
    if scheme in (3, 4):
        warm = tsurf > -1.0
        if scheme == 3:
            albi = torch.where(warm, p.alb_ice - 0.075 * (tsurf + 1.0), p.alb_ice)
        else:
            albi = p.alb_ice
        albs = torch.where(warm, p.alb_sn - 0.124 * (tsurf + 1.0), p.alb_sn)
        frac_sn = hs / (hs + 0.02)
        alb = frac_sn * albs + frac_pnd * p.alb_ponds + (1.0 - frac_sn - frac_pnd) * albi
        pen_sw = (1.0 - frac_sn - frac_pnd) * p.I_0
        return alb, pen_sw
    raise ValueError(f"alb_scheme {scheme}")


# ---------------------------------------------------------------------------
# Ice-atmosphere bulk fluxes (reference: IABulkFluxes, fe.cpp:6148-6359)
# ---------------------------------------------------------------------------


def ia_bulk_fluxes(p: ThermoParams, forcing, tsurf, snow_thick, conc, drag_ui, drag_ti,
                   pond_fraction, lid_volume, wspeed, sphuma, bulk_for_young: bool):
    """Returns dict of fluxes + updated drag coefficients."""
    # outgoing longwave + derivative (fe.cpp:6208-6211)
    tsurfK = tsurf + phys.tfrwK
    qlw_out = phys.eps * phys.sigma_sb * _fast_pow(tsurfK, 4)
    dqlwdT = 4.0 * phys.eps * phys.sigma_sb * _fast_pow(tsurfK, 3)

    sphumi, dsphumidT = specific_humidity_ice(forcing.mslp, tsurf)

    tairK = forcing.tair + phys.tfrwK
    rhoair = air_density(forcing.mslp, forcing.tair, sphuma)
    tpot = tairK + phys.Gamma_d * p.zref_temp

    if not p.force_neutral_atmosphere:
        # --- Monin-Obukhov stability (fe.cpp:6238-6305) -------------------
        retv = 0.6078
        am = 5.0
        bm = am / 6.5
        Bm = ((1 - bm) / bm) ** (1.0 / 3.0)
        ah, bh, ch = 5.0, 5.0, 3.0
        Bh = math.sqrt(5.0)
        C1 = -3.0 * am / bm
        C2 = 0.5 * am * Bm / bm
        C3 = 1.0 / (1.0 + Bm)
        Bm2 = Bm * Bm
        C4 = 1.0 / (1.0 - Bm + Bm2)
        sqrt3 = math.sqrt(3.0)
        C5 = 2.0 * sqrt3
        C6 = 1.0 / (sqrt3 * Bm)
        C7 = math.atan((2.0 - Bm) * C6)
        D1 = -0.5 * bh
        D2 = -ah / Bh + 0.5 * bh * ch / Bh
        D3 = ch - Bh
        D4 = ch + Bh
        D5 = math.log(D3 / D4)
        z0 = p.zref_wind * ties.scalar("exp", -phys.vonKarman / ties.scalar("sqrt", p.quad_drag_coef_air))
        lambda_u = ties.scalar("log", p.zref_wind / z0)
        lambda_h = ties.scalar("log", p.zref_wind / z0)
        linv_range = 1.0 / p.limiting_lengthscale

        ustar = torch.sqrt(ties.maximum(drag_ui, 1e-12)) * wspeed
        tvirt = tpot * (1.0 + retv * sphuma)
        mixrat = sphuma / (1.0 - sphuma)
        wtpot = drag_ti * wspeed * (tsurfK - tpot)
        wr = drag_ti * wspeed * (sphumi - sphuma) / ((1.0 - sphumi) * (1.0 - sphuma))
        wtvirt = wtpot * (1.0 + retv * mixrat) + retv * tpot * wr
        linv = ties.clip(
            -phys.vonKarman * phys.g * wtvirt
            / ties.maximum(_fast_pow(ustar, 3) * tvirt, 1e-15),
            -linv_range,
            linv_range,
        )
        zetam = p.zref_wind * linv
        zetah = p.zref_temp * linv

        # stable branch (fe.cpp:6278-6289)
        x_s = _cbrt(1.0 + ties.maximum(zetam, 0.0))
        psim_s = C1 * (x_s - 1.0) + C2 * (
            2.0 * torch.log((x_s + Bm) * C3)
            - torch.log((x_s * x_s - x_s * Bm + Bm2) * C4)
            + C5 * (torch.atan((2.0 * x_s - Bm) * C6) - C7)
        )
        zetah_s = ties.maximum(zetah, 0.0)
        psih_s = D1 * torch.log(1.0 + ch * zetah_s + zetah_s * zetah_s) + D2 * (
            torch.log((2.0 * zetah_s + D3) / (2.0 * zetah_s + D4)) - D5
        )
        # unstable branch (fe.cpp:6290-6299)
        x_u = torch.sqrt(torch.sqrt(1.0 - 16.0 * ties.minimum(zetam, 0.0)))
        psim_u = (
            2.0 * torch.log(0.5 * (1.0 + x_u))
            + torch.log(0.5 * (1.0 + x_u * x_u))
            - 2.0 * torch.atan(x_u)
            + 0.5 * math.pi
        )
        xh_u = torch.sqrt(torch.sqrt(1.0 - 16.0 * ties.minimum(zetah, 0.0)))
        psih_u = 2.0 * torch.log(0.5 * (1.0 + xh_u * xh_u))

        stable = linv >= 0.0
        psim = torch.where(stable, psim_s, psim_u)
        psih = torch.where(stable, psih_s, psih_u)

        drag_ui = _fast_pow(rdiv(phys.vonKarman, lambda_u - psim), 2)
        drag_ti = _fast_pow(rdiv(phys.vonKarman, lambda_h - psih), 2)

    # --- heat fluxes (fe.cpp:6307-6325) -----------------------------------
    qsh = drag_ti * rhoair * phys.cpa * wspeed * (tsurfK - tpot)
    dqshdT = drag_ti * rhoair * phys.cpa * wspeed
    lsub = phys.Lf + phys.Lv0 - 240.0 - 290.0 * tsurf - 4.0 * tsurf * tsurf
    qlh = drag_ti * rhoair * lsub * wspeed * (sphumi - sphuma)
    dqlhdT = drag_ti * lsub * rhoair * wspeed * dsphumidT
    dqiadT = dqlwdT + dqshdT + dqlhdT
    subl = ties.maximum(qlh / lsub, 0.0)  # deposition removed (fe.cpp:6328-6330)

    hs = torch.where(conc > 0.0, snow_thick / ties.maximum(conc, 1e-15), 0.0)

    # pond fraction only counts with a thin (<5 cm water-equivalent) lid
    # (fe.cpp:6340-6349); none on young ice
    frac_pnd = torch.where(
        (pond_fraction > 0.0)
        & (lid_volume <= 0.05 * ties.maximum(pond_fraction, 1e-30)),
        pond_fraction,
        0.0,
    )
    if bulk_for_young:
        frac_pnd = torch.zeros_like(frac_pnd)

    alb, pen_sw = albedo(p, tsurf, hs, frac_pnd)
    qsw = -forcing.qsw_in * (1.0 - alb) * (1.0 - pen_sw)
    I = forcing.qsw_in * (1.0 - alb) * pen_sw  # noqa: E741 (the reference's name)

    qlw = qlw_out - incoming_longwave(p, forcing, tsurf)
    qia = qsw + qlw + qsh + qlh
    return dict(
        qia=qia, qlw=qlw, qsw=qsw, qlh=qlh, qsh=qsh, I=I, subl=subl,
        dqiadT=dqiadT, albedo=alb, drag_ui=drag_ui, drag_ti=drag_ti,
    )


# ---------------------------------------------------------------------------
# Zero-layer Semtner slab (reference: thermoIce0, fe.cpp:6860-6962)
# ---------------------------------------------------------------------------


def thermo_ice0(p: ThermoParams, dt, conc, voli, vols, snowfall, qia, dqiadT, I, subl, tbot,  # noqa: E741
                qio, tsurf_in):
    """Returns dict(qio, hi, hs, hi_old, del_hi, del_hs_mlt, mlt_hi_top,
    mlt_hi_bot, del_hi_s2i, tsurf)."""
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    tfr_ice = -p.freezingpoint_mu * phys.si
    beta = 0.4  # Semtner (1967) fudge factors (fe.cpp:6875-6877)
    gamma = 1.065
    ks = p.snow_cond

    no_ice = (conc <= 0.0) | (voli <= 0.0)
    safe_conc = torch.where(no_ice, 1.0, conc)

    hi = torch.where(no_ice, 0.0, voli / safe_conc)
    hi_old = hi
    hs = torch.where(no_ice, 0.0, vols / safe_conc)
    tsurf = tsurf_in

    qia_mod = qia + (1.0 - beta) * I

    # conductive flux + surface temperature update (fe.cpp:6899-6910)
    denom = hs + ks * hi / phys.ki
    denom = ties.maximum(denom, 1e-10)
    qic = ks * (tbot - tsurf) / denom * gamma
    tsurf = tsurf + (qic - qia_mod) / (rdiv(ks, denom) + dqiadT)
    tsurf = torch.where(hs > 0.0, ties.minimum(tsurf, 0.0), ties.minimum(tsurf, tfr_ice))

    # --- melt & growth (fe.cpp:6912-6937) ---------------------------------
    del_hs_mlt = ties.minimum(qia_mod - qic, 0.0) * dt / qs
    hs = hs + del_hs_mlt - subl * dt / phys.rhos
    del_ht = ties.minimum(hs, 0.0) * qs / qi  # leftover energy melts ice
    hs = ties.maximum(hs, 0.0)
    hs = hs + snowfall / phys.rhos * dt

    del_hb = (qic - qio) * dt / qi
    del_hi = del_ht + del_hb
    hi = hi + del_hi
    mlt_hi_top = ties.minimum(del_ht, 0.0)
    mlt_hi_bot = ties.minimum(del_hb, 0.0)

    # snow-to-ice by flooding (fe.cpp:6939-6948)
    draft = (hi * phys.rhoi + hs * phys.rhos) / phys.rhow
    flood = (draft > hi) if p.flooding else torch.zeros_like(draft, dtype=torch.bool)
    del_hi_s2i = torch.where(flood, draft - hi, 0.0)
    hs = torch.where(flood, hs - (draft - hi) * phys.rhoi / phys.rhos, hs)
    hi = torch.where(flood, draft, hi)

    # --- too-thin cleanup (fe.cpp:6950-6969) -------------------------------
    thin = hi < phys.hmin
    melt_scale = torch.where(del_hi < 0.0, -hi_old / ties.minimum(del_hi, -1e-15), 0.0)
    mlt_hi_top = torch.where(thin, mlt_hi_top * melt_scale, mlt_hi_top)
    mlt_hi_bot = torch.where(thin, mlt_hi_bot * melt_scale, mlt_hi_bot)
    del_hi_s2i = torch.where(thin, 0.0, del_hi_s2i)
    qio = torch.where(thin, qio + hi * qi / dt + hs * qs / dt, qio)
    del_hi = torch.where(thin, -hi_old, del_hi)
    hi = torch.where(thin, 0.0, hi)
    hs = torch.where(thin, 0.0, hs)
    tsurf = torch.where(thin, tfr_ice, tsurf)

    # no-ice lanes produce the reference's no-op outputs (fe.cpp:6883-6890)
    hi = torch.where(no_ice, 0.0, hi)
    hi_old = torch.where(no_ice, 0.0, hi_old)
    hs = torch.where(no_ice, 0.0, hs)
    tsurf = torch.where(no_ice, tfr_ice, tsurf)
    del_hi = torch.where(no_ice, 0.0, del_hi)
    del_hs_mlt = torch.where(no_ice, 0.0, del_hs_mlt)
    mlt_hi_top = torch.where(no_ice, 0.0, mlt_hi_top)
    mlt_hi_bot = torch.where(no_ice, 0.0, mlt_hi_bot)
    del_hi_s2i = torch.where(no_ice, 0.0, del_hi_s2i)

    return dict(
        qio=qio, hi=hi, hs=hs, hi_old=hi_old, del_hi=del_hi,
        del_hs_mlt=del_hs_mlt, mlt_hi_top=mlt_hi_top, mlt_hi_bot=mlt_hi_bot,
        del_hi_s2i=del_hi_s2i, tsurf=tsurf,
    )


# ---------------------------------------------------------------------------
# Winton (2000) 3-layer slab (reference: thermoWinton, fe.cpp:6633-6855)
# ---------------------------------------------------------------------------


def _layer_evening_t1(tbar, tfr_ice, qi, crho):
    """T1 from the mixed-layer enthalpy (Winton eqs 38-39)."""
    return (tbar - torch.sqrt(ties.maximum(tbar * tbar - 4.0 * tfr_ice * qi / crho, 1e-20))) / 2.0


def thermo_winton(p: ThermoParams, dt, conc, voli, vols, snowfall, qia, dqiadT, I, subl, tbot,  # noqa: E741
                  qio, tsurf_in, t1_in, t2_in):
    """Returns dict(qio, hi, hs, hi_old, del_hi, del_hs_mlt, mlt_hi_top,
    mlt_hi_bot, del_hi_s2i, tsurf, t1, t2). Equation numbers refer to
    Winton (2000) as cited in the reference."""
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    crho = phys.C * phys.rhoi
    tfr_ice = -p.freezingpoint_mu * phys.si
    ks = p.snow_cond

    no_ice = (conc <= 0.0) | (voli <= 0.0)
    safe_conc = torch.where(no_ice, 1.0, conc)
    hi = torch.where(no_ice, 1.0, voli / safe_conc)  # safe placeholder 1 m
    hi_old = hi
    hs = torch.where(no_ice, 0.0, vols / safe_conc)
    tsurf = torch.where(no_ice, tfr_ice, tsurf_in)
    t1 = ties.minimum(torch.where(no_ice, tfr_ice, t1_in), -1e-6)  # T1<0 for sqrt/div
    t2 = torch.where(no_ice, tfr_ice, t2_in)

    tfr_surf = torch.where(hs > 0.0, 0.0, torch.full_like(hs, tfr_ice))

    # --- internal temperatures (eqs 5-22; fe.cpp:6668-6705) ---------------
    k12 = rdiv(4.0 * phys.ki * ks, ks * hi + 4.0 * phys.ki * hs)
    A = qia - tsurf * dqiadT
    B = dqiadT
    k32 = rdiv(2.0 * phys.ki, hi)

    a1 = hi * crho / (2.0 * dt) + k32 * (4.0 * dt * k32 + hi * crho) / (
        6.0 * dt * k32 + hi * crho
    ) + k12 * B / (k12 + B)
    b1 = (
        -hi / (2.0 * dt) * (crho * t1 + rdiv(qi * tfr_ice, t1))
        - I
        - k32 * (4.0 * dt * k32 * tbot + hi * crho * t2) / (6.0 * dt * k32 + hi * crho)
        + A * k12 / (k12 + B)
    )
    c1 = hi * qi * tfr_ice / (2.0 * dt)

    t1_new = -(b1 + torch.sqrt(ties.maximum(b1 * b1 - 4.0 * a1 * c1, 1e-20))) / (2.0 * a1)
    tsurf_new = (k12 * t1_new - A) / (k12 + B)

    # surface-melt recalculation (eqs 19-22; fe.cpp:6684-6698)
    melting = tsurf_new > tfr_surf
    a1m = a1 + k12 - k12 * B / (k12 + B)
    b1m = b1 - k12 * tfr_surf - A * k12 / (k12 + B)
    t1_melt = -(b1m + torch.sqrt(ties.maximum(b1m * b1m - 4.0 * a1m * c1, 1e-20))) / (2.0 * a1m)
    msurf = ties.maximum(k12 * (t1_melt - tfr_surf) - (A + B * tfr_surf), 0.0)
    t1 = ties.minimum(torch.where(melting, t1_melt, t1_new), -1e-6)
    tsurf = torch.where(melting, tfr_surf, tsurf_new)
    msurf = torch.where(melting, msurf, 0.0)

    # T2 (eq 15; fe.cpp:6701)
    t2 = (2.0 * dt * k32 * (t1 + 2.0 * tbot) + hi * crho * t2) / (6.0 * dt * k32 + hi * crho)

    # --- thickness changes (fe.cpp:6707-6790) -----------------------------
    h1 = hi / 2.0
    h2 = hi / 2.0
    e1 = crho * (t1 - tfr_ice) - qi * (1.0 - rdiv(tfr_ice, t1))  # (1) x rhoi
    e2 = crho * (t2 - tfr_ice) - qi  # (25) x rhoi

    hs = hs + snowfall / phys.rhos * dt

    # sublimation cascade (fe.cpp:6716-6741)
    s = subl * dt
    c1_ = s <= hs * phys.rhos
    c2_ = (~c1_) & (s - hs * phys.rhos <= h1 * phys.rhoi)
    c3_ = (~c1_) & (~c2_) & (s - h1 * phys.rhoi - hs * phys.rhos <= h2 * phys.rhoi)
    c4_ = (~c1_) & (~c2_) & (~c3_)
    h2 = torch.where(c3_, h2 - (s - h1 * phys.rhoi - hs * phys.rhos) / phys.rhoi, h2)
    h1 = torch.where(c2_, h1 - (s - hs * phys.rhos) / phys.rhoi, torch.where(c3_ | c4_, 0.0, h1))
    hs = torch.where(c1_, hs - s / phys.rhos, 0.0)
    h2 = torch.where(c4_, 0.0, h2)
    mlt_hi_top = ties.maximum(h1 + h2 - hi_old, 0.0)  # (fe.cpp:6742-6743)

    # bottom melt/growth (eqs 23-26, 31-34; fe.cpp:6745-6775)
    mbot = qio - 4.0 * phys.ki * (tbot - t2) / hi
    growth = mbot <= 0.0
    ebot = crho * (tbot - tfr_ice) - qi
    delh2_g = mbot * dt / ebot
    t2_g = (delh2_g * tbot + h2 * t2) / ties.maximum(delh2_g + h2, 1e-12)
    # melt branch
    delh2_m = -torch.minimum(-mbot * dt / e2, h2)
    delh1_m = -torch.minimum(ties.maximum(-(mbot * dt + e2 * h2) / e1, 0.0), h1)
    del_hs_mlt_b = -torch.minimum(ties.maximum((mbot * dt + e2 * h2 + e1 * h1) / qs, 0.0), hs)
    all_melts_b = (h2 + h1 + hs - delh2_m - delh1_m - del_hs_mlt_b) <= 0.0
    qio_refund_b = ties.maximum(mbot * dt - qs * hs + e1 * h1 + e2 * h2, 0.0) / dt
    qio = torch.where((~growth) & all_melts_b, qio - qio_refund_b, qio)

    t2 = torch.where(growth, t2_g, t2)
    h2 = torch.where(growth, h2 + delh2_g, h2 + delh2_m)
    h1 = torch.where(growth, h1, h1 + delh1_m)
    del_hs_mlt = torch.where(growth, 0.0, del_hs_mlt_b)
    hs = torch.where(growth, hs, hs + del_hs_mlt_b)
    mlt_hi_bot = torch.where(growth, 0.0, delh1_m + delh2_m)

    # surface melt (eqs 27-30; fe.cpp:6777-6790). NB the reference adds the
    # accumulated del_hs_mlt (bottom+surface) to hs here — kept for parity.
    dhs_s = -torch.minimum(msurf * dt / qs, hs)
    delh1_s = -torch.minimum(ties.maximum(-(msurf * dt - qs * hs) / e1, 0.0), h1)
    delh2_s = -torch.minimum(ties.maximum(-(msurf * dt - qs * hs + e1 * h1) / e2, 0.0), h2)
    del_hs_mlt = del_hs_mlt + dhs_s
    all_melts_s = (h2 + h1 + hs - delh2_s - delh1_s - del_hs_mlt) <= 0.0
    qio_refund_s = ties.maximum(msurf * dt - qs * hs + e1 * h1 + e2 * h2, 0.0) / dt
    qio = torch.where(all_melts_s, qio - qio_refund_s, qio)
    hs = hs + del_hs_mlt
    h1 = h1 + delh1_s
    h2 = h2 + delh2_s
    mlt_hi_top = mlt_hi_top + delh1_s + delh2_s

    # snow-to-ice (eqs 35-39; fe.cpp:6792-6808) — freeboard uses the
    # pre-melt hi, as the reference does
    del_hi_s2i = torch.zeros_like(hi)
    if p.flooding:
        freeboard = (hi * (phys.rhow - phys.rhoi) - hs * phys.rhos) / phys.rhow
        flood = freeboard < 0.0
        hs = torch.where(flood, hs + ties.minimum(freeboard * phys.rhoi / phys.rhos, 0.0), hs)
        delh1_f = torch.where(flood, ties.maximum(-freeboard, 0.0), 0.0)
        f1 = 1.0 - delh1_f / ties.maximum(delh1_f + h1, 1e-12)
        tbar = f1 * (t1 + rdiv(qi * tfr_ice, crho * t1)) + (1.0 - f1) * tfr_ice
        t1_f = _layer_evening_t1(tbar, tfr_ice, qi, crho)
        t1 = ties.minimum(torch.where(flood, t1_f, t1), -1e-6)
        h1 = h1 + delh1_f
        del_hi_s2i = delh1_f

    hi = h1 + h2

    # even out the two layers (eqs 38-40; fe.cpp:6810-6838)
    lower_bigger = h2 > h1
    f1a = h1 / ties.maximum(hi, 1e-12) * 2.0
    tbar_a = f1a * (t1 + rdiv(qi * tfr_ice, crho * t1)) + (1.0 - f1a) * t2
    t1_a = _layer_evening_t1(tbar_a, tfr_ice, qi, crho)
    f1b = (2.0 * h1 - hi) / ties.maximum(hi, 1e-12)
    t2_b = f1b * (t1 + rdiv(qi * tfr_ice, crho * t1)) + (1.0 - f1b) * t2
    has_hi = hi > 0.0
    t1 = ties.minimum(torch.where(lower_bigger, t1_a, t1), -1e-6)
    t2 = torch.where((~lower_bigger) & has_hi, t2_b, t2)
    # melt from both if T2 drifted above freezing (fe.cpp:6824-6837). The
    # denominator crosses zero near T1 ~ Tfr/2, a window float32 hits, so
    # its magnitude is clamped: the huge melt term then drives hi below
    # hmin and the cleanup below zeroes the cell (all ice melts).
    hot2 = (~lower_bigger) & has_hi & (t2 > tfr_ice)
    mlt_den = qi * t1 + (crho * t1 - qi) * (tfr_ice - t1)
    mlt_den = torch.where(
        torch.abs(mlt_den) < 1e3,
        torch.where(mlt_den >= 0.0, torch.full_like(mlt_den, 1e3), -1e3),
        mlt_den,
    )
    mlt_term = hi / 4.0 * crho * (t2 - tfr_ice) * t1 / mlt_den
    mlt_hi_top = torch.where(hot2, mlt_hi_top - mlt_term, mlt_hi_top)
    mlt_hi_bot = torch.where(hot2, mlt_hi_bot - mlt_term, mlt_hi_bot)
    hi = torch.where(hot2, hi - 2.0 * mlt_term, hi)
    t2 = torch.where(hot2, tfr_ice, t2)

    del_hi = hi - hi_old

    # too-thin cleanup (fe.cpp:6842-6862). Non-finite lanes (pathological
    # float32 corner states) go through the cleanup as fully melted rather
    # than propagating NaN (NaN < hmin is False).
    bad = ~(torch.isfinite(hi) & torch.isfinite(hs) & torch.isfinite(t1) & torch.isfinite(t2))
    hi = torch.where(bad, 0.0, hi)
    hs = torch.where(bad, 0.0, hs)
    del_hi = torch.where(bad, -hi_old, del_hi)
    thin = (hi < phys.hmin) | bad
    qio = torch.where(thin, qio - (-qs * hs + (e1 + e2) * hi / 2.0) / dt, qio)
    melt_scale = torch.where(del_hi < 0.0, -hi_old / ties.minimum(del_hi, -1e-15), 0.0)
    mlt_hi_top = torch.where(thin, mlt_hi_top * melt_scale, mlt_hi_top)
    mlt_hi_bot = torch.where(thin, mlt_hi_bot * melt_scale, mlt_hi_bot)
    del_hi_s2i = torch.where(thin, 0.0, del_hi_s2i)
    del_hi = torch.where(thin, -hi_old, del_hi)
    hi = torch.where(thin, 0.0, hi)
    hs = torch.where(thin, 0.0, hs)
    tsurf = torch.where(thin, tfr_ice, tsurf)
    t1 = torch.where(thin, tfr_ice, t1)
    t2 = torch.where(thin, tfr_ice, t2)

    # no-ice lanes (fe.cpp:6652-6661)
    hi = torch.where(no_ice, 0.0, hi)
    hs = torch.where(no_ice, 0.0, hs)
    hi_old = torch.where(no_ice, 0.0, hi_old)
    del_hi = torch.where(no_ice, 0.0, del_hi)
    del_hs_mlt = torch.where(no_ice, 0.0, del_hs_mlt)
    mlt_hi_top = torch.where(no_ice, 0.0, mlt_hi_top)
    mlt_hi_bot = torch.where(no_ice, 0.0, mlt_hi_bot)
    del_hi_s2i = torch.where(no_ice, 0.0, del_hi_s2i)
    tsurf = torch.where(no_ice, tfr_ice, tsurf)
    t1 = torch.where(no_ice, tfr_ice, t1)
    t2 = torch.where(no_ice, tfr_ice, t2)

    return dict(
        qio=qio, hi=hi, hs=hs, hi_old=hi_old, del_hi=del_hi,
        del_hs_mlt=del_hs_mlt, mlt_hi_top=mlt_hi_top, mlt_hi_bot=mlt_hi_bot,
        del_hi_s2i=del_hi_s2i, tsurf=tsurf, t1=t1, t2=t2,
    )


# ---------------------------------------------------------------------------
# Melt ponds (reference: meltPonds, fe.cpp:6538-6633)
# ---------------------------------------------------------------------------


def melt_ponds(p: ThermoParams, dt, conc, thick, tice0, hi, hs, mlt_hi_top, del_hs_mlt, qia,
               rain_on_ice, pond_volume, lid_volume):
    """Returns (pond_volume, lid_volume, pond_fraction)."""
    h_ice_min = 0.1
    conc_min = 0.1
    max_lid = 0.3
    min_lid = 1e-3
    i2w = phys.rhoi / phys.rhow
    s2w = phys.rhos / phys.rhow
    w2i = phys.rhow / phys.rhoi
    tfr_ice = -p.freezingpoint_mu * phys.si

    available = -mlt_hi_top * i2w - del_hs_mlt * s2w + rain_on_ice / phys.rhow * dt
    pond_volume = pond_volume + (1.0 - p.meltponds_roff) * available * conc

    flush = (
        (pond_volume <= 0.0)
        | (conc <= conc_min)
        | (torch.where(conc > 0.0, thick / ties.maximum(conc, 1e-15), 0.0) <= h_ice_min)
    )

    pond_fraction = torch.sqrt(ties.maximum(pond_volume, 1e-20) / p.meltponds_dep2frac)
    pond_fraction = torch.minimum(pond_fraction, 1.0 - hs / (hs + 0.2))
    pond_depth = torch.minimum(p.meltponds_dep2frac * pond_fraction, 0.9 * hi)
    pond_volume = pond_depth * pond_fraction
    pond_depth = ties.maximum(pond_depth, 0.05)
    pond_fraction = torch.minimum(
        pond_fraction, (lid_volume + pond_volume) / ties.maximum(pond_depth, 1e-15)
    )

    # lid growth/melt (fe.cpp:6596-6616)
    has_lid = (lid_volume > 0.0) & (pond_fraction > 1e-11)
    tpond = tfr_ice
    lid_thickness = ties.clip(
        lid_volume * w2i / ties.maximum(pond_fraction, 1e-15), min_lid, max_lid
    )
    qic = (tpond - tice0) / lid_thickness * phys.ki
    del_lid_thick = (ties.minimum(qia - qic, 0.0) + qic) * dt / (phys.rhoi * phys.Lf)
    del_lid_haslid = torch.maximum(del_lid_thick * i2w * pond_fraction, -lid_volume)
    del_lid_forms = dt * ties.maximum(qia, 0.0) / (phys.rhoi * phys.Lf) * i2w
    del_lid = torch.where(has_lid, del_lid_haslid, torch.where(qia > 0.0, del_lid_forms, 0.0))

    lid_volume = lid_volume + del_lid
    pond_volume = pond_volume - del_lid

    # remove lid if pond frozen solid or lid too thick (fe.cpp:6620-6629)
    kill = (pond_volume <= 0.0) | (
        lid_volume * w2i / ties.maximum(pond_fraction, 1e-15) >= max_lid
    )
    dead = flush | kill
    pond_volume = torch.where(dead, 0.0, pond_volume)
    lid_volume = torch.where(dead, 0.0, lid_volume)
    pond_fraction = torch.where(dead, 0.0, pond_fraction)
    return pond_volume, lid_volume, pond_fraction


# ---------------------------------------------------------------------------
# Ice-ocean heat flux (reference: iceOceanHeatflux, fe.cpp:6396-6432)
# ---------------------------------------------------------------------------


def ice_ocean_heatflux(p: ThermoParams, state, forcing, mld, dt):
    tbot = freezing_point(p, state.sss)
    if p.qio_type == "basic":
        return (state.sst - tbot) * phys.rhow * phys.cpw * mld / dt
    # exchange: element-mean |v_ice - v_ocean| (fe.cpp:6416-6426)
    rel_u = state.vt_u - forcing.ocean_u
    rel_v = state.vt_v - forcing.ocean_v
    rel = torch.sqrt(rel_u * rel_u + rel_v * rel_v + 1e-20)
    norm = stencil.cell_mean_of_nodes(rel)
    return (state.sst - tbot) * norm * p.Csens_io * phys.rhow * phys.cpw


# ---------------------------------------------------------------------------
# The thermo step (reference: FiniteElement::thermo, fe.cpp:5170-6148)
# ---------------------------------------------------------------------------


def _on(tinfo, key):
    """The flag ``key`` of ``tinfo``: a bool for a host number (None: off),
    a 0-dim bool tensor for a tensor."""
    if tinfo is None:
        return False
    v = tinfo[key]
    return v > 0.5 if isinstance(v, torch.Tensor) else float(v) > 0.5


def _pick(flag, a, b):
    """``a`` where ``flag`` is set, else ``b``: a Python branch on a bool, a
    ``torch.where`` on a tensor flag."""
    if isinstance(flag, bool):
        return a if flag else b
    return torch.where(flag, a, b)


def thermo_step(state, forcing, grid_arrays, dt: float, cfg_params: ThermoParams,
                tinfo: Dict | None = None, fsd_params=None, fsd_bins=None):
    """One full thermodynamics step. Returns (state, diag_dict).

    ``tinfo`` carries the per-step time flags is_day_start, is_day_end,
    is_0915, is_0801 and is_myi_reset_date as host numbers (1.0 or 0.0) or
    0-dim tensors, computed by the Simulator; None means all off.
    """
    p = cfg_params
    mask = grid_arrays["mask"]

    ddt = dt
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    rh0 = 1.0 / p.hnull
    rPhiF = 1.0 / p.PhiF
    tfr_ice = -p.freezingpoint_mu * phys.si
    zeros = lambda: torch.zeros_like(state.conc)  # noqa: E731

    diag: Dict = {}

    # =====================================================================
    # 2) atmospheric fluxes
    # =====================================================================
    wspeed = wind_speed_cells(forcing)
    sphuma = specific_humidity_air(p, forcing)

    obf = p.ocean_bulk_formula
    if obf != "nextsim":
        ow = ow_bulk_fluxes_aerobulk(p, state, forcing, wspeed, sphuma, scheme=obf)
    else:
        ow = ow_bulk_fluxes(p, state, forcing, wspeed, sphuma)
    qow = ow["qow"]
    diag["tau_ow"] = ow["tau_ow"]

    # previous-step pond fraction for the albedo (reference keeps
    # D_pond_fraction from the last step; recomputed below)
    pond_fraction_prev = torch.where(
        state.pond_volume > 0.0,
        torch.sqrt(ties.maximum(state.pond_volume, 1e-20) / p.meltponds_dep2frac),
        0.0,
    )

    ia = ia_bulk_fluxes(
        p, forcing, state.tice[0], state.snow_thick, state.conc,
        state.drag_ui, state.drag_ti, pond_fraction_prev, state.lid_volume,
        wspeed, sphuma, bulk_for_young=False,
    )
    qia, dqiadT, subl, I = ia["qia"], ia["dqiadT"], ia["subl"], ia["I"]  # noqa: E741

    if p.use_young_ice:
        ia_y = ia_bulk_fluxes(
            p, forcing, state.tsurf_young, state.hs_young, state.conc_young,
            state.drag_ui_young, state.drag_ti_young, pond_fraction_prev,
            state.lid_volume, wspeed, sphuma, bulk_for_young=True,
        )
    else:
        z = zeros()
        ia_y = dict(qia=z, qlw=z, qsw=z, qlh=z, qsh=z, I=z, subl=z, dqiadT=z,
                    albedo=z, drag_ui=state.drag_ui_young, drag_ti=state.drag_ti_young)

    # =====================================================================
    # 3) slab: save old volumes and concentrations (fe.cpp:5302-5322)
    # =====================================================================
    old_vol = state.thick
    old_conc = state.conc
    old_conc_young = state.conc_young if p.use_young_ice else zeros()
    old_conc_tot = old_conc + old_conc_young
    old_ow_fraction = 1.0 - old_conc_tot

    # snowfall (fe.cpp:5325-5338)
    if forcing.snowfr is not None:
        snowfall = forcing.precip * forcing.snowfr
    elif forcing.snowfall is not None:
        snowfall = forcing.snowfall
    else:
        snowfall = torch.where(forcing.tair < 0.0, forcing.precip, 0.0)
    snowfall = ties.maximum(snowfall, 0.0)

    mld = forcing.mld if forcing.mld is not None else torch.full_like(old_conc, p.constant_mld)

    # =====================================================================
    # 4) nudging fluxes (fe.cpp:5345-5367)
    # =====================================================================
    if p.ocean_type == "constant":
        qdw = forcing.qdw if forcing.qdw is not None else torch.full_like(old_conc, p.Qdw_const)
        fdw = forcing.fdw if forcing.fdw is not None else torch.full_like(old_conc, p.Fdw_const)
    elif p.ocean_type == "coupled":
        qdw = zeros()
        fdw = zeros()
        state = state.replace(sst=forcing.ocean_temp, sss=forcing.ocean_salt)
    else:
        qdw = -(state.sst - forcing.ocean_temp) * mld * phys.rhow * phys.cpw / p.ocean_nudge_timeT
        dels_nudge = state.sss - forcing.ocean_salt
        fdw = dels_nudge * mld * phys.rhow / (
            p.ocean_nudge_timeS * state.sss - ddt * dels_nudge
        )

    # =====================================================================
    # 5) vertical ice thermo (fe.cpp:5369-5417)
    # =====================================================================
    qio = ice_ocean_heatflux(p, state, forcing, mld, ddt)
    qio_young = qio
    tfrw = freezing_point(p, state.sss)

    if p.thermo_type == "winton":
        slab = thermo_winton(
            p, ddt, state.conc, state.thick, state.snow_thick, snowfall,
            qia, dqiadT, I, subl, tfrw, qio,
            state.tice[0], state.tice[1], state.tice[2],
        )
        t1_new, t2_new = slab["t1"], slab["t2"]
    else:
        slab = thermo_ice0(
            p, ddt, state.conc, state.thick, state.snow_thick, snowfall,
            qia, dqiadT, I, subl, tfrw, qio, state.tice[0],
        )
        t1_new, t2_new = state.tice[1], state.tice[2]
    qio = slab["qio"]
    hi, hs = slab["hi"], slab["hs"]
    hi_old = slab["hi_old"]
    del_hi = slab["del_hi"]
    del_hs_mlt = slab["del_hs_mlt"]
    mlt_hi_top, mlt_hi_bot = slab["mlt_hi_top"], slab["mlt_hi_bot"]
    del_hi_s2i = slab["del_hi_s2i"]
    tice0_new = slab["tsurf"]

    # young-ice slab (always zero-layer; fe.cpp:5419-5431)
    if p.use_young_ice:
        slab_y = thermo_ice0(
            p, ddt, state.conc_young, state.h_young, state.hs_young, snowfall,
            ia_y["qia"], ia_y["dqiadT"], ia_y["I"], ia_y["subl"], tfrw,
            qio_young, state.tsurf_young,
        )
        qio_young = slab_y["qio"]
        del_hi_young = slab_y["del_hi"]
        tsurf_young_new = slab_y["tsurf"]
        h_young = slab_y["hi"] * old_conc_young
        hs_young = slab_y["hs"] * old_conc_young
        del_hs_young_mlt = slab_y["del_hs_mlt"]
        mlt_hi_top_y, mlt_hi_bot_y = slab_y["mlt_hi_top"], slab_y["mlt_hi_bot"]
        del_hi_s2i_y = slab_y["del_hi_s2i"]
    else:
        z = zeros()
        del_hi_young = h_young = hs_young = z
        tsurf_young_new = state.tsurf_young
        del_hs_young_mlt = mlt_hi_top_y = mlt_hi_bot_y = del_hi_s2i_y = z

    # assimilation-compensating flux (fe.cpp:5433-5447)
    conc_pre_assim = old_conc + old_conc_young - state.conc_upd
    if p.use_assim_flux:
        qassm = torch.where(
            (conc_pre_assim > 0.0) & (state.conc_upd < 0.0),
            (qow * old_ow_fraction + qio * old_conc + qio_young * old_conc_young)
            * ((state.conc_upd / conc_pre_assim + 1.0) ** p.assim_flux_exponent - 1.0),
            0.0,
        )
    else:
        qassm = zeros()

    # =====================================================================
    # 6) open-water freezing and lateral melt (fe.cpp:5452-5649)
    # =====================================================================
    tw_new = state.sst - ddt * (qow + qassm) / (mld * phys.rhow * phys.cpw)
    supercooled = tw_new < tfrw
    newice = torch.where(
        supercooled,
        old_ow_fraction * (tfrw - tw_new) * mld * phys.rhow * phys.cpw / qi,
        0.0,
    )
    qow = torch.where(
        supercooled, -(tfrw - state.sst) * mld * phys.rhow * phys.cpw / ddt, qow
    )
    newice_stored = newice

    del_vi = newice + del_hi * old_conc
    mlt_vi_top = mlt_hi_top * old_conc
    mlt_vi_bot = mlt_hi_bot * old_conc
    del_vs_mlt = del_hs_mlt * old_conc
    snow2ice = del_hi_s2i * old_conc
    del_vi_young = zeros()
    if p.use_young_ice:
        del_vi_young = del_hi_young * old_conc_young
        del_vi = del_vi + del_hi_young * old_conc_young
        mlt_vi_top = mlt_vi_top + mlt_hi_top_y * old_conc_young
        mlt_vi_bot = mlt_vi_bot + mlt_hi_bot_y * old_conc_young
        snow2ice = snow2ice + del_hi_s2i_y * old_conc_young
        del_vs_mlt = del_vs_mlt + del_hs_young_mlt * old_conc_young

    conc = state.conc
    conc_young = state.conc_young
    newsnow = zeros()
    thick_dump = zeros()  # young ice dumped into thick (type 4)

    # --- freezing: new-ice distribution by newice_type (fe.cpp:5476-5556)
    if p.newice_type == 1:
        del_c = newice * rh0
    elif p.newice_type == 2:
        del_c = torch.where(
            hi_old > 0.0,
            newice * p.PhiF / ties.maximum(hi_old, 1e-15),
            torch.where(newice > 0.0, torch.ones_like(newice), 0.0),
        )
    elif p.newice_type == 3:
        h0 = (1.0 + 0.1 * wspeed) / 15.0
        del_c = newice / torch.maximum(rPhiF * hi_old, h0)
    elif p.newice_type == 4:
        # young-ice category (fe.cpp:5505-5551)
        h_young = h_young + newice
        conc_young = torch.minimum(1.0 - conc, conc_young + newice / p.h_young_min)

        has_young = conc_young > 0.0
        # young ice thinner than h_young_min: shrink its area
        thin_y = has_young & (h_young < p.h_young_min * conc_young)
        conc_young = torch.where(thin_y, h_young / p.h_young_min, conc_young)
        # young ice thicker than the sharp max: promote to old ice
        hi_y = h_young / ties.maximum(conc_young, 1e-15)
        thick_y = has_young & (~thin_y) & (hi_y > p.h_young_max_sharp)
        hs_y = ties.maximum(hs_young / ties.maximum(conc_young, 1e-15), 0.0)
        tmp_c = conc_young * (p.h_young_max_sharp - p.h_young_min) / ties.maximum(
            hi_y - p.h_young_min, 1e-15
        )
        del_c = torch.where(thick_y, ties.maximum(conc_young - tmp_c, 0.0), 0.0)
        conc_young2 = torch.where(thick_y, tmp_c, conc_young)
        tmp_v = conc_young2 * p.h_young_max_sharp
        newice = torch.where(thick_y, ties.maximum(h_young - tmp_v, 0.0), 0.0)
        h_young = torch.where(thick_y, tmp_v, h_young)
        tmp_s = conc_young2 * hs_y
        newsnow = torch.where(thick_y, ties.maximum(hs_young - tmp_s, 0.0), 0.0)
        hs_young = torch.where(thick_y, tmp_s, hs_young)
        conc_young = conc_young2
        # no room for young ice at all: dump it into old ice (fe.cpp:5543-5551)
        no_young = ~has_young
        newice = torch.where(no_young, h_young, newice)
        newsnow = torch.where(no_young, hs_young, newsnow)
        # the reference also adds h_young to M_thick here, which only
        # matters for the Winton new-ice mixing fraction below
        thick_dump = torch.where(no_young, h_young, 0.0)
        h_young = torch.where(no_young, 0.0, h_young)
        hs_young = torch.where(no_young, 0.0, hs_young)
    else:
        raise ValueError(f"newice_type {p.newice_type}")

    del_c = torch.minimum(1.0 - conc, del_c)

    # --- melting: lateral melt by melt_type (fe.cpp:5560-5649)
    melting = del_hi < 0.0
    if p.melt_type == 1:
        del_c_melt = torch.where(
            conc < 1.0, del_hi * conc * p.PhiM / ties.maximum(hi_old, 1e-15), 0.0
        )
        del_c = del_c + torch.where(melting, del_c_melt, 0.0)
    elif p.melt_type == 2:
        has_hi = hi > 0.0
        lat_melt = (
            p.PhiM * (1.0 - conc) * ties.minimum(qow, 0.0) * ddt
            / ties.maximum(hi * qi + hs * qs, 1e-15)
        )
        del_c = del_c + torch.where(melting & has_hi, lat_melt, 0.0)
        qow = torch.where(melting & has_hi, qow * (1.0 - p.PhiM), qow)
        del_c = torch.where(melting & (~has_hi), -conc, del_c)
    elif p.melt_type == 3:
        # FSD-dependent lateral melt (fe.cpp:5596-5649; Roach et al. 2018)
        if state.conc_fsd is None or fsd_params is None:
            raise ValueError("melt_type=3 requires wave_coupling.num_fsd_bins > 0")
        dcf, dcy, qow, lat_melt_rate = fsd_ops.lateral_melt_type3(
            state.conc_fsd, conc, conc_young, h_young, hi, hs, qow,
            tw_new, tfrw, del_hi, ddt, p.PhiM, p.h_young_min,
            fsd_params, fsd_bins,
        )
        del_c = del_c + dcf
        conc_young = ties.clip(conc_young + dcy, 0.0, 1.0)
    else:
        raise ValueError(f"melt_type {p.melt_type}")

    # =====================================================================
    # freeze-day / summer trackers (fe.cpp:5652-5697)
    # =====================================================================
    vi_tend = _pick(_on(tinfo, "is_day_start"), zeros(), state.del_vi_tend)
    del_vi_tend = vi_tend + del_vi * ddt
    day_end = _on(tinfo, "is_day_end")
    if day_end is not False:
        freezing_day = del_vi_tend > 0.0
        melting_day = del_vi_tend < 0.0
        freeze_days = _pick(day_end, torch.where(
            freezing_day, state.freeze_days + 1.0,
            torch.where(melting_day, 0.0, state.freeze_days),
        ), state.freeze_days)
    else:
        freeze_days = state.freeze_days
    use_young_in_reset = p.include_young_ice and p.reset_by_date
    young_in_reset = p.use_young_ice and use_young_in_reset
    if day_end is not False:
        conc_summer_cand = conc + ties.minimum(del_c, 0.0)
        thick_summer_cand = state.thick + ties.minimum(del_vi, 0.0)
        if young_in_reset:
            conc_summer_cand = conc_summer_cand + conc_young
            thick_summer_cand = thick_summer_cand + h_young
        conc_summer = _pick(day_end, torch.where(melting_day, ties.clip(conc_summer_cand, 0.0, 1.0),
                                                 state.conc_summer), state.conc_summer)
        thick_summer = _pick(day_end, torch.where(melting_day, ties.maximum(thick_summer_cand, 0.0),
                                                  state.thick_summer), state.thick_summer)
    else:
        conc_summer, thick_summer = state.conc_summer, state.thick_summer

    # =====================================================================
    # new concentration & volume/energy conservation (fe.cpp:5699-5733)
    # =====================================================================
    conc = conc + del_c
    ok = conc >= phys.cmin
    hi_cons = (hi * old_conc + newice) / ties.maximum(conc, phys.cmin)
    hi = torch.where(ok, hi_cons, hi)
    shrunk = del_c < 0.0
    qow = torch.where(ok & shrunk, qow - del_c * hs * qs / ddt, qow)
    hs_cons = (hs * old_conc + newsnow) / ties.maximum(conc, phys.cmin)
    hs = torch.where(ok & (~shrunk), hs_cons, hs)

    if p.thermo_type == "winton":
        # mix new ice into both layers (fe.cpp:5725-5732; Winton eqs 38-39)
        thick_before = state.thick + thick_dump
        f1 = thick_before / ties.maximum(thick_before + newice, 1e-15)
        mu_si_lf_c = p.freezingpoint_mu * phys.si * phys.Lf / phys.C
        t1_safe = ties.minimum(t1_new, -1e-6)
        tbar = f1 * (t1_safe - rdiv(mu_si_lf_c, t1_safe)) + (1.0 - f1) * tfrw
        t1_mixed = (tbar - torch.sqrt(tbar * tbar + 4.0 * mu_si_lf_c + 1e-20)) / 2.0
        t2_mixed = f1 * t2_new + (1.0 - f1) * tfrw
        mix = ok & (newice > 0.0)
        t1_new = torch.where(mix, t1_mixed, t1_new)
        t2_new = torch.where(mix, t2_mixed, t2_new)

    # limits: melt residual ice away (fe.cpp:5736-5760)
    gone = (conc < phys.cmin) | (hi < phys.hmin)
    qow = torch.where(gone, qow + conc * hi * qi / ddt + conc * hs * qs / ddt, qow)
    conc = torch.where(gone, 0.0, conc)
    tice0_new = torch.where(gone, tfr_ice, tice0_new)
    t1_new = torch.where(gone, tfr_ice, t1_new)
    t2_new = torch.where(gone, tfr_ice, t2_new)
    hi = torch.where(gone, 0.0, hi)
    hs = torch.where(gone, 0.0, hs)
    ridge_ratio = torch.where(gone, 0.0, state.ridge_ratio)

    # FSD reshaping under lateral melt (fe.cpp:5770-5775 ->
    # redistributeThermoFSD); shape closure happens in the step-level
    # update_fsd rescale
    conc_fsd_new = state.conc_fsd
    if p.melt_type == 3 and state.conc_fsd is not None:
        conc_fsd_new = fsd_ops.redistribute_thermo_fsd(
            state.conc_fsd, lat_melt_rate, ddt, fsd_params, fsd_bins
        )

    # 7) effective thickness (fe.cpp:5798-5800)
    thick = hi * conc
    snow_thick = hs * conc

    # =====================================================================
    # 8) slab ocean (fe.cpp:5803-5847)
    # =====================================================================
    rain_on_ice = ties.maximum(forcing.precip - snowfall, 0.0)
    rain = old_ow_fraction * forcing.precip + old_conc_tot * rain_on_ice
    emp = ow["evap"] * old_ow_fraction - rain

    pond_volume, lid_volume = state.pond_volume, state.lid_volume
    pond_fraction = zeros()
    if p.use_meltponds:
        pond_volume, lid_volume, pond_fraction = melt_ponds(
            p, ddt, conc, thick, tice0_new, hi, hs, mlt_hi_top, del_hs_mlt,
            qia, rain_on_ice, pond_volume, lid_volume,
        )

    qio_mean = qio * old_conc + qio_young * old_conc_young
    qow_mean = qow * old_ow_fraction

    sst = state.sst
    sss = state.sss
    if p.ocean_type != "coupled":
        sst = sst - ddt * (qio_mean + qow_mean - qdw + qassm) / (phys.rhow * phys.cpw * mld)

    denom = mld * phys.rhow - del_vi * phys.rhoi - (
        del_vs_mlt * phys.rhos + (emp - fdw) * ddt
    )
    denom = ties.maximum(denom, phys.rhow)
    si_eff = ties.minimum(sss, phys.si)
    delsss = (
        (sss - si_eff) * phys.rhoi * del_vi
        + sss * (del_vs_mlt * phys.rhos + (emp - fdw) * ddt)
    ) / denom
    if p.ocean_type != "coupled":
        sss = sss + delsss

    # ridge ratio conservation on growth (fe.cpp:5849-5852)
    ridge_ratio = torch.where(
        thick > old_vol, ridge_ratio * old_vol / ties.maximum(thick, 1e-15), ridge_ratio
    )

    # =====================================================================
    # 9) temperature-dependent healing (fe.cpp:5857-5886)
    # =====================================================================
    time_relaxation_damage = state.time_relaxation_damage
    if p.temp_dep_healing:
        tbot_h = freezing_point(p, sss)
        if p.thermo_type == "zero-layer":
            Ch = phys.ki * snow_thick / (p.snow_cond * ties.maximum(thick, 1e-15))
            deltaT = ties.maximum(tbot_h - tice0_new, 1e-36) / (1.0 + Ch)
        else:
            Ch = phys.ki * snow_thick / (p.snow_cond * ties.maximum(thick, 1e-15) / 4.0)
            deltaT = ties.maximum(tbot_h + Ch * (tbot_h - t1_new) - tice0_new, 1e-36) / (1.0 + Ch)
        trd = ties.maximum(
            rdiv(p.time_relaxation_damage * p.deltaT_relaxation_damage, deltaT), ddt
        )
        time_relaxation_damage = torch.where(thick > 0.0, trd, 1e36)

    # =====================================================================
    # 10) flux diagnostics (fe.cpp:5891-5970)
    # =====================================================================
    def by_area(key):
        return ia[key] * old_conc + ia_y[key] * old_conc_young + ow[key] * old_ow_fraction

    diag["qa"] = qia * old_conc + ia_y["qia"] * old_conc_young + qow * old_ow_fraction
    for key in ("qsw", "qlw", "qsh", "qlh"):
        diag[key] = by_area(key)
    diag["qo"] = qio_mean + qow_mean
    diag["qnosun"] = qio_mean + old_ow_fraction * (ow["qlw"] + ow["qlh"] + ow["qsh"])
    diag["qsw_ocean"] = old_ow_fraction * ow["qsw"]
    diag["qassim"] = qassm
    diag["dels"] = delsss * phys.rhow * mld * phys.days_in_sec / dt
    diag["fwflux_ice"] = -1.0 / ddt * (
        (1.0 - 1e-3 * si_eff) * phys.rhoi * del_vi + phys.rhos * del_vs_mlt
    )
    diag["fwflux"] = diag["fwflux_ice"] - emp
    diag["brine"] = -1e-3 * si_eff * phys.rhoi * del_vi / ddt
    diag["evap"] = ow["evap"] * old_ow_fraction
    diag["rain"] = rain
    diag["vice_melt"] = del_vi * phys.days_in_sec / ddt
    diag["del_vi_young"] = del_vi_young * phys.days_in_sec / ddt
    diag["del_hi"] = del_hi * phys.days_in_sec / ddt
    diag["del_hi_young"] = del_hi_young * phys.days_in_sec / ddt
    diag["newice"] = newice_stored * phys.days_in_sec / ddt
    diag["mlt_top"] = mlt_vi_top * phys.days_in_sec / ddt
    diag["mlt_bot"] = mlt_vi_bot * phys.days_in_sec / ddt
    diag["snow2ice"] = snow2ice * phys.days_in_sec / ddt
    sialb = old_conc * ia["albedo"]
    if p.use_young_ice:
        sialb = sialb + old_conc_young * ia_y["albedo"]
    diag["albedo"] = sialb + ties.maximum(old_ow_fraction, 0.0) * p.ocean_albedo
    diag["sialb"] = torch.where(old_conc_tot > 0.0, sialb / ties.maximum(old_conc_tot, 1e-15), 0.0)
    diag["pond_fraction"] = pond_fraction

    # =====================================================================
    # 10b) ice age & multiyear-ice tracers (fe.cpp:5973-6130)
    # =====================================================================
    no_ice_tr = (conc < phys.cmin) | (thick < conc * phys.hmin)

    is_0915 = _on(tinfo, "is_0915")
    fyi = zeros() if is_0915 is True else ties.clip(state.fyi_fraction + del_c, 0.0, 1.0)
    if isinstance(is_0915, torch.Tensor):
        fyi = torch.where(is_0915, zeros(), fyi)

    w_age = torch.where(old_conc <= 0.0, 0.0, ties.minimum(old_conc / ties.maximum(conc, 1e-15), 1.0))
    age_det = w_age * (state.age_det + dt) + ties.maximum((1.0 - w_age) * dt, 0.0)
    w_agev = torch.where(old_vol <= 0.0, 0.0, ties.minimum(old_vol / ties.maximum(thick, 1e-15), 1.0))
    age = w_agev * (state.age + dt) + ties.maximum((1.0 - w_agev) * dt, 0.0)

    # MYI reset logic (fe.cpp:6040-6106)
    conc_myi, thick_myi = state.conc_myi, state.thick_myi
    freeze_onset = state.freeze_onset
    if p.reset_by_date:
        reset_myi = _on(tinfo, "is_myi_reset_date")
    else:
        reset_myi = (freeze_days >= p.reset_freeze_days) & (freeze_onset <= 0.5)
        freeze_onset = torch.where(reset_myi, 1.0, freeze_onset)

    # Aug 1: reset onset + summer trackers (fe.cpp:6059-6080)
    young_tot = conc_young if young_in_reset else None
    aug1 = _on(tinfo, "is_0801")
    if aug1 is not False:
        ctot_aug = conc + conc_young if p.use_young_ice else conc
        freeze_onset = _pick(aug1, torch.where(ctot_aug == 0.0, torch.ones_like(conc), 0.0), freeze_onset)
        conc_summer = _pick(aug1, ties.clip(conc if young_tot is None else conc + conc_young, 0.0, 1.0),
                            conc_summer)
        thick_summer = _pick(aug1, ties.maximum(thick + h_young if young_in_reset else thick, 0.0),
                             thick_summer)
    freeze_onset = torch.round(freeze_onset)

    c_myi_max = conc + conc_young if young_in_reset else conc
    v_myi_max = thick + h_young if young_in_reset else thick

    old_conc_myi, old_thick_myi = conc_myi, thick_myi
    if p.reset_by_date:
        conc_myi_reset = ties.clip(c_myi_max, 0.0, 1.0)
        thick_myi_reset = ties.maximum(v_myi_max, 0.0)
    else:
        conc_myi_reset = ties.clip(
            torch.minimum(c_myi_max, torch.maximum(conc_summer, conc_myi)), 0.0, 1.0
        )
        thick_myi_reset = ties.maximum(
            torch.minimum(v_myi_max, torch.maximum(thick_summer, thick_myi)), 0.0
        )

    # melt-only myi decay on non-reset days (fe.cpp:6090-6118)
    some_melt = (thick < old_vol) & (old_conc > 0.0) & (old_vol > 0.0)
    if p.equal_melting:
        del_c_ratio = ties.minimum(conc / ties.maximum(old_conc, 1e-15), 1.0)
        del_v_ratio = ties.minimum(thick / ties.maximum(old_vol, 1e-15), 1.0)
        dci = ties.minimum(conc_myi * (del_c_ratio - 1.0), 0.0)
        dvi = ties.minimum(thick_myi * (del_v_ratio - 1.0), 0.0)
    else:
        dci = dvi = zeros()
    conc_myi_melt = ties.maximum(conc_myi + torch.where(some_melt, dci, 0.0), 0.0)
    conc_myi_melt = torch.minimum(conc_myi_melt, torch.where(some_melt, c_myi_max, math.inf))
    thick_myi_melt = ties.maximum(thick_myi + torch.where(some_melt, dvi, 0.0), 0.0)
    thick_myi_melt = torch.minimum(thick_myi_melt, torch.where(some_melt, v_myi_max, math.inf))

    if isinstance(reset_myi, bool):  # reset by date: one host flag
        conc_myi = conc_myi_reset if reset_myi else conc_myi_melt
        thick_myi = thick_myi_reset if reset_myi else thick_myi_melt
        del_c_myi, del_v_myi = conc_myi - old_conc_myi, thick_myi - old_thick_myi
        z = zeros()
        del_ci_rplnt, del_vi_rplnt = (del_c_myi, del_v_myi) if reset_myi else (z, z)
        del_ci_mlt, del_vi_mlt = (z, z) if reset_myi else (del_c_myi, del_v_myi)
    else:
        conc_myi = torch.where(reset_myi, conc_myi_reset, conc_myi_melt)
        thick_myi = torch.where(reset_myi, thick_myi_reset, thick_myi_melt)
        del_ci_rplnt = torch.where(reset_myi, conc_myi - old_conc_myi, 0.0)
        del_vi_rplnt = torch.where(reset_myi, thick_myi - old_thick_myi, 0.0)
        del_ci_mlt = torch.where(~reset_myi, conc_myi - old_conc_myi, 0.0)
        del_vi_mlt = torch.where(~reset_myi, thick_myi - old_thick_myi, 0.0)

    # no-ice tracer reset (fe.cpp:5985-5995)
    fyi = torch.where(no_ice_tr, 0.0, fyi)
    age_det = torch.where(no_ice_tr, 0.0, age_det)
    age = torch.where(no_ice_tr, 0.0, age)
    conc_myi = torch.where(no_ice_tr, 0.0, conc_myi)
    thick_myi = torch.where(no_ice_tr, 0.0, thick_myi)
    freeze_days = torch.where(no_ice_tr, 0.0, freeze_days)
    freeze_onset = torch.where(no_ice_tr, 1.0, freeze_onset)

    diag["del_ci_mlt_myi"] = del_ci_mlt * phys.days_in_sec / ddt
    diag["del_vi_mlt_myi"] = del_vi_mlt * phys.days_in_sec / ddt
    diag["del_ci_rplnt_myi"] = del_ci_rplnt * phys.days_in_sec / ddt
    diag["del_vi_rplnt_myi"] = del_vi_rplnt * phys.days_in_sec / ddt

    # =====================================================================
    # write back (masked to ocean cells)
    # =====================================================================
    young_updates = {}
    if p.use_young_ice:
        young_updates = dict(
            h_young=h_young * mask,
            hs_young=hs_young * mask,
            conc_young=ties.clip(conc_young, 0.0, 1.0) * mask,
            tsurf_young=tsurf_young_new,
            drag_ui_young=ia_y["drag_ui"],
            drag_ti_young=ia_y["drag_ti"],
        )

    state = state.replace(
        conc=ties.clip(conc, 0.0, 1.0) * mask,
        thick=ties.maximum(thick, 0.0) * mask,
        snow_thick=ties.maximum(snow_thick, 0.0) * mask,
        tice=torch.stack([tice0_new, t1_new, t2_new]),
        sst=sst,
        sss=ties.maximum(sss, 0.0),
        ridge_ratio=ridge_ratio,
        fyi_fraction=fyi,
        age_det=age_det,
        age=age,
        conc_myi=conc_myi,
        thick_myi=thick_myi,
        conc_summer=conc_summer,
        thick_summer=thick_summer,
        freeze_days=freeze_days,
        freeze_onset=freeze_onset,
        del_vi_tend=del_vi_tend,
        pond_volume=pond_volume,
        lid_volume=lid_volume,
        drag_ui=ia["drag_ui"],
        drag_ti=ia["drag_ti"],
        time_relaxation_damage=time_relaxation_damage,
        conc_fsd=conc_fsd_new,
        **young_updates,
    )
    return state, diag


# ---------------------------------------------------------------------------
# AeroBulk-family ocean bulk fluxes (reference: #ifdef AEROBULK path of
# OWBulkFluxes, fe.cpp:5041-5100, over the str2oblk map fe.cpp:1254-1263).
# The turbulent scales come from ops/aerobulk.py; the radiative terms are
# assembled as in the nextsim formula.
# ---------------------------------------------------------------------------


def ow_bulk_fluxes_aerobulk(p: ThermoParams, state, forcing, wspeed, sphuma,
                            scheme: str = "coare3.0"):
    """Open-water fluxes through one of the five named AeroBulk algorithms
    (coare3.0 / coare3.6 / ncar / ecmwf / andreas)."""
    from benchmark.reference.plain.ops import aerobulk

    sst = state.sst
    sstK = sst + phys.tfrwK
    sphumw = 0.98 * specific_humidity_water(sst)  # salinity reduction factor
    rhoair = air_density(forcing.mslp, forcing.tair, sphuma)
    u = ties.maximum(wspeed, 0.1)

    scales = aerobulk.turbulent_scales(
        scheme, u, sst, forcing.tair, sphuma, sphumw,
        zu=p.zref_wind, zt=p.zref_temp,
    )
    ustar, tstar, qstar = scales["ustar"], scales["tstar"], scales["qstar"]

    qsh = -rhoair * phys.cpa * ustar * tstar
    lv = _latent_heat_vap(sst)
    qlh = ties.maximum(-rhoair * lv * ustar * qstar, 0.0)
    evap = qlh / lv
    tau_ow = rhoair * _fast_pow(ustar / u, 2)  # rho * Cd

    qsw = -forcing.qsw_in * (1.0 - p.ocean_albedo)
    qlw_out = phys.eps * phys.sigma_sb * _fast_pow(sstK, 4)
    qlw = qlw_out - incoming_longwave(p, forcing, state.tice[0])
    qow = qlw + qsh + qlh + _qsw_into_slab(forcing, qsw)
    return dict(qow=qow, qlw=qlw, qsw=qsw, qlh=qlh, qsh=qsh, evap=evap, tau_ow=tau_ow)
