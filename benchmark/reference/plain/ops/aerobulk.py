"""Ocean-atmosphere turbulent bulk-flux algorithms, the AeroBulk family (the
counterpart of nextsim_tpu/ops/aerobulk.py).

``thermo.ocean_bulk_formula`` selects one of five named algorithms
(reference: model/finiteelement.cpp:1254-1263 str2oblk map; the call site
OWBulkFluxes #ifdef AEROBULK path, fe.cpp:5041-5100):

* ``coare3.0`` — Fairall et al. (2003);
* ``coare3.6`` — Edson et al. (2013);
* ``ncar``     — Large & Yeager (2009);
* ``ecmwf``    — IFS documentation (Cy31+), Beljaars & Holtslag stable forms;
* ``andreas``  — Andreas et al. (2015) u* closure with the COARE scalar law.

Every scheme runs a fixed count of Monin-Obukhov fixed-point iterations as a
plain Python loop over tensors, with the JAX package's term order. The
returned scales satisfy ``Qsh_up = -rho*cpa*ustar*tstar`` and
``Qlh_up = -rho*Lv*ustar*qstar``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.plain.core import constants as phys
from benchmark.reference.plain.core import ties
from benchmark.reference.plain.ops.rheology import _fast_pow, rdiv

NU_AIR = 1.5e-5  # kinematic viscosity of air [m2/s]

_SQRT3 = math.sqrt(3.0)


# ---------------------------------------------------------------------------
# stability (psi) function families
# ---------------------------------------------------------------------------

def _kansas_m(x):
    return (
        2.0 * torch.log(0.5 * (1.0 + x))
        + torch.log(0.5 * (1.0 + x * x))
        - 2.0 * torch.atan(x)
        + 0.5 * math.pi
    )


def _psi_m_paulson(z):
    """Paulson (1970) momentum psi: Kansas unstable, linear stable."""
    x = ties.pow(1.0 - 16.0 * ties.minimum(z, 0.0), 0.25)
    return torch.where(z < 0.0, _kansas_m(x), -5.0 * ties.maximum(z, 0.0))


def _psi_h_paulson(z):
    x = torch.sqrt(torch.abs(1.0 - 16.0 * ties.minimum(z, 0.0)))
    unstable = 2.0 * torch.log(0.5 * (1.0 + x))
    return torch.where(z < 0.0, unstable, -5.0 * ties.maximum(z, 0.0))


def _psi_convective(y):
    return (
        1.5 * torch.log((1.0 + y + y * y) / 3.0)
        - _SQRT3 * torch.atan((1.0 + 2.0 * y) / _SQRT3)
        + math.pi / _SQRT3
    )


def _psi_m_coare(z):
    """COARE blended psi_m (Fairall et al. 2003, Eq. A3/A4)."""
    zn = ties.minimum(z, 0.0)
    psik = _kansas_m(ties.pow(1.0 - 15.0 * zn, 0.25))
    psic = _psi_convective(ties.pow(1.0 - 10.15 * zn, 1.0 / 3.0))
    f = zn * zn / (1.0 + zn * zn)
    unstable = (1.0 - f) * psik + f * psic
    zp = ties.maximum(z, 0.0)
    c = ties.minimum(0.35 * zp, 50.0)
    stable = -((1.0 + zp) + 0.6667 * (zp - 14.28) * torch.exp(-c) + 8.525)
    return torch.where(z < 0.0, unstable, stable)


def _psi_h_coare(z):
    zn = ties.minimum(z, 0.0)
    x = torch.sqrt(torch.abs(1.0 - 15.0 * zn))
    psik = 2.0 * torch.log(0.5 * (1.0 + x))
    psic = _psi_convective(ties.pow(1.0 - 34.15 * zn, 1.0 / 3.0))
    f = zn * zn / (1.0 + zn * zn)
    unstable = (1.0 - f) * psik + f * psic
    zp = ties.maximum(z, 0.0)
    c = ties.minimum(0.35 * zp, 50.0)
    stable = -(
        ties.pow(1.0 + 2.0 * zp / 3.0, 1.5) + 0.6667 * (zp - 14.28) * torch.exp(-c) + 8.525
    )
    return torch.where(z < 0.0, unstable, stable)


# Beljaars & Holtslag (1991) stable forms used by the IFS
_BH_A, _BH_B, _BH_C, _BH_D = 1.0, 2.0 / 3.0, 5.0, 0.35


def _psi_m_ecmwf(z):
    zn = ties.minimum(z, 0.0)
    unstable = _kansas_m(ties.pow(1.0 - 16.0 * zn, 0.25))
    zp = ties.maximum(z, 0.0)
    stable = -(
        _BH_A * zp
        + _BH_B * (zp - _BH_C / _BH_D) * torch.exp(-ties.minimum(_BH_D * zp, 50.0))
        + _BH_B * _BH_C / _BH_D
    )
    return torch.where(z < 0.0, unstable, stable)


def _psi_h_ecmwf(z):
    zn = ties.minimum(z, 0.0)
    x = torch.sqrt(torch.abs(1.0 - 16.0 * zn))
    unstable = 2.0 * torch.log(0.5 * (1.0 + x))
    zp = ties.maximum(z, 0.0)
    stable = -(
        ties.pow(1.0 + 2.0 * _BH_A * zp / 3.0, 1.5)
        + _BH_B * (zp - _BH_C / _BH_D) * torch.exp(-ties.minimum(_BH_D * zp, 50.0))
        + _BH_B * _BH_C / _BH_D
        - 1.0
    )
    return torch.where(z < 0.0, unstable, stable)


# ---------------------------------------------------------------------------
# per-scheme roughness closures: (ustar, u10n) -> (z0, z0t, z0q)
# ---------------------------------------------------------------------------

def _rough_coare30(ustar, u10n):
    charn = ties.clip(0.011 + (0.018 - 0.011) * (u10n - 10.0) / 8.0, 0.011, 0.018)
    us = ties.maximum(ustar, 1e-4)
    z0 = charn * us * us / phys.g + rdiv(0.11 * NU_AIR, us)
    rr = z0 * us / NU_AIR
    z0q = ties.minimum(5.5e-5 * rr ** -0.6, 1.15e-4)
    return z0, z0q, z0q  # COARE 3.0 uses the same scalar roughness for t and q


def _rough_coare36(ustar, u10n):
    # Edson et al. (2013): Charnock linear in wind, capped (AeroBulk coare3p6)
    charn = ties.clip(0.0017 * u10n - 0.005, 0.011, 0.028)
    us = ties.maximum(ustar, 1e-4)
    z0 = charn * us * us / phys.g + rdiv(0.11 * NU_AIR, us)
    rr = z0 * us / NU_AIR
    z0q = ties.minimum(5.8e-5 * rr ** -0.72, 1.6e-4)
    return z0, z0q, z0q


def _rough_ecmwf(ustar, u10n):
    us = ties.maximum(ustar, 1e-4)
    z0 = rdiv(0.11 * NU_AIR, us) + 0.018 * us * us / phys.g
    z0t = rdiv(0.40 * NU_AIR, us)
    z0q = rdiv(0.62 * NU_AIR, us)
    return z0, z0t, z0q


def _ustar_andreas(u10n):
    """Andreas et al. (2015) Eq. 4.2: friction velocity directly from the
    neutral 10-m wind."""
    w = u10n - 8.271
    return 0.239 + 0.0433 * (w + torch.sqrt(0.12 * w * w + 0.181))


_SCHEMES = ("coare3.0", "coare3.6", "ncar", "ecmwf", "andreas")


def _nonzero(wflux):
    return torch.where(torch.abs(wflux) > 1e-12, wflux, 1e-12)


def turbulent_scales(scheme: str, u, sst, tair, sphuma, sphumw,
                     zu: float = 10.0, zt: float = 2.0, n_iter: int = 6):
    """Monin-Obukhov scales (ustar, tstar, qstar) + transfer coefficients.

    ``sst`` and ``tair`` in deg C, ``u`` the wind speed at ``zu``. The
    air-surface gradients are ``dtheta = tair + Gamma_d*zt - sst`` and
    ``dq = sphuma - sphumw``. Returns dict(ustar, tstar, qstar, cd, ch, ce,
    u10n).
    """
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown aerobulk scheme {scheme!r} (allowed: {_SCHEMES})")

    kv = phys.vonKarman
    g = phys.g
    u = ties.maximum(u, 0.1)
    tairK = tair + phys.tfrwK
    dtheta = tair + phys.Gamma_d * zt - sst  # air minus surface, potential
    dq = sphuma - sphumw
    tv = tairK * (1.0 + 0.61 * sphuma)  # virtual temperature

    if scheme == "ncar":
        return _ncar_scales(u, dtheta, dq, tv, sphuma, tairK, zu, zt, n_iter)

    rough = {
        "coare3.0": _rough_coare30,
        "coare3.6": _rough_coare36,
        "ecmwf": _rough_ecmwf,
        "andreas": _rough_coare30,  # scalar roughness stand-in
    }[scheme]
    psi_m, psi_h = {
        "coare3.0": (_psi_m_coare, _psi_h_coare),
        "coare3.6": (_psi_m_coare, _psi_h_coare),
        "ecmwf": (_psi_m_ecmwf, _psi_h_ecmwf),
        "andreas": (_psi_m_paulson, _psi_h_paulson),
    }[scheme]
    # convective gustiness (Fairall et al. 1996): beta*(Bf*zi)^(1/3)
    gust_beta, gust_zi = {
        "coare3.0": (1.2, 600.0),
        "coare3.6": (1.2, 600.0),
        "ecmwf": (1.0, 1000.0),
        "andreas": (0.0, 600.0),
    }[scheme]

    ustar = 0.035 * u
    tstar = torch.zeros_like(u)
    qstar = torch.zeros_like(u)
    u10n = u
    ublend = u
    log_zu10 = math.log(zu / 10.0)
    for _ in range(n_iter):
        z0, z0t, z0q = rough(ustar, u10n)
        wflux = tstar * (1.0 + 0.61 * sphuma) + 0.61 * tairK * qstar
        L = tv * ustar * ustar / (kv * g * _nonzero(wflux))
        zeta_u = ties.clip(rdiv(zu, L), -10.0, 10.0)
        zeta_t = ties.clip(rdiv(zt, L), -10.0, 10.0)
        if gust_beta > 0.0:
            bf = ties.maximum(rdiv(-g, tv) * ustar * wflux, 1e-9)
            ug = gust_beta * ties.pow(bf * gust_zi, 1.0 / 3.0)
            ublend = torch.sqrt(u * u + ug * ug)
        cd_sqrt = rdiv(kv, torch.log(rdiv(zu, z0)) - psi_m(zeta_u))
        ch_fac = rdiv(kv, torch.log(rdiv(zt, ties.maximum(z0t, 1e-9))) - psi_h(zeta_t))
        ce_fac = rdiv(kv, torch.log(rdiv(zt, ties.maximum(z0q, 1e-9))) - psi_h(zeta_t))
        if scheme == "andreas":
            ustar = ties.maximum(_ustar_andreas(u10n), 1e-4)
        else:
            ustar = ties.maximum(cd_sqrt * ublend, 1e-4)
        tstar = ch_fac * dtheta
        qstar = ce_fac * dq
        # neutral 10-m wind anchored on the measured wind at zu
        u10n = ties.maximum(ublend - ustar / kv * (log_zu10 - psi_m(zeta_u)), 0.1)

    cd = _fast_pow(ustar / ublend, 2)
    ch = (ustar / ublend) * ch_fac
    ce = (ustar / ublend) * ce_fac
    return dict(ustar=ustar, tstar=tstar, qstar=qstar, cd=cd, ch=ch, ce=ce, u10n=u10n)


def _cd_n10(w):
    w = ties.clip(w, 0.5, 33.0)
    return 1e-3 * (rdiv(2.7, w) + 0.142 + w / 13.09 - 3.14807e-10 * _fast_pow(w, 6))


def _ncar_scales(u, dtheta, dq, tv, sphuma, tairK, zu, zt, n_iter):
    """Large & Yeager (2009) NCAR/CORE-II algorithm: polynomial neutral 10-m
    coefficients adjusted to height/stability with Paulson psi functions."""
    kv = phys.vonKarman
    g = phys.g
    u = ties.maximum(u, 0.5)  # LY04 floor
    log_zu10 = math.log(zu / 10.0)
    log_zt10 = math.log(zt / 10.0)

    u10n = u
    ustar = torch.sqrt(_cd_n10(u10n)) * u
    tstar = torch.zeros_like(u)
    qstar = torch.zeros_like(u)
    cd = _cd_n10(u10n)
    ch = cd
    ce = cd
    for _ in range(n_iter):
        cdn = _cd_n10(u10n)
        cen = 1e-3 * 34.6 * torch.sqrt(cdn)
        stable = dtheta > 0.0
        chn = 1e-3 * torch.where(stable, torch.full_like(cdn, 18.0), 32.7) * torch.sqrt(cdn)

        wflux = tstar * (1.0 + 0.61 * sphuma) + 0.61 * tairK * qstar
        L = tv * ustar * ustar / (kv * g * _nonzero(wflux))
        zeta_u = ties.clip(rdiv(zu, L), -10.0, 10.0)
        zeta_t = ties.clip(rdiv(zt, L), -10.0, 10.0)
        pm, ph = _psi_m_paulson(zeta_u), _psi_h_paulson(zeta_t)

        cdn_sqrt = torch.sqrt(cdn)
        den_m = 1.0 + cdn_sqrt / kv * (log_zu10 - pm)
        cd = cdn / (den_m * den_m)
        cd_sqrt = torch.sqrt(cd)
        den_h = 1.0 + chn / (kv * cdn_sqrt) * (log_zt10 - ph)
        ch = chn * cd_sqrt / cdn_sqrt / den_h
        den_e = 1.0 + cen / (kv * cdn_sqrt) * (log_zt10 - ph)
        ce = cen * cd_sqrt / cdn_sqrt / den_e

        ustar = ties.maximum(cd_sqrt * u, 1e-4)
        tstar = ch / cd_sqrt * dtheta
        qstar = ce / cd_sqrt * dq
        u10n = ties.maximum(u / den_m, 0.5)

    return dict(ustar=ustar, tstar=tstar, qstar=qstar, cd=cd, ch=ch, ce=ce, u10n=u10n)
