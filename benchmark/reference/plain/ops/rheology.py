"""Sea-ice rheology: pointwise stress/damage updates (the counterpart of
nextsim_tpu/ops/rheology.py).

* **BBM** (Brittle Bingham-Maxwell, the default) — stress relaxation with
  damage and plasticity (reference: FiniteElement::updateSigmaDamage,
  model/finiteelement.cpp:4137-4260; Olason et al. 2024).
* **EVP / mEVP** — elastic-visco-plastic toward the Hibler ellipse
  (reference: updateSigmaVP/EVP/MEVP, model/finiteelement.cpp:10649-10726).

Elementwise maps over cell planes, with the JAX package's float32 guards
(relaxation floor, division floors, +1e-20 inside the norms) and term order.
The CUDA substep kernel (csrc/momentum_substep.cu) transcribes the same
formulas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from benchmark.reference.plain.core import constants as phys
from benchmark.reference.plain.core import ties


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` for a Python scalar ``c``, as a true division. (torch's
    ``c / t`` computes ``reciprocal(t) * c``, which rounds twice.)"""
    return torch.full_like(t, c) / t


def _fast_pow(x, e: float):
    """x**e with small-integer / half-integer exponents strength-reduced to
    multiplies and sqrts, in the JAX package's square-and-multiply order."""
    if e == int(e) and 0 <= int(e) <= 8:
        n = int(e)
        out = None
        acc = x
        while n:
            if n & 1:
                out = acc if out is None else out * acc
            acc = acc * acc
            n >>= 1
        return out if out is not None else torch.ones_like(x)
    if (2.0 * e) == int(2.0 * e) and 0 < e < 8:  # half-integer, e.g. 1.5
        return _fast_pow(x, e - 0.5) * torch.sqrt(x + 1e-20)
    return ties.pow(x, e)


@dataclasses.dataclass(frozen=True)
class BBMParams:
    """BBM constants (reference: initOptAndParam, finiteelement.cpp:1047-1491)."""

    young: float = 5.9605e8  # undamaged Young modulus [Pa] (dynamics.young)
    nu0: float = 1.0 / 3.0  # Poisson ratio (dynamics.nu0)
    compaction_param: float = -20.0  # ridging exponent C (dynamics.compaction_param)
    compr_strength: float = 1e10  # scaled by scale_coef at init! [Pa]
    tan_phi: float = 0.7  # internal friction (dynamics.tan_phi)
    compression_factor: float = 10e3  # P in Pmax (dynamics.compression_factor)
    exponent_compression_factor: float = 1.5  # h exponent (dynamics.exponent_compression_factor)
    undamaged_time_relaxation_sigma: float = 1e7  # lambda0 [s]
    exponent_relaxation_sigma: float = 5.0  # alpha
    min_c_rheology: float = 0.1  # concentration floor (hard-coded, fe.cpp:4146)

    @property
    def dunit(self) -> Tuple[float, ...]:
        """Plane-stress stiffness entries (reference: initFETensors,
        finiteelement.cpp:1491-1507): D/(1-nu^2) with rows (xx, yy, xy)."""
        f = 1.0 / (1.0 - self.nu0**2)
        return (f, f * self.nu0, f * (1.0 - self.nu0) / 2.0)


def bbm_update_planes(
    sxx, syy, sxy,
    damage,
    conc,
    thick,
    cohesion,
    time_relaxation_damage,
    eps11,
    eps22,
    eps12,
    delta_x,
    dt: float,
    p: BBMParams,
    expC=None,  # optional precomputed exp(C*(1-conc)) — loop-invariant
    Pmax=None,  # optional precomputed P*h^1.5*expC — loop-invariant
    heal_rate=None,  # optional precomputed dt/t_heal*expC — loop-invariant
    rtd_coef=None,  # optional precomputed sqrt(E0*expC)/(dx*c_d) — loop-invariant
):
    """One BBM sub-step on separate stress planes (reference:
    updateSigmaDamage, finiteelement.cpp:4137-4260). Returns
    (sxx, syy, sxy, damage)."""

    # no-ice cells: sigma=0, damage=0 (fe.cpp:4150-4159)
    has_ice = conc > p.min_c_rheology

    # --- stress update (fe.cpp:4183-4210) ---------------------------------
    sigma_n = 0.5 * (sxx + syy)
    if expC is None:
        expC = torch.exp(p.compaction_param * (1.0 - conc))
    dmg_el = (1.0 - damage) * expC
    # the relaxation-time base is floored: dmg_el^(alpha-1) underflows
    # float32 for heavily damaged low-concentration ice, and the
    # multiplicator below would become 0/0 = NaN
    time_viscous = p.undamaged_time_relaxation_sigma * _fast_pow(
        ties.maximum(dmg_el, 1e-8), p.exponent_relaxation_sigma - 1.0
    )

    # plastic failure folded into the multiplicator (fe.cpp:4189-4210):
    # s*(1-tildeP) = max(s - Pmax, 0) in compression, s otherwise
    if Pmax is None:
        Pmax = _fast_pow(thick, p.exponent_compression_factor) * p.compression_factor * expC
    compressing = sigma_n < 0.0
    # division floors at 1e-15 keep the float32 divisions finite
    s_mag = ties.maximum(-sigma_n, 1e-15)
    s_unyielded = torch.where(compressing, ties.maximum(s_mag - Pmax, 0.0), s_mag)
    tv_s = ties.maximum(time_viscous * s_mag, 1e-15)
    multiplicator = ties.minimum(tv_s / (tv_s + dt * s_unyielded), 1.0 - 1e-12)

    elasticity = p.young * dmg_el
    d0, d1, d2 = p.dunit
    # sigma += dt*E*(Dunit @ eps); Dunit = [[d0,d1,0],[d1,d0,0],[0,0,d2]]
    sxx = (sxx + dt * elasticity * (d0 * eps11 + d1 * eps22)) * multiplicator
    syy = (syy + dt * elasticity * (d1 * eps11 + d0 * eps22)) * multiplicator
    sxy = (sxy + dt * elasticity * (d2 * eps12)) * multiplicator

    # --- damage criterion (fe.cpp:4216-4243) ------------------------------
    half_diff = 0.5 * (sxx - syy)
    sigma_s = torch.sqrt(half_diff * half_diff + sxy * sxy + 1e-20)
    sigma_n = 0.5 * (sxx + syy)

    # Mohr-Coulomb + compressive failure (Plante & Tremblay form): select
    # numerator/denominator per cell and divide once
    compressive = sigma_n < -p.compr_strength
    dcrit_num = torch.where(compressive, -p.compr_strength, cohesion)
    dcrit_den = torch.where(
        compressive,
        ties.minimum(sigma_n, -1e-15),
        ties.maximum(sigma_s + p.tan_phi * sigma_n, 1e-15),
    )
    dcrit = dcrit_num / dcrit_den

    failing = (dcrit > 0.0) & (dcrit < 1.0)
    # 1/t_d = rtd_coef*sqrt(1-damage) (fe.cpp:4230)
    if rtd_coef is None:
        sqrt_nu_rhoi = math.sqrt(2.0 * (1.0 + p.nu0) * phys.rhoi)
        rtd_coef = torch.sqrt(p.young * expC) / (delta_x * sqrt_nu_rhoi)
    rtd = rtd_coef * torch.sqrt(ties.maximum(1.0 - damage, 0.0) + 1e-20)
    relax = (1.0 - dcrit) * dt * rtd
    relax = torch.where(failing, relax, 0.0)

    damage_new = damage + (1.0 - damage) * relax
    # elastic stress relaxation on failure (fe.cpp:4241-4242)
    sxx = sxx * (1.0 - relax)
    syy = syy * (1.0 - relax)
    sxy = sxy * (1.0 - relax)

    # --- healing (fe.cpp:4254-4257) ---------------------------------------
    if heal_rate is None:
        heal_rate = rdiv(dt, time_relaxation_damage) * expC
    damage_new = ties.maximum(damage_new - heal_rate, 0.0)

    sxx = torch.where(has_ice, sxx, 0.0)
    syy = torch.where(has_ice, syy, 0.0)
    sxy = torch.where(has_ice, sxy, 0.0)
    damage_new = torch.where(has_ice, damage_new, 0.0)

    return sxx, syy, sxy, damage_new


@dataclasses.dataclass(frozen=True)
class EVPParams:
    e: float = 2.0  # ellipse ratio (dynamics.evp.e)
    Pstar: float = 27.5e3  # [Pa] (dynamics.evp.Pstar)
    C: float = 20.0  # compaction parameter (dynamics.evp.C)
    delta_min: float = 1e-9  # (dynamics.evp.dmin)


def vp_update_planes(
    sxx, syy, sxy, conc, thick, eps11, eps22, eps12, ralpha1: float, ralpha2,
    p: EVPParams,
    P=None,  # optional precomputed Pstar*exp(-C*(1-conc)) — loop-invariant
):
    """Shared (m)EVP stress update on separate planes (reference:
    updateSigmaVP, finiteelement.cpp:10649-10699); returns (sxx, syy, sxy)."""
    re2 = 1.0 / (p.e * p.e)

    eps1 = eps11 + eps22
    eps2 = eps11 - eps22
    delta = torch.sqrt(eps1 * eps1 + (eps2 * eps2 + 4.0 * eps12 * eps12) * re2)
    if P is None:
        P = p.Pstar * torch.exp(-p.C * (1.0 - conc))
    zeta = P / (delta + p.delta_min)

    sigma1 = sxx + syy
    sigma2 = sxx - syy
    sigma1 = sigma1 + ralpha1 * (zeta * (eps1 - delta) - sigma1)
    sigma2 = sigma2 + ralpha2 * (zeta * eps2 * re2 - sigma2)
    sxy = sxy + ralpha2 * (zeta * eps12 * re2 - sxy)

    sxx = 0.5 * (sigma1 + sigma2)
    syy = 0.5 * (sigma1 - sigma2)

    # ice-free elements carry zero stress (fe.cpp:10656-10662)
    has_ice = thick > 0.0
    sxx = torch.where(has_ice, sxx, 0.0)
    syy = torch.where(has_ice, syy, 0.0)
    sxy = torch.where(has_ice, sxy, 0.0)
    return sxx, syy, sxy
