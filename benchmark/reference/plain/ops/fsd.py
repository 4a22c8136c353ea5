"""Floe size distribution (FSD) (the counterpart of nextsim_tpu/ops/fsd.py).

Equivalent of the reference's FSD physics (reference: initFsd
fe.cpp:7399-7585; redistributeFSD fe.cpp:4268-4460; updateFSD; weldingRoach
fe.cpp:4720-4850; FSD-damage coupling): an N-bin area-based distribution
per cell, with

* wave-induced breakup redistribution (none/uniform_size/zhang/dumont,
  reference enums.hpp:110-116) driven by the coupled wave field `wlbk`
  (breaking wavelength),
* Roach et al. (2018) welding (coagulation) during freezing: on the card a
  plain version ``welding_roach_reference`` on every device,
* shape-conserving rescaling to the total concentration after any process
  that changes conc (updateFSD),
* optional damage feedback (wave_coupling.fsd_damage_type).

The bin geometry is host numpy; everything else is elementwise PyTorch over
(nbins, ny, nx) tensors, with the per-bin loops unrolled in Python (N is
10-30) in the JAX package's order of additions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.plain.core import constants as phys
from benchmark.reference.plain.core import ties
from benchmark.reference.plain.ops.rheology import _fast_pow

#: cap on the per-cell welding substeps (the JAX package's loop length)
WELDING_NDT_MAX = 256
#: a welding cell's least broken area and least concentration
WELDING_BROKEN_MIN = 0.01
WELDING_TOTAL_MIN = 0.1


@dataclasses.dataclass(frozen=True)
class FSDParams:
    num_bins: int = 0
    fsd_type: str = "constant_size"  # constant_size | constant_area
    bin_cst_width: float = 10.0  # [m]
    min_floe_size: float = 10.0  # [m]
    floe_shape: float = 0.66  # (fe.cpp:7415)
    breakup_type: str = "uniform_size"  # none|uniform_size|zhang|dumont
    breakup_prob_type: int = 0
    breakup_timescale_tuning: float = 1.0
    breakup_thick_min: float = 0.0
    breakup_cell_average_thickness: bool = False
    breakup_coef1: float = 0.5
    breakup_coef2: float = 1.0
    breakup_coef3: float = 1.0
    breakup_prob_cutoff: float = 0.0015
    welding_type: str = "none"  # none | roach
    welding_kappa: float = 0.01
    welding_use_scaled_area: bool = False
    floes_flex_young: float = 5.49e9
    distinguish_mech_fsd: bool = True
    damage_type: int = 0
    damage_max: float = 0.99
    unbroken_floe_size: float = 1000.0

    @staticmethod
    def from_config(cfg) -> "FSDParams":
        return FSDParams(
            num_bins=cfg["wave_coupling.num_fsd_bins"],
            fsd_type=cfg["wave_coupling.fsd_type"],
            bin_cst_width=cfg["wave_coupling.fsd_bin_cst_width"],
            min_floe_size=cfg["wave_coupling.fsd_min_floe_size"],
            breakup_type=cfg["wave_coupling.breakup_type"],
            breakup_prob_type=cfg["wave_coupling.breakup_prob_type"],
            breakup_timescale_tuning=cfg["wave_coupling.breakup_timescale_tuning"],
            breakup_thick_min=cfg["wave_coupling.breakup_thick_min"],
            breakup_cell_average_thickness=cfg["wave_coupling.breakup_cell_average_thickness"],
            breakup_coef1=cfg["wave_coupling.breakup_coef1"],
            breakup_coef2=cfg["wave_coupling.breakup_coef2"],
            breakup_coef3=cfg["wave_coupling.breakup_coef3"],
            breakup_prob_cutoff=cfg["wave_coupling.breakup_prob_cutoff"],
            welding_type=cfg["wave_coupling.welding_type"],
            welding_kappa=cfg["wave_coupling.welding_kappa"],
            welding_use_scaled_area=cfg["wave_coupling.fsd_welding_use_scaled_area"],
            floes_flex_young=cfg["wave_coupling.floes_flex_young"],
            distinguish_mech_fsd=cfg["wave_coupling.distinguish_mech_fsd"],
            damage_type=cfg["wave_coupling.fsd_damage_type"],
            damage_max=cfg["wave_coupling.fsd_damage_max"],
            unbroken_floe_size=cfg["wave_coupling.fsd_unbroken_floe_size"],
        )


@dataclasses.dataclass(frozen=True)
class FSDBins:
    """Static bin geometry (reference: initFsd, fe.cpp:7428-7533)."""

    low: np.ndarray  # (N,) bin lower floe-size limits [m]
    up: np.ndarray
    width: np.ndarray
    centre: np.ndarray
    area_low: np.ndarray  # floe areas [m^2]
    area_up: np.ndarray
    area_centre: np.ndarray
    area_binwidth: np.ndarray
    scaled_low: np.ndarray  # scaled areas used by welding
    scaled_up: np.ndarray
    scaled_centre: np.ndarray
    scaled_binwidth: np.ndarray
    alpha_merge: np.ndarray  # (N, N) int merge matrix (fe.cpp:7520-7533)


def make_bins(p: FSDParams) -> FSDBins:
    n = p.num_bins
    s = p.floe_shape
    if p.fsd_type == "constant_size":
        low = p.min_floe_size + p.bin_cst_width * np.arange(n)
        up = low + p.bin_cst_width
        area_low = s * low**2
        area_up = s * up**2
    else:  # constant_area (fe.cpp:7459-7483)
        binw = s * (p.bin_cst_width**2 + 2 * p.min_floe_size * p.bin_cst_width)
        area_low = s * p.min_floe_size**2 + binw * np.arange(n)
        area_up = area_low + binw
        low = np.sqrt(area_low / s)
        up = np.sqrt(area_up / s)
    width = up - low
    centre = 0.5 * (low + up)
    area_centre = s * centre**2
    area_binwidth = area_up - area_low

    lims = np.concatenate([area_low, [area_up[-1]]])
    if p.welding_use_scaled_area:
        lims_scaled = (lims - lims[0]) / area_binwidth.max()
    else:
        lims_scaled = lims - lims[0]
    scaled_low = lims_scaled[:-1]
    scaled_up = lims_scaled[1:]
    scaled_centre = 0.5 * (scaled_low + scaled_up)
    scaled_binwidth = scaled_up - scaled_low

    alpha = np.full((n, n), -999, dtype=np.int32)
    for m in range(n):
        for k in range(n):
            test = scaled_up[m] - scaled_centre[k]
            for q in range(n):
                if scaled_low[q] <= test < scaled_up[q]:
                    alpha[m, k] = q + 1
    return FSDBins(
        low=low, up=up, width=width, centre=centre,
        area_low=area_low, area_up=area_up, area_centre=area_centre,
        area_binwidth=area_binwidth,
        scaled_low=scaled_low, scaled_up=scaled_up,
        scaled_centre=scaled_centre, scaled_binwidth=scaled_binwidth,
        alpha_merge=alpha,
    )


def _unbroken(like, ctot) -> torch.Tensor:
    """An FSD of ``like``'s shape with all of ``ctot`` in the last bin."""
    out = torch.zeros_like(like)
    out[-1] = ctot
    return out


def init_fsd(p: FSDParams, conc_total) -> torch.Tensor:
    """All ice starts unbroken: total concentration in the last bin
    (reference: initFsd then updateFSD's empty-FSD branch)."""
    shape = (p.num_bins,) + tuple(conc_total.shape)
    return _unbroken(conc_total.new_zeros(shape), conc_total)


def update_fsd(conc_fsd, ctot) -> torch.Tensor:
    """Rescale the FSD to the (changed) total concentration, conserving its
    shape (reference: updateFSD, fe.cpp)."""
    ctot2 = conc_fsd.sum(dim=0)
    scale = ctot / ties.maximum(ctot2, 1e-30)
    rescaled = conc_fsd * scale[None]
    # empty FSD but ice present: put everything in the unbroken bin
    empty = (ctot2 <= 0.0) & (ctot > 0.0)
    out = torch.where(empty[None], _unbroken(conc_fsd, ctot), rescaled)
    # keep zero where there's no ice at all
    return torch.where((ctot > 0.0)[None], out, torch.zeros_like(conc_fsd))


def wave_breakup(
    conc_fsd,
    thick, conc, h_young, conc_young,
    wlbk,  # breaking wavelength from the wave model [m] (>=499 -> no waves)
    dt_cpl: float,
    p: FSDParams,
    bins: FSDBins,
):
    """Wave-induced breakup redistribution (reference: redistributeFSD,
    fe.cpp:4268-4460). Returns (conc_fsd, broke) where `broke` flags cells
    where breakup occurred this step."""
    poisson = 0.3
    ctot = conc + conc_young
    p_inf = torch.where(wlbk < 499.0, torch.ones_like(wlbk), torch.zeros_like(wlbk))
    active = (ctot > 0.0) & (p_inf > p.breakup_prob_cutoff)

    if p.breakup_cell_average_thickness:
        h = thick
    else:
        h = (thick + h_young) / ties.maximum(ctot, 1e-30)
    h = ties.maximum(h, p.breakup_thick_min)

    # flexural-failure floe size limit (Mellor 1984 / Boutin 2018)
    d_flex = 0.5 * ties.pow(
        (math.pi**4)
        * p.floes_flex_young
        * _fast_pow(h, 3)
        / (48.0 * phys.rhow * phys.g * (1.0 - poisson**2)),
        0.25,
    )
    lam = wlbk
    tau_w = p.breakup_timescale_tuning

    n = p.num_bins
    if p.breakup_type == "none":
        return conc_fsd, active
    if p.breakup_type not in ("uniform_size", "zhang", "dumont"):
        raise ValueError(p.breakup_type)
    out = [conc_fsd[j] for j in range(n)]
    # the breakup probability does not depend on the bin
    pj0 = p_inf * (1.0 - torch.exp(-p_inf * dt_cpl / tau_w))
    lam_den = p.breakup_coef2 * ties.maximum(lam, 1e-3)
    flex_den = p.breakup_coef3 * ties.maximum(d_flex, 1e-3)
    for j in range(n):
        cj = float(bins.centre[j])
        lim_lambda = ties.maximum(torch.tanh((cj - p.breakup_coef1 * lam) / lam_den), 0.0)
        lim_dflex = ties.maximum(torch.tanh((cj - d_flex) / flex_den), 0.0)
        if p.breakup_type in ("uniform_size", "zhang"):
            pj = pj0 * lim_dflex * lim_lambda
            broken = torch.where(active & (pj > 0.0), out[j] * pj, 0.0)
            out[j] = out[j] - broken
            for k in range(j + 1):
                if p.breakup_type == "zhang":
                    beta = bins.width[k] / (bins.up[j] - bins.low[0])
                else:
                    beta = (bins.up[k] ** 3 - bins.low[k] ** 3) / (
                        bins.up[j] ** 3 - bins.low[0] ** 3
                    )
                out[k] = out[k] + broken * float(beta)
        else:  # dumont
            fragility = lim_dflex * lim_lambda
            broken = torch.where(active & (fragility > 0.0), out[j] * pj0 * fragility, 0.0)
            out[j] = out[j] - broken
            frag_safe = ties.maximum(fragility, 1e-10)
            exponent = ties.maximum(
                2.0 - (2.0 + torch.log(frag_safe) / math.log(2.0)), 1e-6
            )

            def powe(base):
                return ties.pow(torch.full_like(exponent, float(base)), exponent)

            den = powe(bins.up[j]) - powe(bins.low[0])
            for k in range(j + 1):
                beta = (powe(bins.up[k]) - powe(bins.low[k])) / den
                out[k] = out[k] + broken * beta
    return torch.stack(out), active


def welding_pairs(bins: FSDBins, n: int):
    """The static pair structure of the coagulation sum, as host lists in
    the order of the sum (ky, then kx = ky..n-1): for every pair its merge
    bin a(kx, ky) (1..n; 1 where it is undefined), the width of bin a - 1,
    the offset of the pair term and its valid flag (0.0 where the merge bin
    is undefined). The plain loop and the kernel's table (ops/welding_cuda.py)
    both come from it."""
    merge, width, off, valid = [], [], [], []
    for ky in range(n):
        for kx in range(ky, n):
            a = int(bins.alpha_merge[kx, ky])
            ok = a >= 1
            a = a if ok else 1
            merge.append(a)
            width.append(max(bins.scaled_binwidth[a - 1], 1e-30))
            off.append(bins.scaled_up[a - 1] - bins.scaled_up[kx] + bins.scaled_centre[ky])
            valid.append(1.0 if ok else 0.0)
    return merge, width, off, valid


def _welding_plan(bins: FSDBins, n: int, dtype, device):
    """``welding_pairs`` per lower bin ky as tensors: for the rows kx =
    ky..n-1, the merge bin, the bin before it and the columns of width,
    offset and valid flag; the valid column is None where every pair of the
    row is valid."""
    merge, width, off, valid = welding_pairs(bins, n)
    col = lambda v: torch.as_tensor(v, dtype=dtype, device=device)[:, None]  # noqa: E731
    plan, q = [], 0
    for ky in range(n):
        rows = slice(q, q + n - ky)
        q += n - ky
        a_idx = torch.as_tensor(merge[rows], dtype=torch.int64, device=device)
        plan.append((a_idx, a_idx - 1, col(width[rows]), col(off[rows]),
                     None if all(valid[rows]) else col(valid[rows])))
    return plan


def welding_roach(conc_fsd, dt: float, p: FSDParams, bins: FSDBins, freezing):
    """Roach et al. (2018) coagulation during freezing (reference:
    weldingRoach, fe.cpp:4720-4850), the JAX package's ``welding_roach``.
    A stack on the CPU runs ``welding_roach_reference``; on the card the
    CUDA kernel of csrc/welding_roach.cu runs it (``welding_cuda.
    welding_roach``: one call, nothing read back, a recorded gradient
    through ``welding_cuda.WeldingRoach``), or raises: nothing falls back
    to the plain loop there. ``conc_fsd`` is (nbins, ny, nx) or a batched
    ensemble's member-minor (nbins, N, ny, nx)."""
    return welding_roach_reference(conc_fsd, dt, p, bins, freezing)


def _kernel_for(conc_fsd) -> bool:
    """Whether ``welding_roach`` takes the kernel for this stack: on any
    device but the CPU."""
    return conc_fsd.device.type != "cpu"


def welding_roach_reference(conc_fsd, dt: float, p: FSDParams, bins: FSDBins, freezing):
    """The plain version of ``welding_roach``: the reference's per-cell
    sub-time stepping expressed as masked substeps, vectorised over cells.

    The update is pointwise in the cell, and a cell that is not active, or
    whose own count ``ndt`` is reached, keeps its value. So the active cells
    are gathered into a dense (nbins, m) array (one read-back of their
    number and of their largest ``ndt`` per call), the loop runs on those to
    that count, and the result is scattered back: what the fixed loop of
    ``WELDING_NDT_MAX`` masked substeps over the whole grid gives, cell by
    cell, so a member-minor stack gives each member's own result. Within a
    substep the pair terms of one lower bin ky are formed for all upper bins
    kx at once and added to the bins' sums in ky order, the reference's
    order of additions. The kernel's oracle on the card."""
    n = p.num_bins
    ctot_all = conc_fsd.sum(dim=0)
    c_broken = conc_fsd[:-1].sum(dim=0)
    active = freezing & (c_broken > WELDING_BROKEN_MIN) & (ctot_all > WELDING_TOTAL_MIN)
    if not bool(active.any()):
        return conc_fsd

    c = conc_fsd[:, active]  # (n, m)
    ctot = ctot_all[active]
    # stability limit -> per-cell substep count (fe.cpp:4754-4757), capped
    stability = dt * p.welding_kappa * ctot * float(bins.scaled_up[-1])
    ndt = ties.clip(torch.ceil(stability + 0.5), 1.0, float(WELDING_NDT_MAX))
    step_fac = (dt / ndt)[None] * p.welding_kappa
    n_loop = int(ndt.max())

    plan = _welding_plan(bins, n, c.dtype, c.device)
    centre = torch.as_tensor(bins.scaled_centre, dtype=c.dtype, device=c.device)[:, None]
    zero_row = torch.zeros_like(c[:1])
    for t in range(n_loop):
        live = t < ndt
        # suffix[a] = c[a:].sum(0) for a = 0..n (the last is zero)
        suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(c, (0,)), 0), (0,)), zero_row])
        lead = centre * c * ctot[None]  # centre[ky] * c[ky] * ctot
        coag = torch.zeros_like(c)
        for ky, (a_idx, a_prev, width, off, valid) in enumerate(plan):
            part = (c[a_prev] / width) * off
            term = lead[ky] * (suffix[a_idx] + part)
            if valid is not None:
                term = term * valid
            coag[ky:] += term
        # bin m loses coag[m], gains coag[m-1] (fe.cpp:4796-4803)
        gain = torch.cat([zero_row, coag[:-1]])
        upd = c - step_fac * (coag - gain)
        c = torch.where(live[None], ties.maximum(upd, 0.0), c)
    out = conc_fsd.clone()
    out[:, active] = c
    return out


def fsd_damage(conc_fsd, damage, p: FSDParams, broke):
    """Optional damage feedback from breakup (wave_coupling.fsd_damage_type:
    1 = from the broken-area fraction; 2 = binary on breakup)."""
    if p.damage_type == 0:
        return damage
    ctot = conc_fsd.sum(dim=0)
    broken_frac = torch.where(
        ctot > 0.0, conc_fsd[:-1].sum(dim=0) / ties.maximum(ctot, 1e-30), 0.0
    )
    if p.damage_type == 1:
        target = p.damage_max * broken_frac
    else:
        target = torch.full_like(damage, p.damage_max)
    return torch.where(broke, torch.maximum(damage, target), damage)


#: device copies of the bins' host arrays, made once: a captured step
#: (model/captured.py) must not copy from the host
_BIN_TENSORS = {}


def _bin_tensor(arr, dtype, device):
    key = (id(arr), dtype, str(device))
    hit = _BIN_TENSORS.get(key)
    if hit is None or hit[0] is not arr:
        hit = _BIN_TENSORS[key] = (arr, torch.as_tensor(arr, dtype=dtype, device=device))
    return hit[1]


def dmax_dmean(conc_fsd, p: FSDParams, bins: FSDBins, threshold: float = 0.1):
    """Diagnostics: max floe size (9th decile by default) and mean floe size
    (reference: Dmax/Dmean gridoutput variables)."""
    ctot = conc_fsd.sum(dim=0)
    frac = conc_fsd / ties.maximum(ctot, 1e-30)[None]
    cum = torch.cumsum(frac, dim=0)
    # dmax: first bin where cumulative fraction exceeds (1 - threshold); an
    # all-false column gives bin 0 (the first of the tied zeros)
    over = cum >= (1.0 - threshold)
    idx = torch.argmax(over.to(torch.uint8), dim=0)
    centre = _bin_tensor(bins.centre, conc_fsd.dtype, conc_fsd.device)
    dmax = centre[idx]
    dmean = (frac * centre.view((-1,) + (1,) * (frac.ndim - 1))).sum(dim=0)
    has = ctot > 0.0
    return torch.where(has, dmax, 0.0), torch.where(has, dmean, 0.0)


def lateral_melt_type3(
    conc_fsd, conc, conc_young, h_young, hi, hs, qow, tw_new, tfrw,
    del_hi, dt: float, PhiM: float, h_young_min: float, p: FSDParams,
    bins: FSDBins,
):
    """FSD-dependent lateral melt — thermo melt_type=3 (reference:
    fe.cpp:5596-5649, Roach et al. 2018 / Horvat & Tziperman 2015).

    Returns (del_c, del_c_young, qow, lat_melt_rate):
    * unbroken cells (all area in the last bin) follow the melt_type=2
      Mellor & Kantha form;
    * broken cells melt laterally at W = -2*m1*(Tw-Tf)^m2 weighted by the
      perimeter density of each floe-size bin.
    """
    qi = phys.Lf * phys.rhoi
    qs = phys.Lf * phys.rhos
    m1, m2 = 3.0e-6, 1.36  # MIZEX 84 fit (fe.cpp:5607-5610)

    ctot = conc + conc_young
    melting = (del_hi < 0.0) & (tw_new > tfrw) & (hi > 0.0) & (ctot > 1e-11)

    h0 = torch.where(
        conc_young > 0.0,
        h_young_min + 2.0 * (h_young - h_young_min * conc_young)
        / ties.maximum(conc_young, 1e-30),
        0.0,
    )

    unbroken = torch.abs(conc_fsd[-1] - ctot) < 1e-7

    # --- unbroken: melt_type 2 behaviour (fe.cpp:5617-5626) ---------------
    del_c2 = PhiM * (1.0 - ctot) * ties.minimum(qow, 0.0) * dt / ties.maximum(
        hi * qi + hs * qs, 1e-30
    )
    del_c2 = torch.maximum(del_c2, -ctot)
    qow_unbroken = qow * (1.0 - PhiM)

    # --- broken: perimeter-weighted lateral melt (fe.cpp:5628-5641) -------
    dT = ties.maximum(tw_new - tfrw, 0.0)
    lat_melt_rate = -2.0 * m1 * _fast_pow_arr(dT, m2)  # <0 [m/s]
    cat0 = lat_melt_rate * conc_fsd[0] / float(bins.width[0]) * dt
    del_c3 = cat0
    for j in range(p.num_bins - 1):
        del_c3 = del_c3 + lat_melt_rate * (conc_fsd[j] * 2.0 / float(bins.centre[j])) * dt
    qow_broken = qow - del_c3 * (hi * qi * conc + h0 * qi * conc_young) / (
        dt * ties.maximum(ctot, 1e-30)
    )

    del_c_melt = torch.where(melting, torch.where(unbroken, del_c2, del_c3), 0.0)
    qow = torch.where(melting, torch.where(unbroken, qow_unbroken, qow_broken), qow)
    lat_melt_rate = torch.where(melting & (~unbroken), lat_melt_rate, 0.0)

    del_c = (conc / ties.maximum(ctot, 1e-30)) * del_c_melt
    del_c_young = (conc_young / ties.maximum(ctot, 1e-30)) * del_c_melt
    return del_c, del_c_young, qow, lat_melt_rate


def _fast_pow_arr(x, e: float):
    """x**e for x>=0 via exp/log with the x==0 lane fixed to 0."""
    safe = ties.maximum(x, 1e-30)
    return torch.where(x > 0.0, torch.exp(e * torch.log(safe)), 0.0)


def redistribute_thermo_fsd(conc_fsd, lat_melt_rate, dt: float, p: FSDParams, bins: FSDBins):
    """FSD evolution under lateral melt/growth (reference:
    redistributeThermoFSD, fe.cpp:4460-4560; Horvat & Tziperman 2015):
    advection of the distribution in floe-size space plus the perimeter
    area-loss term."""
    n = p.num_bins
    active = torch.abs(lat_melt_rate) > 0.0
    zero = torch.zeros_like(conc_fsd[0])

    # number-density gradient d(c/width)/dr with no transfer from unbroken
    fsd_dr = [zero]
    for m in range(1, n - 1):
        fsd_dr.append(conc_fsd[m] / float(bins.width[m]))
    fsd_dr.append(zero)
    fsd_dr.append(zero)  # index n

    out = [conc_fsd[m] for m in range(n)]
    for m in range(n - 1):
        dfsd = fsd_dr[m + 1] - fsd_dr[m]
        delta = dt * lat_melt_rate * (-dfsd + conc_fsd[m] * 2.0 / float(bins.centre[m]))
        out[m] = torch.where(active, out[m] + delta, out[m])
    # smallest bin loses area out of the distribution when melting
    cat0 = lat_melt_rate * conc_fsd[0] / float(bins.width[0]) * dt
    out[0] = torch.where(active & (lat_melt_rate < 0.0), out[0] + cat0, out[0])
    # growth: flux into the unbroken bin
    grow = float(bins.width[n - 1])
    out[n - 1] = torch.where(
        active & (lat_melt_rate > 0.0),
        out[n - 1] + conc_fsd[n - 1] / grow * dt * lat_melt_rate,
        out[n - 1],
    )
    return torch.stack([ties.maximum(o, 0.0) for o in out])
