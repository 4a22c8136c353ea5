"""Waves-in-ice module (WIM): spectral wave attenuation + floe breakage (the
counterpart of nextsim_tpu/wim/wim.py).

Reimplementation of the reference WIM discretisation (reference:
modules/wim/src/wimdiscr.cpp, iceinfo.cpp, gridinfo.cpp) on a structured
grid. The reference runs the WIM on its own regular grid (or on the neXtSIM
mesh with ``nextwim.coupling-option=run_on_mesh``); here the model grid *is*
structured, so the WIM runs co-located with the sea-ice state — or on its
own grid through wim/regrid.py.

Physics per WIM time step (wimdiscr.cpp:822-1210 ``timeStep``):
  1. steady-state boundary forcing of the incident spectrum,
  2. WENO(3)-limited advection of every (frequency, direction) spectral
     plane at the open-water group speed (gridinfo.cpp:592-824),
  3. attenuation by scattering (per-floe Kohout & Meylan coefficients via
     rtparam.py) + Robinson-Palmer damping, with the dissipated momentum
     accumulated into an ice-surface wave stress (attenSimple,
     wimdiscr.cpp:2249-2324),
  4. spectral moments -> Hs, Tp, mwd, Stokes drift,
  5. strain-variance floe breakage updating Dmax/Nfloes
     (iceinfo.cpp:172-203 ``doBreaking``).

The spectrum is a (nfreq, ndir, ny, nx) tensor. Advection and attenuation
take tensors with leading (frequency, direction) dimensions and roll and
pad the last two, so one call serves a block of frequencies with all their
directions; a run is a Python loop of substeps at the CFL-limited spectral
dt, all branches masked arithmetic.

On a device mesh (``Wim(mesh=seam)``, the JAX ``Wim(mesh=...)``) the
spectrum and every ice and medium plane live on this rank's ext block of a
layout of the WIM's own (parallel/seam.py: rings of ``seam.WIM_RING``
cells, the reach of one time step; periodic where ``wim.advopt`` wraps),
and the rings of the spectrum and of the floe fields are exchanged after
every time step, through ``seam.RingExchange`` when a gradient is recorded.
Every rank takes the same decisions: the frequencies a block holds follow
the global grid's size, the ideal fields its coordinates, and ``run``'s
test for an empty spectrum is maxed over the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nextsim_tpu_torch.core import ties
from nextsim_tpu_torch.core.state import to_host
from nextsim_tpu_torch.ops.rheology import rdiv
from nextsim_tpu_torch.parallel import seam
from nextsim_tpu_torch.wim import rtparam

PI = math.pi

#: memory one block of frequencies may take in wim_time_step's temporaries
#: (the WENO stages keep about _WENO_LIVE arrays of the block's size alive).
#: On an H100 at 608^2, 25 x 16, one block of all 25 frequencies (15 GB) was
#: no faster than the 9 blocks of 3 that 2 GiB gives (chip_smoke.py times
#: both in turns), so the block is not sized from the card's free memory
_BLOCK_BYTES = 2 << 30
_WENO_LIVE = 24


# ---------------------------------------------------------------------------
# Parameters (reference: options_wim.cpp + IceParams, iceinfo.hpp:40-72)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WimParams:
    nwavefreq: int = 1
    nwavedirn: int = 16
    tmin: float = 2.5
    tmax: float = 25.0
    cfl: float = 0.7
    atten: bool = True
    scatmod: str = "dissipated"
    breaking: bool = True
    steady: bool = True
    advdim: int = 2
    advopt: str = "y-periodic"  # notperiodic | y-periodic | xy-periodic
    ref_hs_ice: bool = False
    # incident waves for the ideal setup
    hs_inc: float = 3.0
    tp_inc: float = 12.0
    mwd_inc: float = -90.0
    unifc: float = 0.7
    unifh: float = 1.0
    # ice / floe parameters (iceinfo.hpp:40-72)
    young: float = 5.49e9
    drag_rp: float = 13.0
    cice_min: float = 0.05
    dmin: float = 20.0
    xi: float = 2.0
    fragility: float = 0.9
    dfloe_miz_thresh: float = 200.0
    dfloe_pack_init: float = 300.0
    dfloe_pack_thresh: float = 400.0
    fsdopt: str = "PowerLawSmooth"  # PowerLawSmooth | RG
    vbf: float = 0.1
    gravity: float = 9.81
    rhowtr: float = 1025.0
    rhoice: float = 922.5
    poisson: float = 0.3

    @property
    def sigma_c(self) -> float:
        """Flexural strength [Pa] (iceinfo.cpp:40)."""
        return 1.76e6 * math.exp(-5.88 * math.sqrt(self.vbf))

    @property
    def epsc(self) -> float:
        """Breaking strain (iceinfo.cpp:41)."""
        return self.sigma_c / self.young

    @classmethod
    def from_config(cls, cfg) -> "WimParams":
        return cls(
            nwavefreq=cfg["wimsetup.nwavefreq"],
            nwavedirn=cfg["wimsetup.nwavedirn"],
            tmin=cfg["wimsetup.tmin"],
            tmax=cfg["wimsetup.tmax"],
            cfl=cfg["wim.cfl"],
            atten=cfg["wim.atten"],
            scatmod=cfg["wim.scatmod"],
            breaking=cfg["wim.breaking"],
            steady=cfg["wim.steady"],
            advdim=cfg["wim.advdim"],
            advopt=cfg["wim.advopt"],
            ref_hs_ice=cfg["wim.refhsice"],
            hs_inc=cfg["wim.hsinc"],
            tp_inc=cfg["wim.tpinc"],
            mwd_inc=cfg["wim.mwdinc"],
            unifc=cfg["wim.unifc"],
            unifh=cfg["wim.unifh"],
            young=cfg["wim.young"],
            drag_rp=cfg["wim.dragrp"],
            cice_min=cfg["wim.cicemin"],
            dfloe_pack_init=cfg["wim.dfloepackinit"],
            dfloe_pack_thresh=cfg["wim.dfloepackthresh"],
            fsdopt=cfg["wim.fsdopt"],
            dmin=cfg["wim.dfloemin"],
        )


# ---------------------------------------------------------------------------
# Spectral grids (wimdiscr.cpp assign():225-300)
# ---------------------------------------------------------------------------


def spectral_grids(p: WimParams) -> Dict[str, np.ndarray]:
    """Frequency grid + Simpson quadrature weights, and the direction grid
    with uniform weights (wimdiscr.cpp:228-283)."""
    if p.nwavefreq == 1:
        freq = np.array([1.0 / p.tp_inc])
        wt_freq = np.array([1.0])
    else:
        fmin, fmax = 1.0 / p.tmax, 1.0 / p.tmin
        freq = np.linspace(fmin, fmax, p.nwavefreq)
        wt = np.full(p.nwavefreq, 2.0)
        wt[0] = wt[-1] = 1.0
        wt[1:-1:2] = 4.0
        dom = 2 * PI * (freq[-1] - freq[0]) / (p.nwavefreq - 1)
        wt_freq = wt * dom / 3.0
    if p.nwavedirn == 1:
        wavedir = np.array([p.mwd_inc])
        wt_dir = np.array([1.0])
    else:
        dtheta = -360.0 / p.nwavedirn
        wavedir = 90.0 + dtheta * np.arange(p.nwavedirn)
        wt_dir = np.full(p.nwavedirn, 2 * PI / p.nwavedirn)
    # open-water wavelength / phase / group speeds (wimdiscr.cpp:289-300)
    wlng_wtr = p.gravity / (2 * PI * freq**2)
    ap_wtr = np.sqrt(p.gravity * wlng_wtr / (2 * PI))
    ag_wtr = ap_wtr / 2.0
    adv_dir = (-PI / 180.0) * (wavedir + 90.0)
    return dict(
        freq=freq, wt_freq=wt_freq, wavedir=wavedir, wt_dir=wt_dir,
        wlng_wtr=wlng_wtr, ap_wtr=ap_wtr, ag_wtr=ag_wtr, adv_dir=adv_dir,
    )


# ---------------------------------------------------------------------------
# Wave medium in ice (updateWaveMedium, wimdiscr.cpp:404-525)
# ---------------------------------------------------------------------------


def _vec(a, like) -> torch.Tensor:
    """A host vector (or a tensor) as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def update_wave_medium(thick, ice_mask, sg: Dict[str, Any], p: WimParams):
    """Per-frequency dispersion + attenuation coefficients on the grid.
    The wavenumber guess chains across frequencies (wimdiscr.cpp:441-445):
    a Python loop over the frequency axis, in order."""
    freq = _vec(sg["freq"], thick)
    kw = dict(young=p.young, gravity=p.gravity, rhowtr=p.rhowtr,
              rhoice=p.rhoice, poisson=p.poisson)

    oms = 2 * PI * freq
    guess = torch.full_like(thick, 1.0) * oms[0] ** 2 / p.gravity
    outs = []
    for i in range(oms.shape[0]):
        out = rtparam.rtparam_outer(thick, oms[i], p.drag_rp, guess, **kw)
        guess = out["kice"]
        outs.append(out)
    outs = {k: torch.stack([o[k] for o in outs]) for k in ("kice", "modT", "kwtr", "atten_nond", "damping")}

    nfq = len(sg["freq"])
    shape = (nfq,) + tuple(thick.shape)
    b = lambda a: _vec(a, thick)[:, None, None].expand(shape)  # noqa: E731
    im = ice_mask[None, :, :] > 0.5
    zeros = torch.zeros(shape, dtype=thick.dtype, device=thick.device)
    wlng_ice = torch.where(im, rdiv(2 * PI, outs["kice"]), b(sg["wlng_wtr"]))
    disp_ratio = torch.where(im, outs["kice"] * outs["modT"] / outs["kwtr"], 1.0)
    atten_nond = torch.where(im, outs["atten_nond"], 0.0) if p.atten else zeros
    damping = torch.where(im, outs["damping"], 0.0) if p.atten else zeros
    # group/phase speeds: water values everywhere (useicevel not implemented
    # in the reference either, wimdiscr.cpp:497-505)
    return dict(
        ag_eff=b(sg["ag_wtr"]), ap_eff=b(sg["ap_wtr"]), wlng_ice=wlng_ice,
        disp_ratio=disp_ratio, atten_nond=atten_nond, damping=damping,
    )


# ---------------------------------------------------------------------------
# Incident spectrum (setIncWaveSpec, wimdiscr.cpp:668-790)
# ---------------------------------------------------------------------------


def _theta_in_range(th, th1):
    """Map angle th into [th1, th1+360)."""
    return th - 360.0 * torch.floor((th - th1) / 360.0)


def theta_dir_frac(th1, dtheta, mwd):
    """Integral of the cos^2 directional spreading over [th1, th1+dtheta]
    (wimdiscr.cpp:2499-2538). ``th1`` is a 0-dim tensor or a number,
    ``mwd`` a tensor."""
    th1 = _vec(th1, mwd)
    phi1 = _theta_in_range(mwd - 90.0, th1)
    phi2 = _theta_in_range(mwd + 90.0, th1)
    th2 = th1 + dtheta

    def seg(l1, l2):
        l2 = torch.maximum(l1, l2)
        chi1 = PI * (l1 - mwd) / 180.0
        chi2 = PI * (l2 - mwd) / 180.0
        return 2.0 * (chi2 - chi1) + torch.sin(2 * chi2) - torch.sin(2 * chi1)

    # branch phi2 > phi1: single interval [max(th1,phi1), min(th2,phi2)]
    int_a = seg(torch.maximum(th1, phi1), torch.minimum(th2, phi2))
    # else: [th1, min(th2,phi2)] + [phi1, max(phi1,th2)]
    int_b = seg(torch.zeros_like(phi1) + th1, torch.minimum(th2, phi2)) + seg(
        phi1, torch.maximum(phi1, th2)
    )
    integral = torch.where(phi2 > phi1, int_a, int_b)
    return integral / (2.0 * PI)


def inc_wave_spec(hs, tp, mwd, wave_mask, sg, p: WimParams):
    """Bretschneider frequency spectrum x cos^2 directional spreading
    (wimdiscr.cpp:668-757). Returns sdf (nfreq, ndir, ny, nx)."""
    freq = _vec(sg["freq"], hs)
    wavedir = _vec(sg["wavedir"], hs)
    tp_s = ties.maximum(tp, 1e-8)
    if p.nwavefreq == 1:
        sfreq = ((hs / 4.0) ** 2)[None]
    else:
        om = 2 * PI * freq[:, None, None]
        t_m = rdiv(2 * PI, om)
        om_m = rdiv(2 * PI, tp_s[None])
        om_m2 = om_m * om_m
        f1 = (5.0 / 16.0) * (hs * hs)[None] * (om_m2 * om_m2)
        om2 = om * om
        f2 = rdiv(1.0, om2 * om2 * om)
        r = t_m / tp_s[None]
        r2 = r * r
        f3 = torch.exp(-1.25 * (r2 * r2))
        sfreq = f1 * f2 * f3
    if p.nwavedirn == 1:
        theta_fac = torch.ones((1,) + tuple(hs.shape), dtype=hs.dtype, device=hs.device)
    else:
        dtheta = float(abs(sg["wavedir"][1] - sg["wavedir"][0]))
        theta_fac = torch.stack(
            [
                180.0 / (PI * dtheta)
                * theta_dir_frac(wavedir[nth] - dtheta / 2.0, dtheta, mwd)
                for nth in range(p.nwavedirn)
            ]
        )
    sdf = sfreq[:, None] * theta_fac[None, :]
    return torch.where(wave_mask[None, None] > 0.5, sdf, 0.0)


# ---------------------------------------------------------------------------
# Mean floe size <D> (getDave / floeScaling*, iceinfo.cpp:277-383)
# ---------------------------------------------------------------------------


def dave_from_dfloe(dfloe, ice_mask, p: WimParams, moment: int = 1):
    dmax = dfloe
    if p.fsdopt == "RG":
        # discrete renormalisation-group cascade (floeScaling,
        # iceinfo.cpp:277-325) in closed form via geometric series:
        # nsum  = (1-f) sum_{m<mm} ffac^m            + ffac^mm
        # ndsum = (1-f) dmax^M sum_{m<mm} (ffac/xi^M)^m + ffac^mm (dmax/xi^mm)^M
        ffac = p.fragility * p.xi**2
        r = dmax / p.dmin
        mm = torch.floor(torch.log(ties.maximum(r, 1.0)) / math.log(p.xi))
        mm = ties.maximum(mm, 0.0)

        def powt(q, n):  # q**n for a Python q and a tensor n
            return ties.pow(torch.full_like(n, q), n)

        def geo(q, n):  # sum_{m=0}^{n-1} q^m, n>=0 (q != 1 here: ffac=3.6)
            return (powt(q, n) - 1.0) / (q - 1.0)

        nsum = (1 - p.fragility) * geo(ffac, mm) + powt(ffac, mm)
        qd = ffac / p.xi**moment
        ndsum = (1 - p.fragility) * dmax**moment * geo(qd, mm) + powt(
            ffac, mm
        ) * (dmax / powt(p.xi, mm)) ** moment
        dave_b = ndsum / ties.maximum(nsum, 1e-15)
        dave = torch.where(
            (dmax >= p.xi * p.dmin) & (mm > 0),
            dave_b,
            ties.maximum(dmax**moment, p.dmin**moment),
        )
    else:
        # smooth power law P(d>D) = (Dmin/D)^fsd_exp (floeScalingSmooth,
        # iceinfo.cpp:328-356)
        fsd_exp = 2.0 + math.log(p.fragility) / math.log(p.xi)
        b = moment - fsd_exp
        dmax_s = ties.maximum(dmax, p.dmin * (1 + 1e-6))
        a = fsd_exp * torch.exp(fsd_exp * (math.log(p.dmin) + torch.log(dmax_s)))
        a = a / (torch.exp(fsd_exp * torch.log(dmax_s)) - p.dmin**fsd_exp)
        dave_big = -(a / b) * (p.dmin**b - torch.exp(b * torch.log(dmax_s)))
        dave = torch.where(dmax <= p.dmin, p.dmin**moment, dave_big)
    # uniform distribution above the MIZ threshold (getDave, iceinfo.cpp:375)
    dave = torch.where(dmax >= p.dfloe_miz_thresh, dmax**moment, dave)
    return torch.where(ice_mask > 0.5, dave, 0.0)


def dfloe_to_nfloes(dfloe, conc, p: WimParams):
    """(iceinfo.cpp:210-222)"""
    ok = (dfloe > 0) & (conc >= p.cice_min)
    d = ties.maximum(dfloe, 1e-6)
    return torch.where(ok, conc / (d * d), 0.0)


def nfloes_to_dfloe(nfloes, conc, p: WimParams):
    """(iceinfo.cpp:253-268)"""
    ok = (nfloes > 0) & (conc >= p.cice_min)
    d = torch.where(
        ok, torch.sqrt(ties.maximum(conc, 1e-20) / ties.maximum(nfloes, 1e-15)), 0.0
    )
    return ties.minimum(d, p.dfloe_pack_thresh)


# ---------------------------------------------------------------------------
# WENO(3) predictor-corrector advection (gridinfo.cpp:592-824)
# ---------------------------------------------------------------------------

_NG = 4  # ghost width (>=4 required by the scheme, gridinfo.cpp:618-623)


def _pad(h, advopt: str):
    """padVar (gridinfo.cpp:826+): ghost cells periodic per advopt, zero
    otherwise, on the last two dimensions. Dimension -2 = y, -1 = x (waves
    propagate along x in the ideal setups, so 'y-periodic' wraps y only)."""
    wrap_y = advopt in ("xy-periodic", "y-periodic")
    wrap_x = advopt == "xy-periodic"
    if wrap_y:
        h = torch.cat([h[..., -_NG:, :], h, h[..., :_NG, :]], dim=-2)
    else:
        h = F.pad(h, (0, 0, _NG, _NG))
    if wrap_x:
        return torch.cat([h[..., -_NG:], h, h[..., :_NG]], dim=-1)
    return F.pad(h, (_NG, _NG, 0, 0))


def _weno_sao(g, u, v, dx: float, dy: float, dt, advdim: int):
    """One weno3pdV2 stage on padded arrays: returns the spatial advective
    operator sao (gridinfo.cpp:659-824). Face flux F[i] sits between cells
    i-1 and i and uses the cell-centred speed at i, exactly as the C."""
    eps = 1e-12
    scp2 = dx * dy
    scp2i = 1.0 / scp2

    def face_flux(gq, vel, dim, face_len):
        gm1 = torch.roll(gq, 1, dim)
        gm2 = torch.roll(gq, 2, dim)
        gp1 = torch.roll(gq, -1, dim)
        pos = vel > 0.0
        q0p = -0.5 * gm2 + 1.5 * gm1
        q1p = 0.5 * gm1 + 0.5 * gq
        # frozen-limiter adjoint: the nonlinear WENO weight ratios carry
        # 1/(|Δg|+1e-12) factors whose linearization amplifies a reverse
        # pass without bound while the primal stays exact. The standard
        # adjoint of limited schemes freezes the limiter weights (linearize
        # the stencil, not the limiter); detach() is the identity in the
        # forward pass.
        d_m = torch.abs(gm1 - gq) + eps
        a1p = ((2.0 / 3.0) * (torch.abs(gm2 - gm1) + eps) / d_m).detach()
        wp = ((1.0 / 3.0) * q0p + a1p * q1p) / ((1.0 / 3.0) + a1p)
        q0n = 0.5 * gm1 + 0.5 * gq
        q1n = 1.5 * gq - 0.5 * gp1
        a1n = ((1.0 / 3.0) * d_m / (torch.abs(gq - gp1) + eps)).detach()
        wn = ((2.0 / 3.0) * q0n + a1n * q1n) / ((2.0 / 3.0) + a1n)
        fl = vel * torch.where(pos, gm1, gq) * face_len
        fh = vel * torch.where(pos, wp, wn) * face_len - fl
        return fl, fh

    ful, fuh = face_flux(g, u, -1, dy)
    if advdim == 2:
        fvl, fvh = face_flux(g, v, -2, dx)

    div_l = torch.roll(ful, -1, -1) - ful
    if advdim == 2:
        div_l = div_l + (torch.roll(fvl, -1, -2) - fvl)
    gt = g - dt * div_l * scp2i

    q = rdiv(0.25, dt)
    lo = -q * gt * scp2
    fuh = ful + torch.maximum(lo, torch.minimum(q * torch.roll(gt, 1, -1) * scp2, fuh))
    if advdim == 2:
        fvh = fvl + torch.maximum(lo, torch.minimum(q * torch.roll(gt, 1, -2) * scp2, fvh))
    sao = -(torch.roll(fuh, -1, -1) - fuh)
    if advdim == 2:
        sao = sao - (torch.roll(fvh, -1, -2) - fvh)
    return sao * scp2i


def weno_advect(h, u, v, dt, dx: float, dy: float, land_mask, advopt: str,
                advdim: int = 2):
    """waveAdvWeno (gridinfo.cpp:592-655): RK2 predictor-corrector with the
    weno3pd operator; land cells zeroed after the update. ``h`` is
    (..., ny, nx); ``u`` and ``v`` broadcast against it."""
    dt = _vec(dt, h)
    gp = _pad(h, advopt)
    up = _pad(u, "xy-periodic")
    vp = _pad(v, "xy-periodic")
    sao1 = _weno_sao(gp, up, vp, dx, dy, dt, advdim)
    hp = gp + dt * sao1
    sao2 = _weno_sao(hp, up, vp, dx, dy, dt, advdim)
    out = (0.5 * (gp + hp + dt * sao2))[..., _NG:-_NG, _NG:-_NG]
    return out * (1.0 - land_mask)


# ---------------------------------------------------------------------------
# Attenuation (attenSimple / attenIsotropic, wimdiscr.cpp:2249-2494)
# ---------------------------------------------------------------------------


def attenuate_spectrum(s_fq, ag, atten_dim, damp_dim, imask, dfloe, cos_d,
                       sin_d, wt_dir, dt_wim, p: WimParams):
    """Attenuate the directional spectrum of one frequency, (ndir, ny, nx),
    or of a block of them, (nf, ndir, ny, nx) with ``ag``, ``atten_dim`` and
    ``damp_dim`` (nf, ny, nx), and form the direction integrals. Returns
    (s_new, taux_om, tauy_om, sfreq, sdx_om, sdy_om).

    scatmod='dissipated' (attenSimple, wimdiscr.cpp:2249-2324): scattered
    energy is lost; every direction decays with the total coefficient.

    scatmod='isotropic' (attenIsotropic, wimdiscr.cpp:2328-2494): scattered
    energy is redistributed isotropically — in directional Fourier space the
    mean (mode 0) decays only by damping while every higher mode decays by
    scattering + damping. NOTE the reference's implementation declares but
    never fills its `theta_vec`/`nvec` angle arrays (wimdiscr.cpp:2334-2339,
    all zeros), collapsing its transform; here the intended Fourier-mode
    evolution is implemented exactly (one FFT over the direction axis), with
    the same q_scat/q_abs split: floes smaller than dfloe_pack_init scatter,
    pack ice only absorbs (wimdiscr.cpp:2368-2378). Stress and Stokes-drift
    integrals are only formed inside ice in this mode, as in the reference.
    """
    dt_wim = _vec(dt_wim, s_fq)
    ice = imask > 0.5
    in_ice = ice[None]
    agd = ag.unsqueeze(-3)  # against the direction axis
    cd = cos_d[:, None, None]
    sd = sin_d[:, None, None]
    wd = wt_dir[:, None, None]
    if not p.atten:
        taux_om = tauy_om = torch.zeros_like(ag)
    elif p.scatmod == "isotropic":
        ndir = s_fq.shape[-3]
        wt = 2 * PI / ndir
        scattering = dfloe < p.dfloe_pack_init
        q_scat = torch.where(scattering, atten_dim, 0.0)
        q_abs = torch.where(scattering, damp_dim, atten_dim + damp_dim)
        q_tot = q_scat + q_abs
        # direction-axis DFT; the true mode-1 coefficient on the theta grid
        # (theta_d = -pi + 2pi d/N from adv_dir) is F[1] = -wt*FFT[1]
        spec = torch.fft.fft(s_fq, dim=-3)
        f1 = spec.select(-3, 1)
        f1_re, f1_im = -wt * f1.real, -wt * f1.imag
        taux_om = torch.where(ice, q_tot * ag * f1_re, 0.0)
        tauy_om = torch.where(ice, -q_tot * ag * f1_im, 0.0)
        n0 = (torch.arange(ndir, device=s_fq.device) == 0)[:, None, None]
        decay = torch.where(
            n0,
            torch.exp(-q_abs * ag * dt_wim).unsqueeze(-3),
            torch.exp(-q_tot * ag * dt_wim).unsqueeze(-3),
        )
        s_dec = torch.fft.ifft(spec * decay, dim=-3).real
        s_fq = torch.where(in_ice, s_dec.to(s_fq.dtype), s_fq)
    else:  # dissipated
        alp = (atten_dim + damp_dim).unsqueeze(-3)
        src = -alp * agd * s_fq
        taux_om = torch.where(in_ice, -cd * wd * src, 0.0).sum(dim=-3)
        tauy_om = torch.where(in_ice, -sd * wd * src, 0.0).sum(dim=-3)
        s_fq = torch.where(in_ice, s_fq * torch.exp(-alp * agd * dt_wim), s_fq)

    sfreq = (wd * s_fq).sum(dim=-3)
    sdx_om = ((wt_dir * cos_d)[:, None, None] * s_fq).sum(dim=-3)
    sdy_om = ((wt_dir * sin_d)[:, None, None] * s_fq).sum(dim=-3)
    if p.atten and p.scatmod == "isotropic":
        sdx_om = torch.where(ice, sdx_om, 0.0)
        sdy_om = torch.where(ice, sdy_om, 0.0)
    return s_fq, taux_om, tauy_om, sfreq, sdx_om, sdy_om


# ---------------------------------------------------------------------------
# One WIM time step (wimdiscr.cpp:822-1210)
# ---------------------------------------------------------------------------

_ACC_KEYS = ("tau_x", "tau_y", "mwd_x", "mwd_y", "sd_x", "sd_y",
             "mom0w", "mom2w", "mom0", "mom2", "var_strain")


def _freq_block(sdf, shape=None) -> int:
    """Frequencies advanced together: as many as _BLOCK_BYTES holds for
    planes of ``shape`` (default: the spectrum's own). The sums over a block
    of frequencies group the integrals, so a block on a device mesh passes
    the whole grid's shape and groups them as one device does."""
    nf, nd = sdf.shape[:2]
    ny, nx = sdf.shape[2:] if shape is None else shape
    per_freq = nd * (ny + 2 * _NG) * (nx + 2 * _NG) * sdf.element_size() * _WENO_LIVE
    return max(1, min(nf, _BLOCK_BYTES // per_freq))


def wim_time_step(sdf, ice: Dict[str, Any], medium, sg_dev, p: WimParams,
                  dt_wim, dx: float, land_mask, steady_in=None, block: Optional[int] = None):
    """Advance the directional spectrum one WIM substep and do breaking.

    sdf: (nfreq, ndir, ny, nx); ice: dict with conc, thick, dfloe, nfloes,
    broken, mask; medium: per-frequency wave-medium dict; steady_in:
    optional (sdf_inc, steady_mask) for the steady-state forcing.

    No frequency depends on another within a substep, so the frequencies
    are advanced in blocks (``block`` of them, default ``_freq_block``),
    each with all its directions, and their integrals are added up in
    frequency order.
    """
    conc, thick = ice["conc"], ice["thick"]
    imask = ice["mask"]
    adv_dir = _vec(sg_dev["adv_dir"], sdf)
    wt_dir = _vec(sg_dev["wt_dir"], sdf)
    wt_freq = _vec(sg_dev["wt_freq"], sdf)
    freq = _vec(sg_dev["freq"], sdf)
    dt_wim = _vec(dt_wim, sdf)
    cos_d = torch.cos(adv_dir)
    sin_d = torch.sin(adv_dir)

    # steady forcing (wimdiscr.cpp:893-908): directions travelling in +x
    if p.steady and steady_in is not None:
        sdf_inc, steady_mask = steady_in
        reset = (cos_d >= 0.0)[None, :, None, None] & (
            steady_mask[None, None] > 0.5
        )
        sdf = torch.where(reset, sdf_inc, sdf)

    # mean floe size <D> (wimdiscr.cpp:912)
    dave = dave_from_dfloe(ice["dfloe"], imask, p, moment=1)
    in_ice = imask > 0.5
    c1d = torch.where(in_ice, conc / ties.maximum(dave, 1e-6), 0.0)

    tau_fac = p.rhowtr * p.gravity
    nf = sdf.shape[0]
    block = _freq_block(sdf) if block is None else block
    sdf_new = torch.empty_like(sdf)
    tot = None
    for f0 in range(0, nf, block):
        sl = slice(f0, min(nf, f0 + block))
        ag, cp = medium["ag_eff"][sl], medium["ap_eff"][sl]
        wt = wt_freq[sl, None, None]
        om = 2 * PI * freq[sl, None, None]
        kicel = rdiv(2 * PI, medium["wlng_ice"][sl])
        f_ = medium["disp_ratio"][sl]
        ff = f_ * f_
        f2 = ff if p.ref_hs_ice else torch.ones_like(f_)

        atten_dim = medium["atten_nond"][sl] * c1d
        damp_dim = 2.0 * medium["damping"][sl] * conc

        # advect all directions (advectDirections, wimdiscr.cpp:2052-2072)
        s_fq = weno_advect(
            sdf[sl], ag[:, None] * cos_d[:, None, None], ag[:, None] * sin_d[:, None, None],
            dt_wim, dx, dx, land_mask, p.advopt, p.advdim,
        )

        # attenuation + direction integrals (attenSimple / attenIsotropic)
        s_fq, taux_om, tauy_om, sfreq, sdx_om, sdy_om = attenuate_spectrum(
            s_fq, ag, atten_dim, damp_dim, imask, ice["dfloe"], cos_d, sin_d,
            wt_dir, dt_wim, p,
        )
        sdf_new[sl] = s_fq
        del s_fq

        # frequency integrals (wimdiscr.cpp:989-1070)
        strain = f_ * (kicel * kicel) * thick / 2.0
        acc = dict(
            tau_x=wt * tau_fac * taux_om / cp,
            tau_y=wt * tau_fac * tauy_om / cp,
            mwd_x=wt * f2 * sdx_om,
            mwd_y=wt * f2 * sdy_om,
            sd_x=wt * 2 * om * kicel * f2 * sdx_om,
            sd_y=wt * 2 * om * kicel * f2 * sdy_om,
            mom0w=torch.abs(wt * sfreq),
            mom2w=torch.abs(wt * (om * om) * sfreq),
            mom0=torch.abs(wt * sfreq * ff),
            mom2=torch.abs(wt * (om * om) * sfreq * ff),
            var_strain=torch.where(in_ice, torch.abs(wt * sfreq * (strain * strain)), 0.0),
        )
        part = {k: acc[k].sum(dim=0) for k in _ACC_KEYS}
        tot = part if tot is None else {k: tot[k] + part[k] for k in _ACC_KEYS}

    # integrated wave parameters (wimdiscr.cpp:1115-1146)
    mom0 = tot["mom0"] if p.ref_hs_ice else tot["mom0w"]
    mom2 = tot["mom2"] if p.ref_hs_ice else tot["mom2w"]
    hs = 4.0 * torch.sqrt(mom0 + 1e-20)
    tp_ = torch.where(
        mom2 > 0.0,
        2 * PI * torch.sqrt(ties.maximum(mom0, 1e-20) / ties.maximum(mom2, 1e-15)),
        0.0,
    )
    mwd = torch.where(
        mom2 > 0.0, -90.0 - (180.0 / PI) * ties.atan2(tot["mwd_y"], tot["mwd_x"]), 0.0
    )

    # floe breaking (doBreaking, iceinfo.cpp:172-203)
    dfloe, nfloes, broken = ice["dfloe"], ice["nfloes"], ice["broken"]
    if p.breaking:
        crit = in_ice & (2.0 * tot["var_strain"] > p.epsc**2)
        om_b = torch.sqrt(
            ties.maximum(tot["mom2"], 1e-20) / ties.maximum(tot["mom0"], 1e-15)
        )
        om_b = ties.maximum(om_b, 1e-3)  # keep the masked-out Newton finite
        out_b = rtparam.rtparam_outer(
            thick, om_b, p.drag_rp, om_b * om_b / p.gravity,
            young=p.young, gravity=p.gravity, rhowtr=p.rhowtr,
            rhoice=p.rhoice, poisson=p.poisson,
        )
        lam = rdiv(2 * PI, out_b["kice"])
        brk = crit & (lam < 2.0 * dfloe)
        dfloe = torch.where(brk, ties.maximum(lam / 2.0, p.dmin), dfloe)
        nfloes = torch.where(brk, dfloe_to_nfloes(dfloe, conc, p), nfloes)
        broken = torch.where(brk, 1.0, broken)

    ice_new = dict(ice, dfloe=dfloe, nfloes=nfloes, broken=broken)
    diag = dict(
        hs=hs, tp=tp_, mwd=mwd,
        tau_x=tot["tau_x"], tau_y=tot["tau_y"],
        stokes_x=tot["sd_x"], stokes_y=tot["sd_y"],
        mwd_x=tot["mwd_x"], mwd_y=tot["mwd_y"],
        mom0=mom0, mom2=mom2, var_strain=tot["var_strain"],
    )
    return sdf_new, ice_new, diag


# ---------------------------------------------------------------------------
# The run loop (WimDiscr::run, wimdiscr.cpp:1938-2050)
# ---------------------------------------------------------------------------


class Wim:
    """The WIM on a structured grid: its state and its run loop.

    Standalone (reference uncoupled nextwim.exec): `ideal_ice_fields` +
    `ideal_wave_fields` then `run(duration)`. Coupled: the Simulator sets
    the ice and wave fields every ``nextwim.couplingfreq`` steps, runs the
    coupling window and receives wave stress + breakage.

    The spectrum and every ice and medium plane live on ``device`` (the
    card unless the caller asks for the CPU). With ``mesh``, the rank's
    ``seam.Seam`` on a device mesh, they are this rank's ext blocks of the
    WIM's layout (module docstring): ``set_ice_fields`` and
    ``set_wave_fields`` take planes of that layout (``to_blocks`` cuts them
    from global ones), and ``gather`` puts results together.
    """

    def __init__(self, params: WimParams, grid, dtype=torch.float32, device="cuda", mesh=None):
        self.p = params
        self.grid = grid
        self.dtype = dtype
        self.device = torch.device(device)
        self.sg = spectral_grids(params)
        ny, nx = grid.shape
        self.shape = (ny, nx)
        self.mesh = None
        if mesh is not None:
            wrap_y = params.advopt in ("xy-periodic", "y-periodic")
            self.mesh = mesh.derive(seam.WIM_RING, periodic=(wrap_y, params.advopt == "xy-periodic"))
        self.land = self.to_blocks(self._tensor(1.0 - np.asarray(grid.mask)))
        self.dx = float(grid.dx)
        self.sdf = self.to_blocks(torch.zeros(
            (params.nwavefreq, params.nwavedirn, ny, nx), dtype=dtype, device=self.device
        ))
        self.ice: Optional[Dict[str, Any]] = None
        self.diag: Dict[str, Any] = {}
        self._steady_in = None
        # the spectral grids as tensors, uploaded once
        self._sg_dev = {k: self._tensor(v) for k, v in self.sg.items()}
        # CFL-limited spectral step (update(), wimdiscr.cpp:390-398);
        # group speeds are the open-water ones -> static timestep
        self.max_cg = float(np.max(self.sg["ag_wtr"]))
        self.dt_cfl = params.cfl * self.dx / self.max_cg

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def to_blocks(self, tree):
        """This rank's ext blocks of the global planes of ``tree`` on a
        device mesh; ``tree`` itself on one device."""
        return tree if self.mesh is None else self.mesh.to_blocks(tree)

    def gather(self, tree):
        """Host numpy copy of ``tree`` with the global value of every block
        on a device mesh (collective)."""
        return to_host(tree) if self.mesh is None else self.mesh.gather(tree)

    # -- ice / wave setup ------------------------------------------------
    def set_ice_fields(self, conc, vol, nfloes):
        """(IceInfo::setFields + updateFields, iceinfo.cpp:85-164)"""
        p = self.p
        conc, vol, nfloes = self._tensor(conc), self._tensor(vol), self._tensor(nfloes)
        keep = conc >= p.cice_min
        conc = torch.where(keep, conc, 0.0)
        vol = torch.where(keep, vol, 0.0)
        nfloes = torch.where(keep, nfloes, 0.0)
        thick = torch.where(keep, vol / ties.maximum(conc, 1e-12), 0.0)
        dfloe = nfloes_to_dfloe(nfloes, conc, p)
        # `broken` marks cells whose floes are in a broken state (dfloe below
        # the unbroken-pack size); new breakage this window ORs into it in
        # wim_time_step. Persistent (not newly-broken-only) so the coupled
        # damage/FSD feeds see the full broken zone each window — applied
        # with max()/idempotent redistribution, so this matches the
        # reference's break_on_mesh effect (wimdiscr.cpp breaking on mesh).
        broken = keep & (dfloe > 0.0) & (dfloe < p.dfloe_pack_init)
        self.ice = dict(
            conc=conc, vol=vol, nfloes=nfloes, thick=thick, dfloe=dfloe,
            mask=keep.to(self.dtype), broken=broken.to(self.dtype),
        )

    def _x_edge(self, xfac: float) -> float:
        """The edge of the ideal fields along x, from the whole grid's cell
        centres (idealIceFields, wimdiscr.cpp:793-820)."""
        x = self._tensor(np.arange(self.shape[1]) * self.dx)
        xmin, xmax = float(x.min()), float(x.max())
        return 0.5 * (xmin + xmax) - xfac * 0.5 * (xmax - xmin)

    def ideal_ice_fields(self, xfac: float = 0.7):
        """Uniform ice for x >= x_edge (idealIceFields, wimdiscr.cpp:793-820)."""
        p = self.p
        x = self._cell_x()
        in_ice = (x >= self._x_edge(xfac)) & (self.land < 0.5)
        conc = torch.where(in_ice, torch.full_like(x, p.unifc), 0.0)
        vol = conc * p.unifh
        nfloes = torch.where(in_ice, torch.full_like(x, p.unifc / p.dfloe_pack_init**2), 0.0)
        self.set_ice_fields(conc, vol, nfloes)

    def ideal_wave_fields(self, xfac: float = 0.8):
        """Incident waves for x < x_edge (idealWaveFields, wimdiscr.cpp:527-566)."""
        p = self.p
        x = self._cell_x()
        wave_mask = ((x < self._x_edge(xfac)) & (self.land < 0.5)).to(self.dtype)
        hs = wave_mask * p.hs_inc
        tp_ = wave_mask * p.tp_inc
        mwd = wave_mask * p.mwd_inc
        self.set_wave_fields(hs, tp_, mwd, wave_mask=wave_mask)

    def set_wave_fields(self, swh, mwp, mwd, wave_mask=None):
        """(setWaveFields, wimdiscr.cpp:568-664)"""
        p = self.p
        swh, mwp, mwd = self._tensor(swh), self._tensor(mwp), self._tensor(mwd)
        if wave_mask is None:
            ice_mask = self.ice["mask"] if self.ice is not None else torch.zeros_like(swh)
            wave_mask = (
                (ice_mask < 0.5) & (self.land < 0.5)
                & (swh > 1e-3) & (mwp > 1e-8) & (mwp < 1.5 * p.tmax)
            ).to(self.dtype)
        inc = inc_wave_spec(swh, mwp, mwd, wave_mask, self._sg_dev, p)
        self.sdf = torch.where(wave_mask[None, None] > 0.5, inc, self.sdf)
        if p.steady and self._steady_in is None:
            self._steady_in = (self.sdf, wave_mask)

    def _cell_x(self) -> torch.Tensor:
        """x of the cell centres of this rank's planes, in the whole grid's
        coordinates."""
        return self.to_blocks(self._tensor(np.tile(np.arange(self.shape[1]) * self.dx, (self.shape[0], 1))))

    # -- integration -----------------------------------------------------
    def _run_scan(self, sdf, ice, medium, steady_in, dt_wim, n_steps: int):
        """``n_steps`` WIM time steps from (sdf, ice) on ``medium``: (sdf,
        ice, the last step's diagnostics). Pure, so differentiable; the
        steady input may be zeros when ``p.steady`` is off, as the JAX
        package passes it. On a device mesh the rings of the spectrum and
        of the floe fields breaking changes are exchanged after every time
        step."""
        diag = {}
        block = _freq_block(sdf, self.shape)  # from the whole grid, as one device takes them
        for _ in range(n_steps):
            sdf, ice, diag = wim_time_step(
                sdf, ice, medium, self._sg_dev, self.p, dt_wim, self.dx, self.land, steady_in,
                block=block,
            )
            if self.mesh is not None:
                sdf, *floes = self.mesh.ring([sdf] + [ice[k] for k in _FLOE_KEYS])
                ice = dict(ice, **dict(zip(_FLOE_KEYS, floes)))
        return sdf, ice, diag

    def run(self, duration: float) -> Dict[str, Any]:
        """Integrate the spectrum over `duration` seconds (run(),
        wimdiscr.cpp:1938-2050). Returns the final diagnostics dict."""
        if self.ice is None:
            self.ideal_ice_fields(0.7)
        # one read-back per run, the same answer on every rank of a mesh
        if self._steady_in is None and not self._any(self.sdf > 0):
            self.ideal_wave_fields(0.8)
        n_steps = max(1, int(math.ceil(duration / self.dt_cfl)))
        dt_wim = self._tensor(duration / n_steps)
        medium = update_wave_medium(
            self.ice["thick"], self.ice["mask"], self._sg_dev, self.p
        )
        steady = self._steady_in if self.p.steady else None
        self.sdf, self.ice, self.diag = self._run_scan(
            self.sdf, self.ice, medium, steady, dt_wim, n_steps)
        return self.diag

    def _any(self, flags: torch.Tensor) -> bool:
        """``flags.any()`` over the whole grid (over the ranks of a mesh)."""
        hit = torch.any(flags)
        if self.mesh is None:
            return bool(hit)
        return bool(self.mesh.max_all(hit.to(torch.int32)))


#: the floe fields a WIM time step changes (breaking), exchanged with the
#: spectrum on a device mesh
_FLOE_KEYS = ("dfloe", "nfloes", "broken")
