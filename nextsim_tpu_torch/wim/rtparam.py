"""Wave–ice scattering/attenuation parameters (RTparam) (the counterpart of
nextsim_tpu/wim/rtparam.py).

Reimplementation of the reference WIM's RTparam stack (reference:
modules/wim/src/RTparam_outer.c, RTparam_fast.c, RTparam_hardcoded.c) — the
per-floe scattering model of Kohout & Meylan (2008) as used by Williams et
al. (2013a,b):

* Newton solves of the open-water and ice-covered (thin-elastic-plate)
  dispersion relations in non-dimensional form (RTparam_outer.c:118-225),
  vectorised over cells with a fixed number of iterations instead of the
  reference's per-cell `while |dk|>eps` (Newton is quadratically convergent;
  extra iterations at the root are no-ops, and the fixed count is what makes
  the result the JAX package's).
* 2-D Chebyshev interpolation of the pre-computed attenuation /
  reflection-transmission tables over the (alp_nd, h_nd) plane
  (RTparam_fast.c:16-584). The ten coefficient tables are physical data
  (rtparam_tables.npz, the JAX package's file); each is contracted with the
  Chebyshev bases as one small matrix product and the cell's regime selects
  its table.

Outputs match RTparam_outer's `outputs[8]`:
  damping, kice, kwtr, int_adm, atten_nond (ac), modT, argR, argT.
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from nextsim_tpu_torch.core import ties
from nextsim_tpu_torch.ops.rheology import _fast_pow, rdiv

_H_ND = 4.0  # infinite-depth proxy used in the scattering model (RTparam_outer.c:23)

# regime tables (RTparam_fast.c:24-31)
_ALP_LIMS_BASE = (1.0e-6, 0.005, 0.3, 1.5)  # lims[0..3]; [4],[5] are h-dependent
_MC_ALPLIN = (-3.323529252398524, 3.119943407349375)
_Y0_LL, _DY_LL, _N_LL, _H1_LL = 40.0, 120.0, 3, 0.4
_HND_LIMS = (1.0e-2, 0.2, 0.4)
_LOG_A = (1, 1, 1, 0, 1)  # log-interp in alp_nd per OPT
_INTERP_MODE = (1, 1, 3, 2, 1)  # per OPT (RTparam_fast.c:145)

#: fixed Newton iteration count of the dispersion solves
NEWTON_ITERS = 60


@functools.lru_cache(maxsize=1)
def _load_tables():
    path = os.path.join(os.path.dirname(__file__), "rtparam_tables.npz")
    with np.load(path) as f:
        return np.asarray(f["tables"]), np.asarray(f["ncx"]), np.asarray(f["ncy"])


@functools.lru_cache(maxsize=8)
def _tables_on(dtype, device):
    """The (10, 11, 11*4) coefficient tables as a tensor, cached per dtype
    and device."""
    tables, _, _ = _load_tables()
    t = torch.as_tensor(tables, dtype=dtype, device=device)
    return t.reshape(t.shape[0], t.shape[1], -1).contiguous()


# ---------------------------------------------------------------------------
# Dispersion-relation Newton solvers
# ---------------------------------------------------------------------------

def _nr_corr_term(k, delta, H, fac):
    """Newton correction dk = f/f' for the (non-dimensional) dispersion
    function f = Lam*k*sinh(kH) - cosh(kH), Lam = fac*k^4 + delta
    (reference: RTparam_outer.c:197-222). fac=1 → ice plate, fac=0 → water."""
    k4 = k * k * k * k
    lam = fac * k4 + delta
    lampr = 5.0 * fac * k4 + delta
    kh = k * H
    small = torch.abs(kh) <= 7.5
    khc = ties.clip(kh, -7.5, 7.5)  # keep the unselected sinh branch finite
    sinh, cosh, tanh = torch.sinh(khc), torch.cosh(khc), torch.tanh(kh)
    f_s = lam * k * sinh - cosh
    df_s = lam * khc * cosh + (lampr - H) * sinh
    f_t = lam * k * tanh - 1.0
    df_t = lam * kh + (lampr - H) * tanh
    f = torch.where(small, f_s, f_t)
    df = torch.where(small, df_s, df_t)
    return f / df, lam, lampr


def _gen_root(guess, delta, H, fac, iters: int = NEWTON_ITERS):
    """Find the dispersion root nearest `guess` (gen_root_{ice,wtr},
    RTparam_outer.c:118-196). Returns (k, BG, avc)."""
    k = guess
    for _ in range(iters):
        dk, _, _ = _nr_corr_term(k, delta, H, fac)
        k = k - dk
    k = torch.abs(k)  # may converge to the negative root
    _, lam, lampr = _nr_corr_term(k, delta, H, fac)
    denom = H * (lam * lam * k * k - 1.0) + lampr
    res = -k / denom
    bg = lam * lam * res
    avc = k / denom
    return k, bg, avc


# ---------------------------------------------------------------------------
# Chebyshev table interpolation (RTparam_fast)
# ---------------------------------------------------------------------------

def _cheb_basis(t, order: int = 10):
    """T_0..T_order at t, shape (..., order+1), by the three-term recurrence."""
    ts = [torch.ones_like(t), t]
    for _ in range(order - 1):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return torch.stack(ts, dim=-1)


def _rtparam_fast(alp_nd, hnd, int_adm):
    """Interpolated attenuation coefficient + |T|, arg R, arg T
    (reference: RTparam_fast.c:16-128 regime selection, 130-445 dispatch,
    589-638 interpretation). Vectorised and branch-free."""
    dtype, device = alp_nd.dtype, alp_nd.device
    tables = _tables_on(dtype, device)

    # h-dependent regime limits (computed from the raw hnd, as in the C)
    hnd_safe = ties.clip(hnd, _HND_LIMS[0], _H1_LL)
    alp_lin3 = _MC_ALPLIN[1] + _MC_ALPLIN[0] * torch.log(hnd_safe)
    dtmp = ties.maximum(torch.cos(hnd_safe / _H1_LL * math.pi / 2.0), 1e-30)
    alp_lin4 = _Y0_LL + _DY_LL * _fast_pow(dtmp, _N_LL)

    # thickness regime
    hnd_c = ties.clip(hnd, _HND_LIMS[0], _HND_LIMS[2])
    low = hnd_c < _HND_LIMS[1]
    h0 = torch.where(low, _HND_LIMS[0], torch.full_like(hnd_c, _HND_LIMS[1]))
    h1 = torch.where(low, _HND_LIMS[1], torch.full_like(hnd_c, _HND_LIMS[2]))
    t_h_log = -1.0 + 2.0 * (torch.log(hnd_c) - torch.log(h0)) / (torch.log(h1) - torch.log(h0))
    t_h_lin = -1.0 + 2.0 * (hnd_c - h0) / (h1 - h0)
    t_h = torch.where(low, t_h_log, t_h_lin)

    # frequency regime: lims[0..5]; OPT = index of the bracketing interval
    lims = torch.stack(
        [torch.full_like(alp_nd, lim) for lim in _ALP_LIMS_BASE] + [alp_lin3, alp_lin4],
        dim=-1,
    )
    alp_c = torch.maximum(torch.minimum(alp_nd, lims[..., 5]), lims[..., 0])
    # opt in {0..4}: number of lims[1..4] not above alp_c
    opt = torch.sum(alp_c[..., None] >= lims[..., 1:5], dim=-1)
    opt = ties.clip(opt, 0, 4)
    a0 = torch.take_along_dim(lims, opt[..., None], dim=-1)[..., 0]
    a1 = torch.take_along_dim(lims, opt[..., None] + 1, dim=-1)[..., 0]
    log_a = torch.as_tensor(_LOG_A, dtype=dtype, device=device)[opt]
    t_a_log = -1.0 + 2.0 * (torch.log(alp_c) - torch.log(a0)) / (torch.log(a1) - torch.log(a0))
    t_a_lin = -1.0 + 2.0 * (alp_c - a0) / (a1 - a0)
    t_a = torch.where(log_a > 0.5, t_a_log, t_a_lin)

    # table index = LOW*5 + OPT (tables zero-padded to (10,11,11,4))
    tidx = torch.where(low, 5, 0) + opt
    shape = alp_nd.shape
    tx = _cheb_basis(t_a).reshape(-1, 11)  # (N, 11) in alp
    ty = _cheb_basis(t_h).reshape(-1, 11)  # (N, 11) in h
    # z[n, col] = tx[n] · A[table(n)] · ty[n], one table at a time
    flat_idx = tidx.reshape(-1)
    z = torch.zeros((tx.shape[0], 4), dtype=dtype, device=device)
    for t in range(tables.shape[0]):
        z_t = ((tx @ tables[t]).reshape(-1, 11, 4) * ty[:, :, None]).sum(dim=1)
        z = torch.where((flat_idx == t)[:, None], z_t, z)
    z = z.reshape(shape + (4,))

    im = torch.as_tensor(_INTERP_MODE, device=device)[opt]  # 1, 2 or 3
    # modes 1/2: z = (log-)ac, argR, argT
    ac_12 = torch.where(im == 1, torch.exp(z[..., 0]), z[..., 0])
    arg_r_12 = z[..., 1]
    arg_t_12 = z[..., 2]
    mod_t_12 = torch.sqrt(torch.exp(-ac_12 / 2.0) / int_adm)
    # mode 3: z = Re R, Im R, Re T, Im T
    rr, ri, tr, ti = z[..., 0], z[..., 1], z[..., 2], z[..., 3]
    arg_r_3 = ties.atan2(ri, rr)
    arg_t_3 = ties.atan2(ti, tr)
    mod_r2 = rr * rr + ri * ri
    mod_t_3 = torch.sqrt(tr * tr + ti * ti)
    ac_3 = -2.0 * torch.log(ties.maximum(1.0 - mod_r2, 1e-30))

    is3 = im == 3
    ac = torch.where(is3, ac_3, ac_12)
    mod_t = torch.where(is3, mod_t_3, mod_t_12)
    arg_r = torch.where(is3, arg_r_3, arg_r_12)
    arg_t = torch.where(is3, arg_t_3, arg_t_12)
    return ac, mod_t, arg_r, arg_t


# ---------------------------------------------------------------------------
# Outer routine
# ---------------------------------------------------------------------------

def rtparam_outer(h, om, visc_rp, guess, *, young=5.49e9, gravity=9.81,
                  rhowtr=1025.0, rhoice=922.5, poisson=0.3):
    """Vectorised RTparam_outer (reference: RTparam_outer.c:16-112).

    ``h`` is a tensor of ice thickness [m]; radian frequency ``om`` and the
    initial wavenumber guess [1/m] for the ice dispersion root are tensors
    that broadcast against it (or Python numbers); ``visc_rp`` is the
    Robinson-Palmer drag [Pa s/m].

    Returns a dict: damping [1/m], kice [1/m], kwtr [1/m], int_adm,
    atten_nond (ac, per-floe non-dimensional attenuation), modT, argR, argT.
    """
    hs = ties.maximum(h, 1e-6)  # guard h=0 lanes (masked out by callers)
    om = torch.as_tensor(om, dtype=h.dtype, device=h.device)
    rho = rhoice / rhowtr
    flex = young * _fast_pow(hs, 3) / 12.0 / (1.0 - poisson ** 2)
    L = torch.exp(0.2 * torch.log(flex / rhowtr / (om * om)))
    alp_nd = om * om / gravity * L
    h_nd = hs / L
    zeta_nd = rho * h_nd

    # ice wavenumber
    varpi_i = rdiv(1.0, alp_nd) - zeta_nd
    ki, bg2, avc = _gen_root(guess * L, varpi_i, _H_ND, 1.0)
    kice = ki / L

    # water wavenumber
    varpi_w = rdiv(1.0, alp_nd)
    hw_nd = _H_ND + zeta_nd
    kw, bg1, _ = _gen_root(alp_nd, varpi_w, hw_nd, 0.0)
    kwtr = kw / L

    int_adm = bg1 / bg2

    visc_rp_nd = rdiv(visc_rp / rhowtr, om) / L
    damping = avc * visc_rp_nd / L

    ac, mod_t, arg_r, arg_t = _rtparam_fast(alp_nd, h_nd, int_adm)
    return {
        "damping": damping,
        "kice": kice,
        "kwtr": kwtr,
        "int_adm": int_adm,
        "atten_nond": ac,
        "modT": mod_t,
        "argR": arg_r,
        "argT": arg_t,
    }
