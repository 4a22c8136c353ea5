"""Reverse mode through the PyTorch port's waves-in-ice module, on the CPU:
the counterparts of tests/test_grad.py's WIM tests, through
``update_wave_medium`` (the per-frequency attenuation's Newton solves) and
``Wim._run_scan`` (``wim_time_step``: WENO advection with the frozen-limiter
adjoint, attenuation, breaking).

As in tests/test_torch_grad.py, each counterpart (a) asserts on the port in
float32 what the JAX test asserts (finite, nonzero, the directional finite
difference at rtol 0.1) and (b) holds the port's gradient to the JAX
package's in float64 on the same inputs: 1e-9 of its magnitude, the
tolerance of the float64 WIM parity tests (tests/test_torch_wim.py).
Measured: 1.2e-10 over 8 steps of 8 frequencies, 9.1e-16 for the
adversarial zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nextsim_tpu.grid.grid import Grid as JGrid
from nextsim_tpu.wim import wim as jw
from nextsim_tpu_torch.core import ties
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.wim import wim as pw
from test_torch_grad import assert_grad_close

torch.set_num_threads(1)

RTOL_F64 = 1e-9


def _jax_wim(nfreq, dtype=jnp.float64):
    p = jw.WimParams(nwavefreq=nfreq, nwavedirn=8, steady=False)
    w = jw.Wim(p, JGrid.square(nx=32, ny=8, dx=4e3), dtype=dtype)
    w.ideal_ice_fields(0.7)
    w.ideal_wave_fields(0.8)
    return w


def _port_wim(nfreq, dtype):
    p = pw.WimParams(nwavefreq=nfreq, nwavedirn=8, steady=False)
    w = pw.Wim(p, PGrid.square(nx=32, ny=8, dx=4e3), dtype=dtype, device="cpu")
    w.ideal_ice_fields(0.7)
    w.ideal_wave_fields(0.8)
    return w


def _port_loss(w, n_steps, ice=None, tau=lambda t: t):
    """tests/test_grad.py's WIM loss on the port: mean Hs + 1e3 mean
    tau(tau_x) after ``n_steps`` steps, as a function of the ice volume."""
    ice0 = dict(w.ice if ice is None else ice)
    steady = (torch.zeros_like(w.sdf), torch.zeros(w.shape, dtype=w.dtype))
    dt = w._tensor(w.dt_cfl)

    def loss(vol):
        ice = dict(ice0)
        ice["thick"] = torch.where(ice["mask"] > 0.5, vol / ties.maximum(ice["conc"], 1e-12), 0.0)
        ice["vol"] = vol
        medium = pw.update_wave_medium(ice["thick"], ice["mask"], w._sg_dev, w.p)
        _, _, diag = w._run_scan(w.sdf, ice, medium, steady, dt, n_steps)
        return diag["hs"].mean() + 1e3 * tau(diag["tau_x"]).mean()

    return loss


def _grad(loss, x):
    x = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    return g


def test_grad_through_wim():
    """The sensitivity of attenuated wave height + wave-to-ice stress to the
    ice volume is finite, nonzero and matches a directional central
    difference (rtol 0.1); and equals JAX's in float64."""
    w = _port_wim(8, torch.float32)
    loss = _port_loss(w, 8)
    vol0 = w.ice["vol"]
    g = _grad(loss, vol0)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0
    rng = np.random.default_rng(2)
    mask = w.ice["mask"].numpy()
    d = rng.standard_normal(mask.shape).astype(np.float32) * mask
    d = torch.from_numpy(0.25 * (np.roll(d, 1, 0) + np.roll(d, -1, 0)
                                 + np.roll(d, 1, 1) + np.roll(d, -1, 1)))
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(vol0 + eps * d)) - float(loss(vol0 - eps * d))) / (2 * eps)
    ad = float((g * d).sum())
    assert fd != 0.0
    np.testing.assert_allclose(ad, fd, rtol=0.1)

    with jax.enable_x64(True):
        jwim = _jax_wim(8)
        steady = (jnp.zeros_like(jwim.sdf), jnp.zeros(jwim.shape, jwim.dtype))

        def jloss(vol):
            ice = dict(jwim.ice)
            ice["thick"] = jnp.where(ice["mask"] > 0.5, vol / jnp.maximum(ice["conc"], 1e-12), 0.0)
            ice["vol"] = vol
            medium = jw.update_wave_medium(ice["thick"], ice["mask"], jwim.sg, jwim.p)
            _, _, diag = jwim._run_scan(jwim.sdf, ice, medium, steady,
                                        jnp.asarray(jwim.dt_cfl, jwim.dtype), 8)
            return jnp.mean(diag["hs"]) + 1e3 * jnp.mean(diag["tau_x"])

        ref = np.asarray(jax.jit(jax.grad(jloss))(jwim.ice["vol"]))
    w64 = _port_wim(8, torch.float64)
    np.testing.assert_array_equal(w64.ice["vol"].numpy(), np.asarray(jwim.ice["vol"]))
    assert_grad_close(ref, _grad(_port_loss(w64, 8), w64.ice["vol"]), RTOL_F64, "d loss / d vol")


def test_grad_wim_adversarial_zeros():
    """WIM gradients stay finite at the hazard points: an exactly ice-free
    strip inside the pack, a dead-calm strip in the wave zone, zero nfloes;
    and equal JAX's in float64."""
    def poke(w, xp):
        """tests/test_grad.py's edits, with ``xp`` the array module."""
        conc = np.asarray(w.ice["conc"]).copy()
        conc[:, 20:24] = 0.0
        mask = (conc >= w.p.cice_min).astype(conc.dtype)
        vol = np.asarray(w.ice["vol"]).copy() * mask
        sdf = np.asarray(w.sdf).copy()
        sdf[..., 3:5, :] = 0.0
        ice = dict(w.ice, conc=xp(conc), mask=xp(mask))
        return ice, xp(vol), xp(sdf)

    w = _port_wim(5, torch.float32)
    ice, vol, w.sdf = poke(w, torch.from_numpy)
    g = _grad(_port_loss(w, 6, ice, tau=torch.abs), vol)
    assert torch.isfinite(g).all()

    with jax.enable_x64(True):
        jwim = _jax_wim(5)
        jice, jvol, jwim.sdf = poke(jwim, jnp.asarray)
        steady = (jnp.zeros_like(jwim.sdf), jnp.zeros(jwim.shape, jwim.dtype))

        def jloss(vol_in):
            ice2 = dict(jice)
            ice2["thick"] = jnp.where(ice2["mask"] > 0.5, vol_in / jnp.maximum(ice2["conc"], 1e-12), 0.0)
            ice2["vol"] = vol_in
            medium = jw.update_wave_medium(ice2["thick"], ice2["mask"], jwim.sg, jwim.p)
            _, _, diag = jwim._run_scan(jwim.sdf, ice2, medium, steady,
                                        jnp.asarray(jwim.dt_cfl, jwim.dtype), 6)
            return jnp.mean(diag["hs"]) + 1e3 * jnp.mean(jnp.abs(diag["tau_x"]))

        ref = np.asarray(jax.jit(jax.grad(jloss))(jvol))
    w64 = _port_wim(5, torch.float64)
    ice, vol, w64.sdf = poke(w64, torch.from_numpy)
    assert_grad_close(ref, _grad(_port_loss(w64, 6, ice, tau=torch.abs), vol), RTOL_F64, "d loss / d vol")
