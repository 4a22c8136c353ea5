"""Reverse mode through the PyTorch port's thermodynamics, on the CPU: the
counterparts of tests/test_grad.py's thermodynamics tests.

As in tests/test_torch_grad.py, each counterpart (a) asserts on the port in
float32 what the JAX test asserts (finite, nonzero, the finite difference at
JAX's rtol) and (b) holds the port's gradient to the JAX package's in
float64 on the same numpy inputs: 1e-6 of its magnitude through a full step
(thermo + 30 substeps + transport), 1e-9 through one ``thermo_step``, a
pointwise step with no loop for ulps to grow in. Measured: 1.3e-16 (the
full step), 2.3e-17 (the heat flux), 1.0e-15 and 0 (the albedo), 0 (the
adversarial zeros: exactly zero wind, exactly ice-free cells, zero pond
volume).

Those lanes go through the ``maximum``/``clip`` bounds of ``core/ties.py``;
the gradient at a tie itself is held to JAX's by
``test_tie_gradients_match_jax`` in tests/test_torch_grad.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu.ops import thermo as jthermo
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy
from nextsim_tpu_torch.ops import thermo as pthermo
from test_torch_grad import GRAD_CFG, RTOL_F64, assert_grad_close, grad_of
from test_torch_momentum import jax_to_numpy

torch.set_num_threads(1)

#: float64 tolerance of one thermo_step's gradient (no substep loop)
RTOL_THERMO_F64 = 1e-9

# tests/test_grad.py's configuration (_sim_thermo)
THERMO_CFG = dict(GRAD_CFG, **{
    "thermo.use_thermo_forcing": True,
    "setup.thermo-type": "winton",
    "ideal_simul.init_SST_limit": 10.0,
})


def _sims(over, tmp_path, edit=None):
    """The port's Simulator in float32 (its own initial state), and in
    float64 with the JAX package's Simulator on the same initial state:
    (psim32, jsim, psim64). ``edit(numpy state)`` changes both initial
    states alike. Call inside ``jax.enable_x64(True)``."""
    def cfg(name, dtype):
        return dict(over, **{"tpu.dtype": dtype, "output.exporter_path": str(tmp_path / name)})

    psim32 = PSimulator(PConfig(overrides=cfg("p32", "float32")), device="cpu")
    jsim = JSimulator(JConfig(cfg("jax", "float64")))
    state = jax_to_numpy(jsim.state)
    if edit is not None:
        edit(state)
        jsim.state = jsim.state.replace(**{k: jnp.asarray(v) for k, v in state.items()})
        p32 = {k: np.asarray(v, np.float32) for k, v in jax_to_numpy(jsim.state).items()}
        psim32.state = state_from_numpy(p32, device="cpu")
    psim64 = PSimulator(PConfig(overrides=cfg("p64", "float64")), device="cpu")
    psim64.state = state_from_numpy(state, device="cpu")
    return psim32, jsim, psim64


def _ga(sim, state=None):
    state = sim.state if state is None else state
    ga = dict(sim.grid_arrays)
    ga["cohesion"] = sim.c_fix + sim.c_alea * state.random_number
    return ga


def _forcing(sim):
    return sim.forcing_provider(sim.current_time, sim.time_init)


def test_grad_through_thermo_forcing(tmp_path):
    """The sensitivity of ice volume + SST to the air temperature through the
    full step is finite and nonzero; through one ``thermo_step`` (the total
    heat flux) it matches a central difference (rtol 0.1, as in JAX); both
    equal JAX's in float64."""
    with jax.enable_x64(True):
        sim, jsim, psim = _sims(THERMO_CFG, tmp_path)
        jf, jti, jga = _forcing(jsim), jsim.time_info(), _ga(jsim)

        def jfull(tair):
            s2, _, _ = jsim.raw_step_fn(jsim.state, jf.replace(tair=tair), jti)
            return jnp.mean(s2.thick) * 1e3 + jnp.mean(s2.sst)

        def jthermo_loss(tair):
            _, diag = jthermo.thermo_step(jsim.state, jf.replace(tair=tair), jga, jsim.dt,
                                          cfg_params=jsim._thermo_params, tinfo=jti)
            return jnp.mean(diag["qa"])

        ref_full = np.asarray(jax.jit(jax.grad(jfull))(jf.tair))
        ref_thermo = np.asarray(jax.jit(jax.grad(jthermo_loss))(jf.tair))

    def losses(psim):
        f, ti, ga = _forcing(psim), psim.time_info(), _ga(psim)

        def full(tair):
            s2, _, _ = psim.raw_step_fn(psim.state, f.replace(tair=tair), ti)
            return s2.thick.mean() * 1e3 + s2.sst.mean()

        def thermo_loss(tair):
            _, diag = pthermo.thermo_step(psim.state, f.replace(tair=tair), ga, psim.dt,
                                          cfg_params=psim.thermo_params, tinfo=ti)
            return diag["qa"].mean()

        return f, full, thermo_loss

    f, full, thermo_loss = losses(sim)
    g = grad_of(full, f.tair)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0
    gt = grad_of(thermo_loss, f.tair)
    assert torch.isfinite(gt).all()
    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.standard_normal(tuple(f.tair.shape)).astype(np.float32))
    eps = 3e-2
    with torch.no_grad():
        fd = (float(thermo_loss(f.tair + eps * d)) - float(thermo_loss(f.tair - eps * d))) / (2 * eps)
    ad = float((gt * d).sum())
    assert fd != 0.0
    np.testing.assert_allclose(ad, fd, rtol=0.1)

    f, full, thermo_loss = losses(psim)
    assert_grad_close(ref_full, grad_of(full, f.tair), RTOL_F64, "full step, d/d tair")
    assert_grad_close(ref_thermo, grad_of(thermo_loss, f.tair), RTOL_THERMO_F64, "thermo_step qa, d/d tair")


def test_grad_wrt_thermo_parameter(tmp_path):
    """d(mean volume + SST)/d(ice albedo) through one ``thermo_step``, with
    ``alb_ice`` a tensor in ``ThermoParams``: finite, and the binding
    central difference on the net shortwave diagnostic (rtol 0.05, as in
    JAX); both equal JAX's in float64."""
    with jax.enable_x64(True):
        sim, jsim, psim = _sims(THERMO_CFG, tmp_path)
        jf, jti, jga = _forcing(jsim), jsim.time_info(), _ga(jsim)

        def jloss(alb, key):
            p = dataclasses.replace(jsim._thermo_params, alb_ice=alb)
            s2, diag = jthermo.thermo_step(jsim.state, jf, jga, jsim.dt, cfg_params=p, tinfo=jti)
            if key == "qsw":
                return jnp.mean(diag["qsw"])
            return jnp.mean(s2.thick) * 1e3 + jnp.mean(s2.sst)

        alb0 = float(jsim._thermo_params.alb_ice)
        refs = {key: float(jax.jit(jax.grad(lambda a, key=key: jloss(a, key)))(jnp.float64(alb0)))
                for key in ("volume", "qsw")}

    def loss_of(psim, key):
        f, ti, ga = _forcing(psim), psim.time_info(), _ga(psim)

        def loss(alb):
            p = dataclasses.replace(psim.thermo_params, alb_ice=alb)
            s2, diag = pthermo.thermo_step(psim.state, f, ga, psim.dt, cfg_params=p, tinfo=ti)
            if key == "qsw":
                return diag["qsw"].mean()
            return s2.thick.mean() * 1e3 + s2.sst.mean()
        return loss

    def scalar_grad(loss, x, dtype):
        a = torch.tensor(x, dtype=dtype, requires_grad=True)
        (g,) = torch.autograd.grad(loss(a), a)
        return float(g)

    assert alb0 == sim.thermo_params.alb_ice
    eps = 1e-3
    loss = loss_of(sim, "volume")
    g = scalar_grad(loss, alb0, torch.float32)
    assert np.isfinite(g)
    with torch.no_grad():
        fd = (float(loss(alb0 + eps)) - float(loss(alb0 - eps))) / (2 * eps)
    if abs(fd) > 1e-8:
        np.testing.assert_allclose(g, fd, rtol=0.2)
    loss_sw = loss_of(sim, "qsw")
    gsw = scalar_grad(loss_sw, alb0, torch.float32)
    with torch.no_grad():
        fd_sw = (float(loss_sw(alb0 + eps)) - float(loss_sw(alb0 - eps))) / (2 * eps)
    assert fd_sw != 0.0
    np.testing.assert_allclose(gsw, fd_sw, rtol=0.05)

    for key in ("volume", "qsw"):
        got = scalar_grad(loss_of(psim, key), alb0, torch.float64)
        assert refs[key] != 0.0, key
        np.testing.assert_allclose(got, refs[key], rtol=RTOL_THERMO_F64, err_msg=key)


@pytest.mark.parametrize("ttype", ["winton", "zero-layer"])
def test_grad_thermo_adversarial_zeros(tmp_path, ttype):
    """Thermo gradients stay finite at the reverse-mode hazard points:
    exactly zero wind, exactly ice-free cells (half the domain), zero pond
    volume; and equal JAX's in float64, ties included."""
    over = dict(THERMO_CFG, **{"dynamics.substeps": 10, "setup.thermo-type": ttype,
                               "ideal_simul.constant_wind_u": 0.0})

    def ice_free_half(state):
        for k in ("conc", "thick"):
            a = np.array(state[k])
            a[:, :8] = 0.0
            state[k] = a

    with jax.enable_x64(True):
        sim, jsim, psim = _sims(over, tmp_path, edit=ice_free_half)
        jf, jti, jga = _forcing(jsim), jsim.time_info(), _ga(jsim)

        def jloss(tair, wind_u):
            s2, diag = jthermo.thermo_step(jsim.state, jf.replace(tair=tair, wind_u=wind_u), jga,
                                           jsim.dt, cfg_params=jsim._thermo_params, tinfo=jti)
            return (jnp.mean(s2.thick) * 1e3 + jnp.mean(s2.sst) + jnp.mean(diag["qa"])
                    + jnp.mean(s2.h_young) * 1e3 + jnp.mean(s2.pond_volume) * 1e3)

        refs = [np.asarray(g) for g in jax.jit(jax.grad(jloss, argnums=(0, 1)))(jf.tair, jf.wind_u)]

    def grads(psim):
        f, ti, ga = _forcing(psim), psim.time_info(), _ga(psim)
        tair = f.tair.detach().clone().requires_grad_(True)
        wind_u = f.wind_u.detach().clone().requires_grad_(True)
        s2, diag = pthermo.thermo_step(psim.state, f.replace(tair=tair, wind_u=wind_u), ga, psim.dt,
                                       cfg_params=psim.thermo_params, tinfo=ti)
        loss = (s2.thick.mean() * 1e3 + s2.sst.mean() + diag["qa"].mean()
                + s2.h_young.mean() * 1e3 + s2.pond_volume.mean() * 1e3)
        return torch.autograd.grad(loss, (tair, wind_u))

    assert float(sim.state.conc[:, :8].abs().max()) == 0.0
    assert float(_forcing(sim).wind_u.abs().max()) == 0.0
    for g in grads(sim):
        assert torch.isfinite(g).all()
    for name, ref, got in zip(("tair", "wind_u"), refs, grads(psim)):
        assert_grad_close(ref, got, RTOL_THERMO_F64, name)
