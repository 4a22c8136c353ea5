"""Parity of the PyTorch port's rheology (nextsim_tpu_torch/ops/rheology.py)
with the JAX package's (nextsim_tpu/ops/rheology.py), on the CPU in float32
from the same numpy inputs.

The updates use the same formulas and term order, but torch's CPU sqrt is
not correctly rounded for a small share of float32 inputs (measured: 0.65%
of values spread over 1e-30..1e5 differ by one ulp from numpy's, while JAX's
match), and the un-hoisted path goes through each framework's own exp/pow.
So the updates agree to rtol 1e-6 (a few ulp) rather than bitwise; the
integer powers, which are multiplies only, agree bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.ops import rheology as jrh
from nextsim_tpu_torch.ops import rheology as trh

SHAPE = (17, 23)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, SHAPE).astype(np.float32)  # noqa: E731
    return dict(
        sxx=f(-3e4, 3e4), syy=f(-3e4, 3e4), sxy=f(-1e4, 1e4),
        damage=f(0.0, 1.0), conc=f(0.0, 1.0), thick=f(0.0, 3.0),
        cohesion=f(1e3, 1e4), trd=f(1e6, 3e6),
        eps11=f(-1e-5, 1e-5), eps22=f(-1e-5, 1e-5), eps12=f(-1e-5, 1e-5),
    )


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


def _assert_close(ref, out, rtol):
    for r, o in zip(ref, out):
        r = np.asarray(r)
        if rtol == 0:
            np.testing.assert_array_equal(o.numpy(), r)
        else:
            np.testing.assert_allclose(o.numpy(), r, rtol=rtol, atol=rtol * np.abs(r).max())


@pytest.mark.parametrize("hoisted", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_bbm_update_planes(hoisted, seed):
    # a compression strength inside the sampled stress range exercises
    # the compressive failure branch as well as Mohr-Coulomb
    p = jrh.BBMParams(compr_strength=2e4)
    tp = trh.BBMParams(compr_strength=2e4)
    j, t = _both(_inputs(seed))
    dx, dt = 10e3, 200.0 / 120

    def call(mod, a, par, pre):
        return mod.bbm_update_planes(
            a["sxx"], a["syy"], a["sxy"], a["damage"], a["conc"], a["thick"],
            a["cohesion"], a["trd"], a["eps11"], a["eps22"], a["eps12"], dx, dt, par,
            **pre,
        )

    jpre, tpre = {}, {}
    if hoisted:
        rng = np.random.default_rng(seed + 10)
        planes = {k: rng.uniform(lo, hi, SHAPE).astype(np.float32) for k, lo, hi in (
            ("expC", 1e-6, 1.0), ("Pmax", 0.0, 2e4), ("heal_rate", 0.0, 1e-6),
            ("rtd_coef", 0.0, 1e-2))}
        jpre, tpre = _both(planes)
    ref = call(jrh, j, p, jpre)
    out = call(trh, t, tp, tpre)
    _assert_close(ref, out, 1e-6)


@pytest.mark.parametrize("kind", ["evp", "mevp"])
@pytest.mark.parametrize("hoisted", [True, False])
def test_vp_update_planes(kind, hoisted):
    p, tp = jrh.EVPParams(), trh.EVPParams()
    j, t = _both(_inputs(3))
    if kind == "evp":
        dte, dt = 200.0 / 120, 200.0
        ra1, ra2 = 0.5 * dte / (dt / 3.0), 0.5 * dte / (dt / 3.0) * p.e * p.e
    else:
        ra1 = ra2 = 1.0 / 500.0
    jP = tP = None
    if hoisted:
        P = np.random.default_rng(4).uniform(0.0, 3e4, SHAPE).astype(np.float32)
        jP, tP = jnp.asarray(P), torch.from_numpy(P)

    def call(mod, a, par, P):
        return mod.vp_update_planes(a["sxx"], a["syy"], a["sxy"], a["conc"], a["thick"],
                                    a["eps11"], a["eps22"], a["eps12"], ra1, ra2, par, P=P)

    _assert_close(call(jrh, j, p, jP), call(trh, t, tp, tP), 1e-6)


@pytest.mark.parametrize("e", [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 8.0, 0.5, 1.5, 2.5, 3.3])
def test_fast_pow(e):
    """Integer exponents use the same square-and-multiply order: bitwise,
    except that XLA's CPU backend flushes subnormal results to zero where
    torch keeps them (atol = the smallest normal float32). Half-integer
    exponents add a sqrt and the generic one is each framework's pow
    (rtol 1e-6)."""
    x = np.random.default_rng(5).uniform(0.0, 3.0, SHAPE).astype(np.float32)
    ref = np.asarray(jrh._fast_pow(jnp.asarray(x), e))
    out = trh._fast_pow(torch.from_numpy(x), e).numpy()
    if e != int(e):
        np.testing.assert_allclose(out, ref, rtol=1e-6)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=np.finfo(np.float32).tiny)


def test_params_match():
    """The parameter dataclasses carry the same defaults and stiffness."""
    assert dataclasses.asdict(trh.BBMParams()) == dataclasses.asdict(jrh.BBMParams())
    assert dataclasses.asdict(trh.EVPParams()) == dataclasses.asdict(jrh.EVPParams())
    assert trh.BBMParams().dunit == jrh.BBMParams().dunit


def test_rdiv_is_true_division():
    x = np.random.default_rng(6).uniform(0.1, 10.0, 1000).astype(np.float32)
    np.testing.assert_array_equal(
        trh.rdiv(3.7, torch.from_numpy(x)).numpy(), np.float32(3.7) / x
    )
