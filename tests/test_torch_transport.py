"""Parity of the PyTorch port's advection and transport (nextsim_tpu_torch/
ops/advection.py, ops/transport.py) with the JAX package's, on the CPU in
float32 from the same numpy inputs, op by op.

Advection is +,-,*,/ and selects only, in the same order: bitwise. The
transport step adds a sqrt (the enthalpy inversion), which torch's CPU
rounds differently on a small share of inputs (tests/test_torch_rheology.py):
rtol 1e-6 of each field's magnitude there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.ops import advection as jadv
from nextsim_tpu.ops import transport as jtr
from nextsim_tpu_torch import state_from_numpy
from nextsim_tpu_torch.ops import advection as tadv
from nextsim_tpu_torch.ops import transport as ttr
from test_torch_momentum import assert_close, jax_to_numpy, make_pair

NY, NX = 19, 27
DT, DX = 300.0, 10e3


def _velocity_and_tracer(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (NY + 1, NX + 1)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (NY + 1, NX + 1)).astype(np.float32)
    q = rng.uniform(0.0, 1.0, (NY, NX)).astype(np.float32)
    q[rng.random((NY, NX)) < 0.2] = 0.0  # fronts for the limiter
    mask = np.ones((NY, NX), np.float32)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = 0.0
    return u, v, q, mask


def test_face_velocities_and_divergence():
    u, v, _, _ = _velocity_and_tracer(0)
    jf = jadv.face_velocities(jnp.asarray(u), jnp.asarray(v))
    tf = tadv.face_velocities(torch.from_numpy(u), torch.from_numpy(v))
    for r, o in zip(jf, tf):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        tadv.divergence(*tf, DX).numpy(), np.asarray(jadv.divergence(*jf, DX))
    )


@pytest.mark.parametrize("second_order", [True, False])
@pytest.mark.parametrize("form", ["conservative", "intensive"])
def test_advection_matches_jax_bitwise(form, second_order):
    u, v, q, mask = _velocity_and_tracer(1 + second_order)
    jf = jadv.face_velocities(jnp.asarray(u), jnp.asarray(v))
    tf = tadv.face_velocities(torch.from_numpy(u), torch.from_numpy(v))
    jfn = getattr(jadv, f"advect_{form}")
    tfn = getattr(tadv, f"advect_{form}")
    ref = jfn(jnp.asarray(q), *jf, DT, DX, jnp.asarray(mask), second_order)
    out = tfn(torch.from_numpy(q), *tf, DT, DX, torch.from_numpy(mask), second_order)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _moving_state(j, seed):
    """The toy state with random velocities, ice fields, stress, damage and
    tracers in their physical ranges (young ice included, so the ridging
    branches run)."""
    rng = np.random.default_rng(seed)
    s = jax_to_numpy(j.state)
    cell = s["conc"].shape
    node = s["vt_u"].shape
    nm = np.asarray(j.ga["node_mask"]) * (1.0 - np.asarray(j.ga["node_dirichlet"]))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    s.update(
        vt_u=f32(rng.uniform(-0.4, 0.4, node) * nm),
        vt_v=f32(rng.uniform(-0.4, 0.4, node) * nm),
        conc=f32(rng.uniform(0.5, 1.0, cell)),
        thick=f32(rng.uniform(0.2, 2.0, cell)),
        snow_thick=f32(rng.uniform(0.0, 0.3, cell)),
        conc_young=f32(rng.uniform(0.0, 0.2, cell)),
        h_young=f32(rng.uniform(0.0, 0.05, cell)),
        hs_young=f32(rng.uniform(0.0, 0.01, cell)),
        damage=f32(rng.uniform(0.0, 1.0, cell)),
        ridge_ratio=f32(rng.uniform(0.0, 0.3, cell)),
        sigma=f32(rng.uniform(-3e4, 3e4, (3,) + cell)),
        tice=f32(rng.uniform(-20.0, -0.3, (3,) + cell)),
        age=f32(rng.uniform(0.0, 3e7, cell)),
        age_det=f32(rng.uniform(0.0, 3e7, cell)),
        conc_myi=f32(rng.uniform(0.0, 0.5, cell)),
        thick_myi=f32(rng.uniform(0.0, 1.0, cell)),
    )
    return s


@pytest.mark.parametrize("second_order", [True, False])
def test_transport_and_ridge_matches_jax(second_order):
    j, p = make_pair("bbm")
    s = _moving_state(j, 3)
    jstate = j.state.replace(**{k: jnp.asarray(v) for k, v in s.items()})
    tp_j = jtr.TransportParams(second_order=second_order, diffusivity_sst=100.0)
    tp_t = ttr.TransportParams(second_order=second_order, diffusivity_sst=100.0)
    ref, rdiag = jtr.transport_and_ridge(jstate, j.ga, DT, tp_j)
    out, odiag = ttr.transport_and_ridge(state_from_numpy(s), p.ga, DT, tp_t)
    for f in dataclasses.fields(ref):
        r = getattr(ref, f.name)
        if r is None:
            assert getattr(out, f.name) is None
            continue
        assert_close(r, getattr(out, f.name), 1e-6, f.name)
    for k in rdiag:
        assert_close(rdiag[k], odiag[k], 1e-6, k)


def test_transport_raises_on_fsd_bins():
    _, p = make_pair("bbm")
    state = p.state.replace(conc_fsd=torch.zeros((2,) + tuple(p.state.conc.shape)))
    with pytest.raises(NotImplementedError, match="floe-size"):
        ttr.transport_and_ridge(state, p.ga, DT, ttr.TransportParams())


def test_transport_params_from_config():
    from nextsim_tpu.config import Config as JConfig
    from nextsim_tpu_torch import Config as PConfig

    over = {"numerics.advection_scheme": "upwind", "thermo.diffusivity_sss": 5.0}
    assert dataclasses.asdict(ttr.TransportParams.from_config(PConfig(overrides=over))) == \
        dataclasses.asdict(jtr.TransportParams.from_config(JConfig(overrides=over)))
