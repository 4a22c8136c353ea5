"""The CUDA substep kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and nvcc (marker ``gpu``) and skips
without them. This file imports no jax, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which sets up JAX.)

Tolerances: the kernel is built without multiply-add contraction and
transcribes the plain version's term order, so bbm and evp agree bitwise;
mEVP's ``(vtm - vt) / (beta + 1)`` is a division by a Python scalar, which
torch on CUDA computes through its reciprocal: rtol 1e-6 of the field's
magnitude there.
"""

import pytest
import torch

from nextsim_tpu_torch import Config, Simulator
from nextsim_tpu_torch.ops import momentum, momentum_cuda

pytestmark = pytest.mark.gpu

SQUARE = {
    "grid.preset": "square", "grid.nx": 33, "grid.ny": 33, "grid.resolution": 10e3,
    "simul.timestep": 200, "dynamics.substeps": 40, "dynamics.alea_factor": 0.33,
    "thermo.use_thermo_forcing": False, "setup.ice-type": "constant",
    "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 10.0, "simul.spinup_duration": 0.0,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(dyn_type, dtype_name):
    sim = Simulator(Config(overrides=dict(SQUARE, **{"setup.dynamics-type": dyn_type,
                                                     "tpu.dtype": dtype_name})), device="cuda")
    sim.step()  # a moving, stressed state
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    consts, carry = momentum.substep_setup(sim.state, sim._next_forcing(), ga, sim.dt, sim.dyn)
    return sim, consts, carry


def _loop(fn, sim, consts, carry, steps):
    return fn(consts, carry, steps, sim.dt / sim.dyn.substeps, sim.dt, sim.grid.dx,
              sim.dyn.dynamics_type, sim.dyn)


@pytest.mark.parametrize("steps", [3, 40])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_kernel_matches_plain(cuda, dyn_type, dtype_name, steps):
    sim, consts, carry = _setup(dyn_type, dtype_name)
    before = [c.clone() for c in carry]
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda.substep_loop, sim, consts, carry, steps)
    assert momentum_cuda.launches == launches + 2 * steps
    ref = _loop(momentum_cuda.substep_loop_reference, sim, consts, carry, steps)
    torch.cuda.synchronize()
    for c, b in zip(carry, before):  # the caller's planes are left alone
        torch.testing.assert_close(c, b, rtol=0, atol=0)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.device.type == "cuda"
        if dyn_type == "mevp":
            torch.testing.assert_close(o, r, rtol=1e-6, atol=1e-6 * float(r.abs().max()))
        else:
            torch.testing.assert_close(o, r, rtol=0, atol=0)


def test_kernel_rejects_half_and_strided_planes(cuda):
    sim, consts, carry = _setup("bbm", "float32")
    with pytest.raises(TypeError, match="float32 or float64"):
        _loop(momentum_cuda.substep_loop, sim, consts, tuple(c.half() for c in carry), 3)
    strided = list(carry)
    strided[4] = carry[4].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        _loop(momentum_cuda.substep_loop, sim, consts, tuple(strided), 3)


def test_simulator_step_goes_through_the_kernel(cuda):
    sim = Simulator(Config(overrides=SQUARE), device="cuda")
    launches = momentum_cuda.launches
    sim.step_chunk(2)
    assert momentum_cuda.launches == launches + 2 * 2 * sim.dyn.substeps
    assert bool(torch.isfinite(sim.state.vt_u).all())
