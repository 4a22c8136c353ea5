"""Parity of the PyTorch port's momentum solver (nextsim_tpu_torch/ops/
momentum.py and the plain substep loop of ops/momentum_cuda.py) with the JAX
package's, on the CPU in float32.

References, as the JAX package's own tests run them on the CPU:
* ``momentum.explicit_solve`` with ``substep_kernel="xla"`` (the jitted
  ``fori_loop``) for the whole dynamics step;
* the blocked Pallas kernel ``momentum_pallas.substep_loop_blocked`` in
  interpret mode (block_rows=16, group_substeps=8) for the substep loop,
  fed the very planes the JAX step builds.

Tolerances are tiered as in tests/test_momentum_pallas.py. XLA contracts
multiply-adds on the CPU and torch does not, and torch's CPU sqrt is off by
one ulp on a small share of inputs (tests/test_torch_rheology.py), so the
two agree to a few ulp per op; the BBM failure branch amplifies such a
difference once damage grows. So: tight over 3 substeps (relative 1e-5 of
each field's magnitude), statistical over 40 (mean speed rtol 1e-3, mean
damage atol 1e-3). The float64 file holds the same comparisons tightly.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.forcing.providers import ConstantForcing as JConstantForcing
from nextsim_tpu.grid.grid import Grid as JGrid
from nextsim_tpu.model import init_state as jinit
from nextsim_tpu.model import params as jparams
from nextsim_tpu.ops import momentum as jmom
from nextsim_tpu.ops import momentum_pallas
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import state_from_numpy
from nextsim_tpu_torch.forcing.providers import ConstantForcing as PConstantForcing
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.model import params as pparams
from nextsim_tpu_torch.ops import momentum as pmom
from nextsim_tpu_torch.ops import momentum_cuda

DX = 10e3
DT = 300.0
FIELDS = ("vt_u", "vt_v", "ut_u", "ut_v", "sigma", "damage")
CARRY = ("vt_u", "vt_v", "ut_u", "ut_v", "sxx", "syy", "sxy", "damage")
# f32 tight tier: |port - jax| <= RTOL*|jax| + RTOL*max|jax| per field
RTOL_F32 = 1e-5


def jax_to_numpy(tree):
    """A JAX dataclass (State, Forcing) as a dict of numpy arrays."""
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if getattr(tree, f.name) is not None}


def to_torch(x):
    if x is None or isinstance(x, float):
        return x
    return torch.from_numpy(np.array(x))


def make_pair(dynamics="bbm", substeps=3, nx=32, wind=10.0, dtype=np.float32):
    """The same toy setup (tests/test_momentum.py:make_setup, with a random
    cohesion field) in the JAX package and in the port. For float64 call it
    inside ``jax.enable_x64(True)``."""
    jdt = jnp.dtype(dtype)
    cfg = JConfig(overrides={
        "grid.nx": nx, "grid.ny": nx, "grid.resolution": DX,
        "ideal_simul.constant_wind_u": wind,
        "setup.atmosphere-type": "constant",
        "setup.dynamics-type": dynamics,
        "dynamics.substeps": substeps,
        "dynamics.alea_factor": 0.33,
        "dynamics.use_coriolis": False,
        "dynamics.oceanic_turning_angle": 0.0,
        "thermo.use_thermo_forcing": False,
        "simul.spinup_duration": 0.0,
    })
    grid = JGrid.square(nx=nx, ny=nx, dx=DX)
    state = jinit.init_state(cfg, grid, dtype=jdt)
    forcing = JConstantForcing(cfg, grid, jdt)(0.0, 0.0)
    dyn = dataclasses.replace(jparams.dyn_params(cfg, DX), substep_kernel="xla")
    node_lat, _ = grid.node_latlon()
    c_fix, c_alea = jparams.cohesion_params(cfg, DX)
    ga = {
        "mask": jnp.asarray(grid.mask, jdt),
        "open_mask": jnp.asarray(grid.open_mask, jdt),
        "node_mask": jnp.asarray(grid.node_mask, jdt),
        "node_dirichlet": jnp.asarray(grid.node_dirichlet, jdt),
        "node_lat": jnp.asarray(node_lat, jdt),
        "delta_x": DX,
        "cohesion": c_fix + c_alea * state.random_number,
    }
    pcfg = PConfig(overrides=cfg.as_dict())
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    port = SimpleNamespace(
        state=state_from_numpy(jax_to_numpy(state)),
        forcing=PConstantForcing(pcfg, PGrid.square(nx=nx, ny=nx, dx=DX), tdt)(0.0, 0.0),
        dyn=pparams.dyn_params(pcfg, DX),
        ga={k: to_torch(v) for k, v in ga.items()},
    )
    jax_side = SimpleNamespace(state=state, forcing=forcing, dyn=dyn, ga=ga)
    return jax_side, port


def assert_close(ref, out, rtol, what=""):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


def assert_statistically_equal(ref_u, ref_v, ref_damage, out_u, out_v, out_damage):
    """After failure onset: finite, same mean speed (rtol 1e-3) and mean
    damage (atol 1e-3)."""
    out_u, out_v, out_damage = (np.asarray(x) for x in (out_u, out_v, out_damage))
    assert np.isfinite(out_u).all() and np.isfinite(out_v).all()
    np.testing.assert_allclose(np.hypot(out_u, out_v).mean(),
                               np.hypot(np.asarray(ref_u), np.asarray(ref_v)).mean(), rtol=1e-3)
    np.testing.assert_allclose(out_damage.mean(), np.asarray(ref_damage).mean(), atol=1e-3)


def capture_jax_loop(monkeypatch, j):
    """Run the JAX explicit_solve and record the planes and scalars it hands
    its substep body: (consts, carry0, dte, dt, dx)."""
    seen = {}
    real = jmom._build_substep

    def spy(p, dyn_type, dte, dt, dx, c, st=None):
        seen.update(consts=c, dte=dte, dt=dt, dx=dx)
        return real(p, dyn_type, dte, dt, dx, c, st)

    monkeypatch.setattr(jmom, "_build_substep", spy)
    jmom.explicit_solve(j.state, j.forcing, j.ga, DT, j.dyn)
    monkeypatch.undo()
    c = seen["consts"]
    s = j.state
    # the loop's initial carry: explicit_solve's masked velocity is vtm
    carry0 = (c.vtm_u, c.vtm_v, s.ut_u, s.ut_v, s.sigma[0], s.sigma[1], s.sigma[2], s.damage)
    return c, carry0, seen["dte"], seen["dt"], seen["dx"]


def consts_to_torch(c):
    return SimpleNamespace(**{k: to_torch(v) for k, v in vars(c).items()})


def run_pallas_and_reference(monkeypatch, j, p, dyn_type, steps):
    c, carry0, dte, dt, dx = capture_jax_loop(monkeypatch, j)
    ref = momentum_pallas.substep_loop_blocked(
        c, carry0, steps, dte, dt, dx, dyn_type, j.dyn,
        block_rows=16, group_substeps=8, interpret=True,
    )
    out = momentum_cuda.substep_loop_reference(
        consts_to_torch(c), tuple(to_torch(x) for x in carry0), steps, dte, dt, dx,
        dyn_type, p.dyn,
    )
    return ref, out


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dynamics", ["bbm", "evp", "mevp"])
def test_explicit_solve_matches_xla_tight(dynamics):
    j, p = make_pair(dynamics, substeps=3)
    ref, rdiag = jmom.explicit_solve(j.state, j.forcing, j.ga, DT, j.dyn)
    launches = momentum_cuda.launches
    out, odiag = pmom.explicit_solve(p.state, p.forcing, p.ga, DT, p.dyn)
    assert momentum_cuda.launches == launches  # CPU tensors: the plain loop
    for f in FIELDS:
        assert_close(getattr(ref, f), getattr(out, f), RTOL_F32, f)
    for k in rdiag:
        assert_close(rdiag[k], odiag[k], RTOL_F32, k)


@pytest.mark.parametrize("dynamics", ["bbm", "evp", "mevp"])
def test_explicit_solve_matches_xla_statistically(dynamics):
    j, p = make_pair(dynamics, substeps=40)
    ref, _ = jmom.explicit_solve(j.state, j.forcing, j.ga, DT, j.dyn)
    out, _ = pmom.explicit_solve(p.state, p.forcing, p.ga, DT, p.dyn)
    assert_statistically_equal(ref.vt_u, ref.vt_v, ref.damage, out.vt_u, out.vt_v, out.damage)


@pytest.mark.parametrize("dynamics", ["bbm", "evp", "mevp"])
def test_substep_setup_matches_jax(monkeypatch, dynamics):
    """The loop-invariant planes and the initial carry the port builds equal
    the JAX package's (rtol 1e-6: exp, sin and sqrt in the prep)."""
    j, p = make_pair(dynamics, substeps=3)
    c, carry0, dte, dt, dx = capture_jax_loop(monkeypatch, j)
    pc, pcarry = pmom.substep_setup(p.state, p.forcing, p.ga, DT, p.dyn)
    assert (dte, dt, dx) == (DT / 3, DT, DX)
    for name, v in vars(c).items():
        if v is None:
            assert getattr(pc, name) is None, name
        elif name == "solve":
            np.testing.assert_array_equal(pc.solve.numpy(), np.asarray(v))
        else:
            assert_close(v, getattr(pc, name), 1e-6, name)
    for name, r, o in zip(CARRY, carry0, pcarry):
        assert_close(r, o, 1e-6, name)


@pytest.mark.parametrize("dynamics", ["bbm", "evp", "mevp"])
def test_reference_loop_matches_pallas_interpret(monkeypatch, dynamics):
    """The plain substep loop against the blocked Pallas kernel on the same
    planes: tight over 3 substeps, statistical over 20."""
    j, p = make_pair(dynamics, substeps=3)
    ref, out = run_pallas_and_reference(monkeypatch, j, p, dynamics, 3)
    for name, r, o in zip(CARRY, ref, out):
        assert_close(r, o, RTOL_F32, name)
    j, p = make_pair(dynamics, substeps=20)
    ref, out = run_pallas_and_reference(monkeypatch, j, p, dynamics, 20)
    assert_statistically_equal(ref[0], ref[1], ref[7], out[0], out[1], out[7])


def test_free_drift_matches_jax():
    j, p = make_pair("free_drift")
    s = j.state.replace(vt_u=j.state.vt_u + 0.1)
    ref = jmom.free_drift(s, j.forcing, j.ga, DT, j.dyn)
    out = pmom.free_drift(p.state.replace(vt_u=p.state.vt_u + 0.1), p.forcing, p.ga, DT, p.dyn)
    for f in ("vt_u", "vt_v", "ut_u", "ut_v"):
        assert_close(getattr(ref, f), getattr(out, f), 1e-6, f)


def test_dyn_params_match_jax():
    """dyn_params reads the same options into the same values (the port
    leaves out the JAX package's TPU loop options)."""
    j, p = make_pair("bbm")
    tpu_only = {"substep_unroll", "substep_kernel", "pallas_block_rows",
                "pallas_group_substeps", "pallas_unroll"}
    jd = {k: v for k, v in dataclasses.asdict(j.dyn).items() if k not in tpu_only}
    assert dataclasses.asdict(p.dyn) == jd
