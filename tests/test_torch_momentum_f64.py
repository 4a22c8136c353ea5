"""The momentum parity comparisons of tests/test_torch_momentum.py in
float64, under the scoped ``jax.enable_x64(True)`` (nothing leaks to other
tests of the same worker process).

Tolerances, relative to each field's magnitude: 1e-9 over 3 substeps, 1e-6
over 20 and 80. The ulp-level differences between the frameworks (XLA's
multiply-add contraction, torch's CPU sqrt) grow in float64 too where the
EVP viscosity P/(delta + dmin) is huge at near-zero strain and where a BBM
cell fails (measured on the u velocity, evp at dt=300 s: 1e-12 after 10
substeps, 3e-9 after 20, 2e-7 after 40 with its larger substep, 1e-8 after
80; mevp stays at 1e-16).

The blocked Pallas kernel is float32-only (the JAX package gates it to
float32 and its interpret mode fails under x64), so the float64 loop
reference is the JAX package's XLA ``fori_loop`` over the same
``_build_substep`` body, fed the same planes.
"""

import jax
import numpy as np
import pytest

from nextsim_tpu.ops import momentum as jmom
from nextsim_tpu_torch.ops import momentum as pmom
from nextsim_tpu_torch.ops import momentum_cuda
from test_torch_momentum import (
    CARRY, DT, FIELDS, assert_close, capture_jax_loop, consts_to_torch,
    make_pair, to_torch,
)


def rtol_f64(substeps):
    return 1e-9 if substeps <= 3 else 1e-6


@pytest.mark.parametrize("substeps", [3, 80])
@pytest.mark.parametrize("dynamics", ["bbm", "evp", "mevp"])
def test_explicit_solve_matches_xla_f64(dynamics, substeps):
    rtol = rtol_f64(substeps)
    with jax.enable_x64(True):
        j, p = make_pair(dynamics, substeps=substeps, dtype=np.float64)
        ref, rdiag = jmom.explicit_solve(j.state, j.forcing, j.ga, DT, j.dyn)
        ref_fields = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
        rdiag = {k: np.asarray(v) for k, v in rdiag.items()}
    assert ref_fields["vt_u"].dtype == np.float64
    out, odiag = pmom.explicit_solve(p.state, p.forcing, p.ga, DT, p.dyn)
    for f in FIELDS:
        assert getattr(out, f).dtype == p.state.vt_u.dtype
        assert_close(ref_fields[f], getattr(out, f), rtol, f)
    for k in rdiag:
        assert_close(rdiag[k], odiag[k], rtol, k)


@pytest.mark.parametrize("dynamics", ["bbm", "evp", "mevp"])
def test_substep_setup_matches_jax_f64(monkeypatch, dynamics):
    with jax.enable_x64(True):
        j, p = make_pair(dynamics, substeps=3, dtype=np.float64)
        c, carry0, *_ = capture_jax_loop(monkeypatch, j)
        c = {k: None if v is None else np.asarray(v) for k, v in vars(c).items()}
        carry0 = [np.asarray(x) for x in carry0]
    pc, pcarry = pmom.substep_setup(p.state, p.forcing, p.ga, DT, p.dyn)
    for name, v in c.items():
        if v is None:
            assert getattr(pc, name) is None, name
        elif name == "solve":
            np.testing.assert_array_equal(pc.solve.numpy(), v)
        else:
            assert_close(v, getattr(pc, name), 1e-9, name)
    for name, r, o in zip(CARRY, carry0, pcarry):
        assert_close(r, o, 1e-9, name)


@pytest.mark.parametrize("substeps", [3, 20])
@pytest.mark.parametrize("dynamics", ["bbm", "evp", "mevp"])
def test_reference_loop_matches_xla_loop_f64(monkeypatch, dynamics, substeps):
    with jax.enable_x64(True):
        j, p = make_pair(dynamics, substeps=substeps, dtype=np.float64)
        c, carry0, dte, dt, dx = capture_jax_loop(monkeypatch, j)
        body = jmom._build_substep(j.dyn, dynamics, dte, dt, dx, c)
        ref = jax.lax.fori_loop(0, substeps, lambda _, cr: body(cr), carry0)
        ref = [np.asarray(x) for x in ref]
    assert ref[0].dtype == np.float64
    out = momentum_cuda.substep_loop_reference(
        consts_to_torch(c), tuple(to_torch(x) for x in carry0), substeps, dte, dt, dx,
        dynamics, p.dyn,
    )
    for name, r, o in zip(CARRY, ref, out):
        assert_close(r, o, rtol_f64(substeps), name)
