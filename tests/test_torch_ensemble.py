"""The port's ensembles against the JAX package, on the CPU.

JAX draws with threefry and the port with ``torch.Generator``, so parity is
held on JAX's own draws handed to the port: the phases of ``spectral_noise``,
and the fresh noise stacks of the AR(1) chain, recomputed from the JAX keys
in the order the JAX package splits them and put in place of the port's
``_draw_stack`` here. Tolerances:

* ``spectral_noise`` given JAX's phases: 1e-12 in float64, 1e-5 of the
  field's std in float32 (shapes 128^2, 70x45, 40x33; rh of 10 and 100 cells,
  the second larger than the domain);
* ``_advance`` against JAX ``_step``: 1e-12 of each field's magnitude in
  float64, 1e-6 in float32;
* a perturbed Simulator and a 3-member BatchedEnsemble, 3 steps of 60
  substeps on a 24^2 square in float64: 1e-9 of each field's magnitude.

With the port's own generators: the statistics of tests/test_extensions.py
(unit variance, the decorrelation length, the AR(1) coefficient, member 0
unperturbed), a chunked perturbed run equal to the per-step one bitwise, and
batched member m equal to ``Simulator(member=m)`` bitwise. Then the batched
outputs (statistics record, npz checkpoint, member restarts) and the driver.

The batched step (``Simulator.batched_step_fn``, all members at once, the
counterpart of the JAX package's vmapped ``_vstep``; one graph replay on the
card, tests/test_torch_cuda.py) against the member loop ``step_members``:
bitwise for bbm, evp and mevp, thermo on, in float32 and float64 (3
members, 3 steps); its body reads nothing back from the device (the
dispatch-mode check of tests/test_torch_chunk.py). Every configuration runs
the batched step, as the JAX package vmaps every one: FSD Roach welding
(a broken area seeded from numpy, welding active), the WIM, the coupler and
nesting (neither package runs their exchanges per member: the step takes
the provider's forcing) each equal the member loop bitwise in float32 and
float64 (3 members, 3 steps, bbm), and ``step`` never calls
``step_members``; the Roach welding and the nesting ensembles equal the JAX
package's ``BatchedEnsemble`` within 1e-9 of each field's magnitude in
float64 (2 members, on JAX's draws).
"""

import dataclasses
import glob
import logging
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.ensemble import EnsembleForcing as JEnsembleForcing
from nextsim_tpu.ensemble import PerturbationParams as JPerturbationParams
from nextsim_tpu.ensemble import spectral_noise as jspectral_noise
from nextsim_tpu.ensemble.batched import BatchedEnsemble as JBatchedEnsemble
from nextsim_tpu.forcing.providers import ConstantForcing as JConstantForcing
from nextsim_tpu.grid.grid import Grid as JGrid
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy, state_to_numpy
from nextsim_tpu_torch.ensemble import EnsembleForcing as PEnsembleForcing
from nextsim_tpu_torch.ensemble import PerturbationParams as PPerturbationParams
from nextsim_tpu_torch.ensemble import run_ensemble
from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble as PBatchedEnsemble
from nextsim_tpu_torch.ensemble.perturbation import draw_phases, member_generator, spectral_noise, stack_forcings
from nextsim_tpu_torch.forcing.base import Forcing as PForcing
from nextsim_tpu_torch.forcing.providers import ConstantForcing as PConstantForcing
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.model.checks import CELL_BOUNDS, YOUNG_BOUNDS
from test_torch_chunk import _NoReadBack
from test_torch_momentum import jax_to_numpy

torch.set_num_threads(1)

# tests/test_extensions.py's batched-ensemble configuration, in float64
ENS = {
    "grid.preset": "square", "grid.nx": 24, "grid.ny": 24, "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00", "simul.duration": 1.0,
    "dynamics.substeps": 60, "thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0,
    "setup.ice-type": "constant", "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 10.0, "simul.spinup_duration": 0.0, "tpu.donate_state": False,
    "tpu.dtype": "float64",
}
SEED = 11  # the default of EnsembleForcing and BatchedEnsemble
STEPS = 3


def rel_err(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-300)


def assert_states_close(ref: dict, got: dict, tol: float, what: str):
    assert set(ref) == set(got), what
    for k in ref:
        assert rel_err(ref[k], got[k]) <= tol, (what, k, rel_err(ref[k], got[k]))


def assert_states_equal(a: dict, b: dict, what: str):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def jax_stacks(pert, member: int, n_steps: int, seed: int = SEED):
    """The fresh noise stacks a JAX member draws over ``n_steps`` steps (the
    carry's first draw, then one a step): the JAX package's splits of
    PRNGKey(seed * 1000003 + member) in order."""
    key = jax.random.PRNGKey(seed * 1000003 + member)
    out = []
    for _ in range(n_steps + 1):
        key, sub = jax.random.split(key)
        out.append(np.asarray(pert._draw_stack(sub)))
    return out


def inject(monkeypatch, pert, stacks_by_generator):
    """The port's ``pert._draw_stack`` hands out the JAX stacks: each
    member's in order, the member known by its generator."""
    draws = {id(g): iter(stacks) for g, stacks in stacks_by_generator.items()}
    monkeypatch.setattr(pert, "_draw_stack", lambda g: torch.from_numpy(next(draws[id(g)])))


def port_forcing(jf):
    return PForcing(**{f.name: None if getattr(jf, f.name) is None else torch.from_numpy(np.array(getattr(jf, f.name)))
                       for f in dataclasses.fields(jf)})


# ---------------------------------------------------------------------------
# the spectral part and the AR(1) step, on JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("rh", [10.0, 100.0])
@pytest.mark.parametrize("shape", [(128, 128), (70, 45), (40, 33)])
def test_spectral_noise_matches_jax_given_its_phases(shape, rh, dtype_name):
    key = jax.random.PRNGKey(sum(shape) + int(rh))
    with jax.enable_x64(dtype_name == "float64"):
        ref = np.asarray(jspectral_noise(key, shape, rh))
        _, kp = jax.random.split(key)
        phase = np.asarray(jax.random.uniform(kp, (shape[0], shape[1] // 2 + 1), minval=0.0, maxval=2.0 * jnp.pi))
    assert ref.dtype == np.dtype(dtype_name) and phase.dtype == ref.dtype
    got = spectral_noise(torch.tensor(phase), shape, rh)
    assert got.dtype == getattr(torch, dtype_name) and tuple(got.shape) == shape
    tol = 1e-12 if dtype_name == "float64" else 1e-5
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * ref.std())
    # leading dimensions are a batch of independent fields
    batch = spectral_noise(torch.stack([torch.tensor(phase) * s for s in (1.0, 0.5, 2.0, 1.5)]), shape, rh)
    assert tuple(batch.shape) == (4,) + shape and rel_err(got, batch[0]) <= tol


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("dair", [True, False], ids=["dair", "no_dair"])
@pytest.mark.parametrize("prsflg", [2, 0])
def test_advance_matches_jax_step(prsflg, dair, dtype_name):
    over = {"statevector.ensemble_member": 1, "setup.atmosphere-type": "constant", "simul.timestep": 3600,
            "tpu.dtype": dtype_name}
    jgrid, pgrid = JGrid.square(nx=20, ny=16, dx=25e3), PGrid.square(nx=20, ny=16, dx=25e3)
    rng = np.random.default_rng(prsflg + 2 * dair)
    dt = np.dtype(dtype_name)
    with jax.enable_x64(dtype_name == "float64"):
        jcfg = JConfig(overrides=over)
        jf = JConstantForcing(jcfg, jgrid, dtype=jnp.dtype(dtype_name))(0.5, 0.0)
        cells = lambda scale, offset: jnp.asarray((offset + scale * rng.standard_normal(jgrid.shape)).astype(dt))  # noqa: E731
        jf = jf.replace(mslp=cells(300.0, 101300.0), tair=cells(3.0, -20.0), precip=cells(2e-5, 1e-5),
                        dair=cells(2.0, -22.0) if dair else None,
                        wind_u=jnp.asarray(rng.standard_normal(jgrid.node_shape).astype(dt)))
        params = JPerturbationParams(prsflg=prsflg)
        jpert = JEnsembleForcing(None, jgrid, jcfg, params=params)
        key = jax.random.PRNGKey(5)
        ran = jnp.asarray(rng.standard_normal((4,) + jgrid.shape).astype(dt))
        _, ran_ref, f_ref = jpert._step(key, ran, jf)
        _, sub = jax.random.split(key)
        fresh = np.asarray(jpert._draw_stack(sub))
    ppert = PEnsembleForcing(None, pgrid, PConfig(overrides=over), params=PPerturbationParams(prsflg=prsflg),
                             dtype=getattr(torch, dtype_name), device="cpu")
    ran_got, f_got = ppert._advance(torch.from_numpy(np.asarray(ran)), torch.from_numpy(fresh), port_forcing(jf))
    tol = 1e-12 if dtype_name == "float64" else 1e-6
    assert rel_err(ran_ref, ran_got) <= tol
    perturbed = 0
    for f in dataclasses.fields(f_ref):
        r, g = getattr(f_ref, f.name), getattr(f_got, f.name)
        if r is None:
            assert g is None, f.name
            continue
        assert g.dtype == getattr(torch, dtype_name), f.name
        assert rel_err(r, g) <= tol, (f.name, rel_err(r, g))
        perturbed += not np.array_equal(np.asarray(r), np.asarray(getattr(jf, f.name)))
    # mslp, tair, precip (+ dair) (+ wind_u, wind_v)
    assert perturbed == 3 + dair + 2 * (prsflg == 2)
    assert float(f_got.precip.min()) == 0.0  # the clamp acted


# ---------------------------------------------------------------------------
# statistics with the port's own generator
# ---------------------------------------------------------------------------

def test_spectral_noise_statistics():
    """tests/test_extensions.py's checks, and the autocorrelation at lag rh
    close to exp(-1) (corr(r) = exp(-r^2/rh^2)), averaged over 16 fields."""
    g = member_generator(0, 1, "cpu")
    shape, rh = (128, 128), 10.0
    f = spectral_noise(draw_phases(g, 16, shape, dtype=torch.float64, device="cpu"), shape, rh).numpy()
    assert np.abs(f.mean(axis=(1, 2))).max() < 1e-12  # no DC mode
    np.testing.assert_allclose(f.std(axis=(1, 2)), 1.0, rtol=1e-12)
    corr = lambda lag: np.mean([np.corrcoef(a[:, :-lag].ravel(), a[:, lag:].ravel())[0, 1]  # noqa: E731
                                for a in np.concatenate([f, f.transpose(0, 2, 1)])])
    assert corr(1) > 0.9
    assert abs(corr(int(rh)) - math.exp(-1.0)) < 0.06, corr(int(rh))
    assert corr(30) < 0.05


def test_ar1_lag_correlation_is_alpha():
    """Successive carries of the AR(1) chain correlate by alpha =
    exp(-dt/tcorr); a short decorrelation length (2 cells) gives many
    independent samples on 64^2."""
    grid = PGrid.square(nx=64, ny=64, dx=10e3)
    cfg = PConfig(overrides={"statevector.ensemble_member": 1, "simul.timestep": 6 * 3600})
    pert = PEnsembleForcing(None, grid, cfg, params=PPerturbationParams(scorr_km=20.0),
                            dtype=torch.float64, device="cpu")
    assert abs(pert.alpha - math.exp(-0.125)) < 1e-15
    ran = [pert.init_state()]
    for _ in range(8):
        fresh = pert._draw_stack(pert.generator)
        ran.append(pert.alpha * ran[-1] + math.sqrt(1.0 - pert.alpha**2) * fresh)
    r = np.stack([x.numpy() for x in ran])
    lag1 = np.mean([np.corrcoef(r[t, i].ravel(), r[t + 1, i].ravel())[0, 1] for t in range(8) for i in range(4)])
    assert abs(lag1 - pert.alpha) < 0.03, (lag1, pert.alpha)
    np.testing.assert_allclose(r.std(axis=(2, 3)), 1.0, atol=0.1)  # the chain keeps unit variance


def test_members_differ_and_control_is_unperturbed():
    grid = PGrid.square(nx=32, ny=32, dx=10e3)
    base_cfg = lambda m: PConfig(overrides={  # noqa: E731
        "setup.atmosphere-type": "constant", "ideal_simul.constant_wind_u": 10.0,
        "ideal_simul.constant_precip": 1e-5, "statevector.ensemble_member": m, "simul.spinup_duration": 0.0})
    f0 = PConstantForcing(base_cfg(0), grid, device="cpu")(0.0, 0.0)
    members = {m: PEnsembleForcing(PConstantForcing(base_cfg(m), grid, device="cpu"), grid, base_cfg(m),
                                   dtype=torch.float32, device="cpu")(0.0, 0.0) for m in (0, 1, 2)}
    assert members[0] is not None and torch.equal(members[0].tair, f0.tair)
    assert not torch.allclose(members[1].tair, f0.tair)
    assert not torch.allclose(members[1].tair, members[2].tair)
    d = (members[1].tair - f0.tair).numpy()
    assert 0.5 < d.std() < 6.0  # tair std ~ sqrt(9) = 3 K
    assert not torch.allclose(members[1].wind_u, f0.wind_u)  # through the pressure flag
    assert float(members[1].precip.min()) >= 0.0


# ---------------------------------------------------------------------------
# the perturbed Simulator and the batched ensemble against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's 3-member batched ensemble and its Simulator with
    ensemble_member=1, 3 steps each in float64, with the stacks each member
    drew."""
    with jax.enable_x64(True):
        ens = JBatchedEnsemble(JConfig(overrides=dict(ENS)), n_members=3)
        init = jax_to_numpy(ens.sim.state)
        stacks = {m: jax_stacks(ens._pert, m, STEPS) for m in (1, 2)}
        ens.run(STEPS)
        members = [jax_to_numpy(ens.member_state(k)) for k in range(3)]
        jsim = JSimulator(JConfig(overrides=dict(ENS, **{"statevector.ensemble_member": 1})))
        for _ in range(STEPS):
            jsim.step()
        sim1 = jax_to_numpy(jsim.state)
        tair1 = np.asarray(jsim.last_forcing.tair)
    return SimpleNamespace(init=init, stacks=stacks, members=members, sim1=sim1, tair1=tair1)


def test_perturbed_simulator_matches_jax(jax_runs, monkeypatch):
    psim = PSimulator(PConfig(overrides=dict(ENS, **{"statevector.ensemble_member": 1})), device="cpu")
    assert isinstance(psim.forcing_provider, PEnsembleForcing)
    psim.state = state_from_numpy(jax_runs.init, device="cpu")
    inject(monkeypatch, psim.forcing_provider, {psim.forcing_provider.generator: jax_runs.stacks[1]})
    for _ in range(STEPS):
        psim.step()
    assert_states_close(jax_runs.sim1, state_to_numpy(psim.state), 1e-9, "member 1")
    assert rel_err(jax_runs.tair1, psim.last_forcing.tair) <= 1e-12


def test_chunked_perturbed_run_matches_per_step():
    """The chain advances once a step on both paths: step_chunk(3) equals 3
    steps bitwise, the last perturbed forcing and the generator included."""
    over = dict(ENS, **{"statevector.ensemble_member": 1})
    a = PSimulator(PConfig(overrides=dict(over, **{"tpu.steps_per_call": 1})), device="cpu")
    b = PSimulator(PConfig(overrides=dict(over, **{"tpu.steps_per_call": STEPS})), device="cpu")
    for _ in range(STEPS):
        a.step()
    b.step_chunk()
    assert a.pcpt == b.pcpt == STEPS
    assert_states_equal(state_to_numpy(a.state), state_to_numpy(b.state), "chunked")
    assert torch.equal(a.last_forcing.tair, b.last_forcing.tair)
    assert torch.equal(a.last_forcing.wind_u, b.last_forcing.wind_u)
    assert torch.equal(a.forcing_provider.generator.get_state(), b.forcing_provider.generator.get_state())
    base = b.forcing_provider.provider(b.current_time, b.time_init)
    assert not torch.equal(b.last_forcing.tair, base.tair)  # outputs see the perturbed forcing


# ---------------------------------------------------------------------------
# the perturbed member's program: the draws inside the step and chunk
# ---------------------------------------------------------------------------

def _pert_sim(**over):
    cfg = dict(ENS, **{"statevector.ensemble_member": 1, "dynamics.substeps": 20})
    cfg.update(over)
    return PSimulator(PConfig(overrides=cfg), device="cpu")


def assert_same_stream(a, b, what):
    """Two perturbed Simulators at the same point of one noise stream: the
    state, the AR(1) carry, the generator and the last perturbed forcing,
    bitwise."""
    assert a.pcpt == b.pcpt, what
    assert_states_equal(state_to_numpy(a.state), state_to_numpy(b.state), what)
    assert torch.equal(a._pert_state, b._pert_state), what
    assert torch.equal(a._ens_pert.generator.get_state(), b._ens_pert.generator.get_state()), what
    for f in dataclasses.fields(a.last_forcing):
        x, y = getattr(a.last_forcing, f.name), getattr(b.last_forcing, f.name)
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), (what, f.name)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("k", [1, 3])
def test_perturbed_program_equals_the_eager_loop(k, dtype_name, monkeypatch):
    """A perturbed member's ``step_chunk(k)`` runs ``_run_program`` (the
    program captured on the card, the body here) with the draws inside it,
    and equals ``step_chunk_eager(k)`` bitwise over two calls: state, carry,
    generator and ``last_forcing``; the last forcing is the perturbed one."""
    a, b = _pert_sim(**{"tpu.dtype": dtype_name}), _pert_sim(**{"tpu.dtype": dtype_name})
    assert a.eager_reason is None and a._program.generators == [a._ens_pert.generator]
    calls = []
    program = a._program
    monkeypatch.setattr(a, "_program", lambda *args: calls.append(len(args)) or program(*args))
    monkeypatch.setattr(a, "step_chunk_eager", None)  # the program path only
    for i in range(2):
        a.step_chunk(k)
        b.step_chunk_eager(k)
        assert_same_stream(a, b, f"call {i}")
    assert calls == [6, 6]  # the carry is the program's sixth argument
    base = a._ens_pert.provider(a.current_time, a.time_init)
    assert not torch.equal(a.last_forcing.tair, base.tair) and a.last_forcing.tair.dtype == a.dtype


def test_step_chunk_and_eager_steps_interleave_as_one_stream():
    """``step``, ``step_chunk(2)`` and ``step_eager`` in turns read and write
    one carry and one generator: they equal four eager steps bitwise."""
    a, b = _pert_sim(), _pert_sim()
    a.step()
    a.step_chunk(2)
    a.step_eager()
    for _ in range(4):
        b.step_eager()
    assert_same_stream(a, b, "interleaved")


def test_perturbed_chunk_matches_jax(monkeypatch):
    """float64, member 1, ``tpu.steps_per_call=3``: the port's
    ``step_chunk()`` on JAX's draws against the JAX package's
    ``step_chunk()`` (``chunk_fn_pert``), every field within 1e-9 of its
    magnitude, the carry and the last perturbed forcing within 1e-12."""
    over = dict(ENS, **{"statevector.ensemble_member": 1, "tpu.steps_per_call": STEPS})
    with jax.enable_x64(True):
        jsim = JSimulator(JConfig(overrides=over))
        init = jax_to_numpy(jsim.state)
        stacks = jax_stacks(jsim._ens_pert, 1, STEPS)
        jsim.step_chunk()
        ref, ref_ran = jax_to_numpy(jsim.state), np.asarray(jsim._pert_state[1])
        ref_forcing = {f.name: np.asarray(getattr(jsim.last_forcing, f.name))
                       for f in dataclasses.fields(jsim.last_forcing) if getattr(jsim.last_forcing, f.name) is not None}
    psim = PSimulator(PConfig(overrides=over), device="cpu")
    psim.state = state_from_numpy(init, device="cpu")
    inject(monkeypatch, psim._ens_pert, {psim._ens_pert.generator: stacks})
    psim.step_chunk()
    assert psim.pcpt == jsim.pcpt == STEPS
    assert_states_close(ref, state_to_numpy(psim.state), 1e-9, "member 1, one chunk")
    assert rel_err(ref_ran, psim._pert_state) <= 1e-12
    for name, r in ref_forcing.items():
        assert rel_err(r, getattr(psim.last_forcing, name)) <= 1e-12, name


def test_batched_ensemble_matches_jax(jax_runs, monkeypatch):
    ens = PBatchedEnsemble(PConfig(overrides=dict(ENS)), 3, device="cpu")
    init = state_from_numpy(jax_runs.init, device="cpu")
    ens.states = ens.states.replace(**{k: torch.stack([getattr(init, k)] * 3) for k in jax_runs.init})
    inject(monkeypatch, ens._pert, dict(zip(ens.generators, (jax_runs.stacks[1], jax_runs.stacks[2]))))
    ens.run(STEPS)
    assert ens._program.capture  # the batched step, JAX's vmapped _vstep (a graph on the card)
    assert tuple(ens.violations.shape) == (3, len(CELL_BOUNDS + YOUNG_BOUNDS) + 1) and not ens.violations.any()
    for k in range(3):
        assert_states_close(jax_runs.members[k], state_to_numpy(ens.member_state(k)), 1e-9, f"member {k}")
    assert ens.spread(("sst", "vt_u"))["sst"] > 0.0
    assert tuple(ens.mean_state().conc.shape) == (24, 24)
    np.testing.assert_allclose(ens.mean_state().conc.numpy(), np.mean([m["conc"] for m in jax_runs.members], 0),
                               rtol=0, atol=1e-12)


def test_batched_members_equal_single_simulators():
    """With the port's own generators: member 0 is the control Simulator and
    member 2 the Simulator with ensemble_member=2, bitwise."""
    ens = PBatchedEnsemble(PConfig(overrides=dict(ENS)), 3, device="cpu")
    ens.run(STEPS)
    for m in (0, 2):
        sim = PSimulator(PConfig(overrides=dict(ENS, **{"statevector.ensemble_member": m})), device="cpu")
        for _ in range(STEPS):
            sim.step()
        assert_states_equal(state_to_numpy(sim.state), state_to_numpy(ens.member_state(m)), f"member {m}")
    d = np.abs(ens.member_state(1).sst.numpy() - ens.member_state(2).sst.numpy()).max()
    assert d > 1e-5


# ---------------------------------------------------------------------------
# the batched step against the member loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_batched_step_equals_the_member_loop_bitwise(dyn_type, dtype_name):
    over = dict(ENS, **{"setup.dynamics-type": dyn_type, "tpu.dtype": dtype_name})
    a = PBatchedEnsemble(PConfig(overrides=over), 3, device="cpu")
    b = PBatchedEnsemble(PConfig(overrides=over), 3, device="cpu")
    assert a._program.capture
    for _ in range(STEPS):
        a.step()
        b.step_members()
    assert a.pcpt == b.pcpt == STEPS and b.violations is None
    assert tuple(a.violations.shape) == (3, len(CELL_BOUNDS + YOUNG_BOUNDS) + 1) and not a.violations.any()
    for k in range(3):
        assert_states_equal(state_to_numpy(a.member_state(k)), state_to_numpy(b.member_state(k)), f"member {k}")
    assert torch.equal(a._ran, b._ran)
    assert not torch.equal(a.member_state(1).vt_u, a.member_state(2).vt_u)


def test_batched_step_reads_nothing_back():
    """The batched body, the perturbed members' draws included, reads
    nothing back from the device."""
    ens = PBatchedEnsemble(PConfig(overrides=dict(ENS)), 3, device="cpu")
    sim = ens.sim
    base = ens._base_forcing(sim.current_time + sim.dt / 86400.0)
    forcing = stack_forcings(ens._perturb(base, ens._ran)[0])
    assert forcing.tair.shape == (3, 24, 24) and forcing.ocean_u.shape == (25, 25)
    flags = sim.time_flags([sim.time_info_at(sim.current_time)])
    with _NoReadBack():
        states, viol, ran = ens._batched_body(ens.states, base, flags, ens._ran)
    assert tuple(states.tice.shape) == (3, 3, 24, 24) and viol.shape[0] == 3 and int(viol.sum()) == 0
    assert bool(torch.isfinite(states.vt_u).all()) and tuple(ran.shape) == (2, 4, 24, 24)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_batched_step_draws_inside_its_body(dtype_name, monkeypatch):
    """``step`` (the batched step's program, the draws in its body; the
    generators registered with its graph on the card) never calls
    ``_member_forcings`` and equals ``step_members`` (the eager draws)
    bitwise: every member, the carry and every generator's state."""
    over = dict(ENS, **{"dynamics.substeps": 20, "tpu.dtype": dtype_name})
    a = PBatchedEnsemble(PConfig(overrides=over), 3, device="cpu")
    b = PBatchedEnsemble(PConfig(overrides=over), 3, device="cpu")
    assert a._program.generators == a.generators and len(a.generators) == 2

    def refuse(t_days):
        raise AssertionError("BatchedEnsemble.step drew on the host")

    monkeypatch.setattr(a, "_member_forcings", refuse)
    for step in range(STEPS):
        a.step()
        b.step_members()
        for k in range(3):
            assert_states_equal(state_to_numpy(a.member_state(k)), state_to_numpy(b.member_state(k)),
                                f"step {step}, member {k}")
        assert torch.equal(a._ran, b._ran), step
        for ga, gb in zip(a.generators, b.generators):
            assert torch.equal(ga.get_state(), gb.get_state()), step


# ---------------------------------------------------------------------------
# every configuration runs the batched step
# ---------------------------------------------------------------------------

# ENS with 20 substeps (dte = 10 s), bbm, and a 6-bin FSD; the ice grows at
# the second step, where welding acts on the seeded broken floes
WELD = dict(ENS, **{"dynamics.substeps": 20, "wave_coupling.num_fsd_bins": 6,
                    "wave_coupling.welding_type": "roach"})
CONFIGS = {
    "roach": WELD,
    "wim": dict(WELD, **{"nextwim.use_wim": True, "nextwim.couplingfreq": 2, "wimsetup.nwavefreq": 5,
                         "wimsetup.nwavedirn": 8, "wave_coupling.fsd_damage_type": 1}),
    "coupler": dict(ENS, **{"dynamics.substeps": 20, "coupler.with_waves": True, "coupler.timestep": 1200}),
}


def seed_broken_floes(ens, seed=8):
    """Spread each member's ice over the bins from a numpy seed: broken
    floes for welding to act on."""
    cf = ens.states.conc_fsd
    w = torch.as_tensor(np.random.default_rng(seed).uniform(0.0, 1.0, cf.shape), dtype=cf.dtype)
    ens.states = ens.states.replace(conc_fsd=(w / w.sum(1, keepdim=True) * cf.sum(1, keepdim=True)).contiguous())


def config_of(name, tmp_path, dtype_name):
    if name == "nesting":
        from test_torch_nesting import nested_config, write_nesting_files

        write_nesting_files(str(tmp_path))
        over = nested_config(tmp_path, **{"setup.dynamics-type": "bbm", "dynamics.substeps": 90})
    else:
        over = CONFIGS[name]
    return dict(over, **{"tpu.dtype": dtype_name, "output.exporter_path": str(tmp_path / "out")})


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("name", ["roach", "wim", "coupler", "nesting"])
def test_batched_step_equals_the_member_loop_in_every_configuration(name, dtype_name, tmp_path, monkeypatch):
    """3 members, 3 steps: the batched step (``step``) against the member
    loop (``step_members``), bitwise, every member; ``step`` never calls
    ``step_members``; with an FSD, welding acts in the batched step."""
    from nextsim_tpu_torch.ops import fsd as pfsd

    over = config_of(name, tmp_path, dtype_name)
    a = PBatchedEnsemble(PConfig(overrides=over), 3, device="cpu")
    b = PBatchedEnsemble(PConfig(overrides=over), 3, device="cpu")
    assert a._program.capture and a.sim.eager_reason is None
    if a.sim.fsd_params is not None:
        seed_broken_floes(a)
        seed_broken_floes(b)
    welded = []
    plain = pfsd.welding_roach_reference

    def spy(cf, *args):
        out = plain(cf, *args)
        welded.append((cf.ndim, not torch.equal(out, cf)))
        return out

    monkeypatch.setattr(pfsd, "welding_roach_reference", spy)

    def refuse():
        raise AssertionError("BatchedEnsemble.step ran the member loop")

    loop = b.step_members
    monkeypatch.setattr(a, "step_members", refuse)
    for _ in range(STEPS):
        a.step()
        loop()
    assert a.pcpt == b.pcpt == STEPS and tuple(a.violations.shape)[0] == 3 and not a.violations.any()
    for k in range(3):
        assert_states_equal(state_to_numpy(a.member_state(k)), state_to_numpy(b.member_state(k)), f"member {k}")
    assert not torch.equal(a.member_state(1).sst, a.member_state(2).sst)
    if name in ("roach", "wim"):
        assert (4, True) in welded  # a batched (nbins, N, ny, nx) stack welded


def test_violations_count_each_members_owned_cells():
    """On an ext block of a device mesh (a corner block of 2 x 2, rings of 3
    cells): the flags are (N, checks), each member's own, and a NaN in a
    ring cell counts for nobody."""
    from nextsim_tpu_torch.core.state import member_minor
    from nextsim_tpu_torch.model import checks
    from nextsim_tpu_torch.parallel.seam import BlockLayout

    ens = PBatchedEnsemble(PConfig(overrides=dict(ENS)), 3, device="cpu")
    lay = BlockLayout(24, 24, 2, 2, 0, 0, 3)
    block = lay.to_ext(member_minor(ens.states))
    assert tuple(block.conc.shape) == (3, 15, 15) and tuple(block.tice.shape) == (3, 3, 15, 15)
    conc = block.conc.clone()
    conc[1, 13, 5] = float("nan")  # a ring cell of member 1 (rows 12.. are the ring)
    conc[2, 4, 5] = float("nan")  # an owned cell of member 2
    flags = checks.violations(block.replace(conc=conc), owned=lay.owned, members=True)
    n_checks = len(CELL_BOUNDS + YOUNG_BOUNDS) + 1
    assert tuple(flags.shape) == (3, n_checks)
    at = [name for name, *_ in CELL_BOUNDS].index("conc")
    assert flags[:, at].tolist() == [0, 0, 1] and int(flags.sum()) == 1


@pytest.mark.parametrize("name", ["roach", "nesting"])
def test_batched_ensemble_matches_jax_in_more_configurations(name, tmp_path, monkeypatch):
    """float64, 2 members (the control and member 1 on JAX's draws), 3
    steps: the port's batched step against the JAX package's vmapped
    ``_vstep``, every member within 1e-9 of each field's magnitude."""
    over = config_of(name, tmp_path, "float64")
    if name == "roach":
        over["dynamics.substeps"] = 60
    with jax.enable_x64(True):
        jens = JBatchedEnsemble(JConfig(overrides=over), n_members=2)
        if name == "roach":
            cf = np.asarray(jens.states.conc_fsd)
            w = np.random.default_rng(8).uniform(0.0, 1.0, cf.shape)
            jens.states = jens.states.replace(conc_fsd=jnp.asarray(w / w.sum(1, keepdims=True)
                                                                   * cf.sum(1, keepdims=True)))
        init = jax_to_numpy(jens.member_state(0))
        seeded = np.asarray(jens.states.conc_fsd) if name == "roach" else None
        stacks = jax_stacks(jens._pert, 1, STEPS)
        jens.run(STEPS)
        ref = [jax_to_numpy(jens.member_state(k)) for k in range(2)]
    ens = PBatchedEnsemble(PConfig(overrides=over), 2, device="cpu")
    start = state_from_numpy(init, device="cpu")
    ens.states = ens.states.replace(**{k: torch.stack([getattr(start, k)] * 2) for k in init})
    if seeded is not None:
        ens.states = ens.states.replace(conc_fsd=torch.from_numpy(seeded.copy()))
    inject(monkeypatch, ens._pert, {ens.generators[0]: stacks})
    ens.run(STEPS)
    for k in range(2):
        assert_states_close(ref[k], state_to_numpy(ens.member_state(k)), 1e-9, f"{name} member {k}")
    if seeded is not None:
        assert not np.allclose(ref[1]["conc_fsd"], seeded[1])


# ---------------------------------------------------------------------------
# the batched outputs, and the driver
# ---------------------------------------------------------------------------

# tests/test_extensions.py::test_batched_ensemble_outputs' configuration
OUT = {
    "grid.preset": "square", "grid.nx": 16, "grid.ny": 16, "grid.resolution": 10e3,
    "simul.timestep": 450, "simul.time_init": "2015-10-16 00:00:00",
    "setup.dynamics-type": "free_drift", "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant", "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 8.0, "simul.spinup_duration": 0.0, "tpu.donate_state": False,
    "output.async_io": False, "moorings.use_moorings": True, "moorings.output_timestep": 2,
    "moorings.output_time_step_units": "time_steps",
}


def out_cfg(cls, tmp_path, **over):
    cfg = cls(overrides=dict(OUT, **over, **{"output.exporter_path": str(tmp_path)}))
    cfg._values["moorings.variables"] = ["conc", "thick", "velocity"]
    return cfg


def test_batched_ensemble_outputs(tmp_path):
    ens = PBatchedEnsemble(out_cfg(PConfig, tmp_path), 4, seed=3, device="cpu")
    ens.run(2)
    ens.write_restart("cycle")
    ens.run(2)

    # the statistics records: mean and population std of the members
    files = glob.glob(str(tmp_path / "Moorings*.nc"))
    assert len(files) == 1
    moor = ens.sim.moorings
    conc = np.stack([ens.member_state(k).conc.numpy() for k in range(4)])
    with netcdf_file(files[0], "r", mmap=False) as nc:
        assert {"sic_mean", "sic_std", "siu_mean", "siu_std"} <= set(nc.variables)
        assert nc.variables["sic_mean"][:].shape[0] == 2  # records at steps 2 and 4
        for name, want in (("sic_mean", conc.mean(0)), ("sic_std", conc.std(0))):
            ref = np.where(moor.lsm > 0.5, moor._cell_interp(want), np.nan).astype(np.float32)
            np.testing.assert_allclose(np.array(nc.variables[name][-1]), ref, rtol=1e-6, atol=1e-7, equal_nan=True)
        assert np.nanmax(np.array(nc.variables["siu_std"][:])) > 0.0  # perturbed winds spread the velocities
    stats = ens._stat_fields()
    np.testing.assert_allclose(stats["sic_std"].numpy(), conc.std(0), rtol=0, atol=1e-7)

    # the npz checkpoint resumes the states and the noise stream bitwise
    back = PBatchedEnsemble(out_cfg(PConfig, tmp_path), 4, seed=99, device="cpu")
    back.read_restart("cycle")
    assert back.pcpt == 2
    back.run(2)
    assert back.pcpt == ens.pcpt == 4
    for k in range(4):
        assert_states_equal(state_to_numpy(ens.member_state(k)), state_to_numpy(back.member_state(k)), f"member {k}")
    assert torch.equal(back._ran, ens._ran)
    with pytest.raises(ValueError, match="holds 4 members"):
        PBatchedEnsemble(out_cfg(PConfig, tmp_path), 3, device="cpu").read_restart("cycle")

    # per-member restarts, read by a Simulator of either package
    ens.export_member_restarts("cyc")
    resume = {"statevector.ensemble_member": 1, "moorings.use_moorings": False, "restart.start_from_restart": True,
              "restart.basename": "cyc", "restart.type": "continue"}
    psim = PSimulator(out_cfg(PConfig, tmp_path / "mem_1", **resume), device="cpu")
    assert psim.pcpt == ens.pcpt
    assert_states_equal(state_to_numpy(psim.state), state_to_numpy(ens.member_state(1)), "port restart")
    jsim = JSimulator(out_cfg(JConfig, tmp_path / "mem_1", **resume))
    assert jsim.pcpt == ens.pcpt
    assert_states_equal(jax_to_numpy(jsim.state), state_to_numpy(ens.member_state(1)), "JAX restart")


def test_run_ensemble_driver(tmp_path):
    """A control and 2 members of a 24^2 toy through the driver's main."""
    rc = run_ensemble.main(["--device", "cpu", "--config-files", "configs/toy.cfg", "--control", "--num-members", "2",
                            "grid.nx=24", "grid.ny=24", "dynamics.substeps=20", "simul.duration=0.0104",
                            "restart.write_final_restart=true", "moorings.use_moorings=false",
                            f"output.exporter_path={tmp_path}"])
    assert rc == 0
    finals = {}
    for m in range(3):
        with np.load(tmp_path / f"mem_{m}" / "restart" / "restart_final.npz") as z:
            finals[m] = {k: z[k] for k in ("conc", "vt_u", "sst")}
        assert all(np.isfinite(v).all() for v in finals[m].values())
    assert not np.array_equal(finals[1]["vt_u"], finals[0]["vt_u"])
    assert not np.array_equal(finals[1]["vt_u"], finals[2]["vt_u"])


def test_entry_points_default_to_cuda():
    import inspect

    default = lambda fn: inspect.signature(fn).parameters["device"].default  # noqa: E731
    assert default(PBatchedEnsemble.__init__) == "cuda"
    assert default(run_ensemble.run_member) == "cuda"
    assert default(PEnsembleForcing.__init__) is inspect.Parameter.empty  # a helper: the caller names the device
