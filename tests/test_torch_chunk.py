"""The step and chunk programs of the port (``Simulator._build_step_fn``,
``Simulator._build_chunk_fn``, ``model/captured.py``), on the CPU.

On the card a step and a chunk are one replay of a captured CUDA graph
(tests/test_torch_cuda.py holds the replays to the eager loop bitwise); on
the CPU the same body runs eagerly, and here it is held:

* to the JAX package's ``_build_chunk_fn(3)`` on the same inputs (a state
  and forcing made by the JAX package, copied through numpy): toy_square32
  and a 32^2 arctic with thermodynamics on, moorings on (running means and
  snapshot mode), and a day's end and the next day's start inside the
  chunk. float32 within tests/test_golden.py's tiers (FIELD_TOLS and
  THERMO_TOLS of tests/test_torch_simulator.py), float64 within 1e-9 of
  each field's magnitude (at least 1e-15) under the scoped
  ``jax.enable_x64(True)``. The
  violation flags and the keys of the chunk's moorings sums must be equal;
* ``step_chunk`` equals ``step`` and the eager loop bitwise on forcing
  interpolated in time (the dataset slice);
* ``thermo_step`` with its time flags as 0-dim tensors (the captured form)
  equals it with host numbers, bitwise, for every flag on and off;
* the body reads nothing back from the device (no ``.item()``, ``float()``
  or ``bool()`` of a tensor, no ``nonzero``): run under a dispatch mode that
  raises on such a read, since a CUDA graph cannot hold one;
* with FSD Roach welding the body reads nothing back either, its welding
  dispatched to the kernel's launch, here a stand-in for it
  (tests/test_torch_welding.py ``emulate_kernel``), and equals the plain
  version's body bitwise;
* a device mesh, the one configuration that keeps the eager loop on the
  card, names its reason and logs it once; a perturbed ensemble member
  runs the step program (JAX ``chunk_fn_pert``): its body reads nothing
  back, and with the coupler's received fields on it equals the eager loop
  bitwise; the JAX package's two noise carries (a fault of the reference,
  ROADMAP C) against the port's one;
* the port's bench (``nextsim_tpu_torch/bench.py``) keeps ``bench.py``'s
  anchor constants, metric and keys.
"""

import dataclasses
import json
import logging
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import bench as pbench
from nextsim_tpu_torch import state_from_numpy, state_to_numpy
from nextsim_tpu_torch.model import captured
from nextsim_tpu_torch.model.simulator import TIME_FLAGS
from nextsim_tpu_torch.ops import thermo as tthermo
from test_torch_momentum import jax_to_numpy
from test_torch_simulator import (DATASET_SLICE, REPO, SLICES, THERMO_TOLS, assert_fields_within_golden_tols,
                                  write_dataset_dir)

torch.set_num_threads(1)

# FSD Roach welding with thermodynamics on a 24^2 square of full ice: the
# ice grows (and welds, given broken floes) at the second step
WELDING = {
    "grid.preset": "square", "grid.nx": 24, "grid.ny": 24, "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00", "dynamics.substeps": 20,
    "thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0, "setup.ice-type": "constant",
    "setup.atmosphere-type": "constant", "setup.ocean-type": "constant", "ideal_simul.constant_wind_u": 10.0,
    "simul.spinup_duration": 0.0, "wave_coupling.num_fsd_bins": 6, "wave_coupling.welding_type": "roach",
}
K = 3
# the chunk's steps start at 23:53:20, 23:56:40 (the day's last step:
# is_day_end) and 00:00:00 (the next day's first: is_day_start)
DAY_EDGE = {"simul.time_init": "2015-10-16 23:53:20", "moorings.use_moorings": True,
            "dynamics.substeps": 40}
# float64: 1e-9 of each field's magnitude, floored at 1e-15 for a field that
# is zero up to rounding (ridge_ratio: 1.1e-16 in a few cells after 3 steps)
F64_TOL = 1e-9
CASES = {
    "toy_square32_thermo-f32-means": (dict(SLICES["toy_square32_thermo"], **DAY_EDGE), "float32", False),
    "arctic32_thermo-f32-snapshot": (dict(SLICES["arctic32_thermo"], **DAY_EDGE), "float32", True),
    "arctic32_thermo-f64-means": (dict(SLICES["arctic32_thermo"], **DAY_EDGE), "float64", False),
}


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _jax_chunk(jsim, k):
    dt_days = jsim.dt / 86400.0
    t0 = jsim.current_time
    forcings = [jsim.forcing_provider(t0 + (i + 1) * dt_days, jsim.time_init) for i in range(k)]
    tinfos = [jsim.time_info_at(t0 + i * dt_days) for i in range(k)]
    out = jsim._build_chunk_fn(k)(jsim.state, forcings[0], _stack(forcings[1:]), tinfos[0], _stack(tinfos[1:]))
    return out, tinfos


def _port_chunk(psim, k):
    dt_days = psim.dt / 86400.0
    t0 = psim.current_time
    forcings = [psim.forcing_provider(t0 + (i + 1) * dt_days, psim.time_init) for i in range(k)]
    tinfos = [psim.time_info_at(t0 + i * dt_days) for i in range(k)]
    rest = {key: [ti[key] for ti in tinfos[1:]] for key in TIME_FLAGS}
    return psim._build_chunk_fn(k)(psim.state, forcings[0], forcings[1:], tinfos[0], rest)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_fn_matches_jax(case, tmp_path):
    over, dtype_name, snapshot = CASES[case]
    over = dict(over, **{"tpu.dtype": dtype_name, "moorings.snapshot": snapshot,
                         "output.exporter_path": str(tmp_path)})
    f64 = dtype_name == "float64"
    with jax.enable_x64(f64):
        jsim = JSimulator(JConfig(overrides=over))
        psim = PSimulator(PConfig(overrides=over), device="cpu")
        psim.state = state_from_numpy(jax_to_numpy(jsim.state), device="cpu")
        (js, _jd, jviol, jacc, jlast), tinfos = _jax_chunk(jsim, K)
        ref, ref_acc = jax_to_numpy(js), {key: np.asarray(v) for key, v in jacc.items()}
        ref_last = {key: np.asarray(v) for key, v in jlast.items()}
    assert [float(ti["is_day_end"]) for ti in tinfos] == [0.0, 1.0, 0.0]
    assert [float(ti["is_day_start"]) for ti in tinfos] == [0.0, 0.0, 1.0]
    ps, pdiag, pviol, pacc, plast = _port_chunk(psim, K)
    got = state_to_numpy(ps)
    np.testing.assert_array_equal(pviol.numpy(), np.asarray(jviol))
    assert set(pacc) == set(ref_acc) and set(plast) == set(ref_last)
    assert {"sic", "sit", "siu", "siv"} <= set(pacc)
    assert "qa" in pdiag and psim.pcpt == 0  # the program leaves the Simulator as it was
    if f64:
        for key, r, g in ([(f, r, got[f]) for f, r in ref.items()]
                          + [(key, r, pacc[key].numpy()) for key, r in ref_acc.items()]
                          + [("last " + key, r, plast[key].numpy()) for key, r in ref_last.items()]):
            np.testing.assert_allclose(g, r, rtol=0, atol=F64_TOL * max(np.abs(r).max(), 1e-6), err_msg=key)
        return
    assert_fields_within_golden_tols(ref, got, case)
    for f, atol in THERMO_TOLS.items():
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=atol, err_msg=f"{case}: {f}")
    # the sums over K steps within K times the fields' golden tolerances
    for key, atol in {"sic": 5e-3, "sit": 5e-3, "siu": 2e-3, "siv": 2e-3}.items():
        np.testing.assert_allclose(pacc[key].numpy(), ref_acc[key], rtol=0, atol=K * atol, err_msg=key)
        np.testing.assert_allclose(plast[key].numpy(), ref_last[key], rtol=0, atol=atol, err_msg=key)


def test_chunk_fn_takes_a_stacked_forcing_as_bench_py_builds_it():
    """``bench.py``'s calling sequence: the tail of the chunk's forcing as
    one ``Forcing`` of stacked planes, the flags as k - 1 values a key; the
    result equals the same chunk given bundle by bundle, bitwise."""
    psim = PSimulator(PConfig(overrides=dict(SLICES["toy_square32"], **{"dynamics.substeps": 10})),
                      device="cpu")
    forcing = psim.forcing_provider(psim.current_time, psim.time_init)
    tinfo = psim.time_info()
    stacked = forcing.replace(**{f.name: torch.stack([getattr(forcing, f.name)] * (K - 1))
                                 for f in dataclasses.fields(forcing)
                                 if isinstance(getattr(forcing, f.name), torch.Tensor)})
    rest = {key: [v] * (K - 1) for key, v in tinfo.items()}
    chunk = psim._build_chunk_fn(K)
    a = chunk(psim.state, forcing, stacked, tinfo, rest)
    b = chunk(psim.state, forcing, [forcing] * (K - 1), tinfo, rest)
    for f, v in state_to_numpy(a[0]).items():
        np.testing.assert_array_equal(state_to_numpy(b[0])[f], v, err_msg=f)
    step = psim._build_step_fn()
    s1, d1, v1 = step(psim.state, forcing, tinfo)
    assert set(d1) == set(a[1]) and v1.shape == a[2].shape


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return write_dataset_dir(tmp_path_factory.mktemp("datasets"))


# ---------------------------------------------------------------------------
# the time flags as tensors
# ---------------------------------------------------------------------------

def _thermo_inputs():
    sim = PSimulator(PConfig(overrides=SLICES["toy_square32_thermo"]), device="cpu")
    sim.step_eager()  # a state with ice tracers in motion
    rng = np.random.default_rng(7)
    mask = sim.grid_arrays["mask"].numpy() > 0
    noise = lambda lo, hi: torch.from_numpy(np.where(mask, rng.uniform(lo, hi, mask.shape), 0.0)  # noqa: E731
                                            .astype(np.float32))
    state = sim.state.replace(del_vi_tend=noise(-0.01, 0.01), freeze_days=noise(0.0, 30.0).round(),
                              conc_myi=noise(0.0, 0.5), thick_myi=noise(0.0, 0.8),
                              fyi_fraction=noise(0.0, 1.0))
    forcing = sim.forcing_provider(sim.current_time, sim.time_init)
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * state.random_number)
    return sim, state, forcing, ga


@pytest.mark.parametrize("reset_by_date", [True, False])
@pytest.mark.parametrize("flag", TIME_FLAGS)
def test_thermo_step_with_tensor_flags_equals_host_flags(flag, reset_by_date):
    sim, state, forcing, ga = _thermo_inputs()
    params = dataclasses.replace(sim.thermo_params, reset_by_date=reset_by_date)
    for on in (0.0, 1.0):
        host = {key: on if key == flag else 0.0 for key in TIME_FLAGS}
        dev = {key: torch.tensor(v, dtype=torch.float32) for key, v in host.items()}
        a_state, a_diag = tthermo.thermo_step(state, forcing, ga, sim.dt, params, tinfo=host)
        b_state, b_diag = tthermo.thermo_step(state, forcing, ga, sim.dt, params, tinfo=dev)
        for f, v in state_to_numpy(a_state).items():
            assert np.array_equal(state_to_numpy(b_state)[f], v, equal_nan=True), (flag, on, f)
        assert set(a_diag) == set(b_diag)
        for key, v in a_diag.items():
            assert np.array_equal(b_diag[key].numpy(), v.numpy(), equal_nan=True), (flag, on, key)


# ---------------------------------------------------------------------------
# what the captured body does not do
# ---------------------------------------------------------------------------

class _NoReadBack(TorchDispatchMode):
    """Raises on every operator that reads a tensor's value back to the host
    (or sizes a result by one), which a CUDA graph cannot hold."""

    READS = {"_local_scalar_dense", "item", "nonzero", "masked_select", "unique", "_unique2"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.READS:
            raise AssertionError(f"the step program reads back from the device: aten.{name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("over", [
    dict(SLICES["toy_square32_thermo"], **DAY_EDGE),
    dict(SLICES["toy_square32_thermo"], **{"wave_coupling.num_fsd_bins": 6, "thermo.melt_type": 3,
                                          "dynamics.substeps": 10}),
    dict(SLICES["toy_square32"], **{"setup.dynamics-type": "mevp", "dynamics.substeps": 10,
                                    "coupler.with_waves": True}),
], ids=["thermo-moorings", "fsd-melt3", "mevp-coupler"])
def test_step_program_reads_nothing_back(over, tmp_path):
    psim = PSimulator(PConfig(overrides=dict(over, **{"output.exporter_path": str(tmp_path)})), device="cpu")
    assert psim.eager_reason is None
    k = 2
    forcings = [psim.forcing_provider(psim.current_time + (i + 1) * psim.dt / 86400.0, psim.time_init)
                for i in range(k)]
    flags = psim.time_flags([psim.time_info_at(psim.current_time + i * psim.dt / 86400.0) for i in range(k)])
    with _NoReadBack():
        state, diag, viol, acc, last = psim._chunk_body(psim.state, forcings, flags, None, psim._wim_diag())
    assert viol.ndim == 1 and int(viol.sum()) == 0
    assert bool(torch.isfinite(state.vt_u).all())


# ---------------------------------------------------------------------------
# the configurations that keep the eager loop
# ---------------------------------------------------------------------------

def test_roach_welding_body_reads_nothing_back(tmp_path, monkeypatch):
    """FSD Roach welding with thermodynamics, a broken area seeded from numpy:
    ``_chunk_body`` with the welding dispatched to the kernel's launch (a
    stand-in here) reads nothing back, welds (the ice grows at the second
    step) and equals the body with the plain version, bitwise; the
    configuration is captured on the card (no eager reason)."""
    from nextsim_tpu_torch.ops import fsd as pfsd
    from nextsim_tpu_torch.ops import welding_cuda
    from test_torch_welding import emulate_kernel

    over = dict(WELDING, **{"output.exporter_path": str(tmp_path)})
    psim = PSimulator(PConfig(overrides=over), device="cpu")
    assert psim.eager_reason is None
    cf = psim.state.conc_fsd
    w = torch.as_tensor(np.random.default_rng(8).uniform(0.0, 1.0, cf.shape), dtype=cf.dtype)
    psim.state = psim.state.replace(conc_fsd=w / w.sum(0) * cf.sum(0))
    k = 2
    forcings = [psim.forcing_provider(psim.current_time + (i + 1) * psim.dt / 86400.0, psim.time_init)
                for i in range(k)]
    flags = psim.time_flags([psim.time_info_at(psim.current_time + i * psim.dt / 86400.0) for i in range(k)])
    plain = psim._chunk_body(psim.state, forcings, flags, None, psim._wim_diag())
    active = []

    def launch(conc_fsd, out, ctot, c_broken, freezing, *rest):
        active.append(freezing & (c_broken > 0.01) & (ctot > 0.1))
        emulate_kernel(conc_fsd, out, ctot, c_broken, freezing, *rest)

    monkeypatch.setattr(pfsd, "_kernel_for", lambda t: True)
    monkeypatch.setattr(welding_cuda, "_launch", launch)
    with _NoReadBack():
        state, diag, viol, acc, last = psim._chunk_body(psim.state, forcings, flags, None, psim._wim_diag())
    assert len(active) == k and int(active[-1].sum()) > 0
    for f in state.__dataclass_fields__:
        a, b = getattr(plain[0], f), getattr(state, f)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), f
    assert int(viol.sum()) == 0


def test_eager_configurations_name_and_log_their_reason(tmp_path, caplog):
    """Only a device mesh keeps the eager loop on the card: a perturbed
    member has no eager reason, runs the step program (its carry the
    program's sixth argument) and logs nothing about an eager loop."""
    base = dict(SLICES["toy_square32_thermo"], **{"dynamics.substeps": 10,
                                                 "output.exporter_path": str(tmp_path)})
    member = dict(base, **{"statevector.ensemble_member": 1})
    sim = PSimulator(PConfig(overrides=member), device="cpu")
    assert sim.eager_reason is None and sim._program.capture
    calls = []
    program = sim._program
    sim._program = lambda *args: calls.append(len(args)) or program(*args)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="nextsim_tpu"):
        sim.step_chunk(2)
        sim.step()
    assert not [r.getMessage() for r in caplog.records if "eager step loop" in r.getMessage()]
    assert sim.pcpt == 3 and calls == [6, 6]
    # a device mesh: the rule on the Simulator's attributes (a mesh needs a
    # world of ranks; tests/test_torch_parallel.py steps one)
    plain = PSimulator(PConfig(overrides=base), device="cpu")
    assert plain.eager_reason is None
    meshed = SimpleNamespace(mesh=object(), fsd_params=None, use_thermo=True, cfg=plain.cfg, log=plain.log,
                             device=plain.device, _eager_logged=False)
    meshed.eager_reason = PSimulator._eager_reason(meshed)
    assert "device mesh" in meshed.eager_reason
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="nextsim_tpu"):
        PSimulator._log_eager(meshed)
        PSimulator._log_eager(meshed)
    logged = [r.getMessage() for r in caplog.records if "eager step loop" in r.getMessage()]
    assert len(logged) == 1 and "device mesh" in logged[0], logged


# ---------------------------------------------------------------------------
# a perturbed member's program (JAX chunk_fn_pert)
# ---------------------------------------------------------------------------

def test_perturbed_body_reads_nothing_back(tmp_path):
    """The perturbed body, moorings on: each step's draw, spectral call,
    AR(1) update and perturbed step read nothing back from the device; it
    returns the carry and the last perturbed forcing, which the moorings'
    sums read (t2m)."""
    over = dict(SLICES["toy_square32_thermo"], **DAY_EDGE, **{"statevector.ensemble_member": 2,
                                                             "output.exporter_path": str(tmp_path)})
    cfg = PConfig(overrides=over)
    cfg._values["moorings.variables"] = ["conc", "velocity", "tair"]
    psim = PSimulator(cfg, device="cpu")
    pert = psim._ens_pert
    ran = pert.init_state()
    k = 2
    forcings = [pert.provider(psim.current_time + (i + 1) * psim.dt / 86400.0, psim.time_init) for i in range(k)]
    flags = psim.time_flags([psim.time_info_at(psim.current_time + i * psim.dt / 86400.0) for i in range(k)])
    with _NoReadBack():
        state, diag, viol, acc, last, ran2, last_f = psim._chunk_body(psim.state, forcings, flags, None,
                                                                      psim._wim_diag(), ran)
    assert int(viol.sum()) == 0 and bool(torch.isfinite(state.vt_u).all())
    assert ran2.shape == ran.shape and not torch.equal(ran2, ran)
    assert not torch.equal(last_f.tair, forcings[-1].tair) and last_f.ocean_u is forcings[-1].ocean_u
    assert torch.equal(last["t2m"], last_f.tair)  # the moorings read the perturbed forcing


def test_perturbed_chunk_fn_takes_and_returns_the_carry():
    """A perturbed member's ``_build_chunk_fn(k)`` has JAX's ``chunk_fn_pert``
    signature: the unperturbed forcing and the carry in, (state, diag,
    viol, acc, last_extract, carry, last perturbed forcing) out, the
    Simulator left as it was; it equals ``step_chunk(k)`` bitwise."""
    from test_torch_ensemble import _pert_sim

    a, b = _pert_sim(), _pert_sim()
    pert = a._ens_pert
    forcings = [pert.provider(a.current_time + (i + 1) * a.dt / 86400.0, a.time_init) for i in range(K)]
    tinfos = [a.time_info_at(a.current_time + i * a.dt / 86400.0) for i in range(K)]
    rest = {key: [ti[key] for ti in tinfos[1:]] for key in TIME_FLAGS}
    out = a._build_chunk_fn(K)(a.state, forcings[0], forcings[1:], tinfos[0], rest, pert.init_state())
    assert len(out) == 7 and a.pcpt == 0 and a._pert_state is None
    b.step_chunk(K)
    for f, v in state_to_numpy(b.state).items():
        np.testing.assert_array_equal(state_to_numpy(out[0])[f], v, err_msg=f)
    assert torch.equal(out[5], b._pert_state) and torch.equal(out[6].tair, b.last_forcing.tair)
    assert torch.equal(pert.generator.get_state(), b._ens_pert.generator.get_state())


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_perturbed_chunk_with_received_coupler_fields_equals_the_eager_loop(dtype_name, tmp_path):
    """The coupler's received fields (SST, currents, wave stress, qsrml)
    overlaid on a perturbed member's forcing: the program perturbs after
    the overlays (the noise's fields are not theirs), the eager loop
    before; two chunks of 2 equal the eager loop bitwise, and the last
    forcing holds both the received fields and the noise."""
    from test_torch_ensemble import _pert_sim, assert_same_stream

    over = {"tpu.dtype": dtype_name, "coupler.with_waves": True, "coupler.timestep": 1200,
            "output.exporter_path": str(tmp_path)}
    a, b = _pert_sim(**over), _pert_sim(**over)
    rng = np.random.default_rng(5)
    cells = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, a.grid.shape), dtype=a.dtype)  # noqa: E731
    nodes = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, a.grid.node_shape), dtype=a.dtype)  # noqa: E731
    received = {"ocean_temp": cells(-1.8, -1.0), "ocean_u": nodes(-0.1, 0.1), "ocean_v": nodes(-0.1, 0.1),
                "tau_wi_u": nodes(0.0, 0.02), "tau_wi_v": nodes(-0.01, 0.01), "qsrml": cells(0.0, 0.5)}
    a.coupler._received, b.coupler._received = dict(received), dict(received)
    for i in range(2):
        a.step_chunk(2)
        b.step_chunk_eager(2)
        assert_same_stream(a, b, f"chunk {i}")
    for name, v in received.items():
        assert torch.equal(getattr(a.last_forcing, name), v), name
    assert not torch.equal(a.last_forcing.tair, a._ens_pert.provider(a.current_time, a.time_init).tair)


def test_the_reference_keeps_two_noise_carries():
    """ROADMAP C, faults of the reference: the JAX package's chunk carries
    its noise in ``Simulator._pert_state`` and its ``step()`` in
    ``EnsembleForcing.key``/``_ran``; ``init_state()`` splits the key without
    keeping the split, so after ``step_chunk()`` of 2 steps, ``step()``
    perturbs with the chunk's first noise update again (constant forcing
    here, so the forcings compare too). The port keeps one carry: that
    sequence equals three eager steps bitwise, and its third update is
    not its first (the chain moves ~5% a step: alpha = exp(-dt/tcorr) =
    0.9988). A 16^2 square with thermodynamics off: the carries are the
    point."""
    from test_torch_ensemble import ENS, _pert_sim, assert_same_stream, rel_err

    over = dict(ENS, **{"statevector.ensemble_member": 1, "tpu.steps_per_call": 2, "grid.nx": 16, "grid.ny": 16,
                        "dynamics.substeps": 10, "thermo.use_thermo_forcing": False})
    with jax.enable_x64(True):
        jsim = JSimulator(JConfig(overrides=over))
        jpert = jsim._ens_pert
        base = jpert.provider(jsim.current_time, jsim.time_init)
        apply = jax.jit(jpert.apply)
        (_, first_ran), first = apply(jpert.init_state(), base)
        jsim.step_chunk()
        (_, next_ran), _ = apply(jsim._pert_state, base)  # where one carry would go next
        jsim.step()
        step_ran, step_tair = np.asarray(jpert._ran), np.asarray(jsim.last_forcing.tair)
        first_ran, first_tair, next_ran = np.asarray(first_ran), np.asarray(first.tair), np.asarray(next_ran)
    assert rel_err(first_ran, step_ran) <= 1e-12 and rel_err(first_tair, step_tair) <= 1e-12
    assert rel_err(next_ran, step_ran) > 1e-3
    pover = {k: over[k] for k in ("tpu.steps_per_call", "grid.nx", "grid.ny", "dynamics.substeps",
                                  "thermo.use_thermo_forcing")}
    a, b = _pert_sim(**pover), _pert_sim(**pover)
    a.step_chunk()
    a.step()
    for _ in range(3):
        b.step_eager()
    assert_same_stream(a, b, "chunk then step")
    c = _pert_sim(**pover)
    c.step_eager()
    assert rel_err(c._pert_state, a._pert_state) > 1e-3




def test_step_chunk_equals_steps_on_time_interpolated_forcing(dataset_dir, monkeypatch):
    """On ERA5 + TOPAZ4 + ETOPO (forcing interpolated in time every step):
    ``step_chunk(3)``, three ``step`` calls and the eager loop agree
    bitwise, so the chunk takes each step's time as the step loop rounds it
    (a time formed otherwise moves the interpolation weights by an ulp: in
    float64, from the chunks that start at steps 1 and 4, whose second
    step's time time_init + (1 + 1) dt rounds otherwise than
    (time_init + 1 dt) + 1 dt)."""
    monkeypatch.setenv("NEXTSIM_DATA_DIR", dataset_dir)
    over = dict(DATASET_SLICE, **{"dynamics.substeps": 40, "simul.time_init": "2015-10-16 01:13:20",
                                  "tpu.dtype": "float64"})
    sims = [PSimulator(PConfig(overrides=over), device="cpu") for _ in range(3)]
    sims[0].step()
    sims[1].step()
    sims[2].step_eager()
    for _ in range(2):
        sims[0].step_chunk(3)
        for _ in range(3):
            sims[1].step()
        sims[2].step_chunk_eager(3)
    ref = state_to_numpy(sims[2].state)
    for sim in sims[:2]:
        assert sim.pcpt == 7
        for f, v in state_to_numpy(sim.state).items():
            np.testing.assert_array_equal(v, ref[f], err_msg=f)
    assert not torch.equal(sims[0].last_forcing.tair, sims[0].forcing_provider(
        sims[0].time_after(-5), sims[0].time_init).tair)


def test_step_program_leaves_references_and_honours_a_replaced_state():
    """Value semantics: a state taken before a step keeps its values, and a
    caller's ``sim.state = ...replace(...)`` between calls is the next
    call's input."""
    over = dict(SLICES["toy_square32"], **{"dynamics.substeps": 20})
    a = PSimulator(PConfig(overrides=over), device="cpu")
    b = PSimulator(PConfig(overrides=over), device="cpu")
    before = a.state
    snap = state_to_numpy(before)
    a.step_chunk(2)
    for f, v in state_to_numpy(before).items():
        np.testing.assert_array_equal(v, snap[f], err_msg=f)
    for sim, step in ((a, a.step_chunk), (b, b.step_chunk_eager)):
        if sim is b:
            b.step_chunk_eager(2)
        sim.state = sim.state.replace(damage=sim.state.damage * 0.5)
        step(2)
    for f, v in state_to_numpy(a.state).items():
        np.testing.assert_array_equal(state_to_numpy(b.state)[f], v, err_msg=f)


def test_captured_flatten_round_trip_and_cpu_call():
    s = PSimulator(PConfig(overrides=dict(SLICES["toy_square32"], **{"dynamics.substeps": 3})), device="cpu")
    tree = (s.state, [None, {"b": torch.ones(2), "a": 1.5}], "x")
    leaves, treedef = captured.flatten(tree)
    back = captured.unflatten(treedef, leaves)
    assert back[1][0] is None and back[1][1]["a"] == 1.5 and back[2] == "x"
    assert back[0].conc is s.state.conc and list(back[1][1]) == ["b", "a"]
    assert captured.flatten(back)[1] == treedef
    # another dtype or a None leaf is another structure
    assert captured.flatten((s.state.replace(conc_fsd=torch.zeros(1)),))[1] != captured.flatten((s.state,))[1]
    calls = []
    prog = captured.Captured(lambda x: calls.append(x) or x * 2.0)
    assert torch.equal(prog(torch.ones(3)), torch.full((3,), 2.0)) and len(calls) == 1
    assert not prog.graphs  # the CPU calls the function


def test_captured_flatten_leaves_no_reference_cycle():
    """Flattening and rebuilding a tree holds no tensor once the caller
    drops it, with the garbage collector off: a reference cycle would keep a
    program call's inputs on the device until a collection."""
    import gc
    import weakref

    x = torch.ones(3)
    ref = weakref.ref(x)
    gc.disable()
    try:
        leaves, treedef = captured.flatten({"a": (x, [x]), "b": 2})
        back = captured.unflatten(treedef, leaves)
        assert back["a"][1][0] is x
        del x, leaves, back
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the port's bench
# ---------------------------------------------------------------------------

def test_bench_keeps_bench_py_anchor_metric_and_keys():
    sys.path.insert(0, str(REPO))
    try:
        import bench as jbench
    finally:
        sys.path.remove(str(REPO))
    for name in ("REF_CORE_ELEMENT_SUBSTEPS_PER_S", "REF_JOB_CORES", "REF_ANCHOR_ELEMENT_SUBSTEPS_PER_S",
                 "TRIANGLES_PER_QUAD_CELL"):
        assert getattr(pbench, name) == getattr(jbench, name), name
    src = (REPO / "bench.py").read_text()
    assert f'"metric": "{pbench.METRIC}"' in src
    for key, v in pbench.bench_overrides().items():
        if key != "tpu.steps_per_call":
            assert f'"{key}": ' in src, key
    assert 'cfg.set("tpu.steps_per_call", 30)' in src and pbench.bench_overrides()["tpu.steps_per_call"] == 30
    out = pbench.measure("cpu", n=24, substeps=10, steps_per_call=2, n_steps=2, n_windows=2)
    json.dumps(out)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == pbench.METRIC and out["unit"] == "ocean-cell-substeps/s"
    for key in ("grid", "ocean_cells", "raw_cell_substeps_per_s", "substeps", "steps_per_s", "model_s_per_wall_s",
                "anchor_element_substeps_per_s", "anchor_note", "timing", "window_ocean_rates",
                "aggregate_ocean_rate", "backend", "device"):
        assert key in out["detail"], key
    assert len(out["detail"]["window_ocean_rates"]) == 2 and out["detail"]["device"] == {"kind": "cpu"}
    assert out["value"] > 0


def test_bench_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pbench.main() == 2
    assert capsys.readouterr().out == ""
