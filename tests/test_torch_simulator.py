"""The PyTorch port's main path as a whole, on the CPU.

* The slice: the port's ``Simulator`` against the JAX package's, 5 steps
  from the same initial state, on a 32^2 arctic grid and on the toy square,
  held to tests/test_golden.py's cross-platform field tolerances.
* The golden toy run: the port's 15 steps against golden_toy_fields.npz
  (FIELD_TOLS) and golden_toy.json (2%), from the JAX package's initial
  random field (golden_toy_random_number.npy, pinned below).
* The port imports no jax; its copies of the JAX package's host-only
  modules (config schema, grid, projection, constants, dates) are pinned to
  their originals; the pieces of the main path around the step
  (State.zeros, init_state, ConstantForcing, time_info) agree with the
  JAX package's; unported subsystems raise.
* The CUDA wrapper raises where it cannot launch its kernel.
"""

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextsim_tpu.core.constants as jconst
import nextsim_tpu.utils.dates as jdates
from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.config import schema as jschema
from nextsim_tpu.core.state import State as JState
from nextsim_tpu.forcing.providers import ConstantForcing as JConstantForcing
from nextsim_tpu.grid.grid import Grid as JGrid
from nextsim_tpu.grid.projection import NPS_ASR as J_NPS_ASR
from nextsim_tpu.grid.projection import NPS_NEXTSIM as J_NPS
from nextsim_tpu.model import init_state as jinit
from nextsim_tpu.model.simulator import Simulator as JSimulator
import nextsim_tpu_torch.core.constants as tconst
import nextsim_tpu_torch.utils.dates as tdates
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy, state_to_numpy
from nextsim_tpu_torch.config import schema as tschema
from nextsim_tpu_torch.core.state import State as PState
from nextsim_tpu_torch.forcing.providers import ConstantForcing as PConstantForcing
from nextsim_tpu_torch.forcing.providers import make_provider
from nextsim_tpu_torch.grid.grid import Grid as PGrid
from nextsim_tpu_torch.grid.projection import NPS_ASR as T_NPS_ASR
from nextsim_tpu_torch.grid.projection import NPS_NEXTSIM as T_NPS
from nextsim_tpu_torch.model import checks as tchecks
from nextsim_tpu_torch.model import init_state as tinit
from nextsim_tpu_torch.ops import momentum_cuda
from test_golden import FIELD_TOLS
from test_torch_momentum import jax_to_numpy

HERE = pathlib.Path(__file__).parent
REPO = HERE.parent

# tests/test_golden.py's toy configuration
GOLDEN_TOY = {
    "grid.nx": 48, "grid.ny": 48, "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00",
    "dynamics.substeps": 120,
    "dynamics.use_coriolis": False,
    "dynamics.alea_factor": 0.33,
    "dynamics.C_lab": 1.5e6,
    "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant_partial",
    "setup.atmosphere-type": "constant",
    "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 20.0,
    "simul.spinup_duration": 0.0,
    "tpu.donate_state": False,
}
SLICES = {
    # bench.py's arctic configuration cut to 32^2, wind on from the start
    "arctic32": {
        "grid.preset": "arctic", "grid.nx": 32, "grid.ny": 32, "grid.resolution": 10e3,
        "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00",
        "dynamics.substeps": 120, "dynamics.alea_factor": 0.33,
        "thermo.use_thermo_forcing": False, "setup.ice-type": "constant",
        "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 10.0, "ideal_simul.constant_wind_v": -3.0,
        "dynamics.use_coriolis": True, "simul.spinup_duration": 0.0,
        "tpu.donate_state": False,
    },
    "toy_square32": dict(GOLDEN_TOY, **{"grid.preset": "square", "grid.nx": 32, "grid.ny": 32}),
}


def assert_fields_within_golden_tols(ref, got, what):
    """tests/test_golden.py's per-field absolute tolerance with its outlier
    budget (damage/stress may flip the failure branch on isolated cells)."""
    for name, (atol, outlier_frac) in FIELD_TOLS.items():
        r = np.asarray(ref[name])
        g = got[name]
        assert np.isfinite(g).all(), (what, name)
        diff = np.abs(g - r)
        n_bad = int((diff > atol).sum())
        budget = max(1, int(outlier_frac * diff.size))
        assert n_bad <= budget, (
            f"{what}: {name} has {n_bad} cells beyond atol={atol} (budget "
            f"{budget}); max |diff|={diff.max():.3e}"
        )


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_matches_jax_simulator(name):
    over = SLICES[name]
    jsim = JSimulator(JConfig(overrides=over))
    psim = PSimulator(PConfig(overrides=over))
    psim.state = state_from_numpy(jax_to_numpy(jsim.state))
    for _ in range(5):
        jsim.step()
        psim.step()
    ref = jax_to_numpy(jsim.state)
    got = state_to_numpy(psim.state)
    assert_fields_within_golden_tols(ref, got, name)
    # the whole state, not only the golden fields: same magnitudes
    for f, r in ref.items():
        np.testing.assert_allclose(np.abs(got[f]).mean(), np.abs(r).mean(), rtol=1e-2, atol=1e-6,
                                   err_msg=f)
    assert psim.pcpt == jsim.pcpt == 5


def _golden_run():
    psim = PSimulator(PConfig(overrides=GOLDEN_TOY))
    rnd = np.load(HERE / "golden_toy_random_number.npy")
    psim.state = psim.state.replace(random_number=torch.from_numpy(rnd))
    for _ in range(15):
        psim.step()
    return psim.state


def test_golden_toy_fields_and_stats():
    s = _golden_run()
    got = {"sigma": s.sigma.numpy(), **{k: getattr(s, k).numpy() for k in FIELD_TOLS if k != "sigma"}}
    with np.load(HERE / "golden_toy_fields.npz") as ref:
        assert_fields_within_golden_tols({k: ref[k] for k in ref.files}, got, "golden")
    conc, thick, damage = s.conc.numpy(), s.thick.numpy(), s.damage.numpy()
    speed = np.hypot(s.vt_u.numpy(), s.vt_v.numpy())
    stats = {
        "conc_sum": conc.sum(), "thick_sum": thick.sum(),
        "conc_max": conc.max(), "thick_max": thick.max(),
        "damage_mean": damage.mean(), "damage_max": damage.max(),
        "speed_max": speed.max(), "speed_mean": speed.mean(),
        "sigma_absmax": np.abs(s.sigma.numpy()).max(),
        "ridge_max": s.ridge_ratio.numpy().max(),
        "damage_grad_energy": (np.diff(damage, axis=0) ** 2).sum() + (np.diff(damage, axis=1) ** 2).sum(),
    }
    golden = json.loads((HERE / "golden_toy.json").read_text())
    assert set(golden) == set(stats)
    for key, ref in golden.items():
        assert abs(float(stats[key]) - ref) <= 0.02 * max(abs(ref), 1e-6) + 1e-6, (key, stats[key], ref)


def test_golden_random_fixture_is_current():
    """golden_toy_random_number.npy is the JAX package's init_state random
    field for the golden configuration."""
    cfg = JConfig(overrides=GOLDEN_TOY)
    state = jinit.init_state(cfg, JGrid.from_config(cfg))
    np.testing.assert_array_equal(
        np.load(HERE / "golden_toy_random_number.npy"), np.asarray(state.random_number)
    )


def test_step_chunk_equals_steps():
    over = dict(SLICES["toy_square32"], **{"dynamics.substeps": 20})
    a = PSimulator(PConfig(overrides=over))
    b = PSimulator(PConfig(overrides=over))
    for _ in range(3):
        a.step()
    b.step_chunk(3)
    assert a.pcpt == b.pcpt == 3
    for f, v in state_to_numpy(a.state).items():
        np.testing.assert_array_equal(state_to_numpy(b.state)[f], v, err_msg=f)


def test_violation_flush_raises_with_messages():
    sim = PSimulator(PConfig(overrides=dict(SLICES["toy_square32"], **{"dynamics.substeps": 10})))
    conc = sim.state.conc.clone()
    conc[5, 5] = float("nan")
    sim.state = sim.state.replace(conc=conc)
    with pytest.raises(RuntimeError, match="checkFieldsFast failed for conc"):
        sim.step_chunk(2)


def test_violations_match_jax():
    from nextsim_tpu.model import checks as jchecks

    j = JState.zeros(JGrid.square(nx=8, ny=8))
    p = state_from_numpy(jax_to_numpy(j))
    bad = {"thick": 60.0, "tice": 1.0, "sss": -1.0}
    for f, v in bad.items():
        arr = np.array(jax_to_numpy(j)[f])
        arr.reshape(-1)[3] = v
        j = j.replace(**{f: jnp.asarray(arr)})
        p = p.replace(**{f: torch.from_numpy(arr)})
    np.testing.assert_array_equal(tchecks.violations(p).numpy(), np.asarray(jchecks.violations(j)))
    assert tchecks.describe(tchecks.violations(p).numpy()) == jchecks.describe(jchecks.violations(j))


def test_time_info_matches_jax():
    over = dict(SLICES["toy_square32"], **{"simul.time_init": "2015-09-14 23:00:00",
                                            "simul.timestep": 3600})
    jsim = JSimulator(JConfig(overrides=over))
    psim = PSimulator(PConfig(overrides=over))
    for t in (psim.current_time, psim.current_time + 1.0 / 24, psim.current_time + 0.5):
        ji = jsim.time_info_at(t)
        pi = psim.time_info_at(t)
        assert {k: float(v) for k, v in ji.items()} == {k: float(v) for k, v in pi.items()}


# ---------------------------------------------------------------------------
# set-up pieces against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ice,thermo", [("constant", False), ("constant_partial", False),
                                       ("constant", True)])
def test_init_state_matches_jax(ice, thermo):
    """thermo on: the constant slab ocean is warmer than the SST limit, so
    the warm-water test clears the ice (reference constantIce)."""
    over = dict(SLICES["arctic32"], **{"setup.ice-type": ice, "ideal_simul.init_young_conc": 0.1,
                                        "ideal_simul.init_snow_thickness": 0.2,
                                        "thermo.use_thermo_forcing": thermo})
    jcfg, pcfg = JConfig(overrides=over), PConfig(overrides=over)
    jstate = jinit.init_state(jcfg, JGrid.from_config(jcfg))
    pstate = tinit.init_state(pcfg, PGrid.from_config(pcfg),
                              random_number=np.asarray(jstate.random_number))
    ref = jax_to_numpy(jstate)
    got = state_to_numpy(pstate)
    assert set(ref) == set(got)
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_init_state_random_field_is_seeded():
    cfg = PConfig(overrides=SLICES["toy_square32"])
    grid = PGrid.from_config(cfg)
    a = tinit.init_state(cfg, grid, seed=3).random_number
    b = tinit.init_state(cfg, grid, seed=3).random_number
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_state_zeros_matches_jax():
    grid_j, grid_p = JGrid.square(nx=9, ny=7), PGrid.square(nx=9, ny=7)
    cfg = SLICES["arctic32"]
    ref = jax_to_numpy(JState.zeros(grid_j, cfg=JConfig(overrides=cfg)))
    got = state_to_numpy(PState.zeros(grid_p, cfg=PConfig(overrides=cfg)))
    assert [f.name for f in dataclasses.fields(PState)] == [f.name for f in dataclasses.fields(JState)]
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_state_numpy_round_trip():
    s = PState.zeros(PGrid.square(nx=5, ny=4))
    back = state_from_numpy(state_to_numpy(s), dtype=torch.float64)
    assert back.conc.dtype == torch.float64 and back.conc_fsd is None
    for f, v in state_to_numpy(s).items():
        np.testing.assert_array_equal(state_to_numpy(back)[f], v)


def test_constant_forcing_matches_jax():
    over = dict(SLICES["arctic32"], **{"simul.spinup_duration": 2.0, "ideal_simul.constant_ssh": 0.3})
    jcfg, pcfg = JConfig(overrides=over), PConfig(overrides=over)
    jf = JConstantForcing(jcfg, JGrid.from_config(jcfg))
    pf = PConstantForcing(pcfg, PGrid.from_config(pcfg))
    for t in (0.5, 1.0, 3.0):
        assert pf.spinup_factor(t, 0.0) == jf.spinup_factor(t, 0.0)
        ref, got = jf(t, 0.0), pf(t, 0.0)
        for f in dataclasses.fields(ref):
            r = getattr(ref, f.name)
            if r is None:
                assert getattr(got, f.name) is None, f.name
            else:
                np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(r), err_msg=f.name)
    assert pf(3.0, 0.0) is pf(4.0, 0.0)  # cached once the spin-up is over


# ---------------------------------------------------------------------------
# what the port does not have raises
# ---------------------------------------------------------------------------

UNPORTED = {
    "thermo": {"thermo.use_thermo_forcing": True},
    "moorings": {"moorings.use_moorings": True},
    "drifters": {"drifters.use_equally_spaced_drifters": True},
    "snapshots": {"output.output_per_day": 8},
    "restart_in": {"restart.start_from_restart": True},
    "restart_out": {"restart.write_final_restart": True},
    "check_fields": {"debugging.check_fields": True},
    "nesting": {"nesting.use_nesting": True},
    "fsd": {"wave_coupling.num_fsd_bins": 4},
    "wim": {"nextwim.use_wim": True},
    "ensemble": {"statevector.ensemble_member": 1},
    "coupler": {"setup.ocean-type": "coupled"},
    "mesh": {"tpu.mesh_shape": "2x4"},
    "shard_map": {"tpu.partition_mode": "shard_map"},
    "bfloat16": {"tpu.dtype": "bfloat16"},
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_subsystems_raise(name):
    over = dict(SLICES["toy_square32"], **UNPORTED[name])
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        PSimulator(PConfig(overrides=over))


@pytest.mark.parametrize("over", [
    {"setup.atmosphere-type": "era5"},
    {"setup.ice-type": "topaz4"},
    {"grid.preset": "arctic_etopo"},
])
def test_dataset_inputs_raise(over):
    cfg = PConfig(overrides=dict(SLICES["toy_square32"], **over))
    with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
        grid = PGrid.from_config(cfg)
        make_provider(cfg, grid)
        tinit.init_state(cfg, grid)


# ---------------------------------------------------------------------------
# the CUDA wrapper
# ---------------------------------------------------------------------------

def _loop_inputs(dtype=torch.float32):
    from nextsim_tpu_torch.ops import momentum as pmom

    sim = PSimulator(PConfig(overrides=dict(SLICES["toy_square32"], **{"dynamics.substeps": 4})))
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    forcing = sim.forcing_provider(0.0, 0.0)
    consts, carry = pmom.substep_setup(sim.state, forcing, ga, sim.dt, sim.dyn)
    if dtype != torch.float32:
        carry = tuple(c.to(dtype) for c in carry)
    return consts, carry, sim


def _cuda_loop(consts, carry, sim):
    return momentum_cuda._substep_loop_cuda(
        consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx, "bbm", sim.dyn)


def test_kernel_request_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc to build the kernel the wrapper raises; it never falls
    back to the plain loop."""
    monkeypatch.setattr(momentum_cuda, "_lib", None)
    monkeypatch.setattr(momentum_cuda, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(momentum_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        momentum_cuda.build()
    consts, carry, sim = _loop_inputs()
    launches = momentum_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_loop(consts, carry, sim)
    assert momentum_cuda.launches == launches


def test_wrapper_rejects_what_the_kernel_does_not_take():
    consts, carry, sim = _loop_inputs()
    with pytest.raises(TypeError, match="float32 or float64"):
        _cuda_loop(consts, tuple(c.half() for c in carry), sim)
    bad = list(carry)
    bad[4] = carry[4][:-1]  # sxx one row short
    with pytest.raises(ValueError, match="sxx"):
        _cuda_loop(consts, tuple(bad), sim)
    bad[4] = carry[4].t().contiguous().t()  # right shape, column-major
    with pytest.raises(ValueError, match="contiguous"):
        _cuda_loop(consts, tuple(bad), sim)
    with pytest.raises(ValueError, match="volume"):
        _cuda_loop(SimpleNamespace(**dict(vars(consts), volume=consts.volume.double())), carry, sim)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        momentum_cuda.substep_loop(consts, tuple(c.to("meta") for c in carry), 4,
                                   sim.dt / 4, sim.dt, sim.grid.dx, "bbm", sim.dyn)


def test_cpu_carry_runs_the_plain_loop():
    consts, carry, sim = _loop_inputs()
    launches = momentum_cuda.launches
    out = momentum_cuda.substep_loop(consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx, "bbm", sim.dyn)
    ref = momentum_cuda.substep_loop_reference(consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx,
                                               "bbm", sim.dyn)
    assert momentum_cuda.launches == launches
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


def test_kernel_params_mirror_the_source():
    """The ctypes mirror of SubstepParams and the plane order follow the
    CUDA source."""
    src = (REPO / "nextsim_tpu_torch" / "csrc" / "momentum_substep.cu").read_text()
    body = src[src.index("struct SubstepParams {"):]
    body = body[:body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in decl.split(None, 1)[1].split(",")]
    assert names == [n for n, _ in momentum_cuda._Params._fields_]
    enum = src[src.index("enum Plane {"):]
    enum = enum[:enum.index("};")]
    planes = [w.strip() for line in enum.splitlines()[1:]
              for w in line.split("//")[0].split(",") if w.strip()]
    assert planes[-1] == "N_PLANES"
    assert [p.lower() for p in planes[:-1]] == [
        {"dte_over_mass_const": "dte_over_mass", "beta_cor_const": "beta_cor"}.get(n, n).lower()
        for n in momentum_cuda._PLANES
    ]


# ---------------------------------------------------------------------------
# no jax, and the copies of the host-only modules
# ---------------------------------------------------------------------------

SLICE_MODULES = [
    "nextsim_tpu_torch", "nextsim_tpu_torch.config.schema", "nextsim_tpu_torch.core.constants",
    "nextsim_tpu_torch.core.state", "nextsim_tpu_torch.utils.dates",
    "nextsim_tpu_torch.grid.projection", "nextsim_tpu_torch.grid.grid",
    "nextsim_tpu_torch.grid.arctic", "nextsim_tpu_torch.forcing.base",
    "nextsim_tpu_torch.forcing.providers", "nextsim_tpu_torch.ops.stencil",
    "nextsim_tpu_torch.ops.rheology", "nextsim_tpu_torch.ops.momentum",
    "nextsim_tpu_torch.ops.momentum_cuda", "nextsim_tpu_torch.ops.advection",
    "nextsim_tpu_torch.ops.transport", "nextsim_tpu_torch.model.params",
    "nextsim_tpu_torch.model.init_state", "nextsim_tpu_torch.model.checks",
    "nextsim_tpu_torch.model.simulator",
]


def test_port_imports_no_jax():
    """In a fresh interpreter where importing jax fails, every module of the
    port imports, and neither jax nor the JAX package gets loaded."""
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'nextsim_tpu'):\n"
        "    sys.modules[name] = None  # any import of them raises ImportError\n"
        f"for mod in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nextsim_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_config_schema_copy_is_pinned():
    assert tschema.OPTIONS == jschema.OPTIONS
    assert tschema.ENUMS == jschema.ENUMS
    for cfgfile in ("toy.cfg", "arctic_10km.cfg"):
        path = str(REPO / "configs" / cfgfile)
        assert PConfig.from_files(path).as_dict() == JConfig.from_files(path).as_dict()
    assert PConfig.describe_options() == JConfig.describe_options()


def test_constants_and_dates_copies_are_pinned():
    public = lambda mod: {k: v for k, v in vars(mod).items()  # noqa: E731
                          if not k.startswith("_") and isinstance(v, (int, float))}
    assert public(tconst) == public(jconst)
    for s in ("2015-10-16", "2015-10-16 06:30:00", "2015-Oct-16", "20151016"):
        assert tdates.string_to_datenum(s) == jdates.string_to_datenum(s)
    t = jdates.string_to_datenum("2015-10-16 06:30:00")
    assert tdates.datenum_to_string(t) == jdates.datenum_to_string(t)
    assert tdates.datenum_to_datetime(t) == jdates.datenum_to_datetime(t)


def test_projection_copy_is_pinned():
    rng = np.random.default_rng(0)
    lat = rng.uniform(50.0, 90.0, 200)
    lon = rng.uniform(-180.0, 180.0, 200)
    for tp, jp in ((T_NPS, J_NPS), (T_NPS_ASR, J_NPS_ASR)):
        x, y = tp.forward(lat, lon)
        jx, jy = jp.forward(lat, lon)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        for a, b in zip(tp.inverse(x, y), jp.inverse(jx, jy)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("over", [
    {"grid.preset": "square", "grid.nx": 20, "grid.ny": 14},
    {"grid.preset": "square", "grid.nx": 20, "grid.ny": 14, "grid.boundary": "open"},
    {"grid.preset": "arctic", "grid.nx": 64, "grid.ny": 48, "grid.resolution": 25e3},
    {"grid.preset": "", "grid.nx": 16, "grid.ny": 16},  # mesh file name -> arctic
])
def test_grid_copy_is_pinned(over):
    jg = JGrid.from_config(JConfig(overrides=over))
    tg = PGrid.from_config(PConfig(overrides=over))
    assert (tg.nx, tg.ny, tg.dx, tg.x0, tg.y0) == (jg.nx, jg.ny, jg.dx, jg.x0, jg.y0)
    for name in ("mask", "open_mask", "node_mask", "node_dirichlet"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name), err_msg=name)
    for a, b in zip(tg.node_latlon() + tg.cell_latlon() + tg.node_xy(),
                    jg.node_latlon() + jg.cell_latlon() + jg.node_xy()):
        np.testing.assert_array_equal(a, b)
    assert math.isclose(tg.cell_area, jg.cell_area)
