"""The waves-in-ice module on a device mesh, on the CPU: ``Wim(mesh=...)``
and the WIM-coupled Simulator on 2x2 meshes of 4 ranks over gloo
(tests/torch_mesh_worker.py holds the rank functions).

* The counterpart of tests/test_parallel.py's
  ``test_wim_sharded_matches_single_device``: a ``Wim`` on the 16 x 64
  strip, 5 x 8 spectrum, steady, 3,600 s, with ``wim.advopt`` y-periodic
  and xy-periodic; the ideal fields, and patchy ones (ice on 55% of the
  cells, floes of 30-400 m, waves from every direction, 5% land) that put
  ice and waves at every edge of the domain, so that a wrong periodic or
  seam ring shows. The gathered spectrum, floe fields and diagnostics
  equal the single-device port's BITWISE; on the ideal fields they equal
  the JAX package's single-device ``Wim`` in float64 within 1e-9 of each
  field's magnitude. (On the patchy fields the two packages' single-device
  runs part by 7e-9 of the floe size after one WIM step: a cell deep in the
  ice breaks at a wave frequency formed from moments attenuated to 1e-20 of
  the field's largest, where an ulp of the attenuation is a large relative
  error. The sharded run is held to the port there.)
* The counterpart of ``test_wim_coupled_sharded_run``: a 16 x 40 square
  grid, BBM, 30 substeps, the WIM every 2 steps (5 x 8, not steady), 3
  steps in float64 from the JAX package's initial state with 30% of the
  cells cleared of ice: conc, thick, damage, vt_u, vt_v and the WIM's
  dfloe equal the single-device port's bitwise and the JAX package's
  within 1e-9.
* ``nextwim.coupling-option=naive``: the WIM on its own 11 x 27 grid, which
  every rank runs whole from gathered fields; bitwise the single-device
  port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_mesh_worker as worker
from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu.output.restart import write_restart as jwrite_restart
from nextsim_tpu.wim import wim as jw
from nextsim_tpu_torch import Config, Simulator, state_to_numpy
from nextsim_tpu_torch.parallel import seam
from nextsim_tpu_torch.parallel.distributed import run_world
from nextsim_tpu_torch.wim import wim as pw
from test_torch_momentum import jax_to_numpy

torch.set_num_threads(1)  # the ranks and the workers share the cores

WORLD_TIMEOUT = 240.0
RTOL_JAX_F64 = 1e-9
WIM_SECONDS = 3600.0
ADVOPTS = ("y-periodic", "xy-periodic")
SETUPS = {"ideal": (worker.StripGrid, worker.ideal_setup), "patchy": (worker.PatchGrid, worker.patchy_setup)}
WIM_CASES = [(a, s) for a in ADVOPTS for s in SETUPS]

# tests/test_parallel.py's coupled configuration, in float64
COUPLED = {
    "grid.preset": "square", "grid.nx": 40, "grid.ny": 16, "grid.resolution": 4e3,
    "setup.ice-type": "constant_partial", "setup.atmosphere-type": "constant",
    "setup.ocean-type": "constant", "setup.dynamics-type": "bbm",
    "thermo.use_thermo_forcing": False, "dynamics.substeps": 30,
    "nextwim.use_wim": True, "nextwim.couplingfreq": 2,
    "wimsetup.nwavefreq": 5, "wimsetup.nwavedirn": 8, "wim.steady": False,
    "ideal_simul.constant_wind_u": 5.0, "simul.spinup_duration": 0.0,
    "tpu.donate_state": False, "tpu.dtype": "float64",
}
STEPS = 3
FIELDS = ("conc", "thick", "damage", "vt_u", "vt_v")


def _wim_kw(advopt):
    return dict(nwavefreq=5, nwavedirn=8, steady=True, advopt=advopt)


def _name(advopt, setup):
    return f"wim_{advopt}_{setup}"


def _restart_over(root):
    return {"restart.start_from_restart": True, "restart.input_path": str(root / "restart"),
            "restart.basename": "patchy", "restart.type": "continue"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The mesh runs (two worlds of 4 ranks) and the JAX package's coupled
    run from the patchy initial state, which it writes as a restart."""
    root = tmp_path_factory.mktemp("waves")
    out = root / "out"
    out.mkdir()
    with jax.enable_x64(True):
        jsim = JSimulator(JConfig(overrides=dict(COUPLED, **{"output.exporter_path": str(root)})))
        bare = np.random.default_rng(3).random(jsim.grid.shape) < 0.3
        jsim.state = jsim.state.replace(**{f: jnp.where(bare, 0.0, getattr(jsim.state, f))
                                           for f in ("conc", "thick", "snow_thick")})
        jwrite_restart(jsim, name="patchy")
        for _ in range(STEPS):
            jsim.step()
        jax_ref = dict(jax_to_numpy(jsim.state), dfloe=np.asarray(jsim.wim.ice["dfloe"]))
    wim_cases = [(_name(a, s), _wim_kw(a), SETUPS[s][0](), SETUPS[s][1], WIM_SECONDS) for a, s in WIM_CASES]
    run_world(worker.wim_standalone, 4, args=(wim_cases, str(out)), device="cpu", timeout=WORLD_TIMEOUT)
    sims = {
        "coupled": dict(COUPLED, **_restart_over(root)),
        "naive": dict(COUPLED, **_restart_over(root), **{"nextwim.coupling-option": "naive", "wimgrid.dx": 6e3}),
    }
    cases = [(k, dict(v, **{"tpu.mesh_shape": "2x2", "output.exporter_path": str(root / k)}), STEPS)
             for k, v in sims.items()]
    run_world(worker.run_cases, 4, args=(cases, str(out)), device="cpu", timeout=WORLD_TIMEOUT)
    got = {}
    for name in [c[0] for c in wim_cases] + list(sims):
        with np.load(out / f"{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return got, sims, jax_ref, root


def _close(ref, got, what, scale=None):
    """|got - ref| within RTOL_JAX_F64 of ``scale`` (default: max |ref|)."""
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max()) if scale is None else scale
    assert err <= RTOL_JAX_F64 * max(scale, 1e-300), (what, err)


# ---------------------------------------------------------------------------
# the WIM alone
# ---------------------------------------------------------------------------

def _single_wim(advopt, setup):
    grid, fn = SETUPS[setup]
    w = pw.Wim(pw.WimParams(**_wim_kw(advopt)), grid(), torch.float64, device="cpu")
    fn(w)
    diag = w.run(WIM_SECONDS)
    return dict(sdf=w.sdf.numpy(), **{f"ice_{k}": v.numpy() for k, v in w.ice.items()},
                **{f"diag_{k}": v.numpy() for k, v in diag.items()})


@pytest.mark.parametrize("advopt,setup", WIM_CASES)
def test_wim_on_mesh_equals_single_device(advopt, setup, runs):
    got = runs[0][_name(advopt, setup)]
    ref = _single_wim(advopt, setup)
    assert set(ref) == set(got)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert ref["diag_hs"].max() > 1.0 and ref["sdf"].max() > 0.0
    if setup == "patchy":  # breaking happened, and ice and waves meet every edge
        assert 0.1 < ref["ice_broken"].mean() < 0.9
        for edge in (ref["diag_hs"][0], ref["diag_hs"][-1], ref["diag_hs"][:, 0], ref["diag_hs"][:, -1]):
            assert edge.max() > 0.5


@pytest.mark.parametrize("advopt", ADVOPTS)
def test_wim_on_mesh_matches_jax_f64(advopt, runs):
    got = runs[0][_name(advopt, "ideal")]
    with jax.enable_x64(True):
        w = jw.Wim(jw.WimParams(**_wim_kw(advopt)), worker.StripGrid(), dtype=jnp.float64)
        w.ideal_ice_fields(0.7)
        w.ideal_wave_fields(0.8)
        diag = w.run(WIM_SECONDS)
        ref = dict(sdf=np.asarray(w.sdf), **{f"ice_{k}": np.asarray(v) for k, v in w.ice.items()},
                   **{f"diag_{k}": np.asarray(v) for k, v in diag.items()})
    for k in ("sdf", "ice_dfloe", "ice_nfloes", "ice_broken", "diag_hs", "diag_tp", "diag_tau_x", "diag_mwd"):
        _close(ref[k], got[k], k)
    # on the ideal strip tau_y is rounding noise (1e-84): held to tau_x's scale
    _close(ref["diag_tau_y"], got["diag_tau_y"], "diag_tau_y", np.abs(ref["diag_tau_x"]).max())


def test_wim_layout_is_periodic_where_advopt_wraps():
    """The WIM's layout of a rank's block: rings of WIM_RING cells, and a
    ring at a periodic edge (from the opposite block); none at an edge that
    does not wrap."""
    lay = seam.BlockLayout(16, 64, 2, 2, 0, 0, 3)
    ex = seam.Seam(lay, 1)
    y = pw.Wim(pw.WimParams(nwavefreq=1, nwavedirn=4), worker.StripGrid(), torch.float64, device="cpu", mesh=ex)
    assert y.mesh.layout.width == seam.WIM_RING == 4 and y.mesh.layout.periodic == (True, False)
    assert y.mesh.layout.rows == (-4, 12, 4) and y.mesh.layout.cols == (0, 36, 0)
    assert y.mesh.layout.neighbours() == (2, 2, None, 1)
    xy = pw.Wim(pw.WimParams(nwavefreq=1, nwavedirn=4, advopt="xy-periodic"), worker.StripGrid(), torch.float64,
                device="cpu", mesh=ex)
    assert xy.mesh.layout.cols == (-4, 36, 4) and xy.mesh.layout.neighbours() == (2, 2, 1, 1)
    assert y.sdf.shape == (1, 4, 16, 36) and xy.land.shape == (16, 40)
    x = torch.arange(16 * 64, dtype=torch.float64).view(16, 64)
    np.testing.assert_array_equal(xy.to_blocks(x)[:4, 4:36].numpy(), x[12:, :32].numpy())  # the wrapped rows
    np.testing.assert_array_equal(xy.to_blocks(x)[4:12, :4].numpy(), x[:8, 60:].numpy())  # the wrapped columns
    with pytest.raises(ValueError, match="do not fit"):
        ex.derive(9, (True, False))


# ---------------------------------------------------------------------------
# the WIM-coupled Simulator
# ---------------------------------------------------------------------------

def _single_sim(over, root, name):
    sim = Simulator(Config(overrides=dict(over, **{"output.exporter_path": str(root / f"{name}1")})), device="cpu")
    for _ in range(STEPS):
        sim.step()
    return dict(state_to_numpy(sim.state), dfloe=sim.wim.ice["dfloe"].numpy()), sim


@pytest.mark.parametrize("name", ["coupled", "naive"])
def test_coupled_wim_on_mesh_equals_single_device(name, runs):
    got, sims = runs[0][name], runs[1]
    ref, sim = _single_sim(sims[name], runs[3], name)
    for f, v in ref.items():
        if f != "dfloe":
            np.testing.assert_array_equal(got[f], v, err_msg=f)
    np.testing.assert_array_equal(got["__wim_dfloe"], ref["dfloe"])
    assert (ref["conc"] == 0.0).mean() > 0.15 and ref["damage"].max() > 0.0
    assert float(sim.wim.ice["broken"].mean()) > 0.05  # the waves broke floes
    assert sim.wim.shape == ((16, 40) if name == "coupled" else (11, 27))


def test_coupled_wim_on_mesh_matches_jax_f64(runs):
    got, _, jax_ref, _ = runs[0]["coupled"], runs[1], runs[2], runs[3]
    for f in FIELDS:
        _close(jax_ref[f], got[f], f)
    _close(jax_ref["dfloe"], got["__wim_dfloe"], "dfloe")
