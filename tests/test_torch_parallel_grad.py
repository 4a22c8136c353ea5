"""Gradients through a device mesh, on the CPU: ``seam.RingExchange`` (the
ring exchange as an autograd Function) and reverse mode through
``Simulator.raw_step_fn`` and ``Wim._run_scan`` on 2x2 meshes of 4 ranks over
gloo (rank functions in tests/torch_mesh_worker.py).

* ``RingExchange`` passes ``torch.autograd.gradcheck`` in float64 on a
  (2, 1) mesh, for a cell, a node and three stacked planes: a global
  function that cuts the global planes to the ext blocks, exchanges their
  rings and adds every block back into a global plane.
* ``raw_step_fn`` on a mesh exchanges: one call, gathered, equals the
  single-device ``raw_step_fn`` BITWISE and a mesh ``step()`` (BBM, thermo
  on, ``tpu.halo_depth=6``, float64; without its exchanger the mesh call
  stepped each block as if it were the whole grid).
* d(mean KE after one step)/d(wind_u) through ``raw_step_fn`` on a 48^2
  2x2 mesh, H = 6, bbm and evp, float64, from the JAX package's state after
  one step (a moving ice pack: at rest EVP's strain invariant is exactly
  zero and its ``sqrt`` has no useful derivative; measured 1.0e-8 against
  JAX from the moving state): each rank's loss counts its own nodes (a seam
  node once) and
  ``Seam.fold`` adds the ranks' block gradients; within 1e-12 of the
  single-device port's gradient (max norm, NaN where it is NaN) and within
  tests/test_torch_grad.py's 1e-6 of ``jax.grad`` of the JAX package's
  ``raw_step_fn``.
* d(mean Hs + 1e3 mean tau_x)/d(ice volume) through ``Wim._run_scan`` on
  the blocks of the 16 x 64 WIM strip, ideal fields with an ice-free patch
  and a dead-calm band that vary along y: within 1e-12 of the single
  device.
* ``Seam.fold`` is the adjoint of ``to_ext``: the gradient through
  ``to_ext`` summed over the ranks.
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
from nextsim_tpu_torch import Config, Simulator, state_to_numpy
from nextsim_tpu_torch.parallel import seam
from nextsim_tpu_torch.parallel.distributed import run_world
from nextsim_tpu_torch.wim import wim as pw
from test_torch_grad import RTOL_F64, assert_grad_close
from test_torch_simulator import SLICES

torch.set_num_threads(1)  # the ranks and the workers share the cores

WORLD_TIMEOUT = 240.0
RTOL_MESH = 1e-12

# tests/test_grad.py's configuration at 48^2, float64
GRAD48 = {
    "grid.preset": "square", "grid.nx": 48, "grid.ny": 48, "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00", "dynamics.substeps": 30,
    "thermo.use_thermo_forcing": False, "setup.ice-type": "constant",
    "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 8.0, "simul.spinup_duration": 0.0, "tpu.donate_state": False,
    "tpu.dtype": "float64",
}
DYN_TYPES = ("bbm", "evp")
# the step-0 case: test_torch_simulator's 32^2 arctic slice, thermo on
RAW = dict(SLICES["arctic32_thermo"], **{"dynamics.substeps": 30, "tpu.dtype": "float64",
                                         "ideal_simul.constant_wind_u": 20.0, "tpu.mesh_shape": "2x2",
                                         "tpu.halo_depth": 6, "setup.dynamics-type": "bbm"})
WIM_KW = dict(nwavefreq=5, nwavedirn=8, steady=False)
WIM_STEPS = 6


@pytest.mark.parametrize("kinds", [("cell",), ("node",), ("cell", "node", "stack")],
                         ids=["cell", "node", "stacked"])
def test_ring_exchange_gradcheck(kinds):
    run_world(worker.ring_gradcheck, 2, args=(8, 5, 2, kinds), device="cpu", timeout=WORLD_TIMEOUT)


def _restart_over(root, dyn_type):
    return dict(GRAD48, **{"setup.dynamics-type": dyn_type, "restart.start_from_restart": True,
                           "restart.input_path": str(root / dyn_type / "restart"), "restart.basename": "jax1",
                           "restart.type": "continue", "output.exporter_path": str(root / dyn_type)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's gradients (and its states after one step, written as restarts), then
    one world of 4 ranks for the mesh gradients, the step-0 case and the
    WIM gradient."""
    root = tmp_path_factory.mktemp("grad")
    out = root / "out"
    out.mkdir()
    jax_grads = {}
    for dyn in DYN_TYPES:
        with jax.enable_x64(True):
            jsim = JSimulator(JConfig(overrides=dict(GRAD48, **{"setup.dynamics-type": dyn,
                                                               "output.exporter_path": str(root / dyn)})))
            jsim.step()
            jwrite_restart(jsim, name="jax1")
            jf = jsim.forcing_provider(jsim.current_time, jsim.time_init)
            jti = jsim.time_info()

            def loss(wind_u, jsim=jsim, jf=jf, jti=jti):
                s2, _, _ = jsim.raw_step_fn(jsim.state, jf.replace(wind_u=wind_u), jti)
                return jnp.mean(s2.vt_u ** 2 + s2.vt_v ** 2)

            jax_grads[dyn] = np.asarray(jax.jit(jax.grad(loss))(jf.wind_u))
    grad_cases = [(dyn, dict(_restart_over(root, dyn), **{"tpu.mesh_shape": "2x2", "tpu.halo_depth": 6}))
                  for dyn in DYN_TYPES]
    raw_cases = [("raw", dict(RAW, **{"output.exporter_path": str(root / "raw")}))]
    wim_args = (worker.StripGrid(), WIM_KW, worker.poked_setup, WIM_STEPS)
    run_world(worker.gradient_world, 4, args=(grad_cases, raw_cases, wim_args, str(out)), device="cpu",
              timeout=WORLD_TIMEOUT)
    got = {}
    for name in list(DYN_TYPES) + ["raw", "wim_grad"]:
        with np.load(out / f"{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return got, jax_grads, root


def _rel_max(got, ref):
    ok = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    return float(np.abs(got - ref)[ok].max() / np.abs(ref[ok]).max())


@pytest.mark.parametrize("dyn_type", DYN_TYPES)
def test_mesh_gradient_equals_single_device(dyn_type, runs):
    got = runs[0][dyn_type]["grad"]
    sim = Simulator(Config(overrides=_restart_over(runs[2], dyn_type)), device="cpu")
    ref = worker.ke_gradient(sim).numpy()
    assert np.abs(ref[np.isfinite(ref)]).max() > 0.0
    assert _rel_max(got, ref) <= RTOL_MESH


@pytest.mark.parametrize("dyn_type", DYN_TYPES)
def test_mesh_gradient_matches_jax_f64(dyn_type, runs):
    assert_grad_close(runs[1][dyn_type], runs[0][dyn_type]["grad"], RTOL_F64, f"{dyn_type} d KE / d wind_u")
    assert np.abs(runs[1][dyn_type]).max() > 0.0


def test_raw_step_fn_on_mesh_exchanges(runs):
    """The repair: raw_step_fn on a mesh is the step step() takes, and it
    equals the single-device raw_step_fn bitwise."""
    got = runs[0]["raw"]
    sim = Simulator(Config(overrides=dict(RAW, **{"tpu.mesh_shape": "1x1",
                                                  "output.exporter_path": str(runs[2] / "raw1")})), device="cpu")
    state, _, viol = sim.raw_step_fn(sim.state, sim._next_forcing(), sim.time_info())
    ref = state_to_numpy(state)
    assert ref["damage"].max() > 0.0 and not viol.numpy().any() and not got["__viol"].any()
    for f, v in ref.items():
        np.testing.assert_array_equal(got[f"raw_{f}"], v, err_msg=f)
        np.testing.assert_array_equal(got[f"step_{f}"], v, err_msg=f)


def test_wim_gradient_on_mesh_equals_single_device(runs):
    got = runs[0]["wim_grad"]["grad"]
    w = pw.Wim(pw.WimParams(**WIM_KW), worker.StripGrid(), torch.float64, device="cpu")
    worker.poked_setup(w)
    ref = worker.wim_loss_gradient(w, WIM_STEPS).numpy()
    assert np.abs(ref).max() > 0.0 and (ref != 0.0).mean() > 0.1
    assert _rel_max(got, ref) <= RTOL_MESH


def test_fold_is_the_adjoint_of_to_ext():
    """``Seam.fold`` of every rank's block of a gradient equals the sum
    over the ranks of the gradient through ``to_ext`` (here the ranks are
    four layouts in one process, and the group's sum a Python sum)."""
    ny, nx = 12, 10
    gen = torch.Generator().manual_seed(1)
    for node, periodic in ((False, (False, False)), (True, (False, False)), (False, (True, True))):
        shape = (ny + node, nx + node)
        x = torch.randn(shape, dtype=torch.float64, generator=gen, requires_grad=True)
        total, folded = torch.zeros(shape, dtype=torch.float64), torch.zeros(shape, dtype=torch.float64)
        for r in range(4):
            lay = seam.BlockLayout(ny, nx, 2, 2, *divmod(r, 2), 3, periodic)
            blk = lay.to_ext(x)
            w = torch.randn(blk.shape, dtype=torch.float64, generator=gen)
            (g,) = torch.autograd.grad((blk * w).sum(), x)
            total += g
            ex = seam.Seam(lay, 1)
            ex._all_reduce = lambda t, op: t  # one rank's share
            folded += ex.fold(w)
        torch.testing.assert_close(folded, total, rtol=1e-15, atol=0)
