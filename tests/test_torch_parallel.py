"""Multi-device runs of the port on the CPU: one torch.distributed rank per
block, over gloo, in spawned worlds of 4 ranks (tests/torch_mesh_worker.py
holds the rank functions).

* The block layout (parallel/seam.py) against the JAX package's
  ``seam.to_ext_*``/``from_ext_*``: the port's ext blocks are the JAX
  package's where the layouts coincide (blocks with a neighbour on every
  side) and the JAX blocks cut at the domain's edge elsewhere; both put a
  global plane back together exactly.
* The ring exchanges over gloo: the generic halo exchange against a global
  stencil, and ``Seam.ring`` restoring poisoned rings, on 2x2, 1x4 and 4x1.
* A sharded run equals the single-device port run BITWISE: meshes 2x2, 1x4
  and 4x1, ``tpu.halo_depth`` 1 and 3, bbm, evp and mevp, float32 and
  float64, thermo on, 2 steps from a restart whose ice is patchy (ice edges
  cross the blocks' seams); and one case on the dataset path
  (test_torch_simulator.write_dataset_dir's ERA5 + TOPAZ4 + ETOPO files).
* The port's 2x2 run against the JAX package's single-device run in float64
  after 3 steps of 60 substeps: every field within 1e-9 of its magnitude.
* The mesh's own errors: sizes that do not divide, a halo depth the blocks
  or the substeps cannot take. (Gradients through the exchanges:
  tests/test_torch_parallel_grad.py.)

Every world joins its process group with a timeout and is joined with one,
so a deadlock fails in seconds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu.output.restart import write_restart as jwrite_restart
from nextsim_tpu.parallel import seam as jseam
from nextsim_tpu_torch import Config, Simulator, state_to_numpy
from nextsim_tpu_torch.output.restart import write_restart
from nextsim_tpu_torch.parallel import multihost, seam
from nextsim_tpu_torch.parallel.distributed import run_world
from test_torch_momentum import jax_to_numpy
from test_torch_simulator import DATASET_SLICE, SLICES, write_dataset_dir

torch.set_num_threads(1)  # the ranks and the workers share the cores

WORLD_TIMEOUT = 240.0

# test_torch_simulator's 32^2 arctic slice with thermo on, a stronger and
# turning wind, 30 substeps (divisible by every halo depth tried)
MESH_SLICE = dict(SLICES["arctic32_thermo"], **{
    "dynamics.substeps": 30, "ideal_simul.constant_wind_u": 20.0,
    "ideal_simul.constant_wind_v": -7.0,
})
MESHES = ("2x2", "1x4", "4x1")
STEP_CASES = [(m, h, d, t) for m in MESHES for h in (1, 3) for d in ("bbm", "evp", "mevp")
              for t in ("float32", "float64")]


def _case_name(mesh, halo_depth, dyn_type, dtype_name):
    return f"{mesh}_h{halo_depth}_{dyn_type}_{dtype_name}"


# ---------------------------------------------------------------------------
# the block layout against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("node", [False, True], ids=["cells", "nodes"])
def test_block_layout_matches_jax_seam_layout(node):
    dpy = dpx = 3
    By, Bx, W = 5, 6, 2
    ny, nx = dpy * By, dpx * Bx
    g = np.random.default_rng(1).normal(size=(ny + node, nx + node)).astype(np.float32)
    to_ext = seam.to_ext_nodes if node else seam.to_ext_cells
    from_ext = seam.from_ext_nodes if node else seam.from_ext_cells
    blocks = to_ext(g, dpy, dpx, W)
    jto = jseam.to_ext_nodes if node else jseam.to_ext_cells
    jfrom = jseam.from_ext_nodes if node else jseam.from_ext_cells
    jext = np.asarray(jto(jnp.asarray(g), dpy, dpx, By, Bx, W))
    hy, hx = By + 2 * W + node, Bx + 2 * W + node
    for r, blk in enumerate(blocks):
        a, b = divmod(r, dpx)
        lay = seam.BlockLayout(ny, nx, dpy, dpx, a, b, W)
        jblk = jext[a * hy:(a + 1) * hy, b * hx:(b + 1) * hx]
        # the JAX block starts W before the owned range, zero-filled beyond
        # the domain; the port's stops at the domain's edge
        (r0, r1, _), (c0, c1, _) = lay.rows, lay.cols
        cut = jblk[r0 - (a * By - W):r1 + node - (a * By - W), c0 - (b * Bx - W):c1 + node - (b * Bx - W)]
        np.testing.assert_array_equal(blk, cut)
        if 0 < a < dpy - 1 and 0 < b < dpx - 1:
            np.testing.assert_array_equal(blk, jblk)  # the layouts coincide
    back = from_ext(blocks, dpy, dpx, ny, nx, W)
    np.testing.assert_array_equal(back, g)
    np.testing.assert_array_equal(back, np.asarray(jfrom(jnp.asarray(jext), dpy, dpx, By, Bx, ny, nx, W)))


# ---------------------------------------------------------------------------
# ring exchanges over gloo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,dtype_name", [((2, 2), "float64"), ((1, 4), "float32"),
                                                   ((4, 1), "float64")])
def test_ring_exchanges_over_gloo(mesh_shape, dtype_name):
    """halo.exchange_halo against the global stencil, and Seam.ring
    restoring poisoned rings (W = 2) of cell, node and stacked planes."""
    ny, nx = 4 * mesh_shape[0] + 4, 5 * mesh_shape[1] + 3
    ny, nx = ny - ny % mesh_shape[0], nx - nx % mesh_shape[1]
    run_world(worker.ring_exchanges, 4, args=(mesh_shape, ny, nx, 2, dtype_name),
              device="cpu", timeout=WORLD_TIMEOUT)


# ---------------------------------------------------------------------------
# sharded = single device, bitwise
# ---------------------------------------------------------------------------

def _over(mesh, halo_depth, dyn_type, dtype_name, restart_dir):
    return dict(MESH_SLICE, **{
        "tpu.mesh_shape": mesh, "tpu.halo_depth": halo_depth, "setup.dynamics-type": dyn_type,
        "tpu.dtype": dtype_name, "restart.start_from_restart": True,
        "restart.input_path": str(restart_dir), "restart.basename": "patchy",
        "restart.type": "continue",
    })


def _patchy_restart(restart_dir):
    """One step of MESH_SLICE in float64, then 30% of the cells (a seeded
    draw) cleared of ice, written as restart_patchy.npz."""
    sim = Simulator(Config(overrides=dict(MESH_SLICE, **{
        "tpu.dtype": "float64", "restart.input_path": str(restart_dir)})), device="cpu")
    sim.step()
    bare = torch.rand(sim.state.conc.shape, generator=torch.Generator().manual_seed(3),
                      dtype=torch.float64) < 0.3
    clear = {f: torch.where(bare, 0.0, getattr(sim.state, f))
             for f in ("conc", "thick", "snow_thick", "conc_young", "h_young", "hs_young")}
    sim.state = sim.state.replace(**clear)
    write_restart(sim, name="patchy")


JAX_CASE = dict(SLICES["arctic32_thermo"], **{
    "dynamics.substeps": 60, "tpu.dtype": "float64", "ideal_simul.constant_wind_u": 20.0})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every sharded case, run in one world of 4 ranks: {name: gathered
    state (+ rank 0's exchange counters)}, and the JAX package's run."""
    root = tmp_path_factory.mktemp("mesh")
    rst, out, data = root / "restart", root / "out", root / "data"
    out.mkdir()
    _patchy_restart(rst)
    cases = [(_case_name(*c), _over(*c, rst), 2) for c in STEP_CASES]
    write_dataset_dir(data)
    cases.append(("dataset", dict(DATASET_SLICE, **{"tpu.mesh_shape": "2x2", "tpu.halo_depth": 2}), 2))
    # the JAX package's single-device run from its own initial state, which
    # the port's 2x2 run reads back from a restart
    with jax.enable_x64(True):
        jsim = JSimulator(JConfig(overrides=dict(JAX_CASE, **{"output.exporter_path": str(root)})))
        jwrite_restart(jsim, name="jax0")
        for _ in range(3):
            jsim.step()
        jax_ref = jax_to_numpy(jsim.state)
    cases.append(("jax", dict(JAX_CASE, **{
        "tpu.mesh_shape": "2x2", "tpu.halo_depth": 3, "restart.start_from_restart": True,
        "restart.input_path": str(root / "restart"), "restart.basename": "jax0",
        "restart.type": "continue"}), 3))
    run_world(worker.run_cases, 4, args=(cases, str(out), {"NEXTSIM_DATA_DIR": str(data)}),
              device="cpu", timeout=WORLD_TIMEOUT)
    runs = {}
    for name, over, steps in cases:
        with np.load(out / f"{name}.npz") as z:
            runs[name] = {k: z[k] for k in z.files}
    return runs, {name: (over, steps) for name, over, steps in cases}, jax_ref, data


def _single_device(over, steps):
    sim = Simulator(Config(overrides=dict(over, **{"tpu.mesh_shape": "1x1"})), device="cpu")
    for _ in range(steps):
        sim.step()
    return state_to_numpy(sim.state), sim


def _assert_bitwise(got, ref):
    assert set(ref) <= set(got)
    for f, v in ref.items():
        np.testing.assert_array_equal(got[f], v, err_msg=f)


@pytest.mark.parametrize("case", STEP_CASES, ids=[_case_name(*c) for c in STEP_CASES])
def test_sharded_step_equals_single_device(case, mesh_runs):
    runs, cases, _, _ = mesh_runs
    name = _case_name(*case)
    got = runs[name]
    ref, sim = _single_device(*cases[name])
    assert got["conc"].dtype == np.dtype(case[3])
    assert (ref["conc"] < 0.1).mean() > 0.1 and ref["damage"].max() > 0.0  # ice edges, damage
    _assert_bitwise(got, ref)
    # the exchanges of rank 0 (a corner block) in 2 steps: the carry every
    # H substeps, the velocity every H smoother sweeps, after momentum and
    # at the end of the step
    H, p = case[1], sim.dyn
    per_step = (p.substeps // H - 1) + -(-p.nit_ow // H) + 2
    assert int(got["__exchanges"]) == 2 * per_step
    # one message a neighbour and exchange: east and north of the corner
    assert int(got["__messages"]) == 2 * per_step * {"2x2": 2, "1x4": 1, "4x1": 1}[case[0]]


def test_sharded_dataset_step_equals_single_device(mesh_runs, monkeypatch):
    runs, cases, _, data = mesh_runs
    monkeypatch.setenv("NEXTSIM_DATA_DIR", str(data))
    ref, sim = _single_device(*cases["dataset"])
    assert float(sim.last_forcing.wind_u.std()) > 1.0  # the datasets reached the step
    _assert_bitwise(runs["dataset"], ref)


def test_sharded_run_matches_jax_single_device_f64(mesh_runs):
    """The port's 2x2 run against the JAX package's single-device run,
    float64, 3 steps of 60 substeps: within 1e-9 of each field's magnitude,
    or of 1 for a field below 1 (tests/test_parallel.py pins the JAX
    package's sharded run to its single-device run)."""
    runs, _, jax_ref, _ = mesh_runs
    got = runs["jax"]
    for f, ref in jax_ref.items():
        if f == "random_number":
            np.testing.assert_array_equal(got[f], ref)
            continue
        scale = max(float(np.abs(ref).max()), 1.0)
        err = float(np.abs(got[f] - ref).max())
        assert err <= 1e-9 * scale, (f, err, scale)


# ---------------------------------------------------------------------------
# what a mesh refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over,match", [
    ({"grid.nx": 31}, "does not divide"),
    ({"tpu.halo_depth": 10, "dynamics.substeps": 40}, "rings of 11 cells"),
    ({"tpu.halo_depth": 4}, "must divide dynamics.substeps=30"),
    ({"tpu.mesh_shape": "2by2"}, "DPYxDPX"),
], ids=["grid", "ring", "substeps", "shape"])
def test_mesh_refuses(over, match, monkeypatch):
    """make_seam's checks, in a world of 4 ranks as the ranks see it."""
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    cfg = {**MESH_SLICE, "grid.nx": 16, "grid.ny": 16, "tpu.mesh_shape": "2x2", **over}
    with pytest.raises(ValueError, match=match):
        Simulator(Config(overrides=cfg), device="cpu")


def test_block_layout_index_ranges():
    """Rings only where a neighbour is; seam nodes in both blocks."""
    lay = seam.BlockLayout(12, 12, 2, 3, 0, 1, 2)
    assert lay.rows == (0, 8, 0) and lay.cols == (2, 10, 2)
    assert lay.ext_shape(False) == (8, 8) and lay.ext_shape(True) == (9, 9)
    assert lay.global_own_index(True) == (slice(0, 7), slice(4, 9))
    right = lay.for_rank(2)
    assert right.cols == (6, 12, 2) and right.neighbours() == (None, 5, 1, None)
    assert dataclasses.replace(lay, a=1).global_own_index(True)[0] == slice(6, 13)
