"""The batched ensemble on a member mesh, on the CPU: ``BatchedEnsemble(mesh=
(P,) | (P, dpy, dpx))`` in worlds of 4 ranks over gloo (rank functions in
tests/torch_mesh_worker.py); the counterparts of tests/test_extensions.py's
``test_member_sharded_ensemble_matches_batched``,
``test_member_and_domain_sharded_ensemble`` and
``test_batched_checkpoint_crosses_member_topology``, at their sizes.

* ``(4,)``: a member a rank; ``(2, 1, 2)``: two groups of 1 x 2 blocks, two
  members each; ``tpu.mesh_shape=2x2`` alone: ``(1, 2, 2)``. Every member
  equals the unsharded port ensemble's BITWISE (the JAX tests allow 2e-5:
  their sharded program fuses otherwise); so do the ensemble mean and the
  spread, and the AR(1) carry and generators gathered from the groups.
  Every layout runs the batched step (``Simulator.batched_step_fn``) once a
  step, the block layouts with every member's strips in one ring, and
  never the member loop.
* A checkpoint written under ``(4,)`` restores into the unsharded ensemble,
  and one written unsharded into ``(4,)``: the states equal, and one more
  step stays equal, bitwise. The checkpoint is one npz of global planes.
* The statistics moorings record of a ``(4,)`` ensemble equals the unsharded
  one's.
* What a member mesh refuses (ValueError): a shape of another form, P not
  dividing the members, a world of another size (naming torchrun), a grid
  the blocks do not divide, and a ``tpu.mesh_shape`` that disagrees.
"""

import glob

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import torch_mesh_worker as worker
from nextsim_tpu_torch import Config
from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble
from nextsim_tpu_torch.parallel import multihost
from nextsim_tpu_torch.parallel.distributed import run_world

torch.set_num_threads(1)  # the ranks and the workers share the cores

WORLD_TIMEOUT = 240.0
SEED = 5  # torch_mesh_worker.ensemble_cases' seed

# tests/test_extensions.py's member-mesh configuration
BASE = {
    "grid.preset": "square", "grid.nx": 24, "grid.ny": 24, "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00", "simul.duration": 1.0,
    "dynamics.substeps": 30, "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant", "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 10.0, "simul.spinup_duration": 0.0, "tpu.donate_state": False,
}
# tests/test_torch_ensemble.py's statistics configuration
STATS = {
    "grid.preset": "square", "grid.nx": 16, "grid.ny": 16, "grid.resolution": 10e3,
    "simul.timestep": 450, "simul.time_init": "2015-10-16 00:00:00",
    "setup.dynamics-type": "free_drift", "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant", "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 8.0, "simul.spinup_duration": 0.0, "output.async_io": False,
    "moorings.use_moorings": True, "moorings.output_timestep": 2,
    "moorings.output_time_step_units": "time_steps", "moorings.variables": ["conc", "thick", "velocity"],
}
N = 4
STEPS = 3
LAYOUTS = {"m4": (4,), "m212": (2, 1, 2), "cfg22": None}


def _ens(over, n=N, seed=SEED, mesh=None):
    return BatchedEnsemble(Config(overrides=over), n, device="cpu", seed=seed, mesh=mesh)


def _arrays(ens, n):
    out = {}
    for m in range(n):
        st = ens.member_state(m)
        out.update({f"{m}_{k}": getattr(st, k).numpy().copy() for k in st.__dataclass_fields__
                    if getattr(st, k) is not None})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded reference (4 steps, its checkpoint "u" after 3), then
    one world of 4 ranks for every member-mesh case."""
    root = tmp_path_factory.mktemp("ensemble")
    out = root / "out"
    out.mkdir()
    base = dict(BASE, **{"output.exporter_path": str(root / "run")})
    ref = _ens(base)
    ref.run(STEPS)
    at3 = dict(_arrays(ref, N), **{f"noise_{k}": v for k, v in ref._noise_arrays().items()},
               mean_conc=ref.mean_state().conc.numpy(), spread=ref.spread())
    ref.write_restart("u")
    ref.step()
    at4 = _arrays(ref, N)
    stats = dict(STATS, **{"output.exporter_path": str(root / "stats1")})
    ens_s = _ens(stats)
    ens_s.run(2)
    cases = [("m4", base, N, (4,), STEPS, None, "m4"), ("m212", base, N, (2, 1, 2), STEPS, None, None),
             ("cfg22", dict(base, **{"tpu.mesh_shape": "2x2"}), 2, None, STEPS, None, None),
             ("from_u", base, N, (4,), 1, "u", None),
             ("stats", dict(STATS, **{"output.exporter_path": str(root / "stats4")}), N, (4,), 2, None, None)]
    run_world(worker.ensemble_cases, 4, args=(cases, str(out)), device="cpu", timeout=WORLD_TIMEOUT)
    got = {}
    for name, *_ in cases:
        with np.load(out / f"{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return got, at3, at4, base, root


def _assert_members_equal(got, ref, n):
    for m in range(n):
        keys = [k for k in ref if k.startswith(f"{m}_")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_member_mesh_equals_unsharded(name, runs):
    got, at3 = runs[0][name], runs[1]
    n = 2 if name == "cfg22" else N
    _assert_members_equal(got, at3, n)
    assert int(got["__pcpt"]) == STEPS
    if n == N:
        np.testing.assert_array_equal(got["mean_conc"], at3["mean_conc"])
        assert float(got["spread_vt_u"]) == at3["spread"]["vt_u"] > 0.0
        for k in ("noise_ran", "noise_generators"):
            np.testing.assert_array_equal(got[k], at3[k], err_msg=k)
    assert not np.array_equal(got["1_vt_u"], got["0_vt_u"])  # the perturbed member moved otherwise


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_member_mesh_runs_the_batched_step(name, runs):
    got = runs[0][name]
    assert int(got["__batched_calls"]) == STEPS and int(got["__loop_calls"]) == 0


def test_checkpoint_from_member_mesh_into_unsharded(runs):
    """(4,) -> unsharded: equal states at the checkpoint, and after one
    more step."""
    at3, at4, base = runs[1], runs[2], runs[3]
    back = _ens(base, seed=77)
    back.read_restart("m4")
    assert back.pcpt == STEPS
    _assert_members_equal(_arrays(back, N), at3, N)
    np.testing.assert_array_equal(back._noise_arrays()["generators"], at3["noise_generators"])
    back.step()
    _assert_members_equal(_arrays(back, N), at4, N)


def test_checkpoint_from_unsharded_into_member_mesh(runs):
    """unsharded -> (4,): the mesh ensemble read the unsharded checkpoint of
    step 3 and stepped once: equal to the unsharded step 4."""
    got, at4 = runs[0]["from_u"], runs[2]
    assert int(got["__pcpt"]) == STEPS + 1
    _assert_members_equal(got, at4, N)


def test_statistics_record_of_member_mesh(runs):
    root = runs[4]
    (one,), (four,) = (glob.glob(str(root / d / "Moorings*.nc")) for d in ("stats1", "stats4"))
    with netcdf_file(one, "r", mmap=False) as a, netcdf_file(four, "r", mmap=False) as b:
        assert {"sic_mean", "sic_std", "siu_mean", "siu_std"} <= set(b.variables)
        for k in a.variables:
            np.testing.assert_array_equal(np.array(b.variables[k][:]), np.array(a.variables[k][:]), err_msg=k)
        assert np.nanmax(np.array(b.variables["siu_std"][:])) > 0.0


@pytest.mark.parametrize("over,n,mesh,world,match", [
    ({}, 4, (2, 2), 4, r"must be \(P,\) or \(P, dpy, dpx\)"),
    ({}, 4, (3,), 3, "must divide n_members=4"),
    ({}, 4, (4,), 1, "torchrun --nproc-per-node 4"),
    ({"grid.nx": 25}, 4, (1, 2, 2), 4, "does not divide"),
    ({"tpu.mesh_shape": "2x2"}, 4, (4,), 4, "disagrees with tpu.mesh_shape=2x2"),
], ids=["shape", "members", "world", "grid", "config"])
def test_member_mesh_refuses(over, n, mesh, world, match, monkeypatch, tmp_path):
    """The member mesh's checks, in a world of ``world`` ranks as the ranks
    see it."""
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    with pytest.raises(ValueError, match=match):
        _ens(dict(BASE, **over, **{"output.exporter_path": str(tmp_path)}), n=n, mesh=mesh)
