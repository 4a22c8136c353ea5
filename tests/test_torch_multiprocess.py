"""Multi-process runs of the port's CLI (the counterpart of
tests/test_multiprocess.py).

The reference is an MPI program whose output paths gather to rank 0
(fe.cpp:2901-3557, 14111-14325). These tests start ``python -m
nextsim_tpu_torch --device cpu`` as 4 ranks of a 2x2 mesh over gloo on the
toy configuration with moorings (running means), drifters, snapshots and a
final restart, through the JAX package's variables (JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID) and through torchrun, and pin that

* every rank ends with 0 and only rank 0 writes the run's files;
* every file (restart npz, moorings NetCDF, drifter trajectories,
  snapshots) is BITWISE equal to the same run's on one process;
* the 4-rank restart resumes in a single-process Simulator;
* ``moorings.parallel_output`` writes one y-slab patch a rank, and the
  merged patches equal the one-process moorings file bitwise.

Every process is joined with a timeout; a rank that hangs fails the test.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import netcdf_file

from nextsim_tpu_torch import Config, Simulator
from nextsim_tpu_torch.output.moorings import merge_parallel_moorings
from nextsim_tpu_torch.parallel.distributed import free_port

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 300

OVERRIDES = [
    "grid.nx=64",
    "grid.ny=64",
    "simul.duration=0.0625",  # 18 steps of 300 s
    "moorings.output_timestep=0.020833333333333332",  # every 6 steps
    "moorings.snapshot=false",  # running means exercise the gather
    "output.output_per_day=48",  # snapshot every 6 steps
    "restart.write_final_restart=true",
    "drifters.use_equally_spaced_drifters=true",
    "drifters.equally_spaced_drifters_output_time_step=0.006944444444444444",
    "output.datetime_in_filename=false",
]
MESH = ["tpu.mesh_shape=2x2", "tpu.halo_depth=2"]


def _cli(outdir, extra=()):
    return [sys.executable, "-m", "nextsim_tpu_torch", "--device", "cpu",
            "--config-files", str(REPO / "configs" / "toy.cfg"),
            f"output.exporter_path={outdir}", *OVERRIDES, *extra]


def _env(**kw):
    env = dict(os.environ, OMP_NUM_THREADS="1", **kw)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        if name not in kw:
            env.pop(name, None)
    return env


def _wait(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out[-4000:]}"


def _run(cmd, env):
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def run_ranks(outdir, extra=()):
    """4 ranks of the CLI through the JAX package's variables."""
    port = free_port()
    _wait([_run(_cli(outdir, [*MESH, *extra]),
                _env(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES="4",
                     JAX_PROCESS_ID=str(r)))
           for r in range(4)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(1 process, 4 ranks, 4 ranks under torchrun with parallel moorings)
    output directories, the three runs started together."""
    root = tmp_path_factory.mktemp("cli")
    d1, d4, dp = root / "p1", root / "p4", root / "par"
    port = free_port()
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                "--nproc-per-node", "4", "--master-addr", "localhost", "--master-port", str(port),
                *_cli(dp, [*MESH, "moorings.parallel_output=true"])[1:]]
    procs = [_run(_cli(d1), _env()), _run(torchrun, _env())]
    run_ranks(d4)
    _wait(procs)
    return d1, d4, dp


SCALAR_FILES = ("restart/restart_final.npz", "Moorings_20151016.nc", "field_final.npz",
                "field_12.npz", "Drifters_equally_spaced.nc", "nextsim_tpu.log")


def test_rank_0_writes_every_file_once(runs):
    _, d4, _ = runs
    for sub in SCALAR_FILES:
        assert (d4 / sub).exists(), sub
    assert sorted(p.name for p in d4.glob("Moorings_*")) == ["Moorings_20151016.nc"]


@pytest.mark.parametrize("name", ["restart/restart_final.npz", "field_final.npz", "field_6.npz"])
def test_four_rank_npz_equals_one_process(runs, name):
    d1, d4, _ = runs
    with np.load(d4 / name) as a, np.load(d1 / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == "__meta__":
                assert str(a[k]) == str(b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["Moorings_20151016.nc", "Drifters_equally_spaced.nc"])
def test_four_rank_netcdf_equals_one_process(runs, name):
    d1, d4, _ = runs
    with netcdf_file(str(d4 / name), "r", mmap=False) as a, \
            netcdf_file(str(d1 / name), "r", mmap=False) as b:
        assert set(a.variables) == set(b.variables)
        assert a.variables["time"][:].size >= 3
        for k in b.variables:
            np.testing.assert_array_equal(a.variables[k][:], b.variables[k][:], err_msg=k)


def test_four_rank_restart_resumes_in_one_process(runs):
    _, d4, _ = runs
    over = dict(o.split("=", 1) for o in OVERRIDES + [
        f"output.exporter_path={d4}", "restart.start_from_restart=true",
        "restart.basename=final", "restart.type=extend",
        "drifters.use_equally_spaced_drifters=false"])
    sim = Simulator(Config.from_files(str(REPO / "configs" / "toy.cfg"), overrides=over), device="cpu")
    with np.load(d4 / "restart" / "restart_final.npz") as a:
        np.testing.assert_array_equal(sim.host_state().conc, a["conc"])
        np.testing.assert_array_equal(sim.host_state().damage, a["damage"])
    sim.step()
    assert np.isfinite(sim.host_state().vt_u).all()


def test_parallel_moorings_patches_merge(runs, tmp_path):
    """moorings.parallel_output: a y-slab patch a rank, merged bitwise equal
    to the one-process file (and the rest of the run's files as before)."""
    d1, _, dp = runs
    patches = sorted(str(p) for p in dp.glob("Moorings_20151016_p*.nc"))
    assert len(patches) == 4, list(dp.iterdir())
    assert not (dp / "Moorings_20151016.nc").exists()
    merged = str(tmp_path / "merged.nc")
    merge_parallel_moorings(patches, merged)
    with netcdf_file(merged, "r", mmap=False) as a, \
            netcdf_file(str(d1 / "Moorings_20151016.nc"), "r", mmap=False) as b:
        for k in b.variables:
            np.testing.assert_array_equal(a.variables[k][:], b.variables[k][:], err_msg=k)
    with np.load(dp / "restart" / "restart_final.npz") as a, \
            np.load(d1 / "restart" / "restart_final.npz") as b:
        np.testing.assert_array_equal(a["vt_u"], b["vt_u"])
