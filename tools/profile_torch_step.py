"""Where a main-path step of the PyTorch port spends its time on one GPU.

    python3 tools/profile_torch_step.py

Runs chip_smoke.py's main-path configuration (arctic, BBM, 120 substeps,
float32) at 464^2 @ 10 km with thermodynamics off and on, and at 1216^2 @
5 km with thermodynamics on, then the dataset path: configs/arctic_10km.cfg
(608^2 @ 10 km, arctic_etopo) on chip_smoke.py's synthetic ERA5 + TOPAZ4 +
ETOPO files with thermo on. For each it prints ms/step over a 10-step
chunk, the host wall time of each phase of a step (each ended by a
synchronize; the first is the forcing provider's call), a torch.profiler
table over 3 steps (device busy time per step, kernel launches per step,
device time by kernel) and, with thermo on, the same profile of
``thermo_step`` alone: its device time and launches per call. Needs a CUDA
device and nvcc, like chip_smoke.py.
"""

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import BENCH, BENCH_THERMO, DATASET_ARGS, make_sim, write_forcing_data  # noqa: E402
from nextsim_tpu_torch import Config, Simulator  # noqa: E402
from nextsim_tpu_torch.model import checks  # noqa: E402
from nextsim_tpu_torch.ops import momentum, momentum_cuda, thermo, transport  # noqa: E402

LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def phases(sim, n=5):
    """Host wall time per phase of a step, each ended by a synchronize,
    averaged over ``n`` steps (which advance ``sim``)."""
    acc = {}
    for _ in range(n):
        t = time.perf_counter()

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            acc[name] = acc.get(name, 0.0) + (now - t) / n
            t = now

        state, forcing = sim.state, sim._next_forcing()
        mark("forcing (host, with its uploads)")
        tinfo = sim.time_info()
        ga = dict(sim.grid_arrays)
        if sim.use_thermo:
            state, _ = thermo.thermo_step(state, forcing, ga, sim.dt, sim.thermo_params, tinfo)
            mark("thermo_step")
        ga["cohesion"] = sim.c_fix + sim.c_alea * state.random_number
        consts, carry = momentum.substep_setup(state, forcing, ga, sim.dt, sim.dyn)
        mark("momentum setup")
        momentum_cuda.substep_loop(consts, carry, sim.dyn.substeps, sim.dt / sim.dyn.substeps,
                                   sim.dt, sim.grid.dx, sim.dyn.dynamics_type, sim.dyn)
        mark(f"substep loop ({sim.dyn.substeps} substeps, "
             f"{momentum_cuda.launches_for(sim.dyn.substeps, *sim.grid.shape)} launches)")
        state, _ = momentum.explicit_solve(state, forcing, ga, sim.dt, sim.dyn)
        mark("whole explicit_solve")
        state, _ = transport.transport_and_ridge(state, ga, sim.dt, sim.transport_params)
        mark("transport_and_ridge")
        checks.violations(state)
        mark("violations")
        sim.state = state
        sim.pcpt += 1
    return acc


def profile(fn, reps=3):
    """(device busy ms per call, launches per call, key_averages) of fn."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    ka = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ka) / reps / 1e3
    launches = sum(e.count for e in ka if e.key in LAUNCH_EVENTS) / reps
    return wall, busy, launches, ka


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    momentum_cuda.build()
    for size, dx, cfg in ((464, 10e3, BENCH), (464, 10e3, BENCH_THERMO), (1216, 5e3, BENCH_THERMO)):
        sim = make_sim(dict(cfg, **{"grid.nx": size, "grid.ny": size, "grid.resolution": dx}))
        report(f"{size}^2, thermo {'on' if sim.use_thermo else 'off'}", sim, smi)
    with tempfile.TemporaryDirectory(dir=ROOT / "nextsim_tpu_torch" / "build") as tmp:  # git-ignored
        write_forcing_data(Path(tmp))
        os.environ["NEXTSIM_DATA_DIR"] = tmp
        cfg = Config.from_files(str(ROOT / "configs" / "arctic_10km.cfg"),
                                overrides=dict(a.split("=") for a in DATASET_ARGS))
        t0 = time.perf_counter()
        sim = Simulator(cfg, device="cuda")
        print(f"\n(dataset Simulator init {time.perf_counter() - t0:.1f} s)")
        report("608^2 arctic_etopo on ERA5 + TOPAZ4 + ETOPO, thermo on", sim, smi)


def report(label, sim, smi):
    """ms/step, phases and profiles of ``sim`` (advances it)."""
    sim.step_chunk(2)  # warm-up (a dataset reader builds its weights here)
    torch.cuda.synchronize()
    f0 = sim.timer.elapsed("forcing")
    t0 = time.perf_counter()
    sim.step_chunk(10)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10
    forcing_ms = 1e3 * (sim.timer.elapsed("forcing") - f0) / 10
    print(f"\n=== {label}: {1e3 * wall:.2f} ms/step over 10 steps (step_chunk), of which "
          f"{forcing_ms:.2f} ms of forcing host time (timer 'forcing'); {smi}")
    for k, v in phases(sim).items():
        print(f"  phase {k:32s} {1e3 * v:8.2f} ms (host wall, synchronized)")
    pwall, busy, launches, ka = profile(lambda: sim.step_chunk(1))
    print(f"  profiled: {1e3 * pwall:.2f} ms/step wall, device busy {busy:.2f} ms/step "
          f"({100 * busy / (1e3 * wall):.1f}% of the unprofiled step), {launches:.0f} kernel launches/step")
    print(ka.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))
    if sim.use_thermo:
        forcing, tinfo = sim._next_forcing(), sim.time_info()
        twall, tbusy, tlaunches, tka = profile(lambda: thermo.thermo_step(
            sim.state, forcing, sim.grid_arrays, sim.dt, sim.thermo_params, tinfo))
        print(f"  thermo_step alone: {1e3 * twall:.2f} ms wall (profiled), device busy {tbusy:.3f} ms "
              f"({100 * tbusy / busy:.1f}% of the step's device time), {tlaunches:.0f} kernel launches")
        print(tka.table(sort_by="self_device_time_total", row_limit=8, max_name_column_width=60))


if __name__ == "__main__":
    main()
