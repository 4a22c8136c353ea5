"""Where a main-path step of the PyTorch port spends its time on one GPU.

    python3 tools/profile_torch_step.py

Runs chip_smoke.py's main-path configuration (arctic, BBM, 120 substeps,
float32) at 464^2 @ 10 km and 1216^2 @ 5 km. For each it prints ms/step
over a 10-step chunk, the host wall time of each phase of a step (each
ended by a synchronize), and a torch.profiler table over 3 steps: device
busy time per step, kernel launches per step, and device time by kernel.
Needs a CUDA device and nvcc, like chip_smoke.py.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import BENCH, make_sim  # noqa: E402
from nextsim_tpu_torch.model import checks  # noqa: E402
from nextsim_tpu_torch.ops import momentum, momentum_cuda, transport  # noqa: E402

LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def phases(sim, n=5):
    """Host wall time per phase of a step, each ended by a synchronize,
    averaged over ``n`` steps (which advance ``sim``)."""
    acc = {}
    for _ in range(n):
        state, forcing = sim.state, sim._next_forcing()
        ga = dict(sim.grid_arrays)
        t = time.perf_counter()

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            acc[name] = acc.get(name, 0.0) + (now - t) / n
            t = now

        ga["cohesion"] = sim.c_fix + sim.c_alea * state.random_number
        consts, carry = momentum.substep_setup(state, forcing, ga, sim.dt, sim.dyn)
        mark("momentum setup")
        momentum_cuda.substep_loop(consts, carry, sim.dyn.substeps, sim.dt / sim.dyn.substeps,
                                   sim.dt, sim.grid.dx, sim.dyn.dynamics_type, sim.dyn)
        mark(f"substep loop ({sim.dyn.substeps} substeps)")
        state, _ = momentum.explicit_solve(state, forcing, ga, sim.dt, sim.dyn)
        mark("whole explicit_solve")
        state, _ = transport.transport_and_ridge(state, ga, sim.dt, sim.transport_params)
        mark("transport_and_ridge")
        checks.violations(state)
        mark("violations")
        sim.state = state
    return acc


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    momentum_cuda.build()
    for size, dx in ((464, 10e3), (1216, 5e3)):
        sim = make_sim(dict(BENCH, **{"grid.nx": size, "grid.ny": size, "grid.resolution": dx}))
        sim.step_chunk(2)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step_chunk(10)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10
        print(f"\n=== {size}^2: {1e3 * wall:.2f} ms/step over 10 steps (step_chunk); {smi}")
        for k, v in phases(sim).items():
            print(f"  phase {k:32s} {1e3 * v:8.2f} ms (host wall, synchronized)")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sim.step_chunk(3)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) / 3
        ka = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ka) / 3 / 1e3
        launches = sum(e.count for e in ka if e.key in LAUNCH_EVENTS) / 3
        print(f"  profiled: {1e3 * pwall:.2f} ms/step wall, device busy {busy:.2f} ms/step "
              f"({100 * busy / (1e3 * pwall):.1f}%), {launches:.0f} kernel launches/step")
        print(ka.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))


if __name__ == "__main__":
    main()
