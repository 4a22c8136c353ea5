#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nextsim_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them. Phases, each
printing a line; any failure raises and ends the run with a non-zero exit:

1. the card's name and power limit (nvidia-smi);
2. build the momentum substep kernel (csrc/momentum_substep.cu) with nvcc;
3. the kernel against its plain PyTorch version on the card: bbm, evp and
   mevp, float32 and float64, on a 33x33 square and on a 464^2 arctic state
   spun up until damage is active; 3 substeps held tightly, 120 substeps
   statistically in float32 and tightly in float64;
4. the golden toy run (48^2, 15 steps) against tests/golden_toy_fields.npz;
5. the main path: the 464^2 10 km arctic configuration of bench.py through
   ``Simulator(cfg, device="cuda").step_chunk()`` for 30 steps; all fields
   finite, zero violations, and every substep launched through the kernel;
6. one 120-substep loop at 464^2 in float32, kernel beside plain;
7. 3 steps at 1216^2 and 5 km (1.48M cells), finite with zero violations.

The line before the last is the JSON record of the kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# tests/test_golden.py: per-field (absolute tolerance, max outlier fraction)
FIELD_TOLS = {
    "conc": (5e-3, 0.002),
    "thick": (5e-3, 0.002),
    "damage": (0.02, 0.005),
    "vt_u": (2e-3, 0.002),
    "vt_v": (2e-3, 0.002),
    "sigma": (500.0, 0.005),  # Pa; |sigma| reaches ~3e4 in this run
}

# tests/test_golden.py's 15-step toy configuration
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
}

# bench.py's main-path configuration: pan-Arctic 464^2 at 10 km, BBM
BENCH = {
    "grid.preset": "arctic",
    "grid.nx": 464,
    "grid.ny": 464,
    "grid.resolution": 10e3,
    "simul.timestep": 200,
    "simul.time_init": "2015-10-16 00:00:00",
    "dynamics.substeps": 120,
    "dynamics.alea_factor": 0.33,
    "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant",
    "setup.atmosphere-type": "constant",
    "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 10.0,
    "ideal_simul.constant_wind_v": -3.0,
    "dynamics.use_coriolis": True,
    "tpu.steps_per_call": 30,
}

STATE_PLANES = ("vt_u", "vt_v", "ut_u", "ut_v", "sxx", "syy", "sxy", "damage")
# tight tier: |kernel - plain| <= atol_rel * max|plain| + rtol * |plain|
TIGHT = {"float32": (1e-6, 1e-5), "float64": (1e-12, 1e-10)}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


def setup_for(sim, dyn_type: str, state=None):
    """(consts, carry, dyn params) of one dynamics step of ``sim``."""
    import dataclasses

    from nextsim_tpu_torch.ops import momentum

    state = sim.state if state is None else state
    p = dataclasses.replace(sim.dyn, dynamics_type=dyn_type)
    ga = dict(sim.grid_arrays)
    ga["cohesion"] = sim.c_fix + sim.c_alea * state.random_number
    forcing = sim.forcing_provider(sim.current_time + sim.dt / 86400.0, sim.time_init)
    consts, carry = momentum.substep_setup(state, forcing, ga, sim.dt, p)
    return consts, carry, p


def run_loop(fn, consts, carry, steps, sim, p):
    return fn(consts, carry, steps, sim.dt / p.substeps, sim.dt, sim.grid.dx,
              p.dynamics_type, p)


def compare(label, sim, dyn_type, steps, dtype_name, state=None):
    """Kernel against plain over ``steps`` substeps; returns the max abs
    velocity error. Raises when a tolerance is exceeded."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda

    consts, carry, p = setup_for(sim, dyn_type, state)
    ref = run_loop(momentum_cuda.substep_loop_reference, consts, carry, steps, sim, p)
    out = run_loop(momentum_cuda.substep_loop, consts, carry, steps, sim, p)
    sync()
    atol_rel, rtol = TIGHT[dtype_name]
    statistical = dtype_name == "float32" and steps > 3
    worst = 0.0
    n_off = 0
    for name, r, o in zip(STATE_PLANES, ref, out):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{label}: kernel {name} is not finite")
        diff = (o - r).abs()
        off = diff > atol_rel * float(r.abs().max()) + rtol * r.abs()
        n_off += int(off.sum())
        if name.startswith("vt"):
            worst = max(worst, float(diff.max()))
        if statistical:
            continue
        if bool(off.any()):
            raise AssertionError(
                f"{label}: {name} differs beyond the tight tolerance in "
                f"{int(off.sum())} points, max |diff| {float(diff.max()):.3e}"
            )
    if statistical:
        # after failure onset one-ulp differences may flip the BBM failure
        # branch of a cell: hold the means instead
        u_r = torch.hypot(ref[0], ref[1]).mean()
        u_o = torch.hypot(out[0], out[1]).mean()
        if abs(float(u_o - u_r)) > 1e-3 * float(u_r) + 1e-12:
            raise AssertionError(f"{label}: mean speed {float(u_o)} vs plain {float(u_r)}")
        if abs(float(out[7].mean() - ref[7].mean())) > 1e-3:
            raise AssertionError(f"{label}: mean damage {float(out[7].mean())} vs {float(ref[7].mean())}")
    phase("compare", f"{label}: max |dvel| {worst:.3e} m/s, points beyond the tight "
          f"tolerance {n_off} ({'statistical tier: mean speed rtol 1e-3, mean damage atol 1e-3' if statistical else 'tight tier'})")
    return worst


def make_sim(overrides, dtype_name="float32"):
    from nextsim_tpu_torch import Config, Simulator

    cfg = Config(overrides=dict(overrides, **{"tpu.dtype": dtype_name}))
    return Simulator(cfg, device="cuda")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from nextsim_tpu_torch import state_from_numpy, state_to_numpy
    from nextsim_tpu_torch.model import checks
    from nextsim_tpu_torch.ops import momentum_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("card", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    # 2. build
    t0 = time.perf_counter()
    lib = momentum_cuda.build()
    ptxas = [ln.strip() for ln in momentum_cuda.build_log.splitlines() if "registers" in ln]
    phase("build", f"{lib.name} in {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}")

    # 3. kernel vs plain
    small = dict(GOLDEN_TOY, **{"grid.preset": "square", "grid.nx": 33, "grid.ny": 33,
                                "setup.ice-type": "constant",
                                "ideal_simul.constant_wind_u": 10.0})
    spun = dict(BENCH, **{"simul.spinup_duration": 0.0, "ideal_simul.constant_wind_u": 20.0})
    sim_spin = make_sim(spun)
    sim_spin.step_chunk(3)
    frac = float((sim_spin.state.damage > 0).float().mean())
    phase("compare", f"464^2 arctic state after 3 steps at 20 m/s: damage > 0 in {frac:.3f} of cells, max {float(sim_spin.state.damage.max()):.3f}")
    if frac <= 0.0:
        raise AssertionError("the spun-up state has no damage")
    host_state = state_to_numpy(sim_spin.state)
    main_err = None
    for dtype_name in ("float32", "float64"):
        sim_small = make_sim(small, dtype_name)
        sim_big = make_sim(spun, dtype_name)
        big_state = state_from_numpy(host_state, device="cuda", dtype=sim_big.dtype)
        for dyn_type in ("bbm", "evp", "mevp"):
            for steps in (3, 120):
                compare(f"33^2 {dyn_type} {dtype_name} {steps} substeps", sim_small, dyn_type, steps, dtype_name)
                err = compare(f"464^2 {dyn_type} {dtype_name} {steps} substeps", sim_big, dyn_type, steps,
                              dtype_name, state=big_state)
                if (dtype_name, dyn_type, steps) == ("float32", "bbm", 120):
                    main_err = err

    # 4. golden toy run
    sim = make_sim(GOLDEN_TOY)
    rnd = np.load(ROOT / "tests" / "golden_toy_random_number.npy")
    sim.state = sim.state.replace(random_number=torch.as_tensor(rnd, device="cuda"))
    for _ in range(15):
        sim.step()
    with np.load(ROOT / "tests" / "golden_toy_fields.npz") as ref:
        for name, (atol, outlier_frac) in FIELD_TOLS.items():
            got = getattr(sim.state, name).cpu().numpy()
            diff = np.abs(got - ref[name])
            n_bad = int((diff > atol).sum())
            budget = max(1, int(outlier_frac * diff.size))
            if n_bad > budget:
                raise AssertionError(f"golden {name}: {n_bad} cells beyond {atol} (budget {budget})")
            phase("golden", f"{name}: {n_bad} cells beyond atol {atol} (budget {budget}), max |diff| {diff.max():.3e}")

    # 5. main path
    sim = make_sim(BENCH)
    sim.step()  # warm-up step outside the count and the timing
    sync()
    momentum_cuda.launches = 0
    t0 = time.perf_counter()
    sim.step_chunk()
    sync()
    wall = time.perf_counter() - t0
    launches = momentum_cuda.launches
    k = sim.cfg["tpu.steps_per_call"]
    substeps = sim.dyn.substeps
    for f in ("conc", "thick", "damage", "sigma", "vt_u", "vt_v", "ut_u", "ut_v"):
        if not bool(torch.isfinite(getattr(sim.state, f)).all()):
            raise AssertionError(f"main path: {f} is not finite")
    viol = checks.violations(sim.state).cpu().numpy()
    if viol.any():
        raise AssertionError(f"main path: violations {checks.describe(viol)}")
    if launches != 2 * substeps * k:
        raise AssertionError(f"main path: {launches} kernel launches, expected {2 * substeps * k}")
    ocean = int(sim.grid.mask.sum())
    phase("main", f"464^2 bbm, {k} steps in {wall:.3f} s: {1e3 * wall / k:.2f} ms/step, "
          f"{ocean * substeps * k / wall:.4e} ocean-cell-substeps/s ({ocean} ocean cells); "
          f"{launches} kernel launches; max speed {float(torch.hypot(sim.state.vt_u, sim.state.vt_v).max()):.3f} m/s; "
          f"zero violations; {smi}")

    # 6. one 120-substep loop at 464^2, kernel beside plain (CUDA events)
    consts, carry, p = setup_for(sim, "bbm")

    def timed(fn, reps=3):
        run_loop(fn, consts, carry, substeps, sim, p)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run_loop(fn, consts, carry, substeps, sim, p)
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    t_plain = [timed(momentum_cuda.substep_loop_reference)]
    t_kern = [timed(momentum_cuda.substep_loop), timed(momentum_cuda.substep_loop)]
    t_plain.append(timed(momentum_cuda.substep_loop_reference))
    ms, plain_ms = min(t_kern), min(t_plain)
    phase("time", f"120-substep bbm loop at 464^2 f32: kernel {t_kern} ms, plain {t_plain} ms "
          f"(order plain, kernel, kernel, plain); {smi}")

    # 7. 1216^2 at 5 km
    big = dict(BENCH, **{"grid.nx": 1216, "grid.ny": 1216, "grid.resolution": 5e3})
    sim = make_sim(big)
    t0 = time.perf_counter()
    sim.step_chunk(3)
    sync()
    wall = time.perf_counter() - t0
    for f in ("conc", "thick", "damage", "sigma", "vt_u", "vt_v"):
        if not bool(torch.isfinite(getattr(sim.state, f)).all()):
            raise AssertionError(f"1216^2: {f} is not finite")
    viol = checks.violations(sim.state).cpu().numpy()
    if viol.any():
        raise AssertionError(f"1216^2: violations {checks.describe(viol)}")
    phase("big", f"1216^2 at 5 km ({1216 * 1216} cells): 3 steps in {wall:.3f} s "
          f"({1e3 * wall / 3:.1f} ms/step, first steps included), finite, zero violations; {smi}")

    print(json.dumps({"kernels": [{
        "name": "momentum_substep",
        "route": "cuda",
        "source": "nextsim_tpu_torch/csrc/momentum_substep.cu",
        "replaces": "nextsim_tpu/ops/momentum_pallas.py:286",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
