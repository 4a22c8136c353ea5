"""Benchmark: momentum + rheology substep throughput on the pan-Arctic domain,
the port's counterpart of the repository's ``bench.py`` (the JAX package's).

    python -m nextsim_tpu_torch.bench        # on the card; prints ONE JSON line

The line has ``bench.py``'s metric and keys: ``metric``, ``value``,
``unit``, ``vs_baseline`` and ``detail`` (the per-window and aggregate
rates among them). ``detail.device`` names the card: its
``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power limit.

The configuration and the sequence are ``bench.py``'s: the 464^2 arctic box
at 10 km, BBM, 120 substeps a 200 s step, thermodynamics off, constant
forcing; ``tpu.steps_per_call`` = 30; the k-step program of
``Simulator._build_chunk_fn(k)`` (on the card one replay of a captured CUDA
graph) called once to warm up (the capture), then the best of 4 windows of
30 steps. The metric counts ocean cells only; the raw whole-grid rate is in
``detail.raw_cell_substeps_per_s``.

``vs_baseline`` uses ``bench.py``'s anchor: a C++ -O3 transcription of the
reference's hot loop measured at 1.4e7 element-substeps/s on one core, times
the 64 cores of the reference's example job, two P1 triangles to a quad
cell (``bench.py``'s docstring gives the derivation; the tests pin these
constants to ``bench.py``'s).

``measure(device=..., n=...)`` runs the same sequence at any size and on
any device, for the CPU tests; a CPU run's numbers are no device metric.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# bench.py's anchor (tools/bench_anchor.py: best of runs 1.40e7..1.50e7 /core)
REF_CORE_ELEMENT_SUBSTEPS_PER_S = 1.4e7
REF_JOB_CORES = 64  # model/job_mpi.pbs:10-35 (16 ranks x 4 OMP)
REF_ANCHOR_ELEMENT_SUBSTEPS_PER_S = REF_CORE_ELEMENT_SUBSTEPS_PER_S * REF_JOB_CORES
TRIANGLES_PER_QUAD_CELL = 2.0
METRIC = "bbm_momentum_ocean_cell_substeps_per_s_per_chip"


def bench_overrides(n: int = 464, substeps: int = 120, steps_per_call: int = 30) -> dict:
    """bench.py's configuration (``n`` = 464, 120 substeps, 30 steps a call)."""
    return {
        "grid.preset": "arctic",
        "grid.nx": n,
        "grid.ny": n,
        "grid.resolution": 10e3,
        "simul.timestep": 200,
        "simul.time_init": "2015-10-16 00:00:00",
        "dynamics.substeps": substeps,
        "dynamics.alea_factor": 0.33,
        "thermo.use_thermo_forcing": False,
        "setup.ice-type": "constant",
        "setup.atmosphere-type": "constant",
        "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 10.0,
        "ideal_simul.constant_wind_v": -3.0,
        "dynamics.use_coriolis": True,
        "tpu.steps_per_call": steps_per_call,
    }


def _device_detail(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"kind": str(device)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"kind": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(device="cuda", n: int = 464, substeps: int = 120, steps_per_call: int = 30,
            n_steps: int = 30, n_windows: int = 4) -> dict:
    """bench.py's sequence on ``device``: the result line as a dict."""
    from nextsim_tpu_torch import Config, Simulator

    device = torch.device(device)
    sim = Simulator(Config(overrides=bench_overrides(n, substeps, steps_per_call)), device=device)
    k = sim._chunk_k
    forcing = sim.forcing_provider(sim.current_time, sim.time_init)
    tinfo = sim.time_info()
    # per-step forcing and flags threaded through the chunk (constant forcing
    # here, so the tail stacks replicate one bundle, as in bench.py)
    f_rest = forcing.replace(**{
        f: torch.stack([getattr(forcing, f)] * (k - 1)) for f in forcing.__dataclass_fields__
        if isinstance(getattr(forcing, f), torch.Tensor)})
    ti_rest = {key: [v] * (k - 1) for key, v in tinfo.items()}
    chunk = sim._build_chunk_fn(k)
    ocean_cells = int(sim.grid.mask.sum())

    # warm-up: the eager run and the capture
    t0 = time.perf_counter()
    state, diag, viol, acc, lex = chunk(sim.state, forcing, f_rest, tinfo, ti_rest)
    _sync(device)
    warmup_s = time.perf_counter() - t0

    windows = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(n_steps // k):
            state, diag, viol, acc, lex = chunk(state, forcing, f_rest, tinfo, ti_rest)
        _sync(device)
        windows.append(time.perf_counter() - t0)
    dt_wall = min(windows)
    if not bool(torch.isfinite(state.vt_u).all()) or int(viol.sum()) != 0:
        raise RuntimeError("bench: the state left its bounds (non-finite velocity or violations)")

    cells = n * n
    steps = (n_steps // k) * k
    raw_rate = cells * substeps * steps / dt_wall
    ocean_rate = ocean_cells * substeps * steps / dt_wall
    steps_per_s = steps / dt_wall
    graph = sim._program.stats
    return {
        "metric": METRIC,
        "value": round(ocean_rate, 1),
        "unit": "ocean-cell-substeps/s",
        "vs_baseline": round(ocean_rate * TRIANGLES_PER_QUAD_CELL / REF_ANCHOR_ELEMENT_SUBSTEPS_PER_S, 3),
        "detail": {
            "grid": f"{n}x{n}@10km",
            "ocean_cells": ocean_cells,
            "raw_cell_substeps_per_s": round(raw_rate, 1),
            "substeps": substeps,
            "steps_per_s": round(steps_per_s, 3),
            "ms_per_step": 1e3 / steps_per_s,
            "model_s_per_wall_s": round(steps_per_s * 200.0, 1),
            "anchor_element_substeps_per_s": REF_ANCHOR_ELEMENT_SUBSTEPS_PER_S,
            "anchor_note": "measured C++ hot loop x64-core ideal (tools/bench_anchor.py)",
            "timing": f"best of {n_windows} x {steps}-step windows",
            "window_ocean_rates": [round(ocean_cells * substeps * steps / w, 1) for w in windows],
            "aggregate_ocean_rate": round(ocean_cells * substeps * steps * n_windows / sum(windows), 1),
            "warmup_s": warmup_s,
            "graph": {key: graph.get(key) for key in ("nodes", "capture_s", "instantiate_s", "pool_bytes")},
            "backend": device.type,
            "device": _device_detail(device),
            "torch": torch.__version__,
        },
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("nextsim_tpu_torch.bench: no CUDA device; the bench runs on the card", file=sys.stderr)
        return 2
    print(json.dumps(measure("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
