#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nextsim_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them. Phases, each
printing a line; any failure raises and ends the run with a non-zero exit:

1. the card's name and power limit (nvidia-smi);
2. build the momentum substep kernel (csrc/momentum_substep.cu) with nvcc,
   and print its launch plan at 464^2 and 1216^2 (tile, substeps a launch,
   shared memory, blocks, launches a loop) beside ptxas' registers;
3. the kernel against its plain PyTorch version on the card: bbm, evp and
   mevp, float32 and float64, on a 33x33 square, on a ragged 70x45 one (11
   and 121 substeps: no multiple of any number of substeps a launch, so
   the last launch runs a remainder) and on a 464^2 arctic state spun up
   until damage is active; 3 (11) substeps held tightly, 120 (121) substeps
   statistically in float32 and tightly in float64; bbm and evp must equal
   the plain loop bitwise in float64 and, over 3 (11) substeps, in float32;
4. the golden toy run (48^2, 15 steps) against tests/golden_toy_fields.npz;
5. the thermo-off main path: the 464^2 10 km arctic configuration of
   bench.py through ``Simulator(cfg, device="cuda").step_chunk()`` for 30
   steps, twice: the first call runs the 30-step program eagerly and
   captures it as a CUDA graph, the second is one replay of the graph (its
   ms/step); all fields finite, zero violations, and every substep launched
   through the kernel in both (the launch plan's count; a replay counts the
   launches its graph holds);
6. one 120-substep loop at 464^2 in float32, kernel beside plain, with the
   least time the card could take for it (its bound) and the share reached;
7. 3 steps at 1216^2 and 5 km (1.48M cells), finite with zero violations,
   and the kernel's time for one 120-substep loop there beside its bound;
7b. the transport kernel (csrc/transport_ridge.cu) against
   ``transport_and_ridge_reference`` on the 464^2 state of phase 3 and the
   1216^2 state of phase 7, each in float32, bfloat16 and float64: every
   field and diagnostic bitwise, one call ``LAUNCHES_A_CALL`` launches; the
   kernel's and the plain version's ms in CUDA graphs beside the byte bound.
   Every path below counts the transport kernel's launches from zero, as
   the substep kernel's: one call a step, one more launch a stack of
   floe-size bins (checked at the end, with the kernel's record);
8. the main path with thermodynamics on (the default Winton slab and young
   ice, configs/arctic_10km.cfg's ice): the same 464^2 configuration through
   ``step_chunk()`` for 30 steps, one replay of the graph captured at a
   first call; all fields finite, zero violations, and
   every substep launched through the kernel (its launch count is the one
   the JSON record reports);
9. one float64 ``thermo_step`` on the phase-8 state on the card against the
   same step on the CPU (rtol 1e-12 of each field's magnitude), and the time
   of one float32 ``thermo_step`` at 464^2;
10. the CLI: ``python -m nextsim_tpu_torch --device cuda`` on
   configs/toy.cfg (128^2) for 0.25 days with moorings, snapshots, drifters,
   an interval restart at 0.125 days and a final restart; all files present
   and finite; then a second run resumes from the interval restart and its
   final restart must equal the first run's (atol 1e-6 of each field's
   magnitude);
11. the dataset path: configs/arctic_10km.cfg (608^2 at 10 km on the
   arctic_etopo coastline, BBM, 120 substeps, 200 s steps) with ERA5 +
   TOPAZ4 reanalysis forcing, TOPAZ ice and thermo on, through the CLI
   (``nextsim_tpu_torch.__main__.main``, in this process) for 36 steps, on
   synthetic files written at the products' own sizes under
   NEXTSIM_DATA_DIR (the ETOPO stand-in 161x720, ERA5 201x1440 hourly, TOPAZ4
   800x880 daily); every output present and finite, zero violations, conc
   in [0, 1], the initial conc equal to the interpolated TOPAZ siconc, the
   wind of step 36 equal to the interpolated ERA5 wind and unlike step 1's,
   and every substep through the kernel (36 loops of the plan's launches);
12. the kernel against its plain version on the phase-11 state, where
   grounding (C_BU) and the SSH gradient are non-zero and the currents vary:
   3 substeps tight, 120 substeps statistically in float32 and tightly in
   float64; DatasetForcing on the card against the CPU (bitwise); the time
   of a dataset step against a constant-forcing one at 608^2, of the
   forcing on the host, of a plane load, and of steps with and without a
   prefetch running;
13. a nested toy run (open boundary, reference-format nesting files, ocean
   nesting and the dynamic variables, thermo on) on the card against the
   CPU in float64 (rtol 1e-12 of each field's magnitude);
14. the wave path at full width: phase 11's configuration with the waves-in-ice
   module (25 frequencies x 16 directions, a 591 MB spectrum) on ERA-Interim
   wave fields (a synthetic file at the product's size, 181x360 6-hourly),
   coupled every 20 steps with the wave stress applied, a 20-bin floe-size
   distribution with roach welding, uniform_size breakup and damage
   feedback, and thermo.melt_type=3, through the CLI for 41 steps (three
   WIM exchanges); finite fields, zero violations, the kernel's launches a
   step as its plan says, Hs > 0 in open water and falling into the ice, a
   broken zone, the bins summing to conc + conc_young within 1e-5, area
   below the last bin where the WIM broke floes, dmax and tauwix in the
   moorings file, the spectrum and the bins in the restart; ms/step beside
   phase 11's, and each WIM exchange's wall and device time; the run's
   chunks are graph replays (Roach welding is one call of its kernel: a
   memset and two launches, nothing read back), one welding call a step.
   At the phase's end (after 16):
   a 20-step chunk between WIM exchanges from one state, ``step_chunk_eager``
   and ``step_chunk`` (one graph replay) in turns, bitwise equal; ms/step
   of each, the graph's nodes, capture and instantiation seconds, pool,
   and both kernels' launches a replay;
15. the kernel against its plain version on the phase-14 state, the wave
   stress non-zero on the nodes: bitwise in float32 and float64;
16. float64 on the card against the CPU (1e-12 of each field's magnitude):
   one ``Wim.run`` over a coupling window (the full spectrum on every 4th
   cell of the phase-14 fields) and one FSD block at 608^2; then wall time,
   device time and launches of one welding_roach (with the run's freezing
   mask and with every cell freezing), one FSD block, one WIM exchange and
   one eager model step under torch.profiler, and the time of an exchange
   with 3 and with 25 frequencies a block, in turns; then the welding
   kernel (csrc/welding_roach.cu) against ``welding_roach_reference``,
   bitwise (NaN in the same places), in float32, float64 and bfloat16, on
   the phase-14 state with the step's own freezing mask, with every cell
   freezing (every active cell to the cap of 256 substeps) and with broken
   floes spread from a numpy seed under the own mask: active cells, the
   kernel's CUDA-event time in one call (two launches), its bound and the
   plain version's time of each;
17. the coupled run: the same configuration with ``coupler.with_waves`` on a
   260x260 exchange grid and a prescribed ``cpl_in.nc`` (wlbk, tauwix,
   tauwiy), through ``Simulator.run`` on the default device for 21 steps
   in captured chunks of the shipped ``tpu.steps_per_call`` as ``run``
   clamps it (2 steps; Roach welding no longer keeps it eager), the
   last step one replay of the one-step graph; each call of the program is
   run again eagerly from its inputs and must equal it bitwise (state,
   diag, the coupler's sums); the two put files hold the 10-step means
   that the device accumulated (held against the host's means of the eager
   steps, remapped and rotated), and the received wlbk breaks floes;
18. ``python -m nextsim_tpu_torch.wim --device cuda`` with its defaults, as a
   subprocess, and its summary line;
19. the ensemble at full width: ``BatchedEnsemble`` on phase 11's
   configuration and files, 4 members (the control and 3 perturbed) for 12
   steps, each step twice from the same state, in turns: the batched step
   (one replay of a captured CUDA graph; the perturbed members' draws, AR(1)
   updates and perturbations inside it, their generators registered, and
   restored with ``set_state`` between the turns; the substep kernel
   launched once for all members, the plan's launches a step) and the
   member loop ``step_members`` (eager draws, 4 x the plan's launches a
   step), every member equal bitwise after every step; every member finite with zero
   violations (the batched step's (4, checks) flags), spread in conc, sst
   and vt_u, member 0 on the provider's forcing, statistics moorings
   records, and a checkpoint at step 6 read back into the same ensemble
   whose second (batched) pass equals the first bitwise; ms/step of each
   (median, min, max) beside phase 11's, the graph's nodes, capture and
   instantiation seconds and pool, and the member loop's step under
   torch.profiler (launches, device busy, idle share; the batched step's
   replay is profiled at the end of phase 29), one batched step's CUDA
   runtime calls under torch.profiler (one graph launch; outside it the
   forcing's copies); then the welding ensemble:
   4 members of phase 19's configuration with phase 14's FSD (20 bins,
   Roach welding on scaled areas, melt_type 3) on phase 14's last state
   with broken floes spread from numpy, 3 steps, the batched replay and
   ``step_members`` in turns, every member bitwise equal after every step,
   welding's active cells printed (> 0); one welding call on its
   member-minor stack equals four single calls bitwise, timed in turns,
   and the plain version bitwise in float32, float64 and bfloat16; the
   kernel's time on the stacks and freezing masks that welding gets in
   the loop's third step (the ensemble's state after two), bitwise the
   plain version's;
19b. the batched launch on phase 19's 608^2 x 4 state: against the 4
   single-member launches and the plain loop on the card, bitwise, for
   bbm, evp and mevp in float32, float64 and bfloat16 over 11 substeps; a
   120-substep bbm float32 loop batched beside 4 single launches by CUDA
   events, in turns, and the plain loop on the batch, with its bound (4 x
   the single one);
20. at 464^2 thermo on, 3 members for 3 steps: batched member 0 equals a
   Simulator and member 2 a Simulator with ensemble_member=2 (one-step
   graph replays, its draws inside them), bitwise; then the perturbed
   member: ``Simulator(member=2)`` at 464^2 thermo on (no eager reason),
   30-step chunks from one state and generator state, ``step_chunk``
   (one replay of the 30-step graph: the noise drawn, filtered, advanced
   and applied inside it) and ``step_chunk_eager`` in turns, three times
   each, every result bitwise equal (state, AR(1) carry, generator state,
   last perturbed forcing); ms/step of each (median, min, max), the
   graph's nodes, capture and instantiation seconds;
21. ``python -m nextsim_tpu_torch.ensemble.run_ensemble --device cuda`` with
   a control and 2 members on configs/toy.cfg for 0.05 days, as a
   subprocess: mem_0..mem_2 finite, the members different;
22. ``run_comparison`` on three synthetic reference-format snapshots with
   configs/toy.cfg in float64, on the card and on the CPU: every metric of
   the reports within 1e-9 relative; ``tools.deformation_stats`` on phase
   19's ensemble-mean velocity;
23. gradients: d(mean KE after one step)/d(wind_u) through ``raw_step_fn``
   at 464^2 (BBM, 120 substeps, thermo off and on), through
   ``momentum_cuda.SubstepLoop`` (the kernel forward, a checkpointed
   recompute with the plain body backward) against straight autograd
   through the plain loop on the card in float32 and float64, a
   directional finite difference in float64 and a 2-step rollout; ms,
   kernel launches and peak memory of each, and device busy of each but
   the rollout;
24. a device mesh: 4 ranks of a 2x2 mesh spawned on the card (gloo with the
   strips staged through pinned host memory when they share one card, NCCL
   when each has its own): phase 8's 464^2 thermo-on configuration for 4
   steps, bbm and evp at tpu.halo_depth 1 and 6, the gathered state
   bitwise equal to the single-device Simulator; the kernel on rank 0's
   ext block against the plain loop (bitwise); 1216^2 at 5 km, thermo on,
   H = 6, 3 steps after one: ms/step, exchange share, bytes a step and
   kernel launches by rank (ranks that share a card time-slice it: no
   scaling numbers); configs/toy.cfg through the CLI on 4 ranks against one
   process, every array of the restart, snapshots, moorings and drifters
   bitwise equal;
25. the wave path on a mesh: phase 14's configuration (608^2, ERA5 + TOPAZ4
   + ETOPO + ERA-Interim waves, thermo on with melt_type 3, 20 FSD bins, the
   WIM 25 x 16 co-located every 20 steps) on a 2x2 mesh of 4 ranks, H = 6,
   21 steps (two WIM exchanges, the WIM on its own layout of the blocks):
   the gathered state and the WIM's dfloe, broken, tau_x and tau_y against
   the single-device Simulator over the same steps (bitwise, or within
   MESH_WAVE_RTOL, as printed); the kernel on rank 0's ext block of the
   step-20 state against the plain loop; ms/step between exchanges, seconds
   a WIM exchange, the WIM's ring bytes and ``Seam.seconds`` by rank;
26. the member mesh: phase 19's configuration, 4 members on the layouts (4,)
   (a batched step of one member a rank) and (2, 1, 2) (the batched step of
   two members on 1x2 blocks a group: one loop of substep launches a step,
   not one a member) (4 ranks each), 3 steps, every member bitwise equal
   to phase 19's single-device ensemble after 3 steps; the (4,) checkpoint
   read by phase 19's ensemble equals it, and one more (batched) step stays
   equal;
27. a mesh gradient: phase 23's thermo-off d(mean KE)/d(wind_u) through
   ``raw_step_fn`` on a 2x2 mesh, H = 6, float32 and float64, each rank's
   loss on its own nodes and ``Seam.fold`` for the global gradient, against
   phase 23's single-device gradient (relative L2 within MESH_GRAD_REL_L2);
   ms, substep launches and peak memory by rank, and the float32
   gradient's kernels and device busy by rank. Times of ranks that share
   one card are no scaling numbers;
28. bfloat16 (``tpu.dtype=bfloat16``): the plan of the kernel's bfloat16
   build at 464^2 and ptxas' registers; the kernel against the plain
   bfloat16 loop on the card over 120 substeps on phase 3's 464^2 state
   (bitwise for bbm and evp, mevp reported) and over 11 substeps of a ragged
   1216^2 plan (bitwise), with a 1216^2 loop's time; one 120-substep bbm
   loop at 464^2 in bfloat16 beside float32 by CUDA events, in turns, with
   the bound and the plain bfloat16 loop's time; phase 8's configuration in
   bfloat16 and float32 for 10 steps through ``step_chunk`` (ms/step,
   launches, every field bfloat16 and finite, violations, the largest
   difference from float32); configs/toy.cfg through the CLI in bfloat16,
   3 steps and a resume for 3 more against 6 uninterrupted (bitwise, the
   restart's planes |V2); one bfloat16 gradient of phase 23's thermo-off
   loss through SubstepLoop (ms, launches, peak memory);
29. the captured step against the eager loop: at 608^2 on the dataset files
   (phase 11's Simulator, kept until then) and at 464^2 thermo off and on,
   30-step chunks from one state,
   ``step_chunk_eager`` and ``step_chunk`` (one graph replay) in turns,
   every result bitwise equal; ms/step of each, the device-busy share of
   each under torch.profiler, the graph's nodes, capture and instantiation
   seconds and pool; phase 20's perturbed member's one-step replays under
   torch.profiler (device busy a step beside the unperturbed one's); phase
   19's batched ensemble step (a graph replay) under torch.profiler, the
   last profile of the run (device busy and idle share); then ``python -m nextsim_tpu_torch.bench`` as a subprocess and
   its line.

The line before the last is the JSON record of the three kernels. The
substep kernel: its launches summed over the paths of phases 5 (the eager
first call and the replay, ``main_graph``), 8, 11, 14 (and its captured
chunk, ``wave_graph``), 17, 19 (the batched steps ``ensemble_batched``, the
member loop ``ensemble``, the welding ensemble's batched steps
``ensemble_welding``), 20 (the perturbed member's replays,
``perturbed``), 22, 23, 24, 25, 26, 27 and 28 (the mesh paths summed
over their ranks), each counted from zero, none of them zero;
``bf16_bitwise`` by rheology and the bfloat16 loop's times; phase 29's
numbers under ``captured``; phase 19's under ``ensemble_608x4``, phase
19b's under ``batched_608x4``, phase 20's perturbed member under
``perturbed_464``, phase 14's captured chunk under
``wave_captured``. The welding kernel: its launches on the paths that weld
(``WELDING_PATHS``: phases 14, its captured chunk, 17, 19's welding
ensemble and 25), none of them zero, and the paths that do not weld named;
its time, bound and the plain version's time with every cell freezing in
float32 (phase 16), every case under ``by_case``, the welding ensemble
under ``ensemble_welding_608x4``. The transport kernel: its launches on
the substep kernel's paths, each one call a step (one more launch a stack
of floe-size bins), none of them zero; its time, byte bound and the plain
version's time at 1216^2 in float32, every case of phase 7b under
``by_case``. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
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

# thermodynamics on, with configs/arctic_10km.cfg's ice; the SST limit sits
# above the constant ocean's +1 C so that the ice survives the first step
BENCH_THERMO = dict(BENCH, **{
    "thermo.use_thermo_forcing": True,
    "ideal_simul.init_SST_limit": 10.0,
    "ideal_simul.init_concentration": 0.95,
    "ideal_simul.init_thickness": 1.5,
})
STEP_DAYS_TOY = 300.0 / 86400.0  # configs/toy.cfg's time step

STATE_PLANES = ("vt_u", "vt_v", "ut_u", "ut_v", "sxx", "syy", "sxy", "damage")
# tight tier: |kernel - plain| <= atol_rel * max|plain| + rtol * |plain|
TIGHT = {"float32": (1e-6, 1e-5), "float64": (1e-12, 1e-10)}


# Operations of one substep, a division, a square root, a clamp, a comparison
# or a selection counted as one, from csrc/momentum_substep.cu: (per cell,
# per node)
SUBSTEP_OPS = {"bbm": (97, 94), "evp": (51, 94), "mevp": (51, 94)}
# Of those, the arithmetic with a float32 scalar operand (a Coef or a literal
# S(...)): in bfloat16 it must compute in float32. Every other operation has
# bfloat16 operands only (or compares with a bound that rounding to bfloat16
# leaves on the same side), where native bfloat16 arithmetic gives the bits of
# float32-then-round (24 >= 2 x 8 + 2 bits: the double rounding is innocuous).
SUBSTEP_SCALAR_OPS = {"bbm": (28, 10), "evp": (15, 10), "mevp": (15, 10)}
H100_BYTES_PER_S = 3.35e12  # device memory
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 133.8e12  # bfloat16 outside the tensor cores (NVIDIA's H100 white paper, SXM5)
H100_F64_OPS_PER_S = 34e12  # float64 outside the tensor cores (NVIDIA's data sheet, SXM)


def kernel_bound_ms(ny, nx, steps, dtype, dyn_type, members=1, shared=()):
    """The least time an H100 could take for one substep loop of ``members``
    members: (bound_ms, "bytes" or "operations", bytes_ms, operations_ms).
    Bytes: every plane the rheology reads once (a plane the members share,
    named in ``shared``, once for all) and every state plane it updates
    written once a member. Operations: SUBSTEP_OPS on every cell and node,
    every substep and member, at the float64 rate for float64 and the
    float32 rate for float32; in bfloat16, SUBSTEP_SCALAR_OPS at the float32
    rate and the rest at the bfloat16 rate (the conversions are not
    counted)."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda

    itemsize = torch.finfo(dtype).bits // 8
    cells, nodes = ny * nx, (ny + 1) * (nx + 1)
    is_node = lambda n: n.startswith(("vt", "ut")) or n in momentum_cuda._NODE  # noqa: E731
    moved = list(momentum_cuda.tile_planes(dyn_type)) + list(momentum_cuda._STATE_USED[dyn_type])
    n_bytes = itemsize * sum((nodes if is_node(n) else cells) * (1 if n in shared else members) for n in moved)
    per_cell, per_node = SUBSTEP_OPS[dyn_type]
    ops = members * steps * (per_cell * cells + per_node * nodes)
    bytes_ms = 1e3 * n_bytes / H100_BYTES_PER_S
    if dtype == torch.bfloat16:
        scalar_cell, scalar_node = SUBSTEP_SCALAR_OPS[dyn_type]
        scalar_ops = members * steps * (scalar_cell * cells + scalar_node * nodes)
        ops_ms = 1e3 * (scalar_ops / H100_F32_OPS_PER_S + (ops - scalar_ops) / H100_BF16_OPS_PER_S)
    else:
        ops_ms = 1e3 * ops / (H100_F64_OPS_PER_S if dtype == torch.float64 else H100_F32_OPS_PER_S)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms else "operations"), bytes_ms, ops_ms


T_START = time.perf_counter()


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg} [{time.perf_counter() - T_START:.0f} s since the start]", flush=True)


def sync():
    import torch

    torch.cuda.synchronize()


def event_ms(fn, reps=3):
    """Mean ms of ``reps`` calls of ``fn`` by CUDA events, after a warm one."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


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


def compare(label, sim, dyn_type, steps, dtype_name, state=None, setup=None):
    """Kernel against plain over ``steps`` substeps (from ``setup``, a
    (consts, carry, params) triple, or ``setup_for``); returns the max abs
    velocity error. Raises when a tolerance is exceeded."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda

    consts, carry, p = setup if setup is not None else setup_for(sim, dyn_type, state)
    ref = run_loop(momentum_cuda.substep_loop_reference, consts, carry, steps, sim, p)
    out = run_loop(momentum_cuda.substep_loop, consts, carry, steps, sim, p)
    sync()
    atol_rel, rtol = TIGHT[dtype_name]
    statistical = dtype_name == "float32" and steps > 11
    worst = 0.0
    n_off = 0
    bitwise = all(torch.equal(o, r) for o, r in zip(out, ref))
    if p.dynamics_type != "mevp" and not statistical and not bitwise:
        # no contraction and the plain version's term order: recomputing a
        # halo point gives the bits of computing it once
        raise AssertionError(f"{label}: the kernel does not equal the plain loop bitwise")
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
    phase("compare", f"{label}: {'bitwise equal' if bitwise else 'not bitwise equal'}, max |dvel| {worst:.3e} m/s, points beyond the tight "
          f"tolerance {n_off} ({'statistical tier: mean speed rtol 1e-3, mean damage atol 1e-3' if statistical else 'tight tier'})")
    return worst


def thermo_vs_cpu(sim):
    """One float64 thermo_step from ``sim``'s state on the card and on the
    CPU; raises beyond rtol 1e-12 of each field's magnitude."""
    import dataclasses

    import torch

    from nextsim_tpu_torch.forcing.providers import make_provider
    from nextsim_tpu_torch.ops import thermo

    f64 = torch.float64
    t = sim.current_time + sim.dt / 86400.0
    tinfo = sim.time_info()
    outs = []
    for dev in ("cuda", "cpu"):
        state = dataclasses.replace(sim.state, **{
            f.name: getattr(sim.state, f.name).to(device=dev, dtype=f64)
            for f in dataclasses.fields(sim.state) if getattr(sim.state, f.name) is not None})
        forcing = make_provider(sim.cfg, sim.grid, f64, device=dev)(t, sim.time_init)
        ga = {"mask": sim.grid_arrays["mask"].to(device=dev, dtype=f64)}
        out, diag = thermo.thermo_step(state, forcing, ga, sim.dt, sim.thermo_params, tinfo)
        fields = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
                  if getattr(out, f.name) is not None}
        outs.append({**fields, **{"diag_" + k: v for k, v in diag.items()}})
    worst = 0.0
    for name, r in outs[1].items():
        o = outs[0][name].cpu()
        scale = float(r.abs().max())
        err = float((o - r).abs().max())
        if not bool(torch.isfinite(o).all()) or err > 1e-12 * scale:
            raise AssertionError(f"thermo_step f64 card vs CPU: {name} max |diff| {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / max(scale, 1e-300))
    phase("thermo", f"f64 thermo_step card vs CPU on the 464^2 thermo-on state: {len(outs[0])} fields, "
          f"worst |diff| / max|field| {worst:.3e} (limit 1e-12)")


def thermo_time(sim, smi):
    """Synchronized host wall and CUDA-event time of one float32
    thermo_step at the phase-8 state."""
    import torch

    from nextsim_tpu_torch.ops import thermo

    forcing = sim._next_forcing()
    tinfo = sim.time_info()

    def once():
        return thermo.thermo_step(sim.state, forcing, sim.grid_arrays, sim.dt, sim.thermo_params, tinfo)

    once()
    sync()
    reps = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        once()
    end.record()
    sync()
    wall = (time.perf_counter() - t0) / reps
    phase("thermo", f"f32 thermo_step at 464^2: {1e3 * wall:.3f} ms host wall (synchronized), "
          f"{start.elapsed_time(end) / reps:.3f} ms between CUDA events, mean of {reps}; {smi}")


def cli_run_and_resume(smi):
    """The CLI on configs/toy.cfg, then a resume from its interval restart
    held against its final restart."""
    import os
    import tempfile

    from scipy.io import netcdf_file

    scratch = ROOT / "nextsim_tpu_torch" / "build"  # git-ignored
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        out = Path(tmp) / "run"
        args = ["--device", "cuda", "--config-files", "configs/toy.cfg",
                f"output.exporter_path={out}", "restart.write_final_restart=true",
                "drifters.use_equally_spaced_drifters=true",
                f"drifters.equally_spaced_drifters_output_time_step={36 * STEP_DAYS_TOY!r}",
                "restart.write_interval_restart=true", "restart.output_interval=36",
                "restart.output_interval_units=time_steps", "restart.datetime_in_filename=false"]

        def cli(extra):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "nextsim_tpu_torch", *args, *extra], cwd=ROOT,
                               capture_output=True, text=True, timeout=600, env=dict(os.environ))
            if r.returncode != 0:
                raise AssertionError(f"CLI exited {r.returncode}: {r.stderr[-3000:]}")
            return time.perf_counter() - t0

        wall = cli([f"simul.duration={72 * STEP_DAYS_TOY!r}"])
        files = {
            "moorings": out / "Moorings_20151016.nc",
            "snapshot": out / "field_final.npz",
            "restart": out / "restart" / "restart_final.npz",
            "drifters": out / "Drifters_equally_spaced.nc",
        }
        for what, path in files.items():
            if not path.exists():
                raise AssertionError(f"CLI: no {what} file {path.name}")
        with netcdf_file(files["moorings"], "r", mmap=False) as nc:
            sic = np.asarray(nc.variables["sic"][:])
            n_rec = sic.shape[0]
            if n_rec != 2 or not np.isfinite(sic[:, nc.variables["lsm"][:] > 0.5]).all():
                raise AssertionError(f"CLI moorings: {n_rec} records or non-finite sic")
        with netcdf_file(files["drifters"], "r", mmap=False) as nc:
            lat = np.asarray(nc.variables["latitude"][:])
            if lat.shape[0] != 2 or not np.isfinite(lat).all():
                raise AssertionError(f"CLI drifters: {lat.shape} records or non-finite positions")
        for what in ("snapshot", "restart"):
            with np.load(files[what]) as z:
                for key in z.files:
                    if key != "__meta__" and not np.isfinite(z[key]).all():
                        raise AssertionError(f"CLI {what}: {key} is not finite")
        final = {k: v for k, v in np.load(files["restart"]).items() if k != "__meta__"}

        # resume from the interval restart at step 36 for 36 more steps
        (out / "restart" / "restart_final.npz").rename(out / "restart" / "restart_uninterrupted.npz")
        wall2 = cli(["restart.start_from_restart=true", "restart.basename=36", "restart.type=continue",
                     f"simul.duration={36 * STEP_DAYS_TOY!r}"])
        resumed = np.load(out / "restart" / "restart_final.npz")
        meta = resumed["__meta__"]
        worst = 0.0
        for key, ref in final.items():
            if key.startswith("__drifter"):
                continue
            got = resumed[key]
            scale = float(np.abs(ref).max()) if ref.size else 0.0
            err = float(np.abs(got.astype(np.float64) - ref).max()) if ref.size else 0.0
            if err > 1e-6 * scale:
                raise AssertionError(f"resume: {key} max |diff| {err:.3e} vs the uninterrupted run")
            worst = max(worst, err)
        phase("cli", f"toy.cfg 128^2 on cuda: 72 steps in {wall:.1f} s (process included), {n_rec} moorings "
              f"records, {lat.shape[1]} drifters, snapshot + restarts finite; resume from step 36 "
              f"({wall2:.1f} s) vs uninterrupted: max |diff| {worst:.3e} (limit 1e-6 of each field's "
              f"magnitude); meta {meta}; {smi}")


# --- 7b. the transport kernel ---------------------------------------------------

#: the transport kernel's launches on every path driven (``transport_path``)
TRANSPORT_LAUNCHES = {}
#: every path count or comparison of the transport kernel that failed; the
#: run raises on them at its end, so one run shows them all
TRANSPORT_FAULTS = []


def fsd_stacks(state) -> int:
    """The stacks of floe-size bins that transport advects in ``state``."""
    return sum(getattr(state, n) is not None for n in ("conc_fsd", "conc_mech_fsd"))


def transport_path(path: str, launches: int, steps: int, stacks: int = 0) -> None:
    """Adds ``launches`` of the transport kernel to ``path``'s count; a
    fault unless they are one call a step over ``steps`` steps
    (``LAUNCHES_A_CALL``, and one more launch a stack of bins)."""
    from nextsim_tpu_torch.ops import transport_cuda

    TRANSPORT_LAUNCHES[path] = TRANSPORT_LAUNCHES.get(path, 0) + launches
    want = steps * (transport_cuda.LAUNCHES_A_CALL + stacks)
    if launches != want:
        TRANSPORT_FAULTS.append(f"{path}: {launches} transport launches in {steps} steps with {stacks} stacks of "
                                f"bins, expected {want}")


def transport_ranks(path: str, recs) -> None:
    """``transport_path`` for each rank record of a world (its
    ``transport_launches``, ``transport_steps`` and ``stacks``)."""
    for r in recs:
        transport_path(path, r["transport_launches"], r["transport_steps"], r["stacks"])


def transport_counts(sim, steps: int) -> dict:
    """A rank record's transport fields: the launches counted since the
    rank set them to zero, over ``steps`` steps of ``sim``."""
    from nextsim_tpu_torch.ops import transport_cuda

    state = sim.states if hasattr(sim, "states") else sim.state
    return {"transport_launches": transport_cuda.launches, "transport_steps": steps, "stacks": fsd_stacks(state)}


def graph_ms(fn, calls: int, reps: int = 3) -> float:
    """ms of one call of ``fn`` by CUDA events over ``reps`` replays of a
    CUDA graph of ``calls`` calls: the device's time, no host time between
    calls (after a warm call outside the graph)."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    sync()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def transport_bound_ms(state, young: bool) -> float:
    """The least time of a call on the card: every plane the kernel must
    touch read or written once over the device's bandwidth (the tracer
    planes read and written, vt_u, vt_v, mask and open_mask read, the two
    diagnostics written)."""
    from nextsim_tpu_torch.ops import transport_cuda

    cells, nodes = state.conc.numel(), state.vt_u.numel()
    grid = state.conc.shape[-2] * state.conc.shape[-1]
    tracers = len(transport_cuda._PLANES) - (0 if young else len(transport_cuda._YOUNG))
    n_bytes = state.conc.element_size() * (2 * tracers * cells + 2 * nodes + 2 * grid + 2 * cells)
    return 1e3 * n_bytes / H100_BYTES_PER_S


def transport_kernel_phase(cases, smi) -> dict:
    """Phase 7b: the transport kernel against the plain version on each
    (label, Simulator) of ``cases``, its state and grid cast to float32,
    bfloat16 and float64: the kernel's call (``transport.transport_and_ridge``
    on card tensors) must equal ``transport_and_ridge_reference`` bitwise on
    every field and diagnostic, NaN in the same places, in
    ``LAUNCHES_A_CALL`` launches, and move the state; the kernel's ms in a
    CUDA graph of 20 calls, the plain version's in one of 2, and the byte
    bound. Returns {"label dtype": record}."""
    import dataclasses

    import torch

    from nextsim_tpu_torch.ops import transport, transport_cuda

    recs, lines = {}, []
    saved = transport_cuda.launches
    for label, sim in cases:
        p = sim.transport_params
        for dtype_name in ("float32", "bfloat16", "float64"):
            dtype = getattr(torch, dtype_name)
            st = _cast_tree(sim.state, dtype)
            ga = {k: v.to(dtype) if isinstance(v, torch.Tensor) else v for k, v in sim.grid_arrays.items()}
            what = f"transport {label} {dtype_name}"
            launches = transport_cuda.launches
            got, gdiag = transport.transport_and_ridge(st, ga, sim.dt, p)
            sync()
            made = transport_cuda.launches - launches
            ref, rdiag = transport.transport_and_ridge_reference(st, ga, sim.dt, p)
            differ = [f.name for f in dataclasses.fields(got) if getattr(got, f.name) is not None
                      and not same_bits(getattr(got, f.name), getattr(ref, f.name))]
            differ += [k for k in rdiag if not same_bits(gdiag[k], rdiag[k])]
            err = max(float((getattr(got, f).double() - getattr(ref, f).double()).nan_to_num(0.0, 0.0, 0.0)
                            .abs().max()) for f in transport_cuda.FIELDS)
            moved = [f for f in ("conc", "thick", "damage", "sigma") if not torch.equal(getattr(got, f), getattr(st, f))]
            if differ or made != transport_cuda.LAUNCHES_A_CALL or not moved:
                TRANSPORT_FAULTS.append(f"{what}: {made} launches; differs from the plain version in {differ} "
                                        f"(max |diff| {err:.3e}); changed {moved}")
            ms = graph_ms(lambda: transport.transport_and_ridge(st, ga, sim.dt, p), calls=20)
            plain_ms = graph_ms(lambda: transport.transport_and_ridge_reference(st, ga, sim.dt, p), calls=2, reps=2)
            bound_ms = transport_bound_ms(st, p.use_young_ice)
            recs[f"{label} {dtype_name}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "launches": made,
                                             "bitwise": not differ, "max_abs_err": err}
            lines.append(f"{label} {dtype_name}: {'bitwise' if not differ else f'NOT bitwise ({differ})'}, {made} "
                         f"launch(es), kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({100 * bound_ms / ms:.1f}% of it)")
            del st, ga, got, gdiag, ref, rdiag
            torch.cuda.empty_cache()
    transport_cuda.launches = saved  # comparisons and timings are no path's launches
    ptxas = [ln.strip() for ln in transport_cuda.build_log.splitlines() if "registers" in ln or "spill" in ln]
    phase("transport", f"the transport kernel against the plain version (every field and diagnostic, NaN in the same "
          f"places), times of one call in CUDA graphs (kernel: 20 calls, plain: 2): {'; '.join(lines)}; ptxas: "
          f"{' | '.join(ptxas) or 'cached'}; {smi}")
    return recs


# --- the dataset path (phases 11-13) ------------------------------------------

STEP_DAYS_ARCTIC = 200.0 / 86400.0  # configs/arctic_10km.cfg's time step
DATASET_STEPS = 36  # 2 model hours: crosses two hourly ERA5 records
# the forcing configs/arctic_10km.cfg's own comment names, thermo on
DATASET_ARGS = ["setup.atmosphere-type=era5", "setup.ocean-type=topaz4_rean",
                "setup.ice-type=topaz4_rean", "thermo.use_thermo_forcing=true"]


def _hours_since_1900(stamp: str) -> float:
    import datetime

    return (datetime.datetime.fromisoformat(stamp) - datetime.datetime(1900, 1, 1)).total_seconds() / 3600.0


def write_nc(path: Path, dims: dict, variables: dict) -> None:
    """A NetCDF3 (64-bit offset) file: variables {name: (dims, array, units)}."""
    from scipy.io import netcdf_file

    path.parent.mkdir(parents=True, exist_ok=True)
    with netcdf_file(str(path), "w", version=2) as nc:
        for d, n in dims.items():
            nc.createDimension(d, n)
        for name, (vdims, arr, units) in variables.items():
            v = nc.createVariable(name, "f8" if arr.dtype == np.float64 else "f4", vdims)
            v[:] = arr
            if units:
                v.units = units.encode()


def write_era5(d: Path) -> None:
    """ERA5 at its own grid (0.25 deg, 90-40N x 360 deg: 201x1440, north to
    south and 0-359.75E as ERA5 stores them), nine per-variable yearly files
    with hourly records from 2015-10-15 23:00 to 2015-10-16 03:00: a moving
    5-15 m/s wind pattern, a travelling pressure wave, air temperature
    falling northward with the dew point 1-3 K below it."""
    lats = np.linspace(90.0, 40.0, 201)
    lons = np.arange(1440) * 0.25
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    lam, phi = np.deg2rad(lon2), np.deg2rad(lat2)
    stamps = ["2015-10-15 23:00:00"] + [f"2015-10-16 0{h}:00:00" for h in range(4)]
    hours = np.array([_hours_since_1900(st) for st in stamps])

    def fields(h):
        speed = 10.0 + 5.0 * np.sin(3.0 * lam + 0.25 * h) * np.cos(2.0 * phi)
        theta = lam + 0.1 * h + 0.5 * np.sin(2.0 * phi)
        t2m = 273.15 - 25.0 * (lat2 - 40.0) / 50.0 + 3.0 * np.sin(lam + 0.05 * h)
        mtpr = 1e-5 * (1.0 + np.sin(2.0 * lam + 0.2 * h))
        return {"u10": speed * np.cos(theta), "v10": speed * np.sin(theta), "t2m": t2m,
                "d2m": t2m - 2.0 - np.cos(lam),
                "msl": 101300.0 + 1500.0 * np.cos(2.0 * lam - 0.1 * h) * np.cos(phi),
                "msdwswrf": 40.0 * np.clip((70.0 - lat2) / 30.0, 0.0, 1.0),
                "msdwlwrf": 180.0 + 80.0 * (90.0 - lat2) / 50.0, "mtpr": mtpr, "msr": 0.7 * mtpr}

    recs = [fields(h) for h in hours - hours[1]]
    for v in recs[0]:
        write_nc(d / f"ERA5_{v}_y2015.nc", {"time": len(hours), "latitude": 201, "longitude": 1440}, {
            "time": (("time",), hours, "hours since 1900-01-01 00:00:00.0"),
            "latitude": (("latitude",), lats.astype(np.float32), None),
            "longitude": (("longitude",), lons.astype(np.float32), None),
            v: (("time", "latitude", "longitude"), np.stack([r[v] for r in recs]).astype(np.float32), None),
        })


TOPAZ_FILE = Path("2015") / "topaz_rean_201510.nc"


def write_topaz(d: Path) -> None:
    """A TOPAZ4 reanalysis monthly file on a TOPAZ4-sized curvilinear grid
    (800x880 points, 12.5 km polar-stereographic on another meridian than
    the model's), daily records at 12:00 on 15 and 16 October: currents of
    ~0.1 m/s, an SSH of +-0.3 m, hydrography, and ice north of 66N (conc
    0.98 from 74N, 0.5-3 m thick)."""
    from nextsim_tpu_torch.grid.projection import PolarStereo

    proj = PolarStereo(lat0=90.0, lat_ts=60.0, lon0=-135.0)
    x = -5500e3 + 12.5e3 * np.arange(880)
    y = -5000e3 + 12.5e3 * np.arange(800)
    lat2, lon2 = (np.asarray(a) for a in proj.inverse(*np.meshgrid(x, y)))
    lam, phi = np.deg2rad(lon2), np.deg2rad(lat2)
    north = np.clip((lat2 - 66.0) / 20.0, 0.0, 1.0)
    hours = np.array([_hours_since_1900(f"2015-10-{day} 12:00:00") for day in (15, 16)])
    recs = [{
        "uo": 0.1 * np.sin(lam + 0.2 * k) * np.cos(phi), "vo": 0.1 * np.cos(2.0 * lam - 0.2 * k),
        "zos": 0.3 * np.cos(lam + 0.1 * k) * np.cos(2.0 * phi),
        "thetao": -1.8 + 5.0 * np.clip((72.0 - lat2) / 12.0, 0.0, 1.0),
        "so": 34.5 - 3.0 * north, "mlotst": 25.0 + 15.0 * np.sin(lam) ** 2,
        "siconc": 0.98 * np.clip((lat2 - 66.0) / 8.0, 0.0, 1.0),
        "sithick": 0.5 + 2.5 * north + 0.05 * k, "sisnthick": 0.05 + 0.2 * north,
    } for k in range(2)]
    write_nc(d / TOPAZ_FILE, {"time": 2, "y": 800, "x": 880}, {
        "time": (("time",), hours, "hours since 1900-01-01 00:00:00"),
        "latitude": (("y", "x"), lat2.astype(np.float32), None),
        "longitude": (("y", "x"), lon2.astype(np.float32), None),
        **{v: (("time", "y", "x"), np.stack([r[v] for r in recs]).astype(np.float32), None) for v in recs[0]},
    })


def write_forcing_data(d: Path) -> str:
    """The ETOPO stand-in (161x720), ERA5 and TOPAZ4 under ``d``."""
    from nextsim_tpu_torch.tools import synthetic_etopo

    d.mkdir(parents=True, exist_ok=True)
    synthetic_etopo.write(str(d / "ETOPO_Arctic_2arcmin.nc"))
    write_era5(d)
    write_topaz(d)
    return "ETOPO 161x720, ERA5 9 x 5 records of 201x1440, TOPAZ4 2 records of 800x880 x 9 variables"


def _all_finite(path: Path, what: str) -> None:
    with np.load(path) as z:
        for key in z.files:
            if key != "__meta__" and not np.isfinite(z[key]).all():
                raise AssertionError(f"{what}: {key} is not finite")


def dataset_cli_run(data: Path, out: Path, smi: str):
    """Phase 11: configs/arctic_10km.cfg on ERA5 + TOPAZ4 + ETOPO through the
    CLI's entry point, in this process; returns the Simulator it ran."""
    import torch

    from nextsim_tpu_torch import __main__ as cli
    from nextsim_tpu_torch.forcing.netcdf_io import NCFile
    from nextsim_tpu_torch.model import checks
    from nextsim_tpu_torch.model.simulator import Simulator
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda
    from nextsim_tpu_torch.utils import dates
    from scipy.io import netcdf_file

    args = ["--device", "cuda", "--config-files", str(ROOT / "configs" / "arctic_10km.cfg"), *DATASET_ARGS,
            f"simul.duration={DATASET_STEPS * STEP_DAYS_ARCTIC!r}", f"output.exporter_path={out}",
            "restart.write_initial_restart=true", "output.save_forcing_fields=true",
            "moorings.output_timestep=18", "moorings.output_time_step_units=time_steps",
            f"drifters.equally_spaced_drifters_output_time_step={18 * STEP_DAYS_ARCTIC!r}"]
    kept = {}
    calls = []  # host seconds of each forcing call
    run = Simulator.run

    def run_and_keep(self, *a, **kw):
        """Keep the CLI's Simulator for phase 12 and time its forcing calls."""
        kept["sim"], kept["t_run"] = self, time.perf_counter()
        provider = self.forcing_provider

        def timed(t, t_init):
            c = time.perf_counter()
            out = provider(t, t_init)
            calls.append(time.perf_counter() - c)
            return out

        self.forcing_provider = timed
        try:
            return run(self, *a, **kw)
        finally:
            self.forcing_provider = provider

    Simulator.run = run_and_keep
    momentum_cuda.launches = transport_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(args)
        sync()
    finally:
        Simulator.run = run
    wall = time.perf_counter() - t0
    launches = momentum_cuda.launches
    transport_path("datasets", transport_cuda.launches, DATASET_STEPS)
    if rc != 0:
        raise AssertionError(f"dataset CLI exited {rc}")
    sim = kept["sim"]
    if sim.pcpt != DATASET_STEPS:
        raise AssertionError(f"dataset CLI ran {sim.pcpt} steps, not {DATASET_STEPS}")
    expect = momentum_cuda.launches_for(sim.dyn.substeps, *sim.grid.shape) * DATASET_STEPS
    if launches != expect:
        raise AssertionError(f"dataset path: {launches} kernel launches, expected {expect}")

    # outputs present and finite
    rdir = out / "restart"
    files = {"snapshot": out / "field_final.npz", "initial restart": rdir / "restart_initial.npz",
             "final restart": rdir / "restart_final.npz", "drifters": out / "Drifters_equally_spaced.nc",
             "log": out / "nextsim_tpu.log"}
    moorings = sorted(out.glob("Moorings_*.nc"))
    for what, path in files.items():
        if not path.exists():
            raise AssertionError(f"dataset CLI: no {what} file {path.name}")
    if not moorings:
        raise AssertionError("dataset CLI: no moorings file")
    for what in ("snapshot", "initial restart", "final restart"):
        _all_finite(files[what], what)
    with netcdf_file(moorings[0], "r", mmap=False) as nc:
        sic = np.asarray(nc.variables["sic"][:])
        if sic.shape[0] != 2 or not np.isfinite(sic[:, nc.variables["lsm"][:] > 0.5]).all():
            raise AssertionError(f"dataset moorings: {sic.shape[0]} records or non-finite sic")
    viol = checks.violations(sim.state).cpu().numpy()
    if viol.any():
        raise AssertionError(f"dataset path: violations {checks.describe(viol)}")
    conc = sim.state.conc
    if not (bool(torch.isfinite(conc).all()) and float(conc.min()) >= 0.0 and float(conc.max()) <= 1.0):
        raise AssertionError("dataset path: conc outside [0, 1]")
    for f in ("thick", "snow_thick", "damage", "sigma", "tice", "sst", "sss", "vt_u", "vt_v"):
        if not bool(torch.isfinite(getattr(sim.state, f)).all()):
            raise AssertionError(f"dataset path: {f} is not finite")

    # the initial conc is the interpolated TOPAZ siconc (topaz_like_ice:
    # min(1, siconc) on the ocean cells; the file's thickness is > 0.5 m)
    provider = sim.forcing_provider
    topaz = next(r for r in provider.sources if r.spec.name == "topaz4r")
    era5 = next(r for r in provider.sources if r.spec.name == "era5")
    with NCFile(str(data / TOPAZ_FILE)) as nc:
        raw = [np.asarray(nc.variables["siconc"][k], np.float64) for k in range(2)]
    t_a, t_b = (r[0] for r in topaz._time_index[:2])
    c1 = float(np.clip((sim.time_init - t_a) / (t_b - t_a), 0.0, 1.0))
    si = (1.0 - c1) * topaz._interp_cell(raw[0]) + c1 * topaz._interp_cell(raw[1])
    with np.load(files["initial restart"]) as z:
        conc0 = z["conc"]
    ocean = sim.grid.mask > 0.5
    want = np.where(ocean & (si > 1e-12), np.minimum(1.0, si), 0.0).astype(np.float32)
    init_err = float(np.abs(conc0 - want).max())
    if init_err > 1e-7 or float(conc0.max()) < 0.9:
        raise AssertionError(f"dataset init: conc vs interpolated TOPAZ siconc max |diff| {init_err:.3e}")

    # the last step's wind is the interpolated ERA5 wind (with the spin-up
    # ramp of arctic_10km.cfg) and unlike the first step's
    def era5_wind(step):
        step_days = sim.dt * dates.DAYS_IN_SEC  # the Simulator's own time arithmetic
        t = (sim.time_init + (step - 1) * sim.dt * dates.DAYS_IN_SEC) + step_days
        f = provider._fallback.spinup_factor(t, sim.time_init)
        return np.asarray(era5.fields_at(t)["wind_u"] * f, np.float32)

    with np.load(files["snapshot"]) as z:
        wind36 = z["forcing_wind_u"]
    w36, w1 = era5_wind(DATASET_STEPS), era5_wind(1)
    if not np.array_equal(wind36, w36):
        raise AssertionError(f"dataset forcing: step-36 wind differs from ERA5 by {np.abs(wind36 - w36).max():.3e}")
    wind_change = float(np.abs(w36 - w1).max())
    if wind_change < 0.1:
        raise AssertionError(f"dataset forcing: wind of steps 1 and 36 differ by only {wind_change:.3e}")

    init = kept["t_run"] - t0
    rest = (sim.timer.elapsed("step") - calls[0]) / (DATASET_STEPS - 1)
    phase("datasets", f"arctic_10km.cfg 608^2 on ERA5 + TOPAZ4 + ETOPO, thermo on, through the CLI: "
          f"{DATASET_STEPS} steps, {launches} kernel launches, CLI wall {wall:.1f} s: init (config, "
          f"ETOPO grid, TOPAZ ice with its interpolation weights) {init:.1f} s, first forcing call "
          f"(the readers' weights and first planes) {calls[0]:.1f} s, then {1e3 * rest:.2f} ms/step "
          f"(timer 'step' less that call, outputs included) with forcing host time "
          f"{1e3 * float(np.median(calls[1:])):.2f} ms/step (median); {int(ocean.sum())} ocean cells; "
          f"conc {float(conc.min()):.3f}..{float(conc.max()):.3f}; initial conc vs TOPAZ siconc max |diff| "
          f"{init_err:.1e}; wind change step 1 -> 36 {wind_change:.3f} m/s; zero violations; {smi}")
    return sim, launches, 1e3 * rest


def _cast_tree(tree, dtype, device=None):
    import dataclasses

    import torch

    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to(device=device, dtype=dtype) for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def dataset_kernel_and_forcing(sim, smi):
    """Phase 12, correctness: kernel against plain on the phase-11 state
    (grounding and an SSH gradient active), and DatasetForcing on the card
    against the CPU."""
    import copy
    import dataclasses

    import torch

    from nextsim_tpu_torch.forcing.providers import ConstantForcing
    from nextsim_tpu_torch.ops import momentum

    p = sim.dyn
    forcing = sim._next_forcing()
    errs = {}
    for dtype_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        state = _cast_tree(sim.state, dt)
        ga = {k: (v.to(dt) if isinstance(v, torch.Tensor) else v) for k, v in sim.grid_arrays.items()}
        ga["cohesion"] = sim.c_fix + sim.c_alea * state.random_number
        consts, carry = momentum.substep_setup(state, _cast_tree(forcing, dt), ga, sim.dt, p)
        n_cbu = int((consts.c_bu > 0).sum())
        grad = float(torch.maximum(consts.grad_ssh_u.abs().max(), consts.grad_ssh_v.abs().max()))
        cur = float(consts.ocean_u.std())
        if n_cbu == 0 or grad == 0.0 or cur == 0.0:
            raise AssertionError(f"dataset state: {n_cbu} grounded nodes, |grad ssh| {grad}, ocean_u std {cur}")
        for steps in (3, 120):
            errs[(dtype_name, steps)] = compare(f"608^2 dataset state bbm {dtype_name} {steps} substeps", sim,
                                                "bbm", steps, dtype_name, setup=(consts, carry, p))
    phase("datasets", f"kernel vs plain on the phase-11 state: C_BU > 0 on {n_cbu} nodes, max |grad SSH term| "
          f"{grad:.3e}, ocean_u std {cur:.3e} m/s; max |dvel| f32 {errs[('float32', 120)]:.3e}, "
          f"f64 {errs[('float64', 120)]:.3e} over 120 substeps")

    # DatasetForcing on the card against the CPU: the same host readers, so
    # the planes differ only by the upload and the cast
    gpu = sim.forcing_provider
    cpu = copy.copy(gpu)
    cpu.device, cpu._dev_cache = torch.device("cpu"), {}
    cpu._fallback = ConstantForcing(sim.cfg, sim.grid, sim.dtype, device="cpu")
    n = 0
    for k in (37, 45):
        t = sim.time_init + k * STEP_DAYS_ARCTIC
        a, b = gpu(t, sim.time_init), cpu(t, sim.time_init)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if (x is None) != (y is None) or (x is not None and not (
                    x.device.type == "cuda" and torch.equal(x.cpu(), y))):
                raise AssertionError(f"DatasetForcing cuda vs cpu: {f.name} differs at step {k}")
            n += x is not None
    phase("datasets", f"DatasetForcing on the card = on the CPU bitwise: {n} planes at 2 times")
    return errs[("float32", 120)]


def dataset_timings(sim, smi):
    """Phase 12, timing: a dataset step against a constant-forcing one at
    608^2 (in turns), the forcing's host time, a plane load, and steps with
    and without a background plane load (the prefetch's work) running."""
    import copy
    import threading

    from nextsim_tpu_torch import Config, Simulator

    const_cfg = Config.from_files(str(ROOT / "configs" / "arctic_10km.cfg"),
                                  overrides={"thermo.use_thermo_forcing": "true"})
    t0 = time.perf_counter()
    const = Simulator(const_cfg, device="cuda")
    const_init = time.perf_counter() - t0
    for s in (sim, const):  # time the step alone, without the outputs
        s.moorings, s.drifters, s.export_interval_steps, s.restart_interval_steps = None, [], 0, 0
    provider = sim.forcing_provider
    host_ms = []

    def timed_provider(t, t_init, _orig=provider):
        a = time.perf_counter()
        out = _orig(t, t_init)
        host_ms.append(1e3 * (time.perf_counter() - a))
        return out

    sim.forcing_provider = timed_provider

    def steps(s, n):
        out = []
        for _ in range(n):
            a = time.perf_counter()
            s.step()
            sync()
            out.append(1e3 * (time.perf_counter() - a))
        return out

    steps(const, 2)  # warm-up
    t_data, t_const = [], []
    for _ in range(2):
        t_data += steps(sim, 9)
        t_const += steps(const, 9)

    # the cost of one plane load, and steps while one runs in the background:
    # copies of the readers (same interpolation weights, own plane cache) do
    # the loads, so the model's own readers are left as they are
    def reader_copy(name):
        r = copy.copy(next(r for r in provider.sources if r.spec.name == name))
        r._plane_cache, r._lock = {}, threading.Lock()
        return r, r._time_index[-1][1:]

    load_ms = {}
    for name in ("era5", "topaz4r"):
        r, (path, idx) = reader_copy(name)
        a = time.perf_counter()
        r._load_plane(path, idx)
        load_ms[name] = 1e3 * (time.perf_counter() - a)
    stop = threading.Event()
    n_loads = [0]

    def background_loads():
        r, (path, idx) = reader_copy("topaz4r")
        while not stop.is_set():
            r._plane_cache.clear()
            r._load_plane(path, idx)
            n_loads[0] += 1

    t_quiet, t_busy = [], []
    for _ in range(2):
        t_quiet += steps(sim, 6)
        stop.clear()
        th = threading.Thread(target=background_loads, daemon=True)
        th.start()
        t_busy += steps(sim, 6)
        stop.set()
        th.join()
    med = lambda v: float(np.median(v))  # noqa: E731
    phase("datasets", f"608^2 thermo on, step alone (synchronized, median of 18): ERA5+TOPAZ4 {med(t_data):.2f} ms, "
          f"constant forcing {med(t_const):.2f} ms (in turns); forcing host time {med(host_ms):.2f} ms/step "
          f"(median, mean {float(np.mean(host_ms)):.2f}); one plane load: ERA5 {load_ms['era5']:.1f} ms "
          f"(9 files), TOPAZ4 {load_ms['topaz4r']:.1f} ms (6 variables); steps without / with a TOPAZ4 load "
          f"running in a background thread: {med(t_quiet):.2f} / {med(t_busy):.2f} ms (median of 12, "
          f"{n_loads[0]} background loads); constant-forcing init {const_init:.1f} s; {smi}")


NEST_MODEL = dict(nx=48, ny=40, dx=10e3)
NEST_VARS = {
    "sea_ice_area_fraction": (0.7, 0.2), "sea_ice_thickness": (1.2, 0.4),
    "surface_snow_thickness": (0.1, 0.05), "sea_ice_damage": (0.1, 0.1), "ridge_ratio": (0.1, 0.05),
    "sea_surface_temperature": (-1.4, 0.3), "sea_surface_salinity": (33.0, 1.0),
    "sea_ice_x_velocity": (0.05, 0.05), "sea_ice_y_velocity": (-0.02, 0.05),
    "stress_tensor_first_component": (0.0, 1e3), "stress_tensor_second_component": (0.0, 1e3),
    "stress_tensor_third_component": (0.0, 5e2),
}


def write_nesting(d: Path) -> None:
    """Reference-format daily nesting files (nesting_outer_%Y%m%d.nc) on a
    coarse outer grid around NEST_MODEL, two smooth records each."""
    from nextsim_tpu_torch.grid.grid import Grid

    outer = Grid.square(nx=NEST_MODEL["nx"] // 2 + 4, ny=NEST_MODEL["ny"] // 2 + 4, dx=2 * NEST_MODEL["dx"],
                        x0=-4 * NEST_MODEL["dx"], y0=-4 * NEST_MODEL["dx"])
    lat2, lon2 = outer.cell_latlon()
    wave = np.sin(np.deg2rad(lon2) * 7.0) * np.cos(np.deg2rad(lat2) * 40.0)
    for day in (16, 17):
        hours = _hours_since_1900(f"2015-10-{day} 00:00:00") + np.array([0.0, 12.0])
        write_nc(d / f"nesting_outer_201510{day}.nc", {"time": 2, "y": lat2.shape[0], "x": lat2.shape[1]}, {
            "time": (("time",), hours, "hours since 1900-01-01 00:00:00"),
            "latitude": (("y", "x"), lat2, None), "longitude": (("y", "x"), lon2, None),
            **{v: (("time", "y", "x"), np.stack([m + a * wave * (1 + 0.1 * k) for k in range(2)]).astype(np.float32),
                   None) for v, (m, a) in NEST_VARS.items()},
        })


def nested_card_vs_cpu(tmp: Path, smi: str) -> None:
    """Phase 13: a nested toy run on the card against the CPU, float64."""
    import dataclasses

    import torch

    from nextsim_tpu_torch import Config, Simulator

    write_nesting(tmp / "nest")
    over = {
        "simul.time_init": "2015-10-16 00:00:00", "simul.timestep": 900, "simul.spinup_duration": 0.0,
        "grid.preset": "square", "grid.nx": NEST_MODEL["nx"], "grid.ny": NEST_MODEL["ny"],
        "grid.resolution": NEST_MODEL["dx"], "grid.boundary": "open",
        "setup.ice-type": "constant", "ideal_simul.init_concentration": 0.3,
        "ideal_simul.init_thickness": 0.5, "setup.dynamics-type": "free_drift",
        "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
        "ideal_simul.constant_wind_u": 8.0, "thermo.use_thermo_forcing": True,
        "ideal_simul.init_SST_limit": 10.0, "nesting.use_nesting": True,
        "nesting.use_ocean_nesting": True, "nesting.nest_dynamic_vars": True,
        "nesting.outer_mesh": str(tmp / "nest" / "outer"), "nesting.nudge_timescale": 0.05,
        "nesting.nudge_lengthscale": 3.0, "tpu.dtype": "float64",
    }
    runs = {}
    for dev in ("cuda", "cpu"):
        s = Simulator(Config(overrides=over), device=dev)
        c0 = float(s.state.conc[2, 24])
        for _ in range(4):
            s.step()
        runs[dev] = s
    worst = 0.0
    n = 0
    for f in dataclasses.fields(runs["cpu"].state):
        r = getattr(runs["cpu"].state, f.name)
        if r is None:
            continue
        o = getattr(runs["cuda"].state, f.name)
        scale = float(r.abs().max())
        err = float((o.cpu() - r).abs().max())
        if o.device.type != "cuda" or not bool(torch.isfinite(o).all()) or err > 1e-12 * scale:
            raise AssertionError(f"nested f64 card vs CPU: {f.name} max |diff| {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / max(scale, 1e-300))
        n += 1
    pulled = float(runs["cuda"].state.conc[2, 24]) - c0
    if pulled < 0.01:
        raise AssertionError(f"nested run: the sponge moved conc by only {pulled:.3e}")
    phase("nesting", f"nested 48x40 toy (open boundary, ocean nesting, dynamic variables, thermo on), 4 steps, "
          f"f64 card vs CPU: {n} fields, worst |diff| / max|field| {worst:.3e} (limit 1e-12); sponge "
          f"pulled conc by {pulled:.3f}; {smi}")


# ---------------------------------------------------------------------------
# The wave path: FSD + WIM + coupler (phases 14-18)
# ---------------------------------------------------------------------------

WAVE_STEPS = 41  # 2 x nextwim.couplingfreq + 1: exchanges at steps 0, 20 and 40
WAVE_CFG = """\
# the wave path on top of configs/arctic_10km.cfg: the WIM on ERA-Interim
# waves, a 20-bin FSD with welding, breakup, damage feedback and FSD melt
[nextwim]
use_wim=true
couplingfreq=20
applywavestress=true
[wimsetup]
nwavefreq=25
nwavedirn=16
wave-type=eraiw_1deg
[wave_coupling]
num_fsd_bins=20
welding_type=roach
breakup_type=uniform_size
fsd_damage_type=1
[thermo]
melt_type=3
[moorings]
variables=conc
variables=thick
variables=velocity
variables=damage
variables=dmax
variables=dmean
variables=tauwix
variables=tauwiy
"""
COUPLED_STEPS = 21  # two coupler windows of 10 steps, and one step on the second get
LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
NOT_KERNELS = ("Memcpy", "Memset")  # entries on the card's side of a trace that are no kernel


def write_waves(d: Path) -> None:
    """The ERA-Interim wave file at its own grid (1 deg global, 181x360, north
    to south), 6-hourly records from 2015-10-15 18:00 to 2015-10-16 12:00: a
    2-5 m swell of 9-13 s travelling poleward with a slowly turning direction."""
    lats = np.linspace(90.0, -90.0, 181)
    lons = np.arange(360) * 1.0
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    lam, phi = np.deg2rad(lon2), np.deg2rad(lat2)
    stamps = ["2015-10-15 18:00:00", "2015-10-16 00:00:00", "2015-10-16 06:00:00", "2015-10-16 12:00:00"]
    hours = np.array([_hours_since_1900(st) for st in stamps])
    recs = [{"swh": 3.5 + 1.5 * np.sin(2.0 * lam + 0.3 * k) * np.cos(phi),
             "mwp": 11.0 + 2.0 * np.cos(lam - 0.2 * k),
             "mwd": np.mod(np.rad2deg(lam) + 180.0 + 20.0 * np.sin(3.0 * lam + 0.1 * k), 360.0)}
            for k in range(len(hours))]
    write_nc(d / "erai_waves_1deg_2015.nc", {"time": len(hours), "latitude": 181, "longitude": 360}, {
        "time": (("time",), hours, "hours since 1900-01-01 00:00:00.0"),
        "latitude": (("latitude",), lats.astype(np.float32), None),
        "longitude": (("longitude",), lons.astype(np.float32), None),
        **{v: (("time", "latitude", "longitude"), np.stack([r[v] for r in recs]).astype(np.float32), None)
           for v in recs[0]},
    })


def write_coupler_files(grid_file: Path, cpl_dir: Path):
    """An exchange grid (25 km polar-stereographic on another meridian than
    the model's, 260x260 points with its orientation angle ptheta) and the
    prescribed receive file ``cpl_in.nc`` on it: a breaking wavelength of
    120-200 m south of 82N (500 m, no breaking waves, beyond) and a wave
    stress of a few 0.01 N/m2 in that grid's own orientation."""
    from nextsim_tpu_torch.grid.projection import PolarStereo

    lon0 = -100.0
    proj = PolarStereo(lat0=90.0, lat_ts=60.0, lon0=lon0)
    x = -3250e3 + 25e3 * np.arange(260)
    plat, plon = (np.asarray(a) for a in proj.inverse(*np.meshgrid(x, x)))
    ptheta = np.full(plat.shape, np.deg2rad(lon0))
    dims = {"y": 260, "x": 260}
    write_nc(grid_file, dims, {"plat": (("y", "x"), plat, None), "plon": (("y", "x"), plon, None),
                               "ptheta": (("y", "x"), ptheta, None)})
    lam = np.deg2rad(plon)
    wlbk = np.where(plat < 82.0, 160.0 + 40.0 * np.sin(3.0 * lam), 500.0)
    write_nc(cpl_dir / "cpl_in.nc", dims, {
        "wlbk": (("y", "x"), wlbk.astype(np.float32), None),
        "tauwix": (("y", "x"), (0.03 * np.cos(lam)).astype(np.float32), None),
        "tauwiy": (("y", "x"), (0.02 * np.sin(2.0 * lam)).astype(np.float32), None),
    })
    return plat.shape


HOST_CALLS = LAUNCH_EVENTS + ("cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def host_calls(fn):
    """The CUDA runtime calls (kernel launches, graph launches, copies,
    memsets) of one synchronized call of ``fn`` under torch.profiler, by
    name, the calls it did not make left out; and its kernel launches by
    the top-level host operator that made them."""
    import torch

    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    counts = {e.key: e.count for e in prof.key_averages() if e.key in HOST_CALLS}
    launched_by = {}
    for e in prof.events():
        if e.name in LAUNCH_EVENTS:
            top = e
            while top.cpu_parent is not None:
                top = top.cpu_parent
            launched_by[top.name] = launched_by.get(top.name, 0) + 1
    return {name: counts[name] for name in HOST_CALLS if counts.get(name)}, launched_by


def profiled(fn, host_events=True):
    """(host wall s, device busy ms, launches) of one synchronized call of
    ``fn`` under torch.profiler; the wall time includes the profiler's cost.
    ``host_events=False`` records the card's
    side only: a call of 200,000 launches then takes the profiler seconds to
    digest, not a minute; launches are counted from the launch calls where
    the trace has them and from the kernels otherwise."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_events:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # the card's own entries (kernels and copies). An operator's entry on the
    # host side repeats the time of the kernels it launched: summing every
    # entry counts them twice
    on_card = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Command Buffer")]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    launches = sum(e.count for e in ka if e.key in LAUNCH_EVENTS) or sum(
        e.count for e in on_card if not e.key.startswith(NOT_KERNELS))
    if busy <= 0.0 or launches == 0:
        raise AssertionError(f"torch.profiler recorded no device activity ({len(ka)} entries, "
                             f"{len(on_card)} on the card: {[e.key[:40] for e in on_card[:5]]})")
    return wall, busy, launches


def timed_call(fn):
    """(host wall s synchronized, ms between CUDA events) of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    sync()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def cli_keep(args):
    """Run the CLI's entry point in this process; returns (its Simulator,
    kernel launches, wall s of the run loop with its outputs, the
    synchronized (wall s, event ms) of every WIM exchange, the host seconds
    of every forcing call)."""
    from nextsim_tpu_torch import __main__ as cli
    from nextsim_tpu_torch.model.simulator import Simulator
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda

    kept, exchanges, calls = {}, [], []
    run, exchange = Simulator.run, Simulator._wim_exchange

    def run_and_keep(self, *a, **kw):
        kept["sim"], kept["t_run"] = self, time.perf_counter()
        provider = self.forcing_provider

        def timed(t, t_init):
            c = time.perf_counter()
            out = provider(t, t_init)
            calls.append(time.perf_counter() - c)
            return out

        self.forcing_provider = timed
        try:
            return run(self, *a, **kw)
        finally:
            self.forcing_provider = provider

    def timed_exchange(self, forcing=None):
        _, wall, ms = timed_call(lambda: exchange(self, forcing))
        exchanges.append((wall, ms))

    Simulator.run, Simulator._wim_exchange = run_and_keep, timed_exchange
    momentum_cuda.launches = transport_cuda.launches = 0
    try:
        rc = cli.main(args)
        sync()
    finally:
        Simulator.run, Simulator._wim_exchange = run, exchange
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}")
    return kept["sim"], momentum_cuda.launches, time.perf_counter() - kept["t_run"], exchanges, calls


def _finite_state(state, what):
    """Raises when a field of ``state`` is not finite or checkFieldsFast
    flags it."""
    import dataclasses

    import torch

    from nextsim_tpu_torch.model import checks

    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is not None and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: {f.name} is not finite")
    viol = checks.violations(state).cpu().numpy()
    if viol.any():
        raise AssertionError(f"{what}: violations {checks.describe(viol)}")


def wave_cli_run(tmp: Path, out: Path, smi: str, dataset_ms: float):
    """Phase 14: the wave path at full width through the CLI; returns (sim,
    kernel launches)."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda
    from scipy.io import netcdf_file

    (tmp / "waves.cfg").write_text(WAVE_CFG)
    args = ["--device", "cuda", "--config-files", str(ROOT / "configs" / "arctic_10km.cfg"), str(tmp / "waves.cfg"),
            *DATASET_ARGS, f"simul.duration={WAVE_STEPS * STEP_DAYS_ARCTIC!r}", f"output.exporter_path={out}",
            "moorings.output_timestep=20", "moorings.output_time_step_units=time_steps",
            f"drifters.equally_spaced_drifters_output_time_step={20 * STEP_DAYS_ARCTIC!r}"]
    sim, launches, wall, exchanges, calls = cli_keep(args)
    transport_path("waves", transport_cuda.launches, WAVE_STEPS, fsd_stacks(sim.state))
    # the chunk divides every cadence: gcd(20 WIM, 20 moorings, 20 drifters, 432 snapshot) = 4
    if sim.pcpt != WAVE_STEPS or sim._chunk_k != 4:
        raise AssertionError(f"wave CLI ran {sim.pcpt} steps in chunks of {sim._chunk_k}")
    plan = momentum_cuda.launch_plan(*sim.grid.shape, sim.dyn.substeps, sim.dtype, "bbm")
    expect = len(plan.launches) * WAVE_STEPS
    if launches != expect or expect != momentum_cuda.launches_for(sim.dyn.substeps, *sim.grid.shape) * WAVE_STEPS:
        raise AssertionError(f"wave path: {launches} kernel launches, expected {expect}")
    if len(exchanges) != 3:
        raise AssertionError(f"wave path: {len(exchanges)} WIM exchanges, expected 3 (steps 0, 20, 40)")
    _finite_state(sim.state, "wave path")
    st = sim.state
    if tuple(sim.wim.sdf.shape) != (25, 16, 608, 608) or st.conc_fsd.shape[0] != 20:
        raise AssertionError(f"wave path: spectrum {tuple(sim.wim.sdf.shape)}, {st.conc_fsd.shape[0]} bins")

    # waves: Hs > 0 in open water and falling into the ice. The open water is
    # that of the first exchange, where the steady forcing holds the incident
    # spectrum: the dataset ocean starts at the freezing point under a cold
    # atmosphere, so young ice covers every cell within the 41 steps
    hs, ice = sim.wim_diag["hs"], sim.wim.ice
    ocean = sim.grid_arrays["mask"] > 0.5
    water = ocean & (sim.wim._steady_in[1] > 0.5)
    pack = ocean & (ice["conc"] > 0.9)
    hs_water, hs_pack = float(hs[water].mean()), float(hs[pack].mean())
    if not (bool(torch.isfinite(hs).all()) and hs_water > 0.5 and hs_pack < 0.25 * hs_water):
        bad = ~torch.isfinite(hs)
        raise AssertionError(f"wave path: mean Hs {hs_water:.3f} m in open water ({int(water.sum())} cells), {hs_pack:.3f} m "
                             f"in the pack ({int(pack.sum())} cells); {int(bad.sum())} cells not finite, "
                             f"{int((bad & water).sum())} of them open water, {int((bad & ~ocean).sum())} land")
    broken = ice["broken"] > 0.5
    n_broken = int(broken.sum())
    if n_broken == 0:
        raise AssertionError("wave path: the WIM broke no floes")
    # the FSD closes on the total concentration, and holds area below the
    # unbroken bin where the WIM broke floes
    ctot = st.conc + st.conc_young
    closure = float((st.conc_fsd.sum(0) - ctot).abs().max())
    if closure > 1e-5:
        raise AssertionError(f"wave path: |sum of bins - (conc + conc_young)| {closure:.3e} > 1e-5")
    small = st.conc_fsd[:-1].sum(0)
    # (a floe size of 150 m and more is a breaking wavelength that the bins'
    # centres, at most 205 m, do not feel: fsd.wave_breakup's lim_lambda)
    has = broken & (ctot > 0.05) & (ice["dfloe"] < 150.0)
    if int(has.sum()) == 0:
        raise AssertionError("wave path: no broken cell with floes below 150 m")
    frac_small = float((small[has] > 1e-3).float().mean())
    if frac_small < 0.9:
        raise AssertionError(f"wave path: only {frac_small:.2f} of the broken cells hold area below the last bin")
    tau = torch.hypot(*sim._wim_stress)
    if float(tau.max()) <= 0.0:
        raise AssertionError("wave path: the wave stress on the nodes is zero")
    moorings = sorted(out.glob("Moorings_*.nc"))
    if not moorings:
        raise AssertionError("wave path: no moorings file")
    with netcdf_file(moorings[0], "r", mmap=False) as nc:
        lsm = nc.variables["lsm"][:] > 0.5
        dmax = np.asarray(nc.variables["dmax"][:])
        tauwix = np.asarray(nc.variables["tauwix"][:])
        if dmax.shape[0] != 2 or not np.isfinite(dmax[:, lsm]).all() or float(dmax[:, lsm].max()) <= 0.0:
            raise AssertionError(f"wave moorings: dmax has {dmax.shape[0]} records, or is not finite, or is zero")
        if not np.isfinite(tauwix[:, lsm]).all() or float(np.abs(tauwix[:, lsm]).max()) <= 0.0:
            raise AssertionError("wave moorings: tauwix is not finite or zero")
        dmax_range = (float(dmax[-1][lsm & (dmax[-1] > 0)].min()), float(dmax[-1][lsm].max()))
    _all_finite(out / "restart" / "restart_final.npz", "wave final restart")
    with np.load(out / "restart" / "restart_final.npz") as z:
        if z["__wim_sdf"].shape != (25, 16, 608, 608) or z["conc_fsd"].shape != (20, 608, 608):
            raise AssertionError("wave final restart: no spectrum or no bins")

    ex_wall = sum(w for w, _ in exchanges)
    rest = (sim.timer.elapsed("step") - ex_wall - calls[0]) / (WAVE_STEPS - 1)
    phase("waves", f"arctic_10km.cfg 608^2 on ERA5 + TOPAZ4 + ETOPO + ERA-Interim waves, thermo on (melt_type 3), WIM 25 x 16 "
          f"(spectrum {sim.wim.sdf.numel() * 4 / 1e6:.0f} MB), 20 FSD bins with roach welding, uniform_size breakup and damage "
          f"feedback (the shipped defaults otherwise), through the CLI: {WAVE_STEPS} steps, {launches} kernel launches "
          f"({len(plan.launches)} a step, the plan's), run loop {wall:.1f} s; first forcing call {calls[0]:.1f} s, then "
          f"{1e3 * rest:.2f} ms/step (timer 'step' less that call and the exchanges, outputs included; phase 11: "
          f"{dataset_ms:.2f} ms/step) with forcing host time {1e3 * float(np.median(calls[1:])):.2f} ms/step (median); "
          f"3 WIM exchanges of {sim.wim_couplingfreq * sim.dt / sim.wim.dt_cfl:.1f} -> "
          f"{int(np.ceil(sim.wim_couplingfreq * sim.dt / sim.wim.dt_cfl))} spectral steps: wall "
          f"{[round(w, 3) for w, _ in exchanges]} s, between CUDA events {[round(ms, 1) for _, ms in exchanges]} ms; "
          f"mean Hs {hs_water:.3f} m on the {int(water.sum())} cells that were open water at the first exchange "
          f"({int((ocean & (ice['mask'] < 0.5)).sum())} are at the last: young ice has formed), {hs_pack:.4f} m where conc > 0.9; {n_broken} broken cells, "
          f"{frac_small:.3f} of the {int(has.sum())} with floes below 150 m hold area below the last bin; |sum of bins - ctot| max {closure:.2e}; "
          f"max |wave stress| {float(tau.max()):.4f} N/m2; moorings dmax {dmax_range[0]:.0f}..{dmax_range[1]:.0f} m; "
          f"zero violations; {smi}")
    return sim, launches


def wave_timings(sim, smi):
    """Wall time, device time and launches of one welding_roach, one FSD
    block and one model step on the phase-14 state, under torch.profiler;
    one WIM exchange under each of two frequency-block budgets between CUDA
    events (an exchange under the profiler, 200,821 launches, took 37-55 s
    of the run and is no longer made)."""
    import torch

    from nextsim_tpu_torch.ops import fsd as fsd_ops

    st, forcing = sim.state, sim.last_forcing
    if forcing.wlbk is None or forcing.tau_wi_u is None:
        raise AssertionError("wave path: the last forcing carries no wlbk or wave stress")
    took, t_last = {}, [time.perf_counter()]

    def lap(what):  # seconds of each part, the profiler's own work included
        took[what] = round(time.perf_counter() - t_last[0], 1)
        t_last[0] = time.perf_counter()

    ctot = st.conc + st.conc_young
    cf = fsd_ops.update_fsd(st.conc_fsd, ctot)
    freezing = sim.diag["del_hi"] > 0.0
    fp, fb = sim.fsd_params, sim.fsd_bins
    active = freezing & (cf[:-1].sum(0) > 0.01) & (cf.sum(0) > 0.1)
    fsd_ops.welding_roach(cf, sim.dt, fp, fb, freezing)  # warm
    weld = profiled(lambda: fsd_ops.welding_roach(cf, sim.dt, fp, fb, freezing))
    # the same call as a step would make it if every cell were freezing: all
    # cells with broken floes are active and run the loop
    everywhere = torch.ones_like(freezing)
    active_all = (cf[:-1].sum(0) > 0.01) & (cf.sum(0) > 0.1)
    if int(active_all.sum()) == 0:
        raise AssertionError("wave path: no cell holds enough broken area for welding to act on")
    welded = fsd_ops.welding_roach(cf, sim.dt, fp, fb, everywhere)
    if not bool(torch.isfinite(welded).all()) or torch.equal(welded, cf):
        raise AssertionError("wave path: welding under freezing everywhere changed nothing or is not finite")
    weld_all = profiled(lambda: fsd_ops.welding_roach(cf, sim.dt, fp, fb, everywhere), host_events=False)
    block = profiled(lambda: sim._fsd_block(st, forcing, dict(sim.diag)))
    # the card's side alone counts the same launches as the whole trace
    lean = profiled(lambda: sim._fsd_block(st, forcing, dict(sim.diag)), host_events=False)
    # (the same launches, and the same device time as far as 848 kernels of
    # ~2 us can be timed: a sum that counted them twice would be 2.0 times it)
    if lean[2] != block[2] or not 0.6 < lean[1] / block[1] < 1.6:
        raise AssertionError(f"FSD block: {block[2]} launches and {block[1]:.2f} ms of device time in the whole trace, "
                             f"{lean[2]} and {lean[1]:.2f} ms from the card's side alone")
    lap("welding and FSD block")
    # the frequencies of a spectral step go in blocks whose temporaries fit a
    # memory budget (2 GiB: 3 frequencies here); beside it all 25 in one
    # block (a budget of 16 GiB), once each
    from nextsim_tpu_torch.wim import wim as wim_mod

    budget, blocks, block_ms = wim_mod._BLOCK_BYTES, {}, {"2 GiB": [], "16 GiB": []}
    try:
        for name, nbytes in (("16 GiB", 16 << 30), ("2 GiB", budget)):
            wim_mod._BLOCK_BYTES = nbytes
            blocks[name] = wim_mod._freq_block(sim.wim.sdf)
            block_ms[name].append(timed_call(lambda: sim._wim_exchange(forcing))[2])
    finally:
        wim_mod._BLOCK_BYTES = budget
    if budget != 2 << 30 or not blocks["16 GiB"] > blocks["2 GiB"]:
        raise AssertionError(f"WIM frequency blocks: {blocks} with a budget of {budget} bytes")
    lap("2 exchanges")
    if sim.pcpt % sim.wim_couplingfreq == 0:
        raise AssertionError(f"wave path: step {sim.pcpt} would run an exchange inside the step's profile")
    sim.step_chunk_eager(1)  # warm
    step = profiled(lambda: sim.step_chunk_eager(1))
    lap("2 steps")
    fmt = lambda r: f"{r[0]:.3f} s wall, {r[1]:.1f} ms device, {r[2]} launches"  # noqa: E731
    phase("waves", f"on the phase-14 state, one call each under torch.profiler (its cost is in the wall time): "
          f"welding_roach with the step's own freezing mask ({int(active.sum())} active cells): {fmt(weld)}; "
          f"welding_roach with every cell freezing ({int(active_all.sum())} active cells, loop to the cap of "
          f"{fsd_ops.WELDING_NDT_MAX} substeps): {fmt(weld_all)}; "
          f"the FSD block of a step (rescale, welding, breakup, damage, diagnostics): {fmt(block)}; "
          f"one model step between two exchanges (forcing, thermo, FSD block, momentum, transport of 40 more planes; "
          f"eager): {fmt(step)}; one WIM exchange (medium, "
          f"{int(np.ceil(sim.wim_couplingfreq * sim.dt / sim.wim.dt_cfl))} spectral steps, breaking, stress to nodes) "
          f"between CUDA events, no profiler, with {blocks['2 GiB']} frequencies a block (the module's 2 GiB of "
          f"temporaries): {[round(ms, 1) for ms in block_ms['2 GiB']]} ms, with {blocks['16 GiB']} a block (16 GiB): "
          f"{[round(ms, 1) for ms in block_ms['16 GiB']]} ms (the larger first); "
          f"seconds these measurements took: {took}; {smi}")


def wave_kernel_vs_plain(sim):
    """Phase 15: the kernel against its plain version on the wave state, with
    the wave stress non-zero on the nodes; bitwise in both precisions."""
    import torch

    from nextsim_tpu_torch.ops import momentum

    p, forcing = sim.dyn, sim.last_forcing
    n_tau = int((torch.hypot(forcing.tau_wi_u, forcing.tau_wi_v) > 0).sum())
    if n_tau == 0:
        raise AssertionError("wave state: the wave stress is zero on every node")
    errs = {}
    for dtype_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        state = _cast_tree(sim.state, dt)
        ga = {k: (v.to(dt) if isinstance(v, torch.Tensor) else v) for k, v in sim.grid_arrays.items()}
        ga["cohesion"] = sim.c_fix + sim.c_alea * state.random_number
        f = _cast_tree(forcing, dt)
        consts, carry = momentum.substep_setup(state, f, ga, sim.dt, p)
        without = momentum.substep_setup(state, f.replace(tau_wi_u=None, tau_wi_v=None), ga, sim.dt, p)[0]
        if torch.equal(consts.tau_ax, without.tau_ax):
            raise AssertionError("wave state: the wave stress does not reach the kernel's forcing term")
        for steps in (3, 120):
            errs[(dtype_name, steps)] = compare(f"608^2 wave state bbm {dtype_name} {steps} substeps", sim,
                                                "bbm", steps, dtype_name, setup=(consts, carry, p))
    phase("waves", f"kernel vs plain on the phase-14 state: wave stress non-zero on {n_tau} nodes and in the kernel's "
          f"forcing term; max |dvel| f32 {errs[('float32', 120)]:.3e}, f64 {errs[('float64', 120)]:.3e} over 120 substeps")
    return errs[("float32", 120)]


WELDING_DTYPES = ("float32", "float64", "bfloat16")
# the paths that weld, and what each is: the wave path through the CLI
# (phase 14, its chunks captured), its 20-step chunk in turns with the eager
# loop (phase 14's end), the coupled run (phase 17), the batched welding
# ensemble (phase 19), the wave path on a 2x2 mesh (phase 25, summed over
# the ranks)
WELDING_PATHS = {"wave": "phase 14", "wave_graph": "phase 14, the captured chunk", "coupled": "phase 17",
                 "ensemble_welding": "phase 19", "mesh_waves": "phase 25"}
# operations of one cell and substep that the welding function needs: the
# suffix sums (nbins), the lead terms (2 nbins), one division for each merge
# bin (the pair's width is its merge bin's), 4 for each pair whose merge bin
# is defined (times the offset, plus the suffix sum, times the lead, into
# coag; an undefined one adds zero), the update (4 nbins)
def welding_ops(bins, nbins: int) -> int:
    from nextsim_tpu_torch.ops.fsd import welding_pairs

    merge, _, _, valid = welding_pairs(bins, nbins)
    defined = [a for a, ok in zip(merge, valid) if ok]
    return 7 * nbins + len(set(defined)) + 4 * len(defined)


def welding_bound_ms(cf, freezing, dt: float, p, bins):
    """The least time an H100 could take for one welding call on this
    stack: (bound_ms, "bytes" or "operations", bytes_ms, operations_ms,
    active cells). Bytes: the stack read and written once and the mask read
    once (the two sums follow from the stack). Operations: ``welding_ops``
    for every substep that an active cell runs (its own count, from this
    call's data), at the float64 rate for float64, the float32 rate for
    float32 and the bfloat16 rate for bfloat16 (every operation of a substep
    has bfloat16 operands there)."""
    import torch

    from nextsim_tpu_torch.ops.fsd import WELDING_NDT_MAX

    ctot, c_broken = cf.sum(0).double(), cf[:-1].sum(0).double()
    active = freezing & (c_broken > 0.01) & (ctot > 0.1)
    ndt = torch.clamp(torch.ceil(dt * p.welding_kappa * ctot * float(bins.scaled_up[-1]) + 0.5), 1, WELDING_NDT_MAX)
    substeps = float(ndt[active].sum())
    n_bytes = 2 * cf.numel() * cf.element_size() + freezing.numel()
    rate = {torch.float64: H100_F64_OPS_PER_S, torch.bfloat16: H100_BF16_OPS_PER_S}.get(cf.dtype, H100_F32_OPS_PER_S)
    ops_ms = 1e3 * substeps * welding_ops(bins, p.num_bins) / rate
    bytes_ms = 1e3 * n_bytes / H100_BYTES_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms else "operations"), bytes_ms, ops_ms, int(active.sum())


def same_bits(a, b) -> bool:
    """Equal values, and NaN in the same places."""
    import torch

    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0))


def welding_kernel_phase(sim, smi) -> dict:
    """Phase 16's welding: the kernel (csrc/welding_roach.cu) against
    ``welding_roach_reference`` on the phase-14 608^2 x 20-bin state,
    bitwise, in float32, float64 and bfloat16, with the step's own freezing
    mask, with every cell freezing (every active cell to the cap of 256
    substeps), and with broken floes spread from a numpy seed over every
    ice cell under the step's own mask (the run breaks floes at the ice
    edge, where the ice melts: its own mask meets few broken cells or none);
    each the kernel's CUDA-event time, launches and bound beside the plain
    version's time. Returns the float32 every-cell record for the JSON."""
    import torch

    from nextsim_tpu_torch.ops import fsd as fsd_ops
    from nextsim_tpu_torch.ops import welding_cuda

    st = sim.state
    ctot = st.conc + st.conc_young
    cf = fsd_ops.update_fsd(st.conc_fsd, ctot)
    own = sim.diag["del_hi"] > 0.0
    w = torch.as_tensor(np.random.default_rng(16).uniform(0.0, 1.0, tuple(cf.shape)), dtype=cf.dtype, device="cuda")
    spread = w / w.sum(0) * cf.sum(0)
    cases = {"own mask": (cf, own), "every cell freezing": (cf, torch.ones_like(own)),
             "spread floes, own mask": (spread, own)}
    fp, fb = sim.fsd_params, sim.fsd_bins
    recs, lines = {}, []
    for label, (stack, freezing) in cases.items():
        for dtype_name in WELDING_DTYPES:
            x = stack.to(getattr(torch, dtype_name)).contiguous()
            launches = welding_cuda.launches
            out = fsd_ops.welding_roach(x, sim.dt, fp, fb, freezing)
            if welding_cuda.launches != launches + welding_cuda.LAUNCHES_A_CALL:
                raise AssertionError(f"welding {label} {dtype_name}: {welding_cuda.launches - launches} launches")
            ref, plain_wall, plain_ms = timed_call(lambda: fsd_ops.welding_roach_reference(x, sim.dt, fp, fb, freezing))
            bound_ms, bound_by, bytes_ms, ops_ms, active = welding_bound_ms(x, freezing, sim.dt, fp, fb)
            if not same_bits(out, ref):
                bad = int((out != ref).sum())
                raise AssertionError(f"welding {label} {dtype_name}: the kernel differs from the plain version in {bad} "
                                     f"values ({active} active cells)")
            err = float((out.double() - ref.double()).nan_to_num(0.0, 0.0, 0.0).abs().max())
            ms = event_ms(lambda: fsd_ops.welding_roach(x, sim.dt, fp, fb, freezing), reps=5)
            recs[(label, dtype_name)] = {"ms": ms, "plain_ms": plain_ms, "plain_wall_s": plain_wall, "max_abs_err": err,
                                         "bound_ms": bound_ms, "bound_by": bound_by, "active": active,
                                         "changed": not torch.equal(out, x)}
            lines.append(f"{label} {dtype_name}: {active} active cells, kernel {ms:.4f} ms in one call, plain "
                         f"{plain_ms:.1f} ms; bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f}, "
                         f"operations {ops_ms:.4f}), {100 * bound_ms / ms:.1f}% of it")
    for label in ("every cell freezing", "spread floes, own mask"):
        if recs[(label, "float32")]["active"] == 0 or not recs[(label, "float32")]["changed"]:
            raise AssertionError(f"welding {label}: no active cell, or nothing welded")
    # ptxas of the build this process made (at the wave run's first step)
    ptxas = [ln.strip() for ln in welding_cuda.build_log.splitlines() if "registers" in ln or "spill" in ln]
    phase("welding", f"the welding kernel against the plain version on the phase-14 608^2 x {fp.num_bins}-bin state, "
          f"bitwise in every dtype and case (NaN in the same places): {'; '.join(lines)}; ptxas (both kernels, "
          f"each dtype): {' | '.join(ptxas) or 'cached'}; {smi}")
    rec = dict(recs[("every cell freezing", "float32")])
    rec["by_case"] = {f"{label}, {d}": r for (label, d), r in recs.items()}
    return rec


WAVE_CHUNK = 20  # a coupling window: the captured chunk between two WIM exchanges


def wave_captured(sim, smi) -> dict:
    """Phase 14's end: the wave path's Simulator (no eager reason now), one
    WAVE_CHUNK-step chunk between WIM exchanges from one state, in turns:
    ``step_chunk_eager`` (the oracle), ``step_chunk`` (its first call runs
    the program eagerly and captures it), then captured, eager; every
    result bitwise equal to the first eager one; ms/step of the second call
    of each (host wall, synchronized), the graph's nodes, capture and
    instantiation seconds, pool, and both kernels' launches a replay."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda, welding_cuda

    if sim.eager_reason is not None:
        raise AssertionError(f"wave path: still eager: {sim.eager_reason}")
    k = WAVE_CHUNK
    state0, pcpt0, last0 = sim.state, sim.pcpt, sim._wim_last_pcpt
    if last0 is None or pcpt0 - last0 >= sim.wim_couplingfreq:
        raise AssertionError(f"wave path: a chunk from step {pcpt0} would start with a WIM exchange")

    def run(mode):
        sim.state, sim.pcpt, sim._wim_last_pcpt, sim._pending_viol = state0, pcpt0, last0, None
        sync()
        counts = (momentum_cuda.launches, welding_cuda.launches)
        t0 = time.perf_counter()
        (sim.step_chunk if mode == "captured" else sim.step_chunk_eager)(k)
        sync()
        return (time.perf_counter() - t0, sim.state,
                (momentum_cuda.launches - counts[0], welding_cuda.launches - counts[1]))

    _, ref, _ = run("eager")
    first_s, got, _ = run("captured")
    stats = dict(sim._program.stats)
    walls, outs, replay = {"eager": [], "captured": []}, [got], None
    for mode in ("captured", "eager"):
        wall, out, launches = run(mode)
        walls[mode].append(wall)
        outs.append(out)
        if mode == "captured":
            replay = launches
    for n, out in enumerate(outs):
        for f in ref.__dataclass_fields__:
            a, b = getattr(ref, f), getattr(out, f)
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"wave path: run {n}: {f} of the captured chunk is not the eager loop's bitwise")
    per_loop = momentum_cuda.launches_for(sim.dyn.substeps, *sim.grid.shape)
    if replay != (k * per_loop, k * welding_cuda.LAUNCHES_A_CALL) or (
            stats["kernel_launches"], stats["welding_launches"]) != replay:
        raise AssertionError(f"wave path: a replay launched {replay}, its graph holds {stats}")
    ms = {mode: 1e3 * min(w) / k for mode, w in walls.items()}
    phase("waves", f"the wave path captured: {k}-step chunks between WIM exchanges from step {pcpt0}, in turns "
          f"eager, captured, captured, eager: eager {ms['eager']:.2f} ms/step "
          f"({[round(1e3 * w / k, 2) for w in walls['eager']]}), captured {ms['captured']:.2f} ms/step "
          f"({[round(1e3 * w / k, 2) for w in walls['captured']]}; host wall, synchronized); the graph: "
          f"{stats['nodes']} nodes, capture {stats['capture_s']:.2f} s, instantiation {stats['instantiate_s']:.2f} s, "
          f"pool {stats['pool_bytes'] / 2**20:.1f} MiB; a replay launches the substep kernel {replay[0]} times and the "
          f"welding kernel {replay[1]} times; first call (eager warm-up + capture) {first_s:.2f} s; bitwise equal to "
          f"the eager loop in {len(outs)} runs; {smi}")
    sim.state, sim.pcpt, sim._wim_last_pcpt = state0, pcpt0, last0
    return {"ms_eager": ms["eager"], "ms_captured": ms["captured"], "walls": walls, "first_call_s": first_s,
            "replay_launches": replay[0], "replay_welding_launches": replay[1],
            **{key: stats[key] for key in ("nodes", "capture_s", "instantiate_s", "pool_bytes")}}


def _worst_rel(got: dict, ref: dict, what: str, limit=1e-12) -> float:
    import torch

    worst = 0.0
    for name, r in ref.items():
        o = got[name]
        if o.device.type != "cuda":
            raise AssertionError(f"{what}: {name} is not on the card")
        r = r.to(torch.float64)
        scale = float(r.abs().max())
        err = float((o.cpu().to(torch.float64) - r).abs().max())
        if not bool(torch.isfinite(o).all()) or err > limit * scale:
            raise AssertionError(f"{what}: {name} max |diff| {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / max(scale, 1e-300))
    return worst


def waves_vs_cpu(sim, smi):
    """Phase 16: in float64, one ``Wim.run`` over a coupling window and one
    FSD block, on the card against the CPU (1e-12 of each field's magnitude).
    The WIM runs the full 25 x 16 spectrum on every 4th cell of the phase-14
    ice and wave fields (152^2 at 40 km); the FSD block runs at 608^2."""
    import torch

    from nextsim_tpu_torch.grid.grid import Grid
    from nextsim_tpu_torch.wim import Wim

    f64 = torch.float64
    sub = lambda a: a[::4, ::4].contiguous()  # noqa: E731
    g = sim.grid
    grid = Grid(nx=152, ny=152, dx=4 * g.dx, x0=g.x0, y0=g.y0, mask=np.ascontiguousarray(g.mask[::4, ::4]),
                open_mask=np.zeros((152, 152), np.float32), projection=g.projection)
    st, forcing = sim.state, sim.last_forcing
    conc, vol = sub(st.conc + st.conc_young), sub(st.thick + st.h_young)
    # the incident waves enter where the run's first exchange had open water
    wave_mask = sub(sim.wim._steady_in[1])
    runs = {}
    for dev in ("cuda", "cpu"):
        w = Wim(sim.wim.p, grid, f64, device=dev)
        on = lambda a: a.to(device=dev, dtype=f64)  # noqa: E731
        w.set_ice_fields(on(conc), on(vol), on(sub(sim._wim_nfloes)))
        w.set_wave_fields(on(sub(forcing.swh)), on(sub(forcing.mwp)), on(sub(forcing.mwd)), wave_mask=on(wave_mask))
        diag = w.run(sim.wim_couplingfreq * sim.dt)
        runs[dev] = {**diag, **{"ice_" + k: v for k, v in w.ice.items()}, "sdf": w.sdf}
    if float(runs["cpu"]["ice_broken"].sum()) == 0 or float(runs["cpu"]["hs"].max()) < 0.5:
        raise AssertionError("WIM f64 card vs CPU: no breaking or no waves on the subsampled grid")
    worst_wim = _worst_rel(runs["cuda"], runs["cpu"], "Wim.run f64 card vs CPU")

    blocks = {}
    for dev in ("cuda", "cpu"):
        state = _cast_tree(st, f64, dev)
        diag = {"del_hi": sim.diag["del_hi"].to(device=dev, dtype=f64)}
        f = forcing.replace(wlbk=forcing.wlbk.to(device=dev, dtype=f64))
        out = sim._fsd_block(state, f, diag)  # reads sim's parameters, bins and dt only
        blocks[dev] = {"conc_fsd": out.conc_fsd, "conc_mech_fsd": out.conc_mech_fsd, "damage": out.damage,
                       "dmax": diag["dmax"], "dmean": diag["dmean"]}
    worst_fsd = _worst_rel(blocks["cuda"], blocks["cpu"], "FSD block f64 card vs CPU")
    phase("waves", f"f64 card vs CPU: Wim.run over one coupling window (25 x 16 on 152^2 at 40 km, "
          f"{int(runs['cpu']['ice_broken'].sum())} broken cells): {len(runs['cpu'])} fields, worst |diff| / max|field| "
          f"{worst_wim:.3e}; one FSD block at 608^2 (welding, breakup, damage): {len(blocks['cpu'])} fields, worst "
          f"{worst_fsd:.3e} (limit 1e-12); {smi}")


def coupled_run(tmp: Path, out: Path, smi: str):
    """Phase 17: the coupled run (``coupler.with_waves``), through
    ``Simulator.run`` in chunks of the configuration's
    ``tpu.steps_per_call`` as ``run`` clamps it (10 -> 2: it divides the
    10-step coupler window and the 432-step snapshot interval), each one
    replay of the captured chunk program (the last step one of the step
    program):
    every call of the program is run again eagerly (``_chunk_body``) from
    the same inputs and must equal it bitwise, state, diag and the
    coupler's sums included; the put files hold the window means that the
    device accumulated, against the host's means of the eager steps; the
    received wlbk breaks floes. Returns the kernel's launches."""
    import torch

    from nextsim_tpu_torch import Config, Simulator
    from nextsim_tpu_torch.coupling.exchange import Coupler
    from nextsim_tpu_torch.forcing.netcdf_io import NCFile
    from nextsim_tpu_torch.model.captured import flatten
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda, welding_cuda

    eg_shape = write_coupler_files(tmp / "exchange_grid.nc", out / "coupler")
    over = {k: v for k, v in (a.split("=", 1) for a in DATASET_ARGS)}
    over.update({
        # (half a step more: the step count is the duration's integer part)
        "simul.duration": (COUPLED_STEPS + 0.5) * STEP_DAYS_ARCTIC, "output.exporter_path": str(out),
        "coupler.with_waves": "true", "coupler.timestep": 2000, "coupler.exchange_grid_file": str(tmp / "exchange_grid.nc"),
        "wave_coupling.num_fsd_bins": 20, "wave_coupling.welding_type": "roach", "wave_coupling.fsd_damage_type": 1,
        "thermo.melt_type": 3, "moorings.use_moorings": "false", "drifters.use_equally_spaced_drifters": "false",
    })
    cfg = Config.from_files(str(ROOT / "configs" / "arctic_10km.cfg"), overrides=over)
    sim = Simulator(cfg)  # the default device: the card
    if sim.device.type != "cuda" or sim.coupler is None or sim.coupler.exchange_grid is None:
        raise AssertionError("coupled run: not on the card, or no coupler on the exchange grid")

    # each call of the program run again eagerly from its inputs; the eager
    # steps' sent fields summed on the host, beside the device's sums
    host = {"sum": {}, "n": 0, "means": [], "replays": []}
    program, extract, write_put = sim._program, sim._extract, Coupler._write_put

    def extract_to_host(state, diag, forcing):
        for name, t in (("conc", state.conc), ("taux", diag["tau_wx"]), ("tauy", diag["tau_wy"])):
            host["sum"][name] = host["sum"].get(name, 0.0) + t.cpu().numpy().astype(np.float64)
        host["n"] += 1
        return extract(state, diag, forcing)

    def checked_program(*args):
        graphs = len(program.graphs)
        got = program(*args)
        # the eager run is the check's, not the path's
        counts = (momentum_cuda.launches, welding_cuda.launches, transport_cuda.launches)
        sim._extract = extract_to_host
        try:
            with torch.no_grad():
                want = sim._chunk_body(*args)
        finally:
            sim._extract = extract
        momentum_cuda.launches, welding_cuda.launches, transport_cuda.launches = counts
        (gl, gd), (wl, wd) = flatten(got), flatten(want)
        if gd != wd or not all(same_bits(x, y) for x, y in zip(gl, wl)):
            raise AssertionError(f"coupled run: a {len(args[1])}-step program call differs from its eager body")
        if len(program.graphs) == graphs:
            host["replays"].append(len(args[1]))
        return got

    def write_put_and_close(self, tag):
        write_put(self, tag)
        host["means"].append((tag, {k: v / host["n"] for k, v in host["sum"].items()}, host["n"]))
        host["sum"], host["n"] = {}, 0

    sim._program, Coupler._write_put = checked_program, write_put_and_close
    momentum_cuda.launches = transport_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        sim.run()
        sync()
    finally:
        sim._program, Coupler._write_put = program, write_put
    wall = time.perf_counter() - t0
    k = sim._chunk_k
    if sim.eager_reason is not None or k < 2 or k not in host["replays"]:
        raise AssertionError(f"coupled run: no replay of a multi-step chunk ({sim.eager_reason}, {k} steps a call, "
                             f"replays {host['replays']})")
    launches = momentum_cuda.launches
    transport_path("coupled", transport_cuda.launches, COUPLED_STEPS, fsd_stacks(sim.state))
    expect = momentum_cuda.launches_for(sim.dyn.substeps, *sim.grid.shape) * COUPLED_STEPS
    if (sim.pcpt != COUPLED_STEPS or launches != expect
            or welding_cuda.launches != COUPLED_STEPS * welding_cuda.LAUNCHES_A_CALL):
        raise AssertionError(f"coupled run: {sim.pcpt} steps, {launches} kernel launches, expected {expect}, "
                             f"{welding_cuda.launches} welding launches")
    _finite_state(sim.state, "coupled run")
    puts = sorted((out / "coupler").glob("cpl_out_*.nc"))
    if len(puts) != 2 or len(host["means"]) != 2:
        raise AssertionError(f"coupled run: {len(puts)} put files, {len(host['means'])} windows")
    eg = sim.coupler.exchange_grid
    worst = 0.0
    for path, (tag, means, n) in zip(puts, host["means"]):
        if n != 10 or tag not in path.name:
            raise AssertionError(f"coupled run: window {tag} of {n} steps against {path.name}")
        want = {"conc": eg["cell_interp"](means["conc"])}
        u, v = eg["node_interp"](means["taux"]), eg["node_interp"](means["tauy"])
        want["taux"], want["tauy"] = eg["cos"] * u - eg["sin"] * v, eg["sin"] * u + eg["cos"] * v
        with NCFile(str(path)) as nc:
            for name, w in want.items():
                got = np.asarray(nc.variables[name][:], np.float32)
                w = w.astype(np.float32)
                err = float(np.abs(got - w).max())
                if got.shape != eg_shape or not np.isfinite(got).all() or err > 1e-6 * float(np.abs(w).max()):
                    raise AssertionError(f"coupled put {path.name}: {name} differs from the host's mean by {err:.3e}")
                worst = max(worst, err)
            if float(np.abs(nc.variables["conc"][:]).max()) < 0.5:
                raise AssertionError(f"coupled put {path.name}: no ice in the sent conc")
    # the get: wlbk on the cells, the stress on the nodes, and broken floes
    rec = sim.coupler._received
    if set(rec) != {"wlbk", "tau_wi_u", "tau_wi_v"} or any(t.device.type != "cuda" for t in rec.values()):
        raise AssertionError(f"coupled get: received {sorted(rec)}")
    f = sim.last_forcing
    if tuple(f.wlbk.shape) != sim.grid.shape or tuple(f.tau_wi_u.shape) != sim.grid.node_shape:
        raise AssertionError("coupled get: wlbk or the wave stress has the wrong shape")
    st = sim.state
    ctot = st.conc + st.conc_young
    breaking = (f.wlbk < 300.0) & (ctot > 0.05)
    small = st.conc_fsd[:-1].sum(0)
    frac = float((small[breaking] > 1e-3).float().mean())
    quiet = (f.wlbk >= 499.0) & (ctot > 0.05)
    leaked = float(small[quiet].max()) if bool(quiet.any()) else 0.0
    if int(breaking.sum()) == 0 or frac < 0.9:
        raise AssertionError(f"coupled get: {int(breaking.sum())} cells under breaking waves, {frac:.2f} of them broken")
    closure = float((st.conc_fsd.sum(0) - ctot).abs().max())
    if closure > 1e-5:
        raise AssertionError(f"coupled run: |sum of bins - ctot| {closure:.3e}")
    phase("coupled", f"arctic_10km.cfg 608^2, coupler.with_waves on a {eg_shape[0]}x{eg_shape[1]} exchange grid with a prescribed "
          f"cpl_in.nc (wlbk, tauwix, tauwiy), 20 FSD bins, Simulator.run on the default device in {k}-step "
          f"chunks (tpu.steps_per_call {cfg['tpu.steps_per_call']}, clamped): {COUPLED_STEPS} steps in {wall:.1f} s (each program call run again eagerly, included), {launches} "
          f"kernel launches; graph replays of {host['replays']} steps, every program call bitwise its eager body "
          f"(state, diag, the coupler's sums); 2 puts of 10-step means (conc, taux, tauy remapped and rotated) "
          f"equal the host's means of the eager steps within {worst:.1e} (limit 1e-6 of the field); received wlbk < 300 m on "
          f"{int(breaking.sum())} ice cells, {frac:.3f} of them with area below the last bin, most broken area where "
          f"no breaking waves were received {leaked:.2e}; zero violations; {smi}")
    return launches


def standalone_wim(tmp: Path, smi: str):
    """Phase 18: ``python -m nextsim_tpu_torch.wim --device cuda`` with its
    defaults, as a subprocess; its summary line."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "nextsim_tpu_torch.wim", "--device", "cuda", "--out", str(tmp / "wim_out.npz")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"standalone WIM exited {r.returncode}: {r.stderr[-800:]}")
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    with np.load(tmp / "wim_out.npz") as z:
        hs, broken, mask = z["hs"], z["ice_broken"], z["ice_mask"]
    if not (np.isfinite(hs).all() and summary["hs_max"] > 2.0 and broken.sum() > 0
            and summary["dmax_min_in_ice"] < 300.0 and hs[5, -1] < 0.1 * hs[5].max() and (broken <= mask).all()):
        raise AssertionError(f"standalone WIM: {summary}")
    phase("wim", f"python -m nextsim_tpu_torch.wim --device cuda (150x10 at 4 km, 1 x 16 spectrum, 6 h) in "
          f"{time.perf_counter() - t0:.1f} s with the process's start: {json.dumps(summary)}; {int(broken.sum())} broken cells; {smi}")


def wave_phases(tmp: Path, smi: str, dataset_ms: float, path_launches: dict, weld_launches: dict):
    """Phases 14-17 (NEXTSIM_DATA_DIR set, the wave file written): the wave
    path through the CLI, its captured chunk, the kernel on its state, card
    against CPU, the timings, the welding kernel, the coupled run. Adds the
    substep kernel's launches of the paths to ``path_launches`` and the
    welding kernel's to ``weld_launches``; returns (the substep kernel's
    error on the wave state, the welding record, the captured wave record,
    the wave state as host arrays)."""
    from nextsim_tpu_torch import state_to_numpy
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda, welding_cuda

    welding_cuda.launches = 0
    sim, path_launches["waves"] = wave_cli_run(tmp, tmp / "wave_run", smi, dataset_ms)
    weld_launches["wave"] = welding_cuda.launches
    if weld_launches["wave"] != WAVE_STEPS * welding_cuda.LAUNCHES_A_CALL:
        raise AssertionError(f"wave path: {weld_launches['wave']} welding launches in {WAVE_STEPS} steps")
    wave_err = wave_kernel_vs_plain(sim)
    waves_vs_cpu(sim, smi)
    wave_timings(sim, smi)
    weld_rec = welding_kernel_phase(sim, smi)
    momentum_cuda.launches = welding_cuda.launches = transport_cuda.launches = 0
    wave_rec = wave_captured(sim, smi)
    path_launches["wave_graph"], weld_launches["wave_graph"] = momentum_cuda.launches, welding_cuda.launches
    # the chunks' steps: those of the substep kernel's launches
    per_loop = momentum_cuda.launches_for(sim.dyn.substeps, *sim.grid.shape)
    transport_path("wave_graph", transport_cuda.launches, momentum_cuda.launches // per_loop, fsd_stacks(sim.state))
    wave_state = state_to_numpy(sim.state)
    del sim
    welding_cuda.launches = 0
    path_launches["coupled"] = coupled_run(tmp, tmp / "coupled_run", smi)
    weld_launches["coupled"] = welding_cuda.launches
    return wave_err, weld_rec, wave_rec, wave_state


# ---------------------------------------------------------------------------
# Ensembles and validation (phases 19-22)
# ---------------------------------------------------------------------------

ENSEMBLE_MEMBERS = 4  # the control and 3 perturbed members
ENSEMBLE_STEPS = 12


def _ensemble_snapshot(ens):
    """What a step of ``ens`` changes: (its stack, cloned; the AR(1) carry;
    the member generators' states; the step count)."""
    import dataclasses

    return ({f.name: getattr(ens.states, f.name).clone() for f in dataclasses.fields(ens.states)
             if getattr(ens.states, f.name) is not None},
            None if ens._ran is None else ens._ran.clone(), [g.get_state() for g in ens.generators], ens.pcpt)


def _ensemble_restore(ens, snap) -> None:
    states, ran, gens, pcpt = snap
    ens.states = ens.states.replace(**{k: v.clone() for k, v in states.items()})
    ens._ran = None if ran is None else ran.clone()
    for g, st in zip(ens.generators, gens):
        g.set_state(st)
    ens.pcpt = pcpt


def ensemble_run(tmp: Path, smi: str, dataset_ms: float):
    """Phase 19: ``BatchedEnsemble`` on configs/arctic_10km.cfg with ERA5 +
    TOPAZ4 + ETOPO (the phase-11 files), 4 members for 12 steps, every step
    twice from the same state, in turns: the batched step (one replay of
    its CUDA graph, the substep kernel launched once for all members) and
    the member loop ``step_members`` (eager), every member equal bitwise;
    then a checkpoint at step 6 resumed into the same object. Returns (the
    ensemble, the kernel's launches in the batched steps and in the member
    loop's, every member's state after MESH_ENSEMBLE_STEPS steps as host
    arrays for phase 26, the numbers for the JSON record)."""
    import dataclasses

    import torch

    from nextsim_tpu_torch import Config, state_to_numpy
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble
    from nextsim_tpu_torch.model import checks
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda
    from scipy.io import netcdf_file

    out = tmp / "ensemble_run"
    overrides = dict(a.split("=", 1) for a in DATASET_ARGS)
    overrides.update({"output.exporter_path": str(out), "moorings.output_timestep": 6,
                      "moorings.output_time_step_units": "time_steps", "output.async_io": False})
    cfg = Config.from_files(str(ROOT / "configs" / "arctic_10km.cfg"), overrides=overrides)
    t0 = time.perf_counter()
    ens = BatchedEnsemble(cfg, ENSEMBLE_MEMBERS, device="cuda")
    init_s = time.perf_counter() - t0
    if ens.sim.eager_reason is not None:
        raise AssertionError(f"ensemble: the batched step is not captured: {ens.sim.eager_reason}")
    half = ENSEMBLE_STEPS // 2
    ny, nx = ens.sim.grid.shape
    substeps = ens.sim.dyn.substeps
    plan_of = (ens.sim.dtype, ens.sim.dyn.dynamics_type)
    per_batched = momentum_cuda.launches_for(substeps, ny, nx, *plan_of, members=ENSEMBLE_MEMBERS)
    per_loop = momentum_cuda.launches_for(substeps, ny, nx, *plan_of)
    counts = {"batched": 0, "loop": 0}
    transport = {"batched": 0, "loop": 0}
    ms = {"batched": [], "loop": []}

    def loop_step():
        # the member loop from the batched step's start: the statistics
        # record of the step is the batched step's to write
        moor, ens.sim.moorings = ens.sim.moorings, None
        try:
            ens.step_members()
        finally:
            ens.sim.moorings = moor

    def timed(mode):
        momentum_cuda.launches = transport_cuda.launches = 0
        a = time.perf_counter()
        (ens.step if mode == "batched" else loop_step)()
        sync()
        ms[mode].append(1e3 * (time.perf_counter() - a))
        counts[mode] += momentum_cuda.launches
        transport[mode] += transport_cuda.launches

    def both(i):
        start = _ensemble_snapshot(ens)
        order = ("batched", "loop") if i % 2 == 0 else ("loop", "batched")
        timed(order[0])
        first = _ensemble_snapshot(ens)
        _ensemble_restore(ens, start)
        timed(order[1])
        second = _ensemble_snapshot(ens)
        differ = [k for k, v in first[0].items() if not torch.equal(v, second[0][k])]
        if differ or not torch.equal(first[1], second[1]) or first[3] != second[3]:
            raise AssertionError(f"ensemble step {i}: the batched step and the member loop differ in "
                                 f"{differ or 'the AR(1) carry'}")

    early = None
    for i in range(ENSEMBLE_STEPS):
        both(i)
        if ens.pcpt == MESH_ENSEMBLE_STEPS:
            early = [state_to_numpy(ens.member_state(m)) for m in range(ENSEMBLE_MEMBERS)]
        if ens.pcpt == half:
            ens.write_restart("half")
    # one call a batched step for all members, one a member in the loop
    transport_path("ensemble_batched", transport["batched"], ENSEMBLE_STEPS, fsd_stacks(ens.states))
    transport_path("ensemble", transport["loop"], ENSEMBLE_MEMBERS * ENSEMBLE_STEPS, fsd_stacks(ens.states))
    if counts["batched"] != per_batched * ENSEMBLE_STEPS or \
            counts["loop"] != ENSEMBLE_MEMBERS * per_loop * ENSEMBLE_STEPS:
        raise AssertionError(f"ensemble: {counts} kernel launches, expected {per_batched} x {ENSEMBLE_STEPS} "
                             f"batched and {ENSEMBLE_MEMBERS} x {per_loop} x {ENSEMBLE_STEPS} in the loop")
    graph = ens._program.stats
    if len(ens._program.graphs) != 1 or graph["kernel_launches"] != per_batched:
        raise AssertionError(f"ensemble: {len(ens._program.graphs)} graphs, {graph}")
    for k in range(ENSEMBLE_MEMBERS):
        _finite_state(ens.member_state(k), f"ensemble member {k}")
    n_checks = len(checks.CELL_BOUNDS + (checks.YOUNG_BOUNDS if ens.sim.dyn.use_young_ice else [])) + 1
    if ens.violations is None or tuple(ens.violations.shape) != (ENSEMBLE_MEMBERS, n_checks) or \
            bool(ens.violations.any()):
        raise AssertionError(f"ensemble: the batched step's violation flags {ens.violations}")
    spread = ens.spread(("conc", "sst", "vt_u"))
    if min(spread.values()) <= 0.0:
        raise AssertionError(f"ensemble: no spread {spread}")
    moorings = sorted(out.glob("Moorings_*.nc"))
    if not moorings:
        raise AssertionError("ensemble: no statistics moorings file")
    with netcdf_file(moorings[0], "r", mmap=False) as nc:
        sic_std = np.asarray(nc.variables["sic_std"][:])
        n_rec = sic_std.shape[0]
        if n_rec != 2 or "siu_mean" not in nc.variables or not np.nanmax(sic_std) > 0.0:
            raise AssertionError(f"ensemble moorings: {n_rec} records, variables {sorted(nc.variables)}")

    # the checkpoint of step 6, read back into the same object: the second
    # pass (batched) equals the first bitwise, the noise stream included
    first = {f.name: getattr(ens.states, f.name).clone() for f in dataclasses.fields(ens.states)
             if getattr(ens.states, f.name) is not None}
    ran = ens._ran.clone()
    ens.read_restart("half")
    if ens.pcpt != half:
        raise AssertionError(f"ensemble restart: pcpt {ens.pcpt}, not {half}")
    for _ in range(ENSEMBLE_STEPS - half):
        ens.step()
    differ = [k for k, v in first.items() if not torch.equal(v, getattr(ens.states, k))]
    if differ or not torch.equal(ran, ens._ran):
        raise AssertionError(f"ensemble restart: the resumed pass differs in {differ or 'the AR(1) carry'}")

    # member 0 rides the provider's forcing; the others are perturbed
    t = ens.current_time + ens.sim.dt / 86400.0
    forcings = ens._member_forcings(t)
    base = ens.sim.forcing_provider(t, ens.sim.time_init)
    for f in dataclasses.fields(base):
        a, b = getattr(forcings[0], f.name), getattr(base, f.name)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"ensemble: member 0's {f.name} is not the provider's")
    dtair = [float((fk.tair - base.tair).abs().max()) for fk in forcings[1:]]
    if min(dtair) <= 0.0:
        raise AssertionError(f"ensemble: a perturbed member has the control's air temperature {dtair}")

    # the member loop under torch.profiler (eager; the batched step's graph
    # is profiled in phase 29, after every profile of eager code), and the
    # runtime calls of one batched step, its draws in the graph: outside the
    # replay the forcing's copies only
    wall, busy, n_launch = profiled(loop_step)
    snap = _ensemble_snapshot(ens)
    calls, launched_by = host_calls(ens.step)
    _ensemble_restore(ens, snap)
    if calls.get("cudaGraphLaunch") != 1:
        raise AssertionError(f"ensemble: one batched step made the runtime calls {calls}, not one graph launch")
    stat = {mode: (float(np.median(v[1:])), min(v[1:]), max(v[1:])) for mode, v in ms.items()}
    rec = {"ms_batched": stat["batched"], "ms_loop": stat["loop"], "first_ms": {m: v[0] for m, v in ms.items()},
           "launches_a_step": {"batched": per_batched, "loop": ENSEMBLE_MEMBERS * per_loop},
           "loop_busy_ms": busy, "loop_busy_share": busy / stat["loop"][0], "nodes": graph["nodes"],
           "capture_s": graph["capture_s"], "instantiate_s": graph["instantiate_s"],
           "pool_bytes": graph["pool_bytes"], "generators": graph["generators"], "host_calls": calls,
           "launched_by": launched_by}
    fmt = lambda v: f"{v[0]:.2f} ms/step (min {v[1]:.2f}, max {v[2]:.2f})"  # noqa: E731
    phase("ensemble", f"BatchedEnsemble on arctic_10km.cfg {ny}x{nx}, ERA5 + TOPAZ4 + ETOPO, thermo on, "
          f"{ENSEMBLE_MEMBERS} members x {ENSEMBLE_STEPS} steps, each step twice from one state in turns: "
          f"init {init_s:.1f} s; first step batched {ms['batched'][0]:.0f} ms (the readers' first call when it "
          f"ran first, and the capture), loop {ms['loop'][0]:.0f} ms; then the batched step (one CUDA graph "
          f"replay) {fmt(stat['batched'])}, the member loop {fmt(stat['loop'])}, against phase 11's "
          f"{dataset_ms:.2f} ms/step of one Simulator; every member equal bitwise after every step; "
          f"substep-kernel launches {counts['batched']} batched ({per_batched} a step for {ENSEMBLE_MEMBERS} "
          f"members), {counts['loop']} in the loop ({per_loop} a member and step); the graph: {graph['nodes']} "
          f"nodes, capture {graph['capture_s']:.2f} s, instantiation {graph['instantiate_s']:.2f} s, pool "
          f"{graph['pool_bytes'] / 2**20:.1f} MiB, {graph['generators']} member generators registered (the draws "
          f"in the graph); a batched step's runtime calls (torch.profiler) {json.dumps(calls)}, kernel launches "
          f"outside the replay {sum(calls.get(n, 0) for n in LAUNCH_EVENTS)}, by host operator "
          f"{json.dumps(launched_by)}; zero violations (flags {tuple(ens.violations.shape)}); spread "
          f"{json.dumps({k: round(v, 6) for k, v in spread.items()})}; perturbed members' max |dtair| "
          f"{', '.join(f'{d:.3f}' for d in dtair)} K; {n_rec} statistics records; restart at step {half} resumed "
          f"bitwise through the batched step; the member loop's step under torch.profiler: {n_launch} launches, "
          f"device busy {busy:.2f} ms, idle share {1.0 - busy / stat['loop'][0]:.3f} of the unprofiled step "
          f"({1e3 * wall:.1f} ms profiled wall); {smi}")
    if early is None:
        raise AssertionError("ensemble: no state after MESH_ENSEMBLE_STEPS steps")
    return ens, counts["batched"], counts["loop"], early, rec


WELD_ENSEMBLE_STEPS = 3
# phase 19's welding ensemble: phase 19's configuration (608^2, ERA5 +
# TOPAZ4 + ETOPO, thermo on) with phase 14's FSD (20 bins, Roach welding,
# breakup, damage feedback, melt_type 3); its members start from phase 14's
# last state, where the ice grows in the north, with broken floes spread
# from a numpy seed (the run breaks floes only at the ice edge, which melts).
# Welding takes scaled areas: with unscaled ones (the default) the loop,
# capped at 256 substeps, overshoots on floes spread over every bin and
# wipes out the area below the last bin, in the plain version as in the
# kernel, and the members turned NaN within three steps
WELD_ENSEMBLE = {"wave_coupling.num_fsd_bins": 20, "wave_coupling.welding_type": "roach",
                 "wave_coupling.fsd_welding_use_scaled_area": True,
                 "wave_coupling.breakup_type": "uniform_size", "wave_coupling.fsd_damage_type": 1,
                 "thermo.melt_type": 3, "moorings.use_moorings": False,
                 "drifters.use_equally_spaced_drifters": False, "output.async_io": False}


def welding_ensemble_phase(tmp: Path, smi: str, wave_state: dict, provider) -> dict:
    """Phase 19's welding ensemble: a 4-member ``BatchedEnsemble`` of
    WELD_ENSEMBLE, every member on phase 14's last state with broken floes
    spread from its own numpy seed, WELD_ENSEMBLE_STEPS steps, each twice
    from one state in turns: the batched step (one graph replay: the
    substep kernel's launches and one welding call for all members) and
    the member loop ``step_members`` (eager), every member equal bitwise
    after every step, the loop's welding active cells printed (> 0). Then
    the welding kernel on the ensemble's member-minor stack (20, 4, 608,
    608), every cell freezing: one call equals four single-member calls
    and the plain version bitwise (every dtype); times of each in turns;
    and its time on the stacks and masks that welding gets in the loop's
    third step (the real state after two steps), bitwise the plain
    version's. ``provider`` is phase 19's
    forcing provider (the same grid and files), taken in place of a second
    set of dataset readers, whose weights cost ~40 s to build. Returns the
    record and the launches of both kernels."""
    import dataclasses

    import torch

    from nextsim_tpu_torch import Config
    from nextsim_tpu_torch.core.state import member_minor
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble
    from nextsim_tpu_torch.model import simulator as sim_mod
    from nextsim_tpu_torch.ops import fsd as fsd_ops
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda, welding_cuda

    overrides = dict(a.split("=", 1) for a in DATASET_ARGS)
    # (the ice comes from phase 14's state: no TOPAZ reader for the ice init)
    overrides.update(WELD_ENSEMBLE, **{"output.exporter_path": str(tmp / "weld_ensemble"),
                                       "setup.ice-type": "constant_partial"})
    cfg = Config.from_files(str(ROOT / "configs" / "arctic_10km.cfg"), overrides=overrides)
    t0 = time.perf_counter()
    make_provider, sim_mod.make_provider = sim_mod.make_provider, lambda *a, **kw: provider
    try:
        ens = BatchedEnsemble(cfg, ENSEMBLE_MEMBERS, device="cuda")
    finally:
        sim_mod.make_provider = make_provider
    init_s = time.perf_counter() - t0
    n = ENSEMBLE_MEMBERS
    kw = {}
    for f in dataclasses.fields(ens.states):
        if getattr(ens.states, f.name) is not None:
            kw[f.name] = torch.stack([torch.as_tensor(wave_state[f.name], device="cuda")] * n)
    cf = kw["conc_fsd"]
    w = torch.as_tensor(np.stack([np.random.default_rng(19 + m).uniform(0.0, 1.0, tuple(cf.shape[1:]))
                                  for m in range(n)]), dtype=cf.dtype, device="cuda")
    kw["conc_fsd"] = (w / w.sum(1, keepdim=True) * cf.sum(1, keepdim=True)).contiguous()
    if kw.get("conc_mech_fsd") is not None:
        kw["conc_mech_fsd"] = kw["conc_fsd"].clone()
    ens.states = ens.states.replace(**kw)
    ny, nx = ens.sim.grid.shape
    plan_of = (ens.sim.dtype, ens.sim.dyn.dynamics_type)
    per_batched = momentum_cuda.launches_for(ens.sim.dyn.substeps, ny, nx, *plan_of, members=n)
    per_loop = momentum_cuda.launches_for(ens.sim.dyn.substeps, ny, nx, *plan_of)
    counts = {"batched": [0, 0, 0], "loop": [0, 0, 0]}
    ms = {"batched": [], "loop": []}
    active = []
    plain_weld = fsd_ops.welding_roach

    real = []  # what welding gets in the loop's third step: each member's stack and mask

    def counted_weld(x, dt, p, bins, freezing):
        active[-1] += int((freezing & (x[:-1].sum(0) > 0.01) & (x.sum(0) > 0.1)).sum())
        if len(active) == 3:
            real.append((x.clone(), freezing.clone()))
        return plain_weld(x, dt, p, bins, freezing)

    def timed(mode):
        c0 = (momentum_cuda.launches, welding_cuda.launches, transport_cuda.launches)
        a = time.perf_counter()
        if mode == "batched":
            ens.step()
        else:
            active.append(0)
            fsd_ops.welding_roach = counted_weld  # the eager loop only: the count reads back
            try:
                ens.step_members()
            finally:
                fsd_ops.welding_roach = plain_weld
        sync()
        ms[mode].append(1e3 * (time.perf_counter() - a))
        counts[mode][0] += momentum_cuda.launches - c0[0]
        counts[mode][1] += welding_cuda.launches - c0[1]
        counts[mode][2] += transport_cuda.launches - c0[2]

    for i in range(WELD_ENSEMBLE_STEPS):
        start = _ensemble_snapshot(ens)
        order = ("batched", "loop") if i % 2 == 0 else ("loop", "batched")
        timed(order[0])
        first = _ensemble_snapshot(ens)
        _ensemble_restore(ens, start)
        timed(order[1])
        second = _ensemble_snapshot(ens)
        differ = [k for k, v in first[0].items() if not same_bits(v, second[0][k])]
        if differ or not torch.equal(first[1], second[1]):
            raise AssertionError(f"welding ensemble step {i}: the batched step and the member loop differ in "
                                 f"{differ or 'the AR(1) carry'}")
    steps = WELD_ENSEMBLE_STEPS
    per_call = welding_cuda.LAUNCHES_A_CALL
    transport_path("ensemble_welding", counts["batched"][2], steps, fsd_stacks(ens.states))
    transport = {mode: counts[mode].pop() for mode in counts}
    if counts["batched"] != [per_batched * steps, steps * per_call] or counts["loop"] != [
            n * per_loop * steps, n * steps * per_call]:
        raise AssertionError(f"welding ensemble: launches (substep, welding) {counts}")
    if transport["loop"] != n * steps * (transport_cuda.LAUNCHES_A_CALL + fsd_stacks(ens.states)):
        TRANSPORT_FAULTS.append(f"welding ensemble: {transport['loop']} transport launches in the member loop")
    if sum(active) == 0:
        raise AssertionError("welding ensemble: welding acted on no cell")
    for k in range(n):
        _finite_state(ens.member_state(k), f"welding ensemble member {k}")
    graph = ens._program.stats

    # the welding kernel on the member-minor stack: one call against a
    # call a member, in turns
    x = member_minor(ens.states).conc_fsd
    freezing = torch.ones(tuple(x.shape[1:]), dtype=torch.bool, device="cuda")
    fp, fb, dt = ens.sim.fsd_params, ens.sim.fsd_bins, ens.sim.dt
    singles = [(x[:, m].contiguous(), freezing[m].contiguous()) for m in range(n)]
    c0 = welding_cuda.launches
    out = fsd_ops.welding_roach(x, dt, fp, fb, freezing)
    if welding_cuda.launches != c0 + welding_cuda.LAUNCHES_A_CALL:
        raise AssertionError("welding ensemble: the member stack took more than one call")
    for m, (xm, fm) in enumerate(singles):
        if not same_bits(out[:, m], fsd_ops.welding_roach(xm, dt, fp, fb, fm)):
            raise AssertionError(f"welding ensemble: member {m} of the batched launch differs from its own launch")
    plain_ms = {}
    for dtype_name in WELDING_DTYPES:  # the stack's launch against the plain version, every dtype
        xd = x.to(getattr(torch, dtype_name))
        ref, _, plain_ms[dtype_name] = timed_call(lambda: fsd_ops.welding_roach_reference(xd, dt, fp, fb, freezing))
        if not same_bits(fsd_ops.welding_roach(xd, dt, fp, fb, freezing), ref):
            raise AssertionError(f"welding ensemble: the member stack's launch differs from the plain version "
                                 f"in {dtype_name}")
    t_stack, t_singles = [], []
    for order in range(2):
        for which in (("stack", "singles") if order == 0 else ("singles", "stack")):
            if which == "stack":
                t_stack.append(event_ms(lambda: fsd_ops.welding_roach(x, dt, fp, fb, freezing), reps=3))
            else:
                t_singles.append(event_ms(lambda: [fsd_ops.welding_roach(xm, dt, fp, fb, fm) for xm, fm in singles],
                                          reps=3))
    bound_ms, bound_by, _, _, n_active = welding_bound_ms(x, freezing, dt, fp, fb)
    # the real state: the loop's third step's stacks and masks, member-minor
    if len(real) != n:
        raise AssertionError(f"welding ensemble: {len(real)} welding calls in the loop's third step")
    x_real = torch.stack([xm for xm, _ in real], dim=1).contiguous()
    f_real = torch.stack([fm for _, fm in real]).contiguous()
    ref, _, real_plain_ms = timed_call(lambda: fsd_ops.welding_roach_reference(x_real, dt, fp, fb, f_real))
    if not same_bits(fsd_ops.welding_roach(x_real, dt, fp, fb, f_real), ref):
        raise AssertionError("welding ensemble: the kernel differs from the plain version on the real state")
    real_ms = event_ms(lambda: fsd_ops.welding_roach(x_real, dt, fp, fb, f_real), reps=5)
    real_bound_ms, real_bound_by, _, _, real_active = welding_bound_ms(x_real, f_real, dt, fp, fb)
    # ms/step of the steps after the first (the batched step's first captures)
    stat = {mode: (float(np.median(v[1:])), min(v[1:]), max(v[1:])) for mode, v in ms.items()}
    rec = {"ms_batched": stat["batched"], "ms_loop": stat["loop"], "launches": counts, "active_cells": active,
           "nodes": graph["nodes"], "capture_s": graph["capture_s"], "instantiate_s": graph["instantiate_s"],
           "pool_bytes": graph["pool_bytes"], "stack_ms": min(t_stack), "singles_ms": min(t_singles),
           "stack_bound_ms": bound_ms, "stack_active": n_active, "stack_plain_ms": plain_ms, "init_s": init_s,
           "real_ms": real_ms, "real_active": real_active, "real_bound_ms": real_bound_ms,
           "real_bound_by": real_bound_by, "real_plain_ms": real_plain_ms}
    fmt = lambda v: f"{v[0]:.2f} ms/step (min {v[1]:.2f}, max {v[2]:.2f})"  # noqa: E731
    phase("ensemble", f"the welding ensemble: arctic_10km.cfg {ny}x{nx}, ERA5 + TOPAZ4 + ETOPO, thermo on, 20 FSD "
          f"bins with Roach welding on scaled areas, {n} members on phase 14's last state with broken floes spread "
          f"from numpy, "
          f"{steps} steps, each twice from one state in turns: init {init_s:.1f} s; over steps 2-{steps} (the first, "
          f"in brackets with the rest, is the batched step's capture) the batched step (one graph replay) "
          f"{fmt(stat['batched'])} ({[round(v, 1) for v in ms['batched']]}), the member loop {fmt(stat['loop'])} "
          f"({[round(v, 1) for v in ms['loop']]}); every member equal bitwise after "
          f"every step; welding active cells by step (the loop's, all members) {active}; launches (substep, welding) "
          f"batched {counts['batched']}, loop {counts['loop']}; the graph: {graph['nodes']} nodes, capture "
          f"{graph['capture_s']:.2f} s, instantiation {graph['instantiate_s']:.2f} s, pool "
          f"{graph['pool_bytes'] / 2**20:.1f} MiB, welding launches a replay {graph['welding_launches']}; the welding "
          f"kernel on the member-minor stack {tuple(x.shape)}, every cell freezing ({n_active} active cells): one "
          f"call {[round(t, 4) for t in t_stack]} ms against {n} single calls {[round(t, 4) for t in t_singles]} "
          f"ms (CUDA events, in turns), bitwise equal, and equal to the plain version bitwise in "
          f"{', '.join(WELDING_DTYPES)} (its time {json.dumps({k: round(v, 1) for k, v in plain_ms.items()})} ms); "
          f"bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / min(t_stack):.1f}% of it reached; on the real "
          f"state (the loop's third step's stacks and masks, {real_active} active cells) {real_ms:.4f} ms, bitwise "
          f"the plain version ({real_plain_ms:.1f} ms), bound {real_bound_ms:.4f} ms by {real_bound_by}; {smi}")
    del ens
    torch.cuda.empty_cache()
    return rec


BATCHED_KERNEL_STEPS = 11  # no multiple of the plan's k: a remainder launch


def batched_kernel_phase(ens, smi: str) -> dict:
    """Phase 19b: the substep kernel's batched launch on phase 19's 608^2 x
    4 state (the member-minor stack and the stacked forcing, as the batched
    step hands them on): against the 4 single-member launches and the plain
    loop on the card, bitwise, for bbm, evp and mevp in float32, float64
    and bfloat16 over BATCHED_KERNEL_STEPS substeps; then one 120-substep
    bbm loop in float32, the batched launch beside the 4 single launches by
    CUDA events, in turns, and the plain loop on the batch, with the
    bound."""
    import dataclasses

    import torch

    from nextsim_tpu_torch.core.state import member_minor
    from nextsim_tpu_torch.ensemble.perturbation import stack_forcings
    from nextsim_tpu_torch.ops import momentum, momentum_cuda

    sim = ens.sim
    ny, nx = sim.grid.shape
    n = ens.n
    snap = _ensemble_snapshot(ens)  # the forcing's draws advance the noise: put it back after
    forcing = stack_forcings(ens._member_forcings(ens.current_time + sim.dt / 86400.0))
    _ensemble_restore(ens, snap)

    def loops(dtype, dyn_type):
        """(batched consts, carry, params; per member (consts, carry))"""
        p = dataclasses.replace(sim.dyn, dynamics_type=dyn_type)
        states = _cast_tree(member_minor(ens.states), dtype)
        f = _cast_tree(forcing, dtype)
        ga = {k: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
              for k, v in sim.grid_arrays.items()}
        ga["cohesion"] = sim.c_fix + sim.c_alea * states.random_number
        consts, carry = momentum.substep_setup(states, f, ga, sim.dt, p)
        singles = []
        for m in range(n):
            pick = lambda x: x[m] if isinstance(x, torch.Tensor) and x.ndim == 3 else x  # noqa: E731
            c = type(consts)(**{k: pick(v) for k, v in vars(consts).items()})
            singles.append((c, tuple(x[m].contiguous() for x in carry)))
        return consts, carry, p, singles

    def call(fn, consts, carry, steps, p, **kw):
        return fn(consts, carry, steps, sim.dt / p.substeps, sim.dt, sim.grid.dx, p.dynamics_type, p, **kw)

    bitwise = {}
    for dtype_name, dtype in (("float32", torch.float32), ("float64", torch.float64), ("bfloat16", torch.bfloat16)):
        for dyn_type in ("bbm", "evp", "mevp"):
            consts, carry, p, singles = loops(dtype, dyn_type)
            launches = momentum_cuda.launches
            out = call(momentum_cuda.substep_loop, consts, carry, BATCHED_KERNEL_STEPS, p)
            made = momentum_cuda.launches - launches
            if made != momentum_cuda.launches_for(BATCHED_KERNEL_STEPS, ny, nx, dtype, dyn_type, members=n):
                raise AssertionError(f"batched kernel {dtype_name} {dyn_type}: {made} launches")
            plain = call(momentum_cuda.substep_loop_reference, consts, carry, BATCHED_KERNEL_STEPS, p)
            same = True
            for m, (c, cr) in enumerate(singles):
                one = call(momentum_cuda.substep_loop, c, cr, BATCHED_KERNEL_STEPS, p)
                for name, o, pl, r in zip(momentum_cuda._STATE, out, plain, one):
                    if not bool(torch.isfinite(o).all()):
                        raise AssertionError(f"batched kernel {dtype_name} {dyn_type}: {name} not finite")
                    same &= torch.equal(o[m], r) and torch.equal(o[m], pl[m])
            bitwise[f"{dyn_type} {dtype_name}"] = same
            momentum_cuda.launches = launches  # comparisons are no path's launches
    if not all(bitwise.values()):
        raise AssertionError(f"batched kernel: not bitwise {bitwise}")

    consts, carry, p, singles = loops(torch.float32, "bbm")
    shared = tuple(k for k, v in vars(consts).items() if isinstance(v, torch.Tensor) and v.ndim == 2)
    steps = p.substeps
    launches = momentum_cuda.launches
    batched = lambda: call(momentum_cuda.substep_loop, consts, carry, steps, p)  # noqa: E731
    each = lambda: [call(momentum_cuda.substep_loop, c, cr, steps, p) for c, cr in singles]  # noqa: E731
    t_b, t_s = [], []
    for fn, into in ((batched, t_b), (each, t_s), (each, t_s), (batched, t_b)):
        into.append(event_ms(fn))
    plain_ms = event_ms(lambda: call(momentum_cuda.substep_loop_reference, consts, carry, steps, p), reps=1)
    momentum_cuda.launches = launches
    bound_ms, bound_by, bytes_ms, ops_ms = kernel_bound_ms(ny, nx, steps, torch.float32, "bbm", members=n,
                                                           shared=shared)
    single_bound = kernel_bound_ms(ny, nx, steps, torch.float32, "bbm")[0]
    pl_b = momentum_cuda.launch_plan(ny, nx, steps, torch.float32, "bbm", members=n)
    pl_1 = momentum_cuda.launch_plan(ny, nx, steps, torch.float32, "bbm")
    rec = {"bitwise": bitwise, "ms_batched": min(t_b), "ms_singles": min(t_s), "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "single_bound_ms": single_bound, "launches_batched": len(pl_b.launches),
           "launches_singles": n * len(pl_1.launches), "shared_planes": len(shared)}
    phase("batched kernel", f"{ny}x{nx} x {n} members (phase 19's state): one batched launch sequence equals the "
          f"{n} single-member loops and the plain loop bitwise for bbm, evp and mevp in float32, float64 and "
          f"bfloat16 over {BATCHED_KERNEL_STEPS} substeps; {len(shared)} of the loop's planes shared (stride 0): "
          f"{', '.join(shared)}. 120-substep bbm float32: batched {t_b} ms in {len(pl_b.launches)} launches "
          f"(tile {pl_b.tile_h} x {pl_b.tile_w}, k {pl_b.k}, {pl_b.blocks_y * pl_b.blocks_x * n} blocks), "
          f"{n} single launches {t_s} ms in {n * len(pl_1.launches)} (order batched, singles, singles, batched), "
          f"the plain loop on the batch {plain_ms:.1f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f}, operations {ops_ms:.4f}; {n} x the "
          f"single {single_bound:.4f}): the batched launch reaches {100 * bound_ms / min(t_b):.1f}% of it, the "
          f"singles {100 * bound_ms / min(t_s):.1f}%; {smi}")
    return rec


PERTURBED_K = 30  # phase 20's chunk: bench.py's tpu.steps_per_call
PERTURBED_TURNS = 3


def ensemble_members_vs_simulators(smi: str):
    """Phase 20: at 464^2 thermo on, batched member 0 equals a Simulator
    and member 2 a Simulator with ensemble_member=2 (its steps graph
    replays, its draws inside them), bitwise, after 3 steps; then
    ``perturbed_member``. Returns its record and Simulator."""
    import dataclasses

    import torch

    from nextsim_tpu_torch import Config, Simulator
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble

    cfg = lambda m: Config(overrides=dict(BENCH_THERMO, **{"statevector.ensemble_member": m}))  # noqa: E731
    ens = BatchedEnsemble(cfg(0), 3, device="cuda")
    ens.run(3)
    report = []
    for m in (0, 2):
        sim = Simulator(cfg(m), device="cuda")
        for _ in range(3):
            sim.step()
        if sim.eager_reason is not None or len(sim._program.graphs) != 1:
            raise AssertionError(f"Simulator(member={m}) did not replay its step graph: {sim.eager_reason}")
        member = ens.member_state(m)
        differ = {f.name: float((getattr(sim.state, f.name) - getattr(member, f.name)).abs().max())
                  for f in dataclasses.fields(sim.state) if getattr(sim.state, f.name) is not None
                  and not torch.equal(getattr(sim.state, f.name), getattr(member, f.name))}
        if differ:
            raise AssertionError(f"batched member {m} vs Simulator(member={m}): max |diff| {differ}")
        report.append(m)
    d12 = float((ens.member_state(1).sst - ens.member_state(2).sst).abs().max())
    ny, nx = ens.sim.grid.shape
    phase("ensemble", f"{ny}x{nx} thermo on, 3 members x 3 steps: members {report} equal Simulator(member=m) bitwise "
          f"in every field, each Simulator's steps replays of its one-step graph; "
          f"members 1 and 2 differ in sst by {d12:.3e} C; {smi}")
    del ens
    return perturbed_member(cfg(2), smi)


def perturbed_member(cfg, smi: str) -> dict:
    """Phase 20's perturbed member: ``Simulator(member=2)`` at 464^2 thermo
    on, one ``step_chunk(30)`` (the eager warm-up, which draws, and the
    capture), then from that state and generator state, in turns,
    ``PERTURBED_TURNS`` times each: ``step_chunk(30)`` (one replay of the
    30-step graph, the noise drawn, filtered, advanced and applied inside
    it) and ``step_chunk_eager(30)``, every result bitwise equal (state,
    AR(1) carry, generator state, last perturbed forcing); ms/step of each
    (median, min, max; host wall, synchronized), the graph's nodes, capture
    and instantiation seconds, and the substep kernel's launches of the
    replays, counted from zero. Returns (the record, the Simulator)."""
    import torch

    from nextsim_tpu_torch import Simulator
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda

    sim = Simulator(cfg, device="cuda")
    if sim.eager_reason is not None:
        raise AssertionError(f"perturbed member: eager_reason {sim.eager_reason!r}")
    gen = sim._ens_pert.generator
    k = PERTURBED_K
    t0 = time.perf_counter()
    sim.step_chunk(k)
    sync()
    first_s = time.perf_counter() - t0
    stats = dict(sim._program.stats)
    state0, ran0, gen0, pcpt0 = sim.state, sim._pert_state.clone(), gen.get_state(), sim.pcpt

    def run(mode):
        sim.state, sim._pert_state, sim.pcpt, sim._pending_viol = state0, ran0.clone(), pcpt0, None
        gen.set_state(gen0)
        sync()
        t = time.perf_counter()
        (sim.step_chunk if mode == "captured" else sim.step_chunk_eager)(k)
        sync()
        return 1e3 * (time.perf_counter() - t) / k, (sim.state, sim._pert_state, gen.get_state(), sim.last_forcing)

    ms = {"captured": [], "eager": []}
    outs = []
    launches = {"captured": 0, "eager": 0}
    transport = {"captured": 0, "eager": 0}
    for i in range(PERTURBED_TURNS):
        for mode in (("captured", "eager") if i % 2 == 0 else ("eager", "captured")):
            momentum_cuda.launches = transport_cuda.launches = 0
            t, out = run(mode)
            launches[mode] += momentum_cuda.launches
            transport[mode] += transport_cuda.launches
            ms[mode].append(t)
            outs.append((mode, out))
    transport_path("perturbed", transport["captured"], PERTURBED_TURNS * k, fsd_stacks(sim.state))
    ref = outs[0][1]
    for n, (mode, (state, ran, g, lf)) in enumerate(outs):
        differ = [f for f in ref[0].__dataclass_fields__ if getattr(ref[0], f) is not None
                  and not torch.equal(getattr(ref[0], f), getattr(state, f))]
        if not torch.equal(ran, ref[1]):
            differ.append("the AR(1) carry")
        if not torch.equal(g, ref[2]):
            differ.append("the generator state")
        differ += [name for name in ("tair", "mslp", "precip", "dair", "wind_u", "wind_v")
                   if getattr(lf, name) is not None and not torch.equal(getattr(lf, name), getattr(ref[3], name))]
        if differ:
            raise AssertionError(f"perturbed member: run {n} ({mode}) differs from run 0 in {differ}")
    if torch.equal(ref[2], gen0) or torch.equal(ref[3].tair, sim._ens_pert.provider(
            sim.current_time, sim.time_init).tair):
        raise AssertionError("perturbed member: the chunk drew no noise")
    per_loop = momentum_cuda.launches_for(sim.dyn.substeps, *sim.grid.shape)
    if launches["captured"] != PERTURBED_TURNS * k * per_loop or stats["kernel_launches"] != k * per_loop:
        raise AssertionError(f"perturbed member: {launches} kernel launches, graph {stats['kernel_launches']}, "
                             f"expected {k * per_loop} a chunk")
    if len(sim._program.graphs) != 1 or stats["generators"] != 1:
        raise AssertionError(f"perturbed member: {len(sim._program.graphs)} graphs, {stats}")
    stat = {mode: (float(np.median(v)), min(v), max(v)) for mode, v in ms.items()}
    fmt = lambda v: f"{v[0]:.2f} ms/step (min {v[1]:.2f}, max {v[2]:.2f})"  # noqa: E731
    ny, nx = sim.grid.shape
    phase("perturbed", f"Simulator(member=2) {ny}x{nx} thermo on, eager_reason None, {k}-step chunks from one state "
          f"and generator state, {PERTURBED_TURNS} turns each (captured first in odd turns): captured (one replay, "
          f"the noise drawn, filtered, advanced and applied in the graph) {fmt(stat['captured'])}, eager "
          f"{fmt(stat['eager'])}; all {len(outs)} runs bitwise equal (state, AR(1) carry, generator state, last "
          f"perturbed forcing); first call (eager warm-up + capture) {first_s:.2f} s; the graph: {stats['nodes']} "
          f"nodes, capture {stats['capture_s']:.2f} s, instantiation {stats['instantiate_s']:.2f} s, pool "
          f"{stats['pool_bytes'] / 2**20:.1f} MiB, {stats['kernel_launches']} substep-kernel launches a replay, "
          f"{stats['generators']} generator registered; {smi}")
    return {"ms_captured": stat["captured"], "ms_eager": stat["eager"], "first_call_s": first_s,
            "nodes": stats["nodes"], "capture_s": stats["capture_s"], "instantiate_s": stats["instantiate_s"],
            "pool_bytes": stats["pool_bytes"], "launches": launches}, sim


def perturbed_profile(sim, unperturbed: dict, smi: str) -> dict:
    """Phase 29: phase 20's perturbed member, ``PROFILED_STEPS`` replays of
    its one-step graph (captured first, outside the profile) under
    torch.profiler, the card's own entries: device busy a step beside the
    unperturbed 464^2 thermo-on one-step replays' of phase 29."""
    sim.step()

    def steps():
        for _ in range(PROFILED_STEPS):
            sim.step()

    busy = profiled(steps, host_events=False)[1] / PROFILED_STEPS
    base = unperturbed["busy_ms"]["captured"]
    phase("captured", f"phase 20's perturbed member (464^2 thermo on, member 2), {PROFILED_STEPS} replays of its "
          f"one-step graph under torch.profiler: device busy {busy:.2f} ms a step, against {base:.2f} for the "
          f"unperturbed member's one-step replays above: the noise {busy - base:+.2f} ms a step; {smi}")
    return {"busy_ms": busy, "unperturbed_busy_ms": base}


def ensemble_driver(tmp: Path, smi: str) -> None:
    """Phase 21: ``python -m nextsim_tpu_torch.ensemble.run_ensemble`` with a
    control and 2 members on configs/toy.cfg for 0.05 days, as a subprocess."""
    out = tmp / "ensemble_driver"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "nextsim_tpu_torch.ensemble.run_ensemble", "--device", "cuda",
                        "--control", "--num-members", "2", "--config-files", "configs/toy.cfg",
                        "simul.duration=0.05", f"output.exporter_path={out}", "restart.write_final_restart=true"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"ensemble driver exited {r.returncode}: {r.stderr[-3000:]}")
    finals = {}
    for m in range(3):
        path = out / f"mem_{m}" / "restart" / "restart_final.npz"
        if not path.exists():
            raise AssertionError(f"ensemble driver: no {path.relative_to(out)}")
        _all_finite(path, f"ensemble driver member {m}")
        with np.load(path) as z:
            finals[m] = {k: z[k] for k in ("vt_u", "conc")}
            meta = json.loads(str(z["__meta__"]))
    d01 = float(np.abs(finals[1]["vt_u"] - finals[0]["vt_u"]).max())
    if d01 <= 0.0 or np.array_equal(finals[1]["vt_u"], finals[2]["vt_u"]):
        raise AssertionError(f"ensemble driver: members do not differ (|d vt_u| 0-1 {d01})")
    phase("ensemble", f"run_ensemble --device cuda --control --num-members 2 on toy.cfg 128^2, "
          f"{meta['pcpt']} steps a member, in {time.perf_counter() - t0:.1f} s (process included): mem_0..mem_2 "
          f"finite, member 1 vs 0 max |d vt_u| {d01:.3e} m/s; {smi}")


def lattice_triangles(ny: int, nx: int):
    """Two triangles a cell on a (ny+1) x (nx+1) node lattice, cell c's at
    2c and 2c+1 (P0 triangle fields align with cells, P1 nodes with nodes)."""
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n00 = (jj * (nx + 1) + ii).ravel()
    tris = np.empty((2 * n00.size, 3), dtype=np.int64)
    tris[0::2] = np.column_stack([n00, n00 + 1, n00 + nx + 2])
    tris[1::2] = np.column_stack([n00, n00 + nx + 2, n00 + nx + 1])
    return tris


def write_reference_snapshots(d: Path, grid, t0: float, dt_days: float, n: int = 3) -> None:
    """``n`` synthetic reference-format snapshot pairs ({mesh,field}_<k>, the
    reference Exporter's layout) of a drifting ice field, one step apart,
    written by the port's ref_binary."""
    from nextsim_tpu_torch.output import ref_binary

    d.mkdir(parents=True, exist_ok=True)
    cx, cy = grid.cell_xy()
    npx, npy = grid.node_xy()
    ids = np.arange(1, npx.size + 1, dtype=np.int32)
    tris = lattice_triangles(*grid.shape)
    p0 = lambda a: np.repeat(np.asarray(a, np.float64).ravel(), 2)  # noqa: E731
    for k in range(1, n + 1):
        ref_binary.write_file(str(d / f"mesh_{k}"), [
            ("Elements", "int", ids[tris].ravel().astype(np.int32)), ("id", "int", ids),
            ("Nodes_x", "double", npx.ravel()), ("Nodes_y", "double", npy.ravel())])
        conc = np.clip(0.9 + 0.1 * np.sin(cx / 60e3 + 0.1 * k) * np.cos(cy / 45e3), 0.0, 1.0)
        u = 0.1 + 0.02 * np.sin(npy / 30e3 + k)
        v = -0.05 * np.cos(npx / 40e3)
        ref_binary.write_file(str(d / f"field_{k}"), [
            ("Time", "double", np.array([t0 + k * dt_days])),
            ("M_VT", "double", np.concatenate([u.ravel(), v.ravel()])),
            ("Concentration", "double", p0(conc)), ("Thickness", "double", p0(1.0 + 0.5 * conc)),
            ("Damage", "double", p0(0.05 * k * (conc > 0.95))), ("Snow", "double", p0(0.1 * conc))])


def _worst_report_diff(a, b, path="report") -> float:
    """The largest relative difference between two nested reports (same keys)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(a)} vs {sorted(b)}")
        return max([_worst_report_diff(a[k], b[k], f"{path}.{k}") for k in a] or [0.0])
    if isinstance(a, str):
        if a != b:
            raise AssertionError(f"{path}: {a} vs {b}")
        return 0.0
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


def validation_run(tmp: Path, smi: str, ens) -> int:
    """Phase 22: ``run_comparison`` on three synthetic reference-format
    snapshots with configs/toy.cfg, float64 on the card and on the CPU
    (every metric within 1e-9 relative); ``tools.deformation_stats`` on phase
    19's ensemble-mean velocity. Returns the kernel launches of the card run."""
    import torch

    from nextsim_tpu_torch import Config
    from nextsim_tpu_torch.grid.grid import Grid
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda
    from nextsim_tpu_torch.tools import deformation_stats
    from nextsim_tpu_torch.utils import dates
    from nextsim_tpu_torch.validation.ref_compare import build_matching_grid, load_snapshot, run_comparison

    toy = str(ROOT / "configs" / "toy.cfg")
    cfg = Config.from_files(toy)
    grid = Grid.square(nx=cfg["grid.nx"], ny=cfg["grid.ny"], dx=cfg["grid.resolution"], x0=-640e3, y0=-640e3)
    ref_dir = tmp / "reference"
    write_reference_snapshots(ref_dir, grid, dates.string_to_datenum(cfg["simul.time_init"]),
                              cfg["simul.timestep"] / 86400.0)
    ov = {"tpu.dtype": "float64", "output.exporter_path": str(tmp / "validation")}
    momentum_cuda.launches = transport_cuda.launches = 0
    t0 = time.perf_counter()
    card = run_comparison(str(ref_dir), [toy], overrides=dict(ov), verbose=False, device="cuda")
    sync()
    t_card = time.perf_counter() - t0
    launches = momentum_cuda.launches
    transport_path("validation", transport_cuda.launches, 3)
    t0 = time.perf_counter()
    cpu = run_comparison(str(ref_dir), [toy], overrides=dict(ov), verbose=False, device="cpu")
    t_cpu = time.perf_counter() - t0
    matched = build_matching_grid(load_snapshot(str(ref_dir), "1"))
    per_loop = len(momentum_cuda.launch_plan(matched.ny, matched.nx, cfg["dynamics.substeps"],
                                             torch.float64, "bbm").launches)
    if len(card) != 3 or launches != 3 * per_loop:
        raise AssertionError(f"validation: {len(card)} snapshots, {launches} kernel launches (3 x {per_loop} expected)")
    worst = max(_worst_report_diff(a[2], b[2]) for a, b in zip(cpu, card))
    if worst > 1e-9:
        raise AssertionError(f"validation: card vs CPU reports differ by {worst:.3e} relative")
    last = card[-1][2]

    mean = ens.mean_state()
    path = tmp / "ensemble_mean.npz"
    np.savez(path, vt_u=mean.vt_u.cpu().numpy(), vt_v=mean.vt_v.cpu().numpy(), conc=mean.conc.cpu().numpy())
    result = deformation_stats.main([str(path), str(ens.sim.grid.dx)])
    total = result["total"]
    if total.get("n", 0) < 100 or not all(np.isfinite(v) for v in total.values()):
        raise AssertionError(f"deformation_stats on the ensemble mean: {total}")
    phase("validation", f"run_comparison on 3 synthetic reference snapshots (toy.cfg on the snapshots' "
          f"{matched.ny}x{matched.nx} grid, float64): card {t_card:.1f} s, {launches} kernel launches; CPU {t_cpu:.1f} s; every metric of the "
          f"3 reports within {worst:.1e} relative (limit 1e-9); last snapshot: speed rmse "
          f"{last['speed']['rmse']:.4f} m/s, conc rmse {last['Concentration']['rmse']:.4f}, tier {last['_tier']}; "
          f"deformation_stats on phase 19's ensemble-mean velocity: {total['n']} cells, p50 "
          f"{total.get('p50_per_day', float('nan')):.4f}/day, p99 {total.get('p99_per_day', float('nan')):.4f}/day; {smi}")
    return launches


# ---------------------------------------------------------------------------
# Gradients (phase 23)
# ---------------------------------------------------------------------------

# the main path's configurations with the wind at full strength from the first
# step (no spin-up ramp): a moving, stressed state after one forward step
GRAD = dict(BENCH, **{"simul.spinup_duration": 0.0})
GRAD_THERMO = dict(BENCH_THERMO, **{"simul.spinup_duration": 0.0})
GRAD_ROLLOUT = 2  # steps of the rollout (a variational window; 3 until the batched ensemble phases came)
# SubstepLoop against straight autograd: float32 in the relative L2 norm (the
# per-segment sums associate the planes' gradients otherwise; measured 1.9e-7
# on an H100, and the kernel may part from the plain loop on the BBM failure
# branch in a few cells over 120 float32 substeps, as phase 3's tier allows);
# float64, where the kernel gives the plain loop's bits, in the max norm
# (measured 1.6e-15)
GRAD_REL_L2_F32 = 1e-4
GRAD_REL_MAX_F64 = 1e-12
# The float64 central difference at GRAD_FD_EPS m/s against the directional
# derivative. A larger step straddles kinks of the BBM update (a cell that
# starts or stops failing): measured on an H100, 2.0e-2 at 1e-3, 1.9e-4 at
# 1e-4, 1.1e-6 at 1e-5; 2.6e-4 at 1e-3 on the undamaged state
GRAD_FD_EPS = 1e-5
GRAD_FD_RTOL_F64 = 1e-4


@contextlib.contextmanager
def straight_autograd():
    """``substep_loop`` replaced by the plain loop inside the block: autograd
    records every operation of every substep on the card (the yardstick of
    SubstepLoop, no path of the port)."""
    from nextsim_tpu_torch.ops import momentum_cuda

    real = momentum_cuda.substep_loop
    momentum_cuda.substep_loop = momentum_cuda.substep_loop_reference
    try:
        yield
    finally:
        momentum_cuda.substep_loop = real


def ke_gradient(sim, steps=1):
    """A function that returns d(mean KE after ``steps`` steps)/d(wind_u)
    through ``sim.raw_step_fn`` from ``sim``'s state, and the wind."""
    import torch

    f = sim.forcing_provider(sim.current_time, sim.time_init)
    ti = sim.time_info()

    def loss(wind_u):
        s = sim.state
        for _ in range(steps):
            s, _, _ = sim.raw_step_fn(s, f.replace(wind_u=wind_u), ti)
        return (s.vt_u * s.vt_u + s.vt_v * s.vt_v).mean()

    def grad():
        w = f.wind_u.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(w), w)
        return g

    return grad, loss, f.wind_u


def measure_gradient(grad, warm=True, profile=False):
    """(gradient, ms of a synchronized call (after a warm one with
    ``warm``), kernel launches of that call, peak device memory above what
    was allocated before it in GiB, and with ``profile`` (device busy ms,
    launches of every kernel) of one more call under torch.profiler). The
    transport kernel's launches of the timed call are left in
    ``transport_cuda.launches``."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda

    if warm:
        grad()
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    momentum_cuda.launches = transport_cuda.launches = 0
    t0 = time.perf_counter()
    g = grad()
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    launches, transported = momentum_cuda.launches, transport_cuda.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    prof = profiled(grad, host_events=False)[1:] if profile else None
    transport_cuda.launches = transported
    if not bool(torch.isfinite(g).all()) or float(g.abs().max()) <= 0.0:
        raise AssertionError("gradient: not finite, or zero")
    return g, ms, launches, peak, prof


def _rel(a, b, norm):
    import torch

    d = (a - b).double()
    if norm == "l2":
        return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(b.double()))
    return float(d.abs().max() / b.double().abs().max())


def gradient_phase(smi: str) -> int:
    """Phase 23: d(mean KE after one step)/d(wind_u) through ``raw_step_fn``
    at 464^2 (BBM, 120 substeps, thermo off and on): SubstepLoop (the
    kernel forward, the plain body's checkpointed recompute backward)
    against straight autograd through the plain loop on the card, in float32
    (relative L2 within GRAD_REL_L2_F32) and float64 (max norm within
    GRAD_REL_MAX_F64); a directional central difference in float64
    (GRAD_FD_RTOL_F64 at GRAD_FD_EPS); a 3-step rollout. Prints ms, kernel
    launches, device busy and peak memory of each. Returns (the kernel's
    launches on the gradient path (the Function's timed calls, each counted
    from zero), the thermo-off gradients through SubstepLoop by dtype as
    host arrays, for phase 27)."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda

    t_phase = time.perf_counter()
    launches = 0
    report = []
    per_loop = momentum_cuda.launches_for(120, 464, 464)
    for name, over in (("thermo off", GRAD), ("thermo on", GRAD_THERMO)):
        t0 = time.perf_counter()
        sim = make_sim(over)
        sim.step()
        t_init = time.perf_counter() - t0
        grad, _, _ = ke_gradient(sim)
        g, ms, n, peak, prof = measure_gradient(grad, profile=True)
        transport_path("gradient", transport_cuda.launches, 1)
        if n != per_loop:
            raise AssertionError(f"gradient {name}: {n} kernel launches, expected {per_loop}")
        launches += n
        if name == "thermo off":
            single = {"float32": g.cpu().numpy()}
        with straight_autograd():  # warm too: its first call grows the allocator's pool by GiBs
            g_ref, ms_ref, n_ref, peak_ref, prof_ref = measure_gradient(grad, profile=True)
        if n_ref:
            raise AssertionError(f"gradient {name}: the straight run launched the kernel {n_ref} times")
        rel = _rel(g, g_ref, "l2")
        if rel > GRAD_REL_L2_F32:
            raise AssertionError(f"gradient {name}: SubstepLoop vs straight autograd {rel:.3e} (relative L2)")
        report.append(f"{name} f32 (init and a step {t_init:.1f} s): SubstepLoop {ms:.1f} ms, {n} kernel launches, "
                      f"{prof[1]} kernels, device busy {prof[0]:.1f} ms, peak {peak:.3f} GiB; straight autograd "
                      f"{ms_ref:.1f} ms, {prof_ref[1]} kernels, busy {prof_ref[0]:.1f} ms, peak {peak_ref:.3f} GiB; "
                      f"relative L2 {rel:.3e}, max {_rel(g, g_ref, 'max'):.3e}")
        if name == "thermo off":
            # (no profiled call: digesting its ~145,000 kernels took ~25 s)
            t0 = time.perf_counter()
            grad, _, _ = ke_gradient(sim, steps=GRAD_ROLLOUT)
            g, ms, n, peak, _ = measure_gradient(grad, warm=False)
            transport_path("gradient", transport_cuda.launches, GRAD_ROLLOUT)
            if n != GRAD_ROLLOUT * per_loop:
                raise AssertionError(f"gradient rollout: {n} kernel launches, expected {GRAD_ROLLOUT * per_loop}")
            launches += n
            report.append(f"{GRAD_ROLLOUT}-step rollout f32 ({time.perf_counter() - t0:.1f} s): {ms:.1f} ms, {n} "
                          f"kernel launches, peak {peak:.3f} GiB")
        del sim, grad, g, g_ref

    t0 = time.perf_counter()
    sim = make_sim(GRAD, "float64")
    sim.step()
    grad, loss, wind = ke_gradient(sim)
    g, ms, n, peak, _ = measure_gradient(grad)
    transport_path("gradient", transport_cuda.launches, 1)
    single["float64"] = g.cpu().numpy()
    per_loop64 = momentum_cuda.launches_for(120, 464, 464, torch.float64)
    if n != per_loop64:
        raise AssertionError(f"gradient f64: {n} kernel launches, expected {per_loop64}")
    launches += n
    with straight_autograd():
        g_ref, ms_ref, _, peak_ref, _ = measure_gradient(grad)
    rel = _rel(g, g_ref, "max")
    if rel > GRAD_REL_MAX_F64:
        raise AssertionError(f"gradient f64: SubstepLoop vs straight autograd {rel:.3e} (relative max)")
    rng = np.random.default_rng(0)
    d = rng.standard_normal(tuple(wind.shape))
    d = 0.25 * (np.roll(d, 1, 0) + np.roll(d, -1, 0) + np.roll(d, 1, 1) + np.roll(d, -1, 1))
    d = torch.as_tensor(d, device="cuda")
    ad = float((g * d).sum())
    fds = {}
    with torch.no_grad():
        for eps in (1e-3, GRAD_FD_EPS):
            fds[eps] = (float(loss(wind + eps * d)) - float(loss(wind - eps * d))) / (2 * eps)
    fd = fds[GRAD_FD_EPS]
    if fd == 0.0 or abs(ad - fd) > GRAD_FD_RTOL_F64 * abs(fd):
        raise AssertionError(f"gradient f64: directional derivative {ad:.6e} against the central difference {fd:.6e}")
    report.append(f"thermo off f64 ({time.perf_counter() - t0:.1f} s): SubstepLoop {ms:.1f} ms, {n} kernel launches, "
                  f"peak {peak:.3f} GiB; straight {ms_ref:.1f} ms, peak {peak_ref:.3f} GiB; relative max {rel:.3e}; "
                  f"directional derivative {ad:.9e} against the central difference " + ", ".join(
                      f"{v:.9e} at eps {e:g} ({abs(ad - v) / abs(v):.3e})" for e, v in fds.items()))
    phase("grad", f"d(mean KE)/d(wind_u) through raw_step_fn at 464^2, BBM, 120 substeps, in "
          f"{time.perf_counter() - t_phase:.1f} s: " + "; ".join(report) + f"; {smi}")
    return launches, single


# --- 24. multi-device runs -----------------------------------------------------

MESH_RANKS = 4  # a 2x2 mesh
MESH_STEPS = 4
MESH_BIG = dict(BENCH_THERMO, **{"grid.nx": 1216, "grid.ny": 1216, "grid.resolution": 5e3})
MESH_CLI = ["--config-files", "configs/toy.cfg", "simul.duration=0.0625", "moorings.snapshot=false",
            "moorings.output_timestep=0.020833333333333332", "output.output_per_day=48",
            "restart.write_final_restart=true", "drifters.use_equally_spaced_drifters=true",
            "drifters.equally_spaced_drifters_output_time_step=0.006944444444444444"]
MESH_FILES = ("restart/restart_final.npz", "field_final.npz", "field_12.npz",
              "Moorings_20151016.nc", "Drifters_equally_spaced.nc")


def mesh_rank(cases, out_dir):
    """One rank of phase 24's world: each (name, overrides, warm-up steps,
    steps) case through ``Simulator.step`` on this rank's block, its kernel
    launches, exchanges and wall time counted from zero over the counted
    steps; rank 0 saves the gathered state to ``out_dir/<name>.npz``, and
    on the bbm H=6 case holds the kernel against the plain loop on its ext
    block (after the counts are read). Every rank writes its records to
    ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from nextsim_tpu_torch import Config, Simulator
    from nextsim_tpu_torch.ops import momentum, momentum_cuda, transport_cuda
    from nextsim_tpu_torch.parallel.distributed import local_device

    rank = dist.get_rank()
    device = local_device("cuda")
    records = []
    for name, over, warm, steps in cases:
        sim = Simulator(Config(overrides=over), device=device)
        for _ in range(warm):
            sim.step()
        torch.cuda.synchronize(device)
        dist.barrier()
        mesh = sim.mesh
        momentum_cuda.launches = transport_cuda.launches = 0
        mesh.exchanges, mesh.seconds, mesh.stats.messages, mesh.stats.bytes = 0, 0.0, 0, 0
        t0 = time.perf_counter()
        for _ in range(steps):
            sim.step()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        rec = {"name": name, "rank": rank, "device": str(device), "backend": dist.get_backend(),
               "block": list(sim.state.conc.shape), "launches": momentum_cuda.launches,
               "steps": steps, "wall": wall, "exchanges": mesh.exchanges,
               "exchange_s": mesh.seconds, "bytes": mesh.stats.bytes, "messages": mesh.stats.messages,
               **transport_counts(sim, steps)}
        host = sim.host_state()
        if rank == 0:
            arrays = {f: getattr(host, f) for f in host.__dataclass_fields__ if getattr(host, f) is not None}
            for f, a in arrays.items():
                if not np.isfinite(a).all():
                    raise AssertionError(f"mesh {name}: {f} is not finite")
            np.savez(Path(out_dir) / f"{name}.npz", **arrays)
        if rank == 0 and name == "bbm_h6":
            ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
            consts, carry = momentum.substep_setup(sim.state, sim._next_forcing(), ga, sim.dt, sim.dyn)
            H = mesh.halo_depth
            args = (H, sim.dt / sim.dyn.substeps, sim.dt, sim.grid.dx, "bbm", sim.dyn)
            got = momentum_cuda.substep_loop(consts, carry, *args)
            ref = momentum_cuda.substep_loop_reference(consts, carry, *args)
            rec["kernel_err"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        records.append(rec)
        del sim
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(records))


def _mesh_cli(out: Path, ranks: int):
    """The CLI on ``ranks`` ranks (one process without a world), started."""
    from nextsim_tpu_torch.parallel.distributed import free_port

    port = free_port()
    procs = []
    for r in range(ranks):
        env = dict(os.environ)
        extra = []
        if ranks > 1:
            env.update(RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(ranks), MASTER_ADDR="localhost", MASTER_PORT=str(port))
            extra = ["tpu.mesh_shape=2x2", "tpu.halo_depth=6"]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nextsim_tpu_torch", "--device", "cuda", *MESH_CLI,
             f"output.exporter_path={out}", *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait_all(procs, what):
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{what}: a process exited {p.returncode}: {out[-3000:]}")


def _same_files(a: Path, b: Path) -> int:
    """Every array of MESH_FILES in ``a`` equals ``b``'s bitwise; returns
    how many arrays were compared."""
    from scipy.io import netcdf_file

    n = 0
    for name in MESH_FILES:
        if name.endswith(".npz"):
            with np.load(a / name) as x, np.load(b / name) as y:
                pairs = [(k, x[k], y[k]) for k in y.files]
                if sorted(x.files) != sorted(y.files):
                    raise AssertionError(f"mesh CLI {name}: arrays {sorted(x.files)} vs {sorted(y.files)}")
        else:
            with netcdf_file(a / name, "r", mmap=False) as x, netcdf_file(b / name, "r", mmap=False) as y:
                pairs = [(k, np.asarray(x.variables[k][:]), np.asarray(y.variables[k][:])) for k in y.variables]
        for k, u, v in pairs:
            if k != "__meta__" and not np.array_equal(u, v, equal_nan=True):
                raise AssertionError(f"mesh CLI {name}: {k} differs from the one-process run")
            n += 1
    return n


def mesh_phase(smi: str):
    """Phase 24: a 2x2 mesh of 4 ranks (gloo with host-staged strips when
    they share a card, NCCL when each has its own): the 464^2 thermo-on
    main path, MESH_STEPS steps, bbm and evp at halo depth 1 and 6, gathered state
    bitwise = the single-device Simulator; 1216^2 at 5 km, thermo on, H = 6,
    3 steps timed after one; the CLI on toy.cfg with moorings, snapshots,
    drifters and a final restart on 4 ranks = on one process, bitwise.
    Returns (the kernel launches of the mesh runs summed over the ranks,
    the kernel's max |diff| from the plain loop on an ext block)."""
    import tempfile

    import torch

    from nextsim_tpu_torch import state_to_numpy
    from nextsim_tpu_torch.parallel.distributed import run_world

    t_phase = time.perf_counter()
    scratch = ROOT / "nextsim_tpu_torch" / "build"  # git-ignored
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        (tmp / "world").mkdir()
        cases = [(f"{d}_h{h}", dict(BENCH_THERMO, **{"setup.dynamics-type": d, "tpu.mesh_shape": "2x2",
                                                    "tpu.halo_depth": h}), 0, MESH_STEPS)
                 for d in ("bbm", "evp") for h in (1, 6)]
        cases.append(("big", dict(MESH_BIG, **{"tpu.mesh_shape": "2x2", "tpu.halo_depth": 6}), 1, 3))
        run_world(mesh_rank, MESH_RANKS, args=(cases, str(tmp / "world")), device="cuda", timeout=300)
        # the CLI runs, 4 ranks and 1 process, beside the single-device runs
        cli = _mesh_cli(tmp / "cli4", MESH_RANKS) + _mesh_cli(tmp / "cli1", 1)
        records = [r for k in range(MESH_RANKS)
                   for r in json.loads((tmp / "world" / f"rank{k}.json").read_text())]
        for d in ("bbm", "evp"):
            sim = make_sim(dict(BENCH_THERMO, **{"setup.dynamics-type": d}))
            for _ in range(MESH_STEPS):
                sim.step()
            ref = state_to_numpy(sim.state)
            del sim
            for h in (1, 6):
                with np.load(tmp / "world" / f"{d}_h{h}.npz") as got:
                    bad = [f for f, v in ref.items() if not np.array_equal(got[f], v)]
                if bad:
                    raise AssertionError(f"mesh {d} H={h}: {bad} differ from the single-device Simulator")
            torch.cuda.empty_cache()
        _wait_all(cli, "mesh CLI")
        n_arrays = _same_files(tmp / "cli4", tmp / "cli1")
        if sorted(p.name for p in (tmp / "cli4").glob("Moorings_*")) != ["Moorings_20151016.nc"]:
            raise AssertionError("mesh CLI: more than rank 0 wrote moorings")

    def of(name):
        return [r for r in records if r["name"] == name]

    for name in ("bbm_h1", "bbm_h6", "evp_h1", "evp_h6", "big"):
        rs = of(name)
        if any(r["launches"] <= 0 for r in rs):
            raise AssertionError(f"mesh {name}: a rank ran without the kernel: {[r['launches'] for r in rs]}")
        phase("mesh", f"{name}: blocks {[tuple(r['block']) for r in rs]}, {rs[0]['backend']} on "
              f"{sorted({r['device'] for r in rs})}; {rs[0]['steps']} steps, ms/step by rank "
              f"{[round(1e3 * r['wall'] / r['steps'], 2) for r in rs]}, exchange share "
              f"{[round(r['exchange_s'] / r['wall'], 3) for r in rs]}, {rs[0]['exchanges'] // rs[0]['steps']} "
              f"exchanges a step, bytes sent a step by rank {[r['bytes'] // r['steps'] for r in rs]}, "
              f"kernel launches by rank {[r['launches'] for r in rs]}; {smi}")
    transport_ranks("mesh", records)
    kernel_err = max(r.get("kernel_err", 0.0) for r in records)
    if kernel_err != 0.0:
        raise AssertionError(f"mesh: the kernel on rank 0's ext block is {kernel_err} off the plain loop")
    phase("mesh", f"464^2 thermo on, bbm and evp, H = 1 and 6: the gathered 2x2 state equals the "
          f"single-device Simulator bitwise after {MESH_STEPS} steps; the kernel on rank 0's ext block "
          f"equals the plain loop bitwise (bbm, 6 substeps); 4-rank CLI = 1-process CLI on "
          f"{n_arrays} arrays of {len(MESH_FILES)} files; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s; times of ranks that share one card are no scaling "
          f"numbers; {smi}")
    return sum(r["launches"] for r in records), kernel_err


# --- 25-27. the WIM on a mesh, the member mesh, gradients on a mesh ----------

MESH_WAVE_STEPS = 21  # WIM exchanges at steps 0 and 20
# outputs off: the phase compares states; moorings and drifters are phase 14's
MESH_WAVE_OVER = {"moorings.use_moorings": False, "drifters.use_equally_spaced_drifters": False}
# If the gathered wave-path state is not bitwise the single device's, each
# field within this share of its largest magnitude (float32, 21 steps; the
# BBM failure branch may amplify an ulp of the wave stress)
MESH_WAVE_RTOL = 1e-3
MESH_ENSEMBLE_STEPS = 3
# phase 23's gradient against the mesh's, relative L2 (the mesh's substep
# loop runs H = 6 substeps a call, so float32 sums associate otherwise)
MESH_GRAD_REL_L2 = {"float32": 1e-5, "float64": 1e-12}


def _wave_config(tmp: Path, **over):
    """Phase 14's wave-path configuration (configs/arctic_10km.cfg with
    WAVE_CFG on the phase-11 and phase-14 files), outputs off, with ``over``."""
    from nextsim_tpu_torch import Config

    overrides = dict(a.split("=", 1) for a in DATASET_ARGS)
    overrides.update(MESH_WAVE_OVER, **over)
    return Config.from_files(str(ROOT / "configs" / "arctic_10km.cfg"), str(tmp / "waves.cfg"), overrides=overrides)


def mesh_waves_rank(tmp, out_dir):
    """One rank of phase 25: the wave path on this rank's block of a 2x2
    mesh for MESH_WAVE_STEPS steps through ``Simulator.step``, each step
    synchronized and timed, each WIM exchange timed with its ring bytes;
    the kernel launches counted from zero over the steps. Rank 0 saves the
    gathered state and the WIM's dfloe, broken, tau_x and tau_y, and holds
    the kernel against the plain loop on its ext block of the step-20 state
    after the count. Every rank writes its record to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from nextsim_tpu_torch import Simulator
    from nextsim_tpu_torch.ops import momentum, momentum_cuda, transport_cuda, welding_cuda
    from nextsim_tpu_torch.parallel.distributed import local_device

    rank = dist.get_rank()
    device = local_device("cuda")
    t0 = time.perf_counter()
    sim = Simulator(_wave_config(Path(tmp), **{"tpu.mesh_shape": "2x2", "tpu.halo_depth": 6,
                                               "output.exporter_path": str(Path(out_dir) / "run")}), device=device)
    init_s = time.perf_counter() - t0
    exchange, exchanges = sim._wim_exchange, []

    def timed_exchange(forcing=None):
        torch.cuda.synchronize(device)
        b0, s0, a = sim.wim.mesh.stats.bytes, sim.wim.mesh.seconds, time.perf_counter()
        exchange(forcing)
        torch.cuda.synchronize(device)
        exchanges.append({"wall": time.perf_counter() - a, "ring_bytes": sim.wim.mesh.stats.bytes - b0,
                          "ring_s": sim.wim.mesh.seconds - s0, "rings": sim.wim.mesh.exchanges})

    sim._wim_exchange = timed_exchange
    dist.barrier()
    momentum_cuda.launches = welding_cuda.launches = transport_cuda.launches = 0
    step_ms, snap = [], None
    for k in range(MESH_WAVE_STEPS):
        if k == MESH_WAVE_STEPS - 1:  # the step-20 state and the next step's forcing, for the check
            state = sim.state.replace(**{f: getattr(sim.state, f).clone() for f in sim.state.__dataclass_fields__
                                         if getattr(sim.state, f) is not None})
            snap = (state, sim._next_forcing(), sim.c_fix + sim.c_alea * state.random_number)
        a = time.perf_counter()
        sim.step()
        torch.cuda.synchronize(device)
        step_ms.append(1e3 * (time.perf_counter() - a))
    launches = momentum_cuda.launches
    rec = {"rank": rank, "device": str(device), "backend": dist.get_backend(), "block": list(sim.state.conc.shape),
           "welding_launches": welding_cuda.launches,
           "wim_block": list(sim.wim.sdf.shape), "init_s": init_s, "launches": launches, "step_ms": step_ms,
           "exchanges": exchanges, "seam_s": sim.mesh.seconds, "seam_bytes": sim.mesh.stats.bytes,
           "wim_ring_s": sim.wim.mesh.seconds, "wim_ring_bytes": sim.wim.mesh.stats.bytes,
           **transport_counts(sim, MESH_WAVE_STEPS)}
    host = sim.host_state()
    wim = sim.wim.gather({"dfloe": sim.wim.ice["dfloe"], "broken": sim.wim.ice["broken"],
                          "tau_x": sim.wim_diag["tau_x"], "tau_y": sim.wim_diag["tau_y"]})
    if rank == 0:
        arrays = {f: getattr(host, f) for f in host.__dataclass_fields__ if getattr(host, f) is not None}
        np.savez(Path(out_dir) / "mesh_waves.npz", **arrays, **{f"wim_{k}": v for k, v in wim.items()})
        state, forcing, cohesion = snap
        ga = dict(sim.grid_arrays, cohesion=cohesion)
        consts, carry = momentum.substep_setup(state, forcing, ga, sim.dt, sim.dyn)
        args = (sim.mesh.halo_depth, sim.dt / sim.dyn.substeps, sim.dt, sim.grid.dx, "bbm", sim.dyn)
        got = momentum_cuda.substep_loop(consts, carry, *args)
        ref = momentum_cuda.substep_loop_reference(consts, carry, *args)
        rec["kernel_err"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))


def mesh_waves_phase(tmp: Path, smi: str):
    """Phase 25: the wave path of phase 14 (608^2, ERA5 + TOPAZ4 + ETOPO +
    ERA-Interim waves, thermo on with melt_type 3, 20 FSD bins, the WIM
    25 x 16 co-located every 20 steps) on a 2x2 mesh of 4 ranks on the card,
    H = 6, 21 steps (two WIM exchanges), against the single-device
    Simulator over the same steps. Returns (kernel launches of the mesh run
    summed over the ranks, the kernel's max |diff| on rank 0's ext block)."""
    import torch

    from nextsim_tpu_torch import Simulator, state_to_numpy
    from nextsim_tpu_torch.ops.welding_cuda import LAUNCHES_A_CALL
    from nextsim_tpu_torch.parallel.distributed import run_world

    t_phase = time.perf_counter()
    world = tmp / "mesh_waves"
    world.mkdir()
    run_world(mesh_waves_rank, MESH_RANKS, args=(str(tmp), str(world)), device="cuda", timeout=600)
    t_world = time.perf_counter() - t_phase
    recs = [json.loads((world / f"rank{r}.json").read_text()) for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    sim = Simulator(_wave_config(tmp, **{"output.exporter_path": str(tmp / "mesh_waves_1")}), device="cuda")
    for _ in range(MESH_WAVE_STEPS):
        sim.step()
    sync()
    t_ref = time.perf_counter() - t0
    ref = state_to_numpy(sim.state)
    ref.update({f"wim_{k}": v.cpu().numpy() for k, v in (("dfloe", sim.wim.ice["dfloe"]),
                                                         ("broken", sim.wim.ice["broken"]),
                                                         ("tau_x", sim.wim_diag["tau_x"]),
                                                         ("tau_y", sim.wim_diag["tau_y"]))})
    n_broken = int((sim.wim.ice["broken"] > 0.5).sum())
    del sim
    torch.cuda.empty_cache()
    worst, bitwise = {}, True
    with np.load(world / "mesh_waves.npz") as got:
        for f, v in ref.items():
            g = got[f]
            if g.shape != v.shape or not np.isfinite(g).all():
                raise AssertionError(f"mesh waves: {f} of shape {g.shape} or not finite")
            d = float(np.abs(g.astype(np.float64) - v).max())
            worst[f] = d
            bitwise &= bool(np.array_equal(g, v))
            if d > MESH_WAVE_RTOL * max(float(np.abs(v).max()), 1e-30):
                raise AssertionError(f"mesh waves: {f} differs from the single device by {d:.3e}")
    if n_broken == 0:
        raise AssertionError("mesh waves: the WIM broke no floes")
    if any(r["launches"] <= 0 for r in recs):
        raise AssertionError(f"mesh waves: a rank ran without the kernel: {[r['launches'] for r in recs]}")
    if any(r["welding_launches"] != MESH_WAVE_STEPS * LAUNCHES_A_CALL for r in recs):
        raise AssertionError(f"mesh waves: welding launches by rank {[r['welding_launches'] for r in recs]}, "
                             f"not one call ({LAUNCHES_A_CALL} launches) a step")
    transport_ranks("mesh_waves", recs)
    kernel_err = recs[0]["kernel_err"]
    if kernel_err != 0.0:
        raise AssertionError(f"mesh waves: the kernel on rank 0's ext block is {kernel_err} off the plain loop")
    between = [float(np.median(r["step_ms"][1:MESH_WAVE_STEPS - 1])) for r in recs]
    phase("mesh waves", f"phase 14's wave path (608^2, WIM 25 x 16 co-located, 20 bins) on a 2x2 mesh, H = 6, "
          f"{MESH_WAVE_STEPS} steps: blocks {[tuple(r['block']) for r in recs]}, WIM blocks "
          f"{[tuple(r['wim_block'][2:]) for r in recs]} (rings of 4, y-periodic), {recs[0]['backend']} on "
          f"{sorted({r['device'] for r in recs})}; init by rank {[round(r['init_s'], 1) for r in recs]} s; "
          f"ms/step between exchanges (median of steps 1-19) by rank {[round(m, 2) for m in between]}; WIM exchanges "
          f"by rank {[[round(e['wall'], 3) for e in r['exchanges']] for r in recs]} s, their ring exchanges "
          f"{[[round(e['ring_s'], 3) for e in r['exchanges']] for r in recs]} s, ring bytes a WIM exchange by rank "
          f"{[[e['ring_bytes'] for e in r['exchanges']] for r in recs]}; Seam.seconds of the sea ice by rank "
          f"{[round(r['seam_s'], 3) for r in recs]} s ({[r['seam_bytes'] for r in recs]} bytes); kernel launches by "
          f"rank {[r['launches'] for r in recs]}, welding launches {[r['welding_launches'] for r in recs]}; the world "
          f"took {t_world:.1f} s; {smi}")
    phase("mesh waves", f"against the single-device Simulator over the same {MESH_WAVE_STEPS} steps ({t_ref:.1f} s, "
          f"{n_broken} broken cells): {'bitwise equal' if bitwise else f'not bitwise equal (tolerance {MESH_WAVE_RTOL:g} of each field magnitude, float32)'}; "
          f"max |diff| by field {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}; the kernel on rank 0's "
          f"ext block of the step-20 state equals the plain loop bitwise (bbm, 6 substeps); times of ranks that "
          f"share one card are no scaling numbers; {smi}")
    return sum(r["launches"] for r in recs), kernel_err, sum(r["welding_launches"] for r in recs)


def mesh_ensemble_rank(cfg_path, overrides, cases, out_dir):
    """One rank of phase 26: each (name, mesh, steps, checkpoint) case, a
    ``BatchedEnsemble`` of ENSEMBLE_MEMBERS members on the member mesh
    ``mesh``, ``steps`` steps timed and counted; rank 0 saves every member's
    state; with ``checkpoint``, the ensemble writes it, steps once more and
    rank 0 saves the members again. Records to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from nextsim_tpu_torch import Config
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda
    from nextsim_tpu_torch.parallel.distributed import local_device

    rank = dist.get_rank()
    device = local_device("cuda")
    recs = []

    def save(ens, name):
        members = [ens.member_state(m) for m in range(ens.n)]
        if rank == 0:
            np.savez(Path(out_dir) / f"{name}.npz", **{f"{m}_{f}": getattr(st, f).cpu().numpy() for m, st in
                                                       enumerate(members) for f in st.__dataclass_fields__
                                                       if getattr(st, f) is not None})

    for name, mesh, steps, checkpoint in cases:
        t0 = time.perf_counter()
        ens = BatchedEnsemble(Config.from_files(cfg_path, overrides=overrides), ENSEMBLE_MEMBERS, device=device,
                              mesh=tuple(mesh))
        init_s = time.perf_counter() - t0
        dist.barrier()
        momentum_cuda.launches = transport_cuda.launches = 0
        step_ms = []
        for k in range(steps + bool(checkpoint)):
            if k == steps:  # the checkpoint, then one more step
                save(ens, name)
                ens.write_restart(checkpoint)
            a = time.perf_counter()
            ens.step()
            torch.cuda.synchronize(device)
            step_ms.append(1e3 * (time.perf_counter() - a))
        launches = momentum_cuda.launches
        save(ens, f"{name}_next" if checkpoint else name)
        # a batched step runs one loop of launches for the rank's members:
        # on blocks, substeps / H calls of H substeps on the ext block
        sim, block = ens.sim, tuple(ens.states.conc.shape[1:])
        calls, per_call = (1, sim.dyn.substeps) if sim.mesh is None else (
            sim.dyn.substeps // sim.mesh.halo_depth, sim.mesh.halo_depth)
        per_step = calls * momentum_cuda.launches_for(per_call, *block, sim.dtype, sim.dyn.dynamics_type,
                                                      members=len(ens.members))
        recs.append({"name": name, "rank": rank, "members": ens.members, "init_s": init_s, "step_ms": step_ms,
                     "launches": launches, "block": list(block), "per_step": per_step,
                     "steps": steps + bool(checkpoint), **transport_counts(ens, steps + bool(checkpoint))})
        del ens
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(recs))


def mesh_ensemble_phase(tmp: Path, smi: str, ens, early):
    """Phase 26: phase 19's configuration and files, 4 members, on the
    member meshes (4,) (a member a rank) and (2, 1, 2) (two members on 1x2
    blocks a group), MESH_ENSEMBLE_STEPS steps: every member equals phase
    19's single-device ``BatchedEnsemble`` member after as many steps
    (``early``) bitwise; the (4,) checkpoint read into phase 19's ensemble
    (``ens``) equals it, and one more step stays equal. Returns the kernel
    launches of the member-mesh runs summed over the ranks."""
    import shutil

    import torch

    from nextsim_tpu_torch import state_to_numpy
    from nextsim_tpu_torch.ops import momentum_cuda
    from nextsim_tpu_torch.parallel.distributed import run_world

    t_phase = time.perf_counter()
    world = tmp / "mesh_ensemble"
    world.mkdir()
    overrides = dict(a.split("=", 1) for a in DATASET_ARGS)
    overrides.update({"output.exporter_path": str(world / "run"), "moorings.use_moorings": False,
                      "tpu.halo_depth": 6})
    cases = [("m4", (4,), MESH_ENSEMBLE_STEPS, "mesh4"), ("m212", (2, 1, 2), MESH_ENSEMBLE_STEPS, None)]
    run_world(mesh_ensemble_rank, MESH_RANKS, args=(str(ROOT / "configs" / "arctic_10km.cfg"), overrides, cases,
                                                     str(world)), device="cuda", timeout=600)
    t_world = time.perf_counter() - t_phase
    recs = [r for k in range(MESH_RANKS) for r in json.loads((world / f"rank{k}.json").read_text())]

    def same(npz, states, what):
        with np.load(npz) as got:
            bad = [f"{m}_{f}" for m, st in enumerate(states) for f, v in st.items()
                   if not np.array_equal(got[f"{m}_{f}"], v)]
        if bad:
            raise AssertionError(f"mesh ensemble {what}: {bad} differ")

    for name in ("m4", "m212"):
        same(world / f"{name}.npz", early, f"{name} against phase 19's members")
    # the (4,) checkpoint into phase 19's single-device ensemble
    shutil.copy(world / "run" / "restart" / "restart_mesh4.npz", Path(ens._restart_file("mesh4")))
    ens.read_restart("mesh4")
    if ens.pcpt != MESH_ENSEMBLE_STEPS:
        raise AssertionError(f"mesh ensemble checkpoint: pcpt {ens.pcpt}")
    same(world / "m4.npz", [state_to_numpy(ens.member_state(m)) for m in range(ens.n)], "checkpoint read")
    momentum_cuda.launches = 0
    ens.step()
    n_one = momentum_cuda.launches
    same(world / "m4_next.npz", [state_to_numpy(ens.member_state(m)) for m in range(ens.n)], "one more step")
    torch.cuda.empty_cache()
    per_step = momentum_cuda.launches_for(ens.sim.dyn.substeps, *ens.sim.grid.shape, ens.sim.dtype,
                                          ens.sim.dyn.dynamics_type, members=ens.n)
    if n_one != per_step:
        raise AssertionError(f"mesh ensemble: the single device's batched step launched {n_one}, not {per_step}")

    transport_ranks("mesh_ensemble", recs)

    def of(name):
        return [r for r in recs if r["name"] == name]

    for name, what in (("m4", "(4,): a member a rank"),
                       ("m212", "(2, 1, 2): 2 members on 1x2 blocks a group, the batched step")):
        rs = of(name)
        if any(r["launches"] <= 0 or r["launches"] != r["per_step"] * r["steps"] for r in rs):
            raise AssertionError(f"mesh ensemble {name}: kernel launches by rank {[r['launches'] for r in rs]}, "
                                 f"not one batched loop a step ({[r['per_step'] for r in rs]})")
        phase("mesh ensemble", f"{what}: members by rank {[r['members'] for r in rs]}, blocks "
              f"{[tuple(r['block']) for r in rs]}; init by rank {[round(r['init_s'], 1) for r in rs]} s; ms/step by rank "
              f"{[[round(m, 1) for m in r['step_ms']] for r in rs]}; kernel launches by rank {[r['launches'] for r in rs]} "
              f"({[r['per_step'] for r in rs]} a step: one loop for the rank's members); {smi}")
    phase("mesh ensemble", f"phase 19's configuration (608^2, ERA5 + TOPAZ4 + ETOPO, thermo on), 4 members x "
          f"{MESH_ENSEMBLE_STEPS} steps on the member meshes (4,) and (2, 1, 2): every member equals phase 19's "
          f"single-device BatchedEnsemble bitwise; the (4,) checkpoint read by phase 19's ensemble equals it, and one "
          f"more step stays equal bitwise; the world took {t_world:.1f} s; times of ranks that share one card are no "
          f"scaling numbers; {smi}")
    return sum(r["launches"] for r in recs)


def mesh_gradient_rank(out_dir):
    """One rank of phase 27: phase 23's thermo-off 464^2 configuration on a
    2x2 mesh, H = 6, one forward step, then d(mean KE after one step)/
    d(wind_u) through ``raw_step_fn``, float32 and float64: each rank's loss
    counts its own nodes (a seam node once), ``Seam.fold`` adds the blocks'
    gradients; one warm call, then one timed with its kernel launches and
    peak memory. Rank 0 saves the gradients; records to ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from nextsim_tpu_torch import Config, Simulator
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda
    from nextsim_tpu_torch.parallel.distributed import local_device

    rank = dist.get_rank()
    device = local_device("cuda")
    recs, grads = [], {}
    for dtype_name in ("float32", "float64"):
        sim = Simulator(Config(overrides=dict(GRAD, **{"tpu.dtype": dtype_name, "tpu.mesh_shape": "2x2",
                                                       "tpu.halo_depth": 6})), device=device)
        sim.step()
        f = sim.forcing_provider(sim.current_time, sim.time_init)
        ti = sim.time_info()
        n = (sim.grid.ny + 1) * (sim.grid.nx + 1)

        def grad():
            wind = sim.to_blocks(f.wind_u).detach().requires_grad_(True)
            s, _, _ = sim.raw_step_fn(sim.state, sim.to_blocks(f).replace(wind_u=wind), ti)
            ke = (s.vt_u * s.vt_u + s.vt_v * s.vt_v)[sim.mesh.layout.count_index(True)]
            (g,) = torch.autograd.grad(ke.sum() / n, wind)
            return sim.mesh.fold(g)

        grad()  # warm
        torch.cuda.synchronize(device)
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        momentum_cuda.launches = transport_cuda.launches = 0
        rings0 = sim.mesh.exchanges
        t0 = time.perf_counter()
        g = grad()
        torch.cuda.synchronize(device)
        ms = 1e3 * (time.perf_counter() - t0)
        launches = momentum_cuda.launches
        transported = transport_counts(sim, 1)  # one step's forward
        peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        rings = sim.mesh.exchanges - rings0
        # one more call of the float32 gradient under the profiler: every
        # kernel on the card (float64's: not profiled, to save its digest)
        _, busy, kernels = profiled(grad, host_events=False) if dtype_name == "float32" else (None, None, None)
        recs.append({"dtype": dtype_name, "rank": rank, "ms": ms, "launches": launches, "peak_gib": peak,
                     "rings": rings, "kernels": kernels, "busy_ms": busy, "block": list(sim.state.conc.shape),
                     **transported})
        grads[dtype_name] = g.cpu().numpy()
        if not np.isfinite(grads[dtype_name]).all():
            raise AssertionError(f"mesh gradient {dtype_name}: not finite")
        del sim
        torch.cuda.empty_cache()
    if rank == 0:
        np.savez(Path(out_dir) / "mesh_grad.npz", **grads)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(recs))


def mesh_gradient_phase(tmp: Path, smi: str, single: dict):
    """Phase 27: the gradient of phase 23 (thermo off, 464^2, one forward
    step first) on a 2x2 mesh, H = 6, float32 and float64, against phase
    23's single-device gradients ``single`` (relative L2 within
    MESH_GRAD_REL_L2). Returns the kernel launches of the timed gradients
    summed over the ranks."""
    from nextsim_tpu_torch.parallel.distributed import run_world

    t_phase = time.perf_counter()
    world = tmp / "mesh_grad"
    world.mkdir()
    run_world(mesh_gradient_rank, MESH_RANKS, args=(str(world),), device="cuda", timeout=600)
    recs = [r for k in range(MESH_RANKS) for r in json.loads((world / f"rank{k}.json").read_text())]
    report = []
    with np.load(world / "mesh_grad.npz") as got:
        for dtype_name in ("float32", "float64"):
            g, ref = got[dtype_name].astype(np.float64), single[dtype_name].astype(np.float64)
            rel = float(np.linalg.norm(g - ref) / np.linalg.norm(ref))
            if not rel <= MESH_GRAD_REL_L2[dtype_name]:
                raise AssertionError(f"mesh gradient {dtype_name}: {rel:.3e} (relative L2) from phase 23's")
            rs = [r for r in recs if r["dtype"] == dtype_name]
            transport_ranks("mesh_gradient", rs)
            if any(r["launches"] <= 0 for r in rs):
                raise AssertionError(f"mesh gradient {dtype_name}: a rank ran without the kernel")
            profile = (f", kernels by rank {[r['kernels'] for r in rs]} (device busy "
                       f"{[round(r['busy_ms'], 1) for r in rs]} ms; one more call under torch.profiler)"
                       if rs[0]["kernels"] is not None else "")
            report.append(f"{dtype_name}: relative L2 {rel:.3e} from phase 23's single-device gradient (max "
                          f"{float(np.abs(g - ref).max() / np.abs(ref).max()):.3e}); ms by rank "
                          f"{[round(r['ms'], 1) for r in rs]}, substep-kernel launches by rank "
                          f"{[r['launches'] for r in rs]}{profile}, "
                          f"ring exchanges by rank {[r['rings'] for r in rs]}, peak memory by rank "
                          f"{[round(r['peak_gib'], 3) for r in rs]} GiB")
    phase("mesh grad", f"d(mean KE)/d(wind_u) through raw_step_fn at 464^2 on a 2x2 mesh, H = 6, BBM, blocks "
          f"{sorted({tuple(r['block']) for r in recs})}, each rank's loss on its own nodes, Seam.fold: "
          + "; ".join(report) + f"; the phase took {time.perf_counter() - t_phase:.1f} s; times of ranks that "
          f"share one card are no scaling numbers; {smi}")
    return sum(r["launches"] for r in recs)


# --- 28. the bfloat16 state ---------------------------------------------------

BF16_RAGGED_STEPS = 11  # substeps of the 1216^2 comparison: a remainder launch
BF16_STEPS = 10  # steps of the thermo-on run through step_chunk
BF16_CLI_STEPS = 3  # steps before and after the CLI's restart


def _bf16_registers() -> str:
    """ptxas' register lines of the bfloat16 kernels in the build log."""
    from nextsim_tpu_torch.ops import momentum_cuda

    out, current = [], None
    for ln in momentum_cuda.build_log.splitlines():
        if "Compiling entry function" in ln:
            current = "bf16" in ln and ln.split("ELi")[1].split("E")[0]
        elif current and "registers" in ln:
            out.append(f"{('bbm', 'evp', 'mevp')[int(current)]}: {ln.split(':', 1)[1].strip()}")
    return "; ".join(out)


def bf16_cli_resume(smi: str) -> str:
    """configs/toy.cfg (128^2) through the CLI's entry point in this process
    with tpu.dtype=bfloat16: BF16_CLI_STEPS steps with a final restart, a
    resume from it for BF16_CLI_STEPS more, against 2 x BF16_CLI_STEPS
    uninterrupted steps: the final restarts bitwise equal, their planes
    |V2 records."""
    import tempfile

    from nextsim_tpu_torch import __main__ as cli

    scratch = ROOT / "nextsim_tpu_torch" / "build"  # git-ignored
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        base = ["--device", "cuda", "--config-files", str(ROOT / "configs" / "toy.cfg"), "tpu.dtype=bfloat16",
                "restart.write_final_restart=true", "restart.datetime_in_filename=false",
                "restart.type=continue"]
        walls = []
        for name, steps, extra in (("first", BF16_CLI_STEPS, []),
                                   ("resumed", BF16_CLI_STEPS,
                                    ["restart.start_from_restart=true", "restart.basename=final",
                                     f"restart.input_path={tmp / 'first' / 'restart'}"]),
                                   ("straight", 2 * BF16_CLI_STEPS, [])):
            t0 = time.perf_counter()
            rc = cli.main([*base, f"simul.duration={steps * STEP_DAYS_TOY!r}",
                           f"output.exporter_path={tmp / name}", *extra])
            walls.append(time.perf_counter() - t0)
            if rc != 0:
                raise AssertionError(f"bf16 CLI run {name} exited {rc}")
        out = {}
        # the resumed run writes its restarts into restart.input_path
        for name, run in (("resumed", "first"), ("straight", "straight")):
            with np.load(tmp / run / "restart" / "restart_final.npz") as z:
                out[name] = {k: z[k] for k in z.files}
        planes = [k for k in out["straight"] if not k.startswith("__")]
        for k in planes:
            if out["straight"][k].dtype != np.dtype("V2"):
                raise AssertionError(f"bf16 CLI restart: {k} is {out['straight'][k].dtype}, not |V2")
        meta = {k: json.loads(str(v["__meta__"]))["pcpt"] for k, v in out.items()}
        for k, ref in out["straight"].items():
            if k != "__meta__" and not np.array_equal(out["resumed"][k].view(np.uint8), ref.view(np.uint8)):
                raise AssertionError(f"bf16 CLI: the resumed run's {k} differs from the uninterrupted run's")
        size = (tmp / "straight" / "restart" / "restart_final.npz").stat().st_size
    return (f"CLI toy.cfg 128^2 bf16: {BF16_CLI_STEPS} steps + restart, resume {BF16_CLI_STEPS} more = "
            f"{2 * BF16_CLI_STEPS} uninterrupted bitwise ({len(planes)} |V2 planes, pcpt {meta}, restart "
            f"{size} bytes; runs {', '.join(f'{w:.1f}' for w in walls)} s)")


def bf16_phase(smi: str, host_state: dict, spun: dict) -> tuple:
    """Phase 28: the bfloat16 build of the kernel and tpu.dtype=bfloat16 on
    the card. Returns (the kernel's launches of the thermo-on bfloat16
    run, {rheology: bitwise}, the kernel's ms and the plain loop's ms of a
    120-substep bbm loop at 464^2, its bound)."""
    import torch

    from nextsim_tpu_torch import state_from_numpy
    from nextsim_tpu_torch.model import checks
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    pl = momentum_cuda.launch_plan(464, 464, 120, bf16, "bbm")
    phase("bf16", f"plan 464^2 bbm bfloat16: tile {pl.tile_h} x {pl.tile_w} nodes, {pl.k} substeps a launch, "
          f"{pl.n_planes} planes in records of {momentum_cuda.record_len(pl.n_planes, 2)} values, "
          f"{pl.smem_bytes} bytes of shared memory, {pl.threads} threads, {pl.blocks_y} x {pl.blocks_x} "
          f"blocks, {len(pl.launches)} launches a 120-substep loop; ptxas {_bf16_registers()}")

    # the kernel against the plain bfloat16 loop on the compare phase's state
    sim = make_sim(spun, "bfloat16")
    state = state_from_numpy(host_state, device="cuda", dtype=bf16)
    bitwise, report = {}, []
    for dyn in ("bbm", "evp", "mevp"):
        consts, carry, p = setup_for(sim, dyn, state)
        ref = run_loop(momentum_cuda.substep_loop_reference, consts, carry, 120, sim, p)
        out = run_loop(momentum_cuda.substep_loop, consts, carry, 120, sim, p)
        sync()
        if not all(o.dtype == bf16 and bool(torch.isfinite(o).all()) for o in out):
            raise AssertionError(f"bf16 kernel {dyn}: not bfloat16 or not finite")
        bitwise[dyn] = all(torch.equal(o, r) for o, r in zip(out, ref))
        diff = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
        report.append(f"{dyn} {'bitwise' if bitwise[dyn] else f'max |diff| {diff:.3e}'}")
        if dyn != "mevp" and not bitwise[dyn]:
            raise AssertionError(f"bf16 kernel {dyn}: not bitwise equal to the plain bfloat16 loop at 464^2")
    del sim, state

    # a ragged 1216^2 plan: edge tiles cut by the grid, a remainder launch
    big = make_sim(dict(BENCH, **{"grid.nx": 1216, "grid.ny": 1216, "grid.resolution": 5e3,
                                  "simul.spinup_duration": 0.0, "ideal_simul.constant_wind_u": 20.0}),
                   "bfloat16")
    big.step()
    consts, carry, p = setup_for(big, "bbm")
    rp = momentum_cuda.launch_plan(1216, 1216, BF16_RAGGED_STEPS, bf16, "bbm")
    ref = run_loop(momentum_cuda.substep_loop_reference, consts, carry, BF16_RAGGED_STEPS, big, p)
    out = run_loop(momentum_cuda.substep_loop, consts, carry, BF16_RAGGED_STEPS, big, p)
    sync()
    if not all(torch.equal(o, r) for o, r in zip(out, ref)):
        raise AssertionError("bf16 kernel at 1216^2: not bitwise equal to the plain bfloat16 loop")
    report.append(f"1216^2 bbm {BF16_RAGGED_STEPS} substeps bitwise (tiles {rp.tile_h} x {rp.tile_w}, the last "
                  f"row and column {1217 - (rp.blocks_y - 1) * rp.tile_h} x {1217 - (rp.blocks_x - 1) * rp.tile_w}, "
                  f"launches {rp.launches})")
    ms_1216 = min(event_ms(lambda: run_loop(momentum_cuda.substep_loop, consts, carry, 120, big, p))
                  for _ in range(2))
    bound_1216 = kernel_bound_ms(1216, 1216, 120, bf16, "bbm")[0]
    report.append(f"a 120-substep bbm loop at 1216^2 in bfloat16 {ms_1216:.3f} ms "
                  f"({momentum_cuda.launches_for(120, 1216, 1216, bf16)} launches), bound {bound_1216:.4f} ms: "
                  f"{100 * bound_1216 / ms_1216:.1f}% of it; {smi}")
    del big, consts, carry, ref, out
    phase("bf16", "kernel vs plain bfloat16 loop on the card, 120 substeps on the 464^2 state of the compare "
          "phase: " + "; ".join(report))

    # one 120-substep bbm loop at 464^2, bfloat16 beside float32, in turns
    sims = {"float32": make_sim(BENCH), "bfloat16": make_sim(BENCH, "bfloat16")}
    loops = {}
    for name, s_ in sims.items():
        consts, carry, p = setup_for(s_, "bbm")
        loops[name] = (lambda fn, c=consts, cr=carry, p=p, s_=s_: run_loop(fn, c, cr, 120, s_, p))
    order = ("float32", "bfloat16", "bfloat16", "float32")
    t = [event_ms(lambda n=n: loops[n](momentum_cuda.substep_loop)) for n in order]
    ms = {"float32": min(t[0], t[3]), "bfloat16": min(t[1], t[2])}
    plain_ms = event_ms(lambda: loops["bfloat16"](momentum_cuda.substep_loop_reference), reps=1)
    bound_ms, bound_by, bytes_ms, ops_ms = kernel_bound_ms(464, 464, 120, bf16, "bbm")
    phase("bf16", f"120-substep bbm loop at 464^2: float32 {t[0]:.3f} / {t[3]:.3f} ms "
          f"({momentum_cuda.launches_for(120, 464, 464)} launches), bfloat16 {t[1]:.3f} / {t[2]:.3f} ms "
          f"({len(pl.launches)} launches; order f32, bf16, bf16, f32); plain bfloat16 loop {plain_ms:.1f} ms; "
          f"bfloat16 bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f}, operations {ops_ms:.4f}): "
          f"{100 * bound_ms / ms['bfloat16']:.1f}% of it; {smi}")
    del sims, loops

    # 464^2 thermo on, BF16_STEPS steps through step_chunk, beside float32
    runs = {}
    for name in ("float32", "bfloat16"):
        s_ = make_sim(BENCH_THERMO, name)
        s_.step()  # warm-up step outside the count and the timing
        sync()
        momentum_cuda.launches = transport_cuda.launches = 0
        t0 = time.perf_counter()
        s_.step_chunk(BF16_STEPS)
        sync()
        runs[name] = (s_, 1e3 * (time.perf_counter() - t0) / BF16_STEPS, momentum_cuda.launches,
                      transport_cuda.launches)
    sim, ms_step, launches, transported = runs["bfloat16"]
    transport_path("bf16", transported, BF16_STEPS)
    per_loop = momentum_cuda.launches_for(120, 464, 464, bf16)
    if launches != per_loop * BF16_STEPS:
        raise AssertionError(f"bf16 thermo on: {launches} kernel launches, expected {per_loop * BF16_STEPS}")
    import dataclasses

    worst = {}
    for f in dataclasses.fields(sim.state):
        a = getattr(sim.state, f.name)
        if a is None:
            continue
        if a.dtype != bf16 or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"bf16 thermo on: {f.name} is {a.dtype} or not finite")
        worst[f.name] = float((a.float() - getattr(runs["float32"][0].state, f.name)).abs().max())
    n_viol = int(checks.violations(sim.state).sum())
    if n_viol:
        raise AssertionError(f"bf16 thermo on: violations {checks.describe(checks.violations(sim.state).cpu())}")
    top = ", ".join(f"{k} {worst[k]:.3e}" for k in ("conc", "thick", "damage", "vt_u", "sst", "tice"))
    phase("bf16", f"464^2 thermo on, tpu.dtype=bfloat16, {BF16_STEPS} steps through step_chunk: "
          f"{ms_step:.2f} ms/step (float32 {runs['float32'][1]:.2f}), {launches} kernel launches "
          f"({per_loop} a step); every field bfloat16 and finite, {n_viol} violations; max |bf16 - f32| after "
          f"{BF16_STEPS + 1} steps: {top}; {smi}")
    del runs, sim

    cli_report = bf16_cli_resume(smi)

    # one bfloat16 gradient of phase 23's thermo-off loss through SubstepLoop
    s_ = make_sim(GRAD, "bfloat16")
    s_.step()
    grad, _, _ = ke_gradient(s_)
    g, g_ms, g_n, peak, _ = measure_gradient(grad)
    if g.dtype != bf16 or g_n != per_loop:
        raise AssertionError(f"bf16 gradient: {g.dtype}, {g_n} kernel launches (expected {per_loop})")
    phase("bf16", f"{cli_report}; d(mean KE)/d(wind_u) through raw_step_fn at 464^2 in bfloat16: finite, "
          f"max |g| {float(g.float().abs().max()):.3e}, {g_ms:.1f} ms, {g_n} kernel launches, peak "
          f"{peak:.3f} GiB; the phase took {time.perf_counter() - t_phase:.1f} s; {smi}")
    return launches, bitwise, ms["bfloat16"], plain_ms, bound_ms


# --- 29. the captured step and chunk ----------------------------------------


#: steps under torch.profiler in phase 29 (its device time a step)
PROFILED_STEPS = 5


def captured_vs_eager(label: str, sim, smi: str, k: int = 30) -> dict:
    """Phase 29 for one configuration: ``step_chunk_eager(k)`` (the eager
    oracle), ``step_chunk(k)`` (one replay of the k-step graph) and k
    ``step()`` calls (k replays of the one-step graph) from the same state,
    in turns (eager, captured, steps, steps, captured, eager, after one of
    each to warm up and capture), every result bitwise equal to the first
    eager one; ms/step of each (host wall, synchronized); the device time a
    step under torch.profiler (the card's own entries) of the eager loop and
    of the one-step graph's replays, over ``PROFILED_STEPS`` steps, and its
    share of the eager loop's and the one-step replays' ms/step; the k-step graph's
    nodes, capture and instantiation seconds and pool, and the substep
    kernel's launches of a replay."""
    import torch

    from nextsim_tpu_torch.ops import momentum_cuda

    state0, pcpt0 = sim.state, sim.pcpt

    def steps(n):
        for _ in range(n):
            sim.step()

    def run(mode):
        sim.state, sim.pcpt, sim._pending_viol = state0, pcpt0, None
        sync()
        t0 = time.perf_counter()
        {"eager": sim.step_chunk_eager, "captured": sim.step_chunk, "steps": steps}[mode](k)
        sync()
        return time.perf_counter() - t0, sim.state

    results = {}
    t_eager, ref = run("eager")  # warm-up
    _, got_steps = run("steps")  # the one-step graph's capture
    t0 = time.perf_counter()
    _, got = run("captured")  # the eager warm-up of the program and its capture
    first_s = time.perf_counter() - t0
    stats = dict(sim._program.stats)
    walls = {"eager": [], "captured": [], "steps": []}
    outs = [got, got_steps]
    for mode in ("eager", "captured", "steps", "steps", "captured", "eager"):
        launches = momentum_cuda.launches
        wall, out = run(mode)
        walls[mode].append(wall)
        outs.append(out)
        if mode == "captured":
            results["replay_launches"] = momentum_cuda.launches - launches
    for n, out in enumerate(outs):
        for f in ref.__dataclass_fields__:
            a, b = getattr(ref, f), getattr(out, f)
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{label}: run {n}: {f} of the captured chunk is not the eager loop's bitwise")
    # device time a step under torch.profiler over PROFILED_STEPS steps: the
    # eager loop, and replays of the one-step graph, whose kernels are those
    # of each step of the k-step graph
    busy = {}
    for mode, fn in (("eager", lambda: sim.step_chunk_eager(PROFILED_STEPS)),
                     ("captured", lambda: steps(PROFILED_STEPS))):
        sim.state, sim.pcpt, sim._pending_viol = state0, pcpt0, None
        busy[mode] = profiled(fn, host_events=False)[1] / PROFILED_STEPS
    ms = {mode: 1e3 * min(w) / k for mode, w in walls.items()}
    share = {"eager": busy["eager"] / ms["eager"], "steps": busy["captured"] / ms["steps"]}
    results.update(ms_eager=ms["eager"], ms_captured=ms["captured"], ms_steps=ms["steps"], walls=walls,
                   busy_ms=busy,
                   busy_share=share, first_call_s=first_s, **stats)
    pool = stats["pool_bytes"] / 2**20
    phase("captured", f"{label}, {k}-step chunks: eager {ms['eager']:.2f} ms/step, captured "
          f"{ms['captured']:.2f} ms/step (host wall, best of 2 each, in turns eager, captured, steps, steps, "
          f"captured, eager: {[round(1e3 * w / k, 2) for w in walls['eager']]} / "
          f"{[round(1e3 * w / k, 2) for w in walls['captured']]}); {k} replays of the one-step graph "
          f"{ms['steps']:.2f} ms/step ({[round(1e3 * w / k, 2) for w in walls['steps']]}); device busy "
          f"{busy['eager']:.2f} / {busy['captured']:.2f} ms a step (torch.profiler over {PROFILED_STEPS} steps: "
          f"eager, one-step replays), so busy {100 * share['eager']:.1f}% / {100 * share['steps']:.1f}% of the "
          f"eager loop's / the one-step replays' wall; the graph: {stats['nodes']} nodes, capture "
          f"{stats['capture_s']:.2f} s, instantiation {stats['instantiate_s']:.2f} s (uploaded: "
          f"{stats['uploaded']}), pool {pool:.1f} MiB, "
          f"{stats['kernel_launches']} substep-kernel launches a replay; first call (eager warm-up + capture) "
          f"{first_s:.2f} s; bitwise equal to the eager loop in {len(outs)} runs; {smi}")
    sim.state, sim.pcpt = state0, pcpt0
    return results


def ensemble_profile(ens, rec: dict, smi: str) -> dict:
    """Phase 29's end: one batched ensemble step (a replay of phase 19's
    graph) under torch.profiler, the card's own entries: device busy, launches
    and the busy share of phase 19's median batched step."""
    wall, busy, n_launch = profiled(ens.step, host_events=False)
    share = busy / rec["ms_batched"][0]
    ny, nx = ens.sim.grid.shape
    phase("captured", f"phase 19's batched ensemble step ({ny}x{nx} x {ens.n} members, one graph replay) under "
          f"torch.profiler: device busy {busy:.2f} ms, {n_launch} kernels, busy share {100 * share:.1f}% "
          f"(idle {100 * (1 - share):.1f}%) of phase 19's median {rec['ms_batched'][0]:.2f} ms/step "
          f"({1e3 * wall:.1f} ms profiled wall); the member loop's step was busy {rec['loop_busy_ms']:.2f} ms "
          f"of {rec['ms_loop'][0]:.2f}; {smi}")
    return {"batched_busy_ms": busy, "batched_busy_share": share, "batched_kernels": n_launch}


def bench_subprocess(smi: str) -> dict:
    """``python -m nextsim_tpu_torch.bench`` as a subprocess: its one JSON
    line."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "nextsim_tpu_torch.bench"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"the bench failed ({r.returncode}): {r.stderr[-3000:]}")
    line = r.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    if out["metric"] != "bbm_momentum_ocean_cell_substeps_per_s_per_chip" or out["value"] <= 0:
        raise AssertionError(f"the bench's line is not bench.py's: {line}")
    phase("bench", f"python -m nextsim_tpu_torch.bench in {time.perf_counter() - t0:.1f} s (process included): {line}")
    return out


@contextlib.contextmanager
def data_dir(path: Path):
    """NEXTSIM_DATA_DIR set to ``path`` inside the block."""
    old = os.environ.get("NEXTSIM_DATA_DIR")
    os.environ["NEXTSIM_DATA_DIR"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("NEXTSIM_DATA_DIR", None)
        else:
            os.environ["NEXTSIM_DATA_DIR"] = old


def make_sim(overrides, dtype_name="float32"):
    from nextsim_tpu_torch import Config, Simulator

    cfg = Config(overrides=dict(overrides, **{"tpu.dtype": dtype_name}))
    return Simulator(cfg, device="cuda")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from nextsim_tpu_torch import state_from_numpy, state_to_numpy
    from nextsim_tpu_torch.model import checks
    from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda

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
    for n in (464, 1216):
        for dt in (torch.float32, torch.float64):
            pl = momentum_cuda.launch_plan(n, n, 120, dt, "bbm")
            phase("build", f"plan {n}^2 bbm {dt}: tile {pl.tile_h} x {pl.tile_w} nodes, {pl.k} substeps a launch, "
                  f"{pl.n_planes} planes, {pl.smem_bytes} bytes of shared memory, {pl.threads} threads, "
                  f"{pl.blocks_y} x {pl.blocks_x} blocks, {len(pl.launches)} launches a 120-substep loop")

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
    ragged = dict(small, **{"grid.nx": 45, "grid.ny": 70, "ideal_simul.constant_wind_v": -6.0})
    for dtype_name in ("float32", "float64"):
        sim_small = make_sim(small, dtype_name)
        sim_ragged = make_sim(ragged, dtype_name)
        sim_ragged.step()  # a moving, stressed state
        sim_big = make_sim(spun, dtype_name)
        big_state = state_from_numpy(host_state, device="cuda", dtype=sim_big.dtype)
        for dyn_type in ("bbm", "evp", "mevp"):
            for steps in (11, 121):  # no multiple of 2..8 substeps a launch: a remainder launch
                compare(f"70x45 {dyn_type} {dtype_name} {steps} substeps", sim_ragged, dyn_type, steps, dtype_name)
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

    # 5. main path: the 30-step program, run eagerly and captured at its
    # first call ("main"), one graph replay at the second ("main_graph")
    sim = make_sim(BENCH)
    momentum_cuda.launches = transport_cuda.launches = 0
    t0 = time.perf_counter()
    sim.step_chunk()
    sync()
    first_s = time.perf_counter() - t0
    path_launches = {"main": momentum_cuda.launches}  # the kernel's launches on every path driven
    weld_launches = {}  # the welding kernel's, on the paths that weld
    k = sim.cfg["tpu.steps_per_call"]
    transport_path("main", transport_cuda.launches, k)
    momentum_cuda.launches = transport_cuda.launches = 0
    t0 = time.perf_counter()
    sim.step_chunk()
    sync()
    wall = time.perf_counter() - t0
    launches = path_launches["main_graph"] = momentum_cuda.launches
    transport_path("main_graph", transport_cuda.launches, k)
    substeps = sim.dyn.substeps
    for f in ("conc", "thick", "damage", "sigma", "vt_u", "vt_v", "ut_u", "ut_v"):
        if not bool(torch.isfinite(getattr(sim.state, f)).all()):
            raise AssertionError(f"main path: {f} is not finite")
    viol = checks.violations(sim.state).cpu().numpy()
    if viol.any():
        raise AssertionError(f"main path: violations {checks.describe(viol)}")
    per_loop = momentum_cuda.launches_for(substeps, *sim.grid.shape)
    if path_launches["main"] != per_loop * k or launches != per_loop * k:
        raise AssertionError(f"main path: {path_launches} kernel launches, expected {per_loop * k} each")
    ocean = int(sim.grid.mask.sum())
    graph = sim._program.stats
    phase("main", f"464^2 bbm, {k} steps as one CUDA graph replay in {wall:.3f} s: {1e3 * wall / k:.2f} ms/step, "
          f"{ocean * substeps * k / wall:.4e} ocean-cell-substeps/s ({ocean} ocean cells); "
          f"{launches} kernel launches ({per_loop} a step); the first call (eager + capture of "
          f"{graph['nodes']} nodes) {first_s:.2f} s; max speed "
          f"{float(torch.hypot(sim.state.vt_u, sim.state.vt_v).max()):.3f} m/s; zero violations; {smi}")

    # 6. one 120-substep loop at 464^2, kernel beside plain (CUDA events)
    def timed(fn, sim, reps=3):
        consts, carry, p = setup_for(sim, "bbm")
        return event_ms(lambda: run_loop(fn, consts, carry, substeps, sim, p), reps)

    t_plain = [timed(momentum_cuda.substep_loop_reference, sim)]
    t_kern = [timed(momentum_cuda.substep_loop, sim), timed(momentum_cuda.substep_loop, sim)]
    t_plain.append(timed(momentum_cuda.substep_loop_reference, sim))
    ms, plain_ms = min(t_kern), min(t_plain)
    bound_ms, bound_by, bytes_ms, ops_ms = kernel_bound_ms(464, 464, substeps, torch.float32, "bbm")
    phase("time", f"120-substep bbm loop at 464^2 f32: kernel {t_kern} ms in {per_loop} launches, plain {t_plain} ms "
          f"(order plain, kernel, kernel, plain); bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f} ms, "
          f"operations {ops_ms:.4f} ms): the kernel reaches {100 * bound_ms / ms:.1f}% of it; {smi}")

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
    t_kern = [timed(momentum_cuda.substep_loop, sim), timed(momentum_cuda.substep_loop, sim)]
    ms_1216 = min(t_kern)
    bound_ms_1216, _, bytes_ms, ops_ms = kernel_bound_ms(1216, 1216, substeps, torch.float32, "bbm")
    phase("time", f"120-substep bbm loop at 1216^2 f32: kernel {t_kern} ms in "
          f"{momentum_cuda.launches_for(substeps, 1216, 1216)} launches; bound {bound_ms_1216:.4f} ms (bytes "
          f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms): the kernel reaches {100 * bound_ms_1216 / ms_1216:.1f}% "
          f"of it; {smi}")

    # 7b. the transport kernel against its plain version on the states of
    # phases 3 and 7
    transport_rec = transport_kernel_phase((("464^2", sim_spin), ("1216^2", sim)), smi)
    del sim_spin

    # 8. the thermo-on main path: one replay of the 30-step graph, captured
    # at the first call
    sim = make_sim(BENCH_THERMO)
    sim.step_chunk()
    sync()
    momentum_cuda.launches = transport_cuda.launches = 0
    t0 = time.perf_counter()
    sim.step_chunk()
    sync()
    wall = time.perf_counter() - t0
    launches = momentum_cuda.launches
    transport_path("thermo", transport_cuda.launches, k)
    for f in ("conc", "thick", "snow_thick", "damage", "sigma", "tice", "sst", "sss",
              "conc_young", "h_young", "tsurf_young", "vt_u", "vt_v", "ut_u", "ut_v"):
        if not bool(torch.isfinite(getattr(sim.state, f)).all()):
            raise AssertionError(f"thermo-on main path: {f} is not finite")
    viol = checks.violations(sim.state).cpu().numpy()
    if viol.any():
        raise AssertionError(f"thermo-on main path: violations {checks.describe(viol)}")
    if launches != per_loop * k:
        raise AssertionError(f"thermo-on main path: {launches} kernel launches, expected {per_loop * k}")
    path_launches["thermo"] = launches
    if float(sim.state.conc.max()) < 0.5:
        raise AssertionError("thermo-on main path: the ice melted away")
    phase("thermo", f"464^2 bbm, thermo on, {k} steps as one CUDA graph replay in {wall:.3f} s: "
          f"{1e3 * wall / k:.2f} ms/step, "
          f"{ocean * substeps * k / wall:.4e} ocean-cell-substeps/s; {launches} kernel launches; "
          f"conc {float(sim.state.conc.min()):.3f}..{float(sim.state.conc.max()):.3f}, "
          f"sst {float(sim.state.sst.min()):.3f}..{float(sim.state.sst.max()):.3f} C; zero violations; {smi}")

    # 9. thermo_step on the card against the CPU, float64
    thermo_vs_cpu(sim)
    thermo_time(sim, smi)

    # 10. the CLI, and a resume against the uninterrupted run
    cli_run_and_resume(smi)

    # 11-13. the dataset path, its kernel state and timings, nesting
    import tempfile

    scratch = ROOT / "nextsim_tpu_torch" / "build"  # git-ignored
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        what = write_forcing_data(tmp / "data")
        write_waves(tmp / "data")
        phase("datasets", f"synthetic inputs written in {time.perf_counter() - t0:.1f} s: {what}, "
              "ERA-Interim waves 4 records of 181x360 x 3 variables")
        with data_dir(tmp / "data"):
            sim, path_launches["datasets"], dataset_ms = dataset_cli_run(tmp / "data", tmp / "run", smi)
            dataset_err = dataset_kernel_and_forcing(sim, smi)
            dataset_timings(sim, smi)
            dataset_sim = sim  # phase 29 steps it again while its files exist
            del sim
            wave_err, weld_rec, wave_rec, wave_state = wave_phases(tmp, smi, dataset_ms, path_launches,
                                                                   weld_launches)
        nested_card_vs_cpu(tmp, smi)
        standalone_wim(tmp, smi)

        # 19-22. ensembles on the phase-11 files (19b: the batched launch on
        # phase 19's state), run_ensemble, validation
        with data_dir(tmp / "data"):
            ens, path_launches["ensemble_batched"], path_launches["ensemble"], early, ens_rec = ensemble_run(
                tmp, smi, dataset_ms)
            batched_rec = batched_kernel_phase(ens, smi)
            weld_ens = welding_ensemble_phase(tmp, smi, wave_state, ens.sim.forcing_provider)
            del wave_state
            path_launches["ensemble_welding"], weld_launches["ensemble_welding"] = weld_ens["launches"]["batched"]
        perturbed_rec, pert_sim = ensemble_members_vs_simulators(smi)
        path_launches["perturbed"] = perturbed_rec["launches"]["captured"]
        ensemble_driver(tmp, smi)
        path_launches["validation"] = validation_run(tmp, smi, ens)

        # 23. gradients through the step
        path_launches["gradient"], single_grads = gradient_phase(smi)

        # 24. a 2x2 mesh of ranks
        path_launches["mesh"], mesh_err = mesh_phase(smi)

        # 25-27. the wave path on a 2x2 mesh, the member meshes, a mesh gradient
        with data_dir(tmp / "data"):
            path_launches["mesh_waves"], mesh_wave_err, weld_launches["mesh_waves"] = mesh_waves_phase(tmp, smi)
            path_launches["mesh_ensemble"] = mesh_ensemble_phase(tmp, smi, ens, early)
        path_launches["mesh_gradient"] = mesh_gradient_phase(tmp, smi, single_grads)

        # 28. the bfloat16 state
        momentum_cuda.launches = 0
        path_launches["bf16"], bf16_bitwise, bf16_ms, bf16_plain_ms, bf16_bound_ms = bf16_phase(
            smi, host_state, spun)

        # 29. the captured chunk against the eager loop: 608^2 on phase 11's
        # Simulator and files, then 464^2 thermo off and on; last, as every
        # phase that profiles eager code runs before it; then the batched
        # ensemble step's replay under the profiler, the last profile
        with data_dir(tmp / "data"):
            captured = {"608^2 datasets, thermo on": captured_vs_eager(
                "608^2 arctic_10km.cfg on ERA5 + TOPAZ4 + ETOPO, thermo on", dataset_sim, smi)}
            del dataset_sim
            for label, over in (("464^2 thermo off", BENCH), ("464^2 thermo on", BENCH_THERMO)):
                captured[label] = captured_vs_eager(label, make_sim(over), smi)
            perturbed_rec.update(perturbed_profile(pert_sim, captured["464^2 thermo on"], smi))
            del pert_sim
            ens_rec.update(ensemble_profile(ens, ens_rec, smi))
        del ens
    bench = bench_subprocess(smi)
    phase("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    if min(path_launches.values()) <= 0:
        raise AssertionError(f"a path ran without the kernel: {path_launches}")
    if sorted(weld_launches) != sorted(WELDING_PATHS) or min(weld_launches.values()) <= 0:
        raise AssertionError(f"a welding path ran without the welding kernel: {weld_launches}")
    if TRANSPORT_FAULTS:
        raise AssertionError("the transport kernel: " + "; ".join(TRANSPORT_FAULTS))
    if sorted(TRANSPORT_LAUNCHES) != sorted(path_launches) or min(TRANSPORT_LAUNCHES.values()) <= 0:
        raise AssertionError(f"a path ran without the transport kernel: {TRANSPORT_LAUNCHES}")

    print(json.dumps({"kernels": [{
        "name": "momentum_substep",
        "route": "cuda",
        "source": "nextsim_tpu_torch/csrc/momentum_substep.cu",
        "replaces": "nextsim_tpu/ops/momentum_pallas.py:286",
        "launches": sum(path_launches.values()),
        "launches_by_path": path_launches,
        "max_abs_err": max(main_err, dataset_err, wave_err, mesh_err, mesh_wave_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no PyTorch call computes this function
        "ms_1216": ms_1216,
        "bound_ms_1216": bound_ms_1216,
        "bf16_bitwise": bf16_bitwise,
        "bf16_ms": bf16_ms,
        "bf16_plain_ms": bf16_plain_ms,
        "bf16_bound_ms": bf16_bound_ms,
        "captured": {label: {key: r[key] for key in ("ms_eager", "ms_captured", "ms_steps", "busy_share", "nodes",
                                                      "capture_s", "instantiate_s", "pool_bytes",
                                                      "replay_launches")}
                     for label, r in captured.items()},
        "ensemble_608x4": ens_rec,
        "perturbed_464": perturbed_rec,
        "batched_608x4": batched_rec,
        "wave_captured": {key: wave_rec[key] for key in ("ms_eager", "ms_captured", "nodes", "capture_s",
                                                          "instantiate_s", "pool_bytes", "replay_launches")},
        "bench_ocean_cell_substeps_per_s": bench["value"],
    }, {
        "name": "welding_roach",
        "route": "cuda",
        "source": "nextsim_tpu_torch/csrc/welding_roach.cu",
        "replaces": "nextsim_tpu/ops/fsd.py:243 (welding_roach: XLA-fused jnp, no Pallas kernel)",
        "launches": sum(weld_launches.values()),
        "launches_by_path": weld_launches,
        "paths": WELDING_PATHS,
        "not_on_paths": "main, main_graph, thermo, datasets, ensemble, ensemble_batched, perturbed, validation, "
                        "gradient, mesh, mesh_ensemble, mesh_gradient and bf16 configure no floe-size distribution, so "
                        "they do not weld",
        "max_abs_err": max(r["max_abs_err"] for r in weld_rec["by_case"].values()),
        "ms": weld_rec["ms"],
        "plain_ms": weld_rec["plain_ms"],
        "bound_ms": weld_rec["bound_ms"],
        "bound_by": weld_rec["bound_by"],
        "library_ms": None,  # no PyTorch call computes this function
        "active_cells": weld_rec["active"],
        "by_case": weld_rec["by_case"],
        "ensemble_welding_608x4": weld_ens,
    }, {
        "name": "transport_ridge",
        "route": "cuda",
        "source": "nextsim_tpu_torch/csrc/transport_ridge.cu",
        "replaces": "nextsim_tpu/ops/transport.py, advection.py (transport_and_ridge: XLA-fused jnp, no Pallas kernel)",
        "launches": sum(TRANSPORT_LAUNCHES.values()),
        "launches_by_path": TRANSPORT_LAUNCHES,
        "max_abs_err": max(r["max_abs_err"] for r in transport_rec.values()),
        "ms": transport_rec["1216^2 float32"]["ms"],
        "plain_ms": transport_rec["1216^2 float32"]["plain_ms"],
        "bound_ms": transport_rec["1216^2 float32"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call computes this function
        "by_case": transport_rec,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
