"""Time the blocked substep kernel under different launch plans on one GPU.

    python3 -m nextsim_tpu_torch.tools.tune_substep [--check] [--sweep] [--clocks] [--old-tree DIR] [--main-path]

Needs a CUDA device and nvcc, and chip_smoke.py beside the package (its
configurations and its bound are used). Every time is taken with CUDA events
around whole 120-substep loops, and the card's name and power limit are
printed with them.

--check      build, print ptxas' registers and spills, and hold the kernel
             against the plain loop on a 33^2 and a 70 x 45 square (all
             rheologies, the three dtypes, 11 substeps: a remainder launch)
             under small tiles and under the default plan, and in bfloat16
             on the 464^2 arctic state after 3 steps at 20 m/s (damage
             engaged), 3 and 120 substeps;
--sweep      time one loop at 464^2, 608^2 and 1216^2 under the default plan
             (the cost model's choice) and under a list of fixed (tile, k,
             threads), for bbm and, with a shorter list, the other
             rheologies, in each dtype (or those of --dtype);
--clocks     build the kernel with -DNEXTSIM_SUBSTEP_CLOCKS and print every
             block's mean SM clocks of loading, computing and storing under
             several plans: the readings ``momentum_cuda``'s cost model
             (_CLK_PER_BYTE, _CLK_PER_UPDATE) is fitted to;
--old-tree   a checkout of another commit (say, the parent's, unpacked by
             ``git archive`` into a git-ignored directory): its
             ``momentum_cuda.substep_loop`` is built there and timed in turns
             with this tree's, at 464^2, 608^2 and 1216^2 in float32 and at
             464^2 in bfloat16;
--main-path  with --old-tree: ms/step of the 464^2 and 1216^2 main path
             (thermo off, 10-step chunks) with the old and the new kernel in
             turns, the old one patched into this tree's ``momentum``.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import BENCH, event_ms, kernel_bound_ms, make_sim, run_loop, setup_for  # noqa: E402
from nextsim_tpu_torch.ops import momentum, momentum_cuda  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def spun_up(n, dx, dtype_name="float32"):
    """A Simulator of the n^2 arctic main path after 3 steps at 20 m/s."""
    sim = make_sim(dict(BENCH, **{"grid.nx": n, "grid.ny": n, "grid.resolution": dx,
                                  "simul.spinup_duration": 0.0,
                                  "ideal_simul.constant_wind_u": 20.0}), dtype_name)
    sim.step_chunk(3)
    return sim


def check():
    small = {"grid.preset": "square", "setup.ice-type": "constant", "ideal_simul.constant_wind_u": 10.0,
             "simul.spinup_duration": 0.0, "thermo.use_thermo_forcing": False}
    bad = 0

    def one(sim, label, dyn, steps, plan=None):
        consts, carry, p = setup_for(sim, dyn)
        plan = plan or momentum_cuda._default_plan(carry, steps, dyn)
        ref = run_loop(momentum_cuda.substep_loop_reference, consts, carry, steps, sim, p)
        out = momentum_cuda._substep_loop_cuda(consts, carry, steps, sim.dt / p.substeps, sim.dt,
                                               sim.grid.dx, dyn, p, plan=plan)
        torch.cuda.synchronize()
        same = all(torch.equal(o, r) for o, r in zip(out, ref))
        # the planes that differ: elements and the largest difference
        diff = "; ".join(f"{n} {int((o != r).sum())} at most {float((o.float() - r.float()).abs().max()):.3e}"
                         for n, o, r in zip(momentum_cuda._STATE, out, ref) if not torch.equal(o, r))
        print(f"check {label} tile {plan.tile_h}x{plan.tile_w} k {plan.k} {dyn} {steps} substeps: "
              f"{'bitwise' if same else 'differs: ' + diff}", flush=True)
        return int(not same and dyn != "mevp")

    for ny, nx, tile, k in ((33, 33, (8, 8), 4), (70, 45, (16, 20), 3), (70, 45, None, None)):
        for dtype_name in DTYPES:
            sim = make_sim(dict(BENCH, **small, **{"grid.nx": nx, "grid.ny": ny}), dtype_name)
            sim.step()
            for dyn in ("bbm", "evp", "mevp"):
                plan = momentum_cuda.launch_plan(ny, nx, 11, DTYPES[dtype_name], dyn, tile=tile, k=k)
                bad += one(sim, f"{ny}x{nx} {dtype_name}", dyn, 11, plan)
    sim = spun_up(464, 10e3, "bfloat16")
    frac = float((sim.state.damage > 0).float().mean())
    print(f"check 464^2 bfloat16 after 3 steps at 20 m/s: damage > 0 in {frac:.3f} of cells", flush=True)
    for dyn in ("bbm", "evp", "mevp"):
        for steps in (3, 120):
            bad += one(sim, "464^2 bfloat16", dyn, steps)
    if bad:
        raise SystemExit(f"{bad} bbm/evp cases differ from the plain loop")


def loop_fn(sim, dyn, plan=None, fn=None):
    consts, carry, p = setup_for(sim, dyn)
    args = (consts, carry, p.substeps, sim.dt / p.substeps, sim.dt, sim.grid.dx, dyn, p)
    if fn is not None:
        return lambda: fn(*args)
    return lambda: momentum_cuda._substep_loop_cuda(*args, plan=plan)


def sweep(smi, dtypes=tuple(DTYPES)):
    f32 = [(None, None, 1024), ((36, 36), 4, 1024), ((36, 36), 4, 512), ((38, 38), 3, 1024), ((40, 40), 2, 1024),
           ((34, 34), 5, 1024), ((32, 32), 6, 1024), ((28, 28), 8, 1024), ((24, 52), 4, 1024),
           ((30, 30), 4, 1024), ((30, 30), 6, 1024), ((22, 22), 4, 512), ((24, 24), 3, 512),
           ((42, 42), 1, 1024)]
    f64 = [(None, None, 512), ((25, 25), 3, 512), ((23, 23), 4, 512), ((27, 27), 2, 512), ((25, 25), 3, 256),
           ((16, 38), 3, 512), ((14, 14), 3, 256), ((29, 29), 1, 512)]
    bf16 = [(None, None, 1024), ((28, 31), 6, 1024), ((36, 36), 4, 1024), ((32, 32), 5, 1024), ((40, 40), 4, 1024),
            ((44, 44), 3, 1024), ((48, 48), 4, 1024), ((30, 30), 6, 512), ((34, 34), 6, 1024), ((24, 52), 5, 1024)]
    lists = {"float32": f32, "float64": f64, "bfloat16": bf16}
    for n, dx in ((464, 10e3), (608, 10e3), (1216, 5e3)):
        for dtype_name, configs in ((d, lists[d]) for d in dtypes):
            sim = spun_up(n, dx, dtype_name)
            for dyn in ("bbm", "evp", "mevp"):
                bound = kernel_bound_ms(n, n, 120, DTYPES[dtype_name], dyn)[0]
                for tile, k, threads in (configs if dyn == "bbm" else configs[:5]):
                    plan = momentum_cuda.launch_plan(n, n, 120, DTYPES[dtype_name], dyn, tile=tile, k=k,
                                                     threads=threads)
                    ms = min(event_ms(loop_fn(sim, dyn, plan)) for _ in range(2))
                    print(f"sweep {n}^2 {dyn} {dtype_name}: {'default plan, ' if tile is None else ''}tile "
                          f"{plan.tile_h}x{plan.tile_w} k {plan.k} "
                          f"threads {threads} blocks {plan.blocks_y * plan.blocks_x} smem {plan.smem_bytes} "
                          f"launches {len(plan.launches)}: {ms:.3f} ms (bound {bound:.3f} ms, "
                          f"{100 * bound / ms:.1f}%); {smi}", flush=True)
            del sim


def clocks(smi):
    """Per-block SM clocks of the three phases, from a build with counters."""
    import ctypes

    lib = momentum_cuda.load(momentum_cuda.build(momentum_cuda._NVCC_FLAGS + ("-DNEXTSIM_SUBSTEP_CLOCKS",)))
    lib.nextsim_substep_clocks.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    sums = (ctypes.c_ulonglong * 4)()
    plain_lib, momentum_cuda._lib = momentum_cuda._lib, lib
    try:
        for n, dx in ((464, 10e3), (1216, 5e3)):
            sim = spun_up(n, dx)
            for tile, k in ((None, None), ((36, 36), 4), ((42, 42), 1), ((40, 40), 2), ((32, 32), 6), ((30, 30), 4)):
                plan = momentum_cuda.launch_plan(n, n, 120, torch.float32, "bbm", tile=tile, k=k)
                fn = loop_fn(sim, "bbm", plan)
                fn()
                lib.nextsim_substep_clocks(sums)  # the warm-up's counts go
                ms = event_ms(fn, reps=1)
                lib.nextsim_substep_clocks(sums)
                load, compute, store, blocks = (float(v) for v in sums)
                box = (plan.tile_h + 2 * plan.k) * (plan.tile_w + 2 * plan.k)
                updates = sum((plan.tile_h + 2 * plan.k - 2 * s + 1) * (plan.tile_w + 2 * plan.k - 2 * s + 1)
                              + (plan.tile_h + 2 * plan.k - 2 * s) * (plan.tile_w + 2 * plan.k - 2 * s)
                              for s in range(1, plan.k + 1))
                print(f"clocks {n}^2 bbm f32 tile {plan.tile_h}x{plan.tile_w} k {plan.k}, "
                      f"{plan.blocks_y * plan.blocks_x} blocks a launch: loop {ms:.3f} ms; a block's mean SM clocks: "
                      f"load {load / blocks:.0f} ({load / blocks / (box * plan.n_planes * 4):.3f} a byte), compute "
                      f"{compute / blocks:.0f} ({compute / blocks / updates:.2f} a cell or node update of an inner "
                      f"tile), store {store / blocks:.0f}; {smi}", flush=True)
            del sim
    finally:
        momentum_cuda._lib = plain_lib


def load_old(tree):
    spec = importlib.util.spec_from_file_location(
        "old_momentum_cuda", Path(tree) / "nextsim_tpu_torch" / "ops" / "momentum_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def old_and_new(old, smi, main_path):
    for n, dx, dtype_name in ((464, 10e3, "float32"), (608, 10e3, "float32"), (1216, 5e3, "float32"),
                              (464, 10e3, "bfloat16")):
        sim = spun_up(n, dx, dtype_name)
        for dyn in ("bbm", "evp", "mevp"):
            f_old, f_new = loop_fn(sim, dyn, fn=old.substep_loop), loop_fn(sim, dyn, fn=momentum_cuda.substep_loop)
            same = all(torch.equal(a, b) for a, b in zip(f_old(), f_new()))
            t = [event_ms(f) for f in (f_old, f_new, f_new, f_old)]
            bound = kernel_bound_ms(n, n, 120, sim.dtype, dyn)[0]
            print(f"old/new {n}^2 {dyn} {dtype_name}, one 120-substep loop: old {t[0]:.3f} / {t[3]:.3f} ms, new "
                  f"{t[1]:.3f} / {t[2]:.3f} ms ({momentum_cuda.launches_for(120, n, n, sim.dtype, dyn)} "
                  f"launches each), bound {bound:.3f} ms; results {'bitwise equal' if same else 'DIFFER'} "
                  f"(order old, new, new, old); {smi}", flush=True)
        if main_path and dtype_name == "float32":
            sim = make_sim(dict(BENCH, **{"grid.nx": n, "grid.ny": n, "grid.resolution": dx}))
            sim.step_chunk(2)
            new_loop = momentum_cuda.substep_loop

            def chunk(fn):
                momentum.momentum_cuda.substep_loop = fn
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sim.step_chunk(10)
                    torch.cuda.synchronize()
                    return 1e3 * (time.perf_counter() - t0) / 10
                finally:
                    momentum.momentum_cuda.substep_loop = new_loop

            t = [chunk(f) for f in (old.substep_loop, new_loop, new_loop, old.substep_loop) * 2]
            print(f"main path {n}^2 bbm f32 thermo off, ms/step over 10-step chunks (order old, new, new, old, "
                  f"twice): old {t[0]:.2f} / {t[3]:.2f} / {t[4]:.2f} / {t[7]:.2f}, new {t[1]:.2f} / {t[2]:.2f} / "
                  f"{t[5]:.2f} / {t[6]:.2f}; {smi}", flush=True)
        del sim


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--old-tree")
    ap.add_argument("--main-path", action="store_true")
    ap.add_argument("--dtype", action="append", choices=sorted(DTYPES),
                    help="with --sweep: the dtypes to sweep (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_substep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    momentum_cuda.build()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    for ln in momentum_cuda.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln or "error" in ln:
            print("ptxas:", ln.strip())
    if args.check:
        check()
    if args.sweep:
        sweep(smi, tuple(args.dtype or DTYPES))
    if args.clocks:
        clocks(smi)
    if args.old_tree:
        old_and_new(load_old(args.old_tree), smi, args.main_path)


if __name__ == "__main__":
    main()
