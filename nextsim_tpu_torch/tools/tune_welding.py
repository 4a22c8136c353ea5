"""Time the Roach welding kernel on one GPU, and another checkout's beside it.

    python3 -m nextsim_tpu_torch.tools.tune_welding [--check] [--old-tree DIR]

Needs a CUDA device and nvcc, and chip_smoke.py beside the package (its
bound, ``welding_bound_ms``, is used). Every time is taken with CUDA events
around whole ``welding_roach`` calls (the two torch sums, the memset and the
kernels), and the card's name and power limit are printed with them. The
cases are made on the card from a numpy seed (``stand_in_cases``): the
phase-16 cases of ``chip_smoke.py`` on a 608^2 x 20-bin stack and the
welding ensemble's member-minor stack of 4 members.

--check      build the kernel for the wave path's 20 bins and for 32 bins,
             print ptxas' registers, stack frame and spills for each
             dtype's kernels, and hold each case below against the plain
             version (bitwise, NaN in the same places) in float32, float64
             and bfloat16, and 32 bins in each dtype;
--old-tree   a checkout of another commit (say, the parent's, unpacked by
             ``git archive`` into a git-ignored directory): its
             ``welding_cuda.weld`` is built there (ptxas' report printed)
             and timed in turns with this tree's (old, new, new, old) on
             every case in float32, float64 and bfloat16, both held to the
             plain version's bits; then one call of each traced
             by ``torch.profiler`` in float32, whose kernel records give
             each kernel's registers a thread and its estimated achieved
             occupancy (CUPTI's, from the grid, the block and the
             registers).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import event_ms, same_bits, welding_bound_ms  # noqa: E402
from nextsim_tpu_torch import Config  # noqa: E402
from nextsim_tpu_torch.ops import fsd, welding_cuda  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}
DT = 200.0  # configs/arctic_10km.cfg's time step [s]


def fsd_setup(n=20, scaled=False):
    """(FSDParams, FSDBins) of the wave path's FSD (``n`` bins, Roach
    welding; scaled areas as the welding ensemble runs them)."""
    p = fsd.FSDParams.from_config(Config(overrides={
        "wave_coupling.num_fsd_bins": n, "wave_coupling.welding_type": "roach",
        "wave_coupling.fsd_welding_use_scaled_area": scaled}))
    return p, fsd.make_bins(p)


def stand_in_cases(seed=16, n=20, size=608, device="cuda"):
    """The cases, made on the card: ice on a disk of 45% of a size^2 grid
    (the arctic grid's share of ocean), at total concentration 0.9 and
    unbroken (all in the last bin) but for a band at its edge 6 cells wide,
    cut to 3,458 cells, whose floes are spread over every bin. Cases (name:
    stack, mask, scaled areas): the ice but the band freezing ("own mask":
    0 active, as in the wave run, whose broken floes melt), every cell
    freezing (the band's 3,458 active, to the cap of 256 substeps), floes
    spread over every ice cell with 933 random cells freezing, 4 such spread
    members stacked member-minor on scaled areas with every cell freezing,
    and the same members with 5,211 random cells freezing (the number that
    weld in the welding ensemble's third step)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:size, :size] - (size - 1) / 2.0
    r = np.hypot(y, x)
    rad = np.sqrt(0.455 * size * size / np.pi)
    ice = r < rad
    band = np.flatnonzero((r >= rad - 6) & ice)[:3458]
    w = rng.uniform(0.0, 1.0, (n, size, size))
    spread = np.where(ice, 0.9 * w / w.sum(0), 0.0)
    cf = np.zeros((n, size, size))
    cf[-1] = np.where(ice, 0.9, 0.0)
    cf.reshape(n, -1)[:, band] = spread.reshape(n, -1)[:, band]
    cold = np.zeros(size * size, bool)
    cold[rng.choice(np.flatnonzero(ice), 933, replace=False)] = True
    members = []
    for m in range(4):
        wm = np.random.default_rng(seed + 1 + m).uniform(0.0, 1.0, (n, size, size))
        members.append(np.where(ice, 0.9 * wm / wm.sum(0), 0.0))
    some = np.zeros(4 * size * size, bool)
    some[rng.choice(np.flatnonzero(np.tile(ice.ravel(), 4)), 5211, replace=False)] = True
    dev = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device).contiguous()  # noqa: E731
    own = ice.ravel().copy()
    own[band] = False
    stack = dev(np.stack(members, 1))
    return {
        "own mask": (dev(cf), dev(own.reshape(size, size), torch.bool), False),
        "every cell freezing": (dev(cf), dev(np.ones((size, size)), torch.bool), False),
        "spread floes, own mask": (dev(spread), dev(cold.reshape(size, size), torch.bool), False),
        "member stack": (stack, dev(np.ones((4, size, size)), torch.bool), True),
        "member stack, 5,211 freezing": (stack, dev(some.reshape(4, size, size), torch.bool), True),
    }


def load_old(tree):
    spec = importlib.util.spec_from_file_location(
        "old_welding_cuda", Path(tree) / "nextsim_tpu_torch" / "ops" / "welding_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def print_ptxas(label, log):
    for ln in log.splitlines():
        if any(k in ln for k in ("Compiling", "registers", "stack frame", "spill", "error")):
            print(f"ptxas {label}:", ln.strip(), flush=True)


def kernel_records(fn):
    """(name, registers a thread, estimated achieved occupancy %, grid,
    block, µs) of every welding kernel (its name holds ``weld`` or
    ``::mark<``) that one call of ``fn`` runs, from a ``torch.profiler``
    trace (CUPTI's kernel records)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["args"].get("registers per thread"), e["args"].get("est. achieved occupancy %"),
             e["args"].get("grid"), e["args"].get("block"), e.get("dur"))
            for e in events if e.get("cat") == "kernel" and any(k in e.get("name", "") for k in ("weld", "::mark<"))]


def check(cases, smi):
    """Build at 20 and 32 bins (ptxas' report), then every case and 32 bins
    against the plain version in each dtype; raises on a difference."""
    bad = []
    for n in (20, 32):
        p, b = fsd_setup(n)
        welding_cuda.build_log = ""
        t0 = time.perf_counter()
        welding_cuda._library(welding_cuda.plan_defines(b, n))
        print(f"built {n} bins in {time.perf_counter() - t0:.1f} s", flush=True)
        print_ptxas(f"{n} bins", welding_cuda.build_log)
    rng = np.random.default_rng(32)
    p32, b32 = fsd_setup(32)
    w = rng.uniform(0.0, 1.0, (32, 64, 64))
    stack32 = (torch.as_tensor(0.9 * w / w.sum(0), device="cuda"), torch.ones((64, 64), dtype=torch.bool, device="cuda"))
    todo = [(name, x, f, fsd_setup(20, scaled)) for name, (x, f, scaled) in cases.items()]
    todo.append(("32 bins, every cell freezing", *stack32, (p32, b32)))
    for name, x, f, (p, b) in todo:
        for dtype_name, dt in DTYPES.items():
            xd = x.to(dt)
            out = welding_cuda.weld(xd, DT, p, b, f)
            ref = fsd.welding_roach_reference(xd, DT, p, b, f)
            same = same_bits(out, ref)
            active = welding_bound_ms(xd, f, DT, p, b)[4]
            print(f"check {name} {dtype_name} ({active} active cells): "
                  f"{'bitwise' if same else 'DIFFERS in ' + str(int((out != ref).sum())) + ' values'}; {smi}",
                  flush=True)
            if not same:
                bad.append((name, dtype_name))
    if bad:
        raise SystemExit(f"the kernel differs from the plain version: {bad}")


def old_and_new(old, cases, smi):
    """Every case in each dtype, the old and the new kernel in turns, then
    each kernel's records from one traced call in float32."""
    shown = set()
    for name, (x, f, scaled) in cases.items():
        p, b = fsd_setup(20, scaled)
        for dtype_name, dtype in DTYPES.items():
            xd = x.to(dtype)
            ref = fsd.welding_roach_reference(xd, DT, p, b, f)
            f_old = lambda: old.weld(xd, DT, p, b, f)  # noqa: E731
            f_new = lambda: welding_cuda.weld(xd, DT, p, b, f)  # noqa: E731
            same = [same_bits(fn(), ref) for fn in (f_old, f_new)]
            log = getattr(old, "build_log", "")
            if log and log not in shown:
                shown.add(log)
                print_ptxas("old tree", log)
            t = [event_ms(fn, reps=5) for fn in (f_old, f_new, f_new, f_old)]
            bound, bound_by, _, _, active = welding_bound_ms(xd, f, DT, p, b)
            print(f"old/new {name} {tuple(x.shape)} {dtype_name} ({active} active cells): old {t[0]:.4f} / "
                  f"{t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms (order old, new, new, old); bound {bound:.4f} ms "
                  f"by {bound_by}, new {100 * bound / min(t[1:3]):.1f}% of it, old {100 * bound / min(t[0], t[3]):.2f}%;"
                  f" plain version's bits: old {same[0]}, new {same[1]}; {smi}", flush=True)
            if not all(same):
                raise SystemExit(f"old/new {name} {dtype_name}: a kernel differs from the plain version")
    for name, (x, f, scaled) in cases.items():  # after every timing: the profiler runs last
        p, b = fsd_setup(20, scaled)
        x32 = x.to(torch.float32)
        for label, mod in (("old", old), ("new", welding_cuda)):
            for kname, regs, occ, grid, block, us in kernel_records(lambda: mod.weld(x32, DT, p, b, f)):
                print(f"trace {label} {name} float32: {kname[:90]}: {regs} registers a thread, est. achieved "
                      f"occupancy {occ}%, grid {grid}, block {block}, {us} us; {smi}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--old-tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_welding: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cases = stand_in_cases()
    print("cases:", {k: (tuple(x.shape), int(f.sum())) for k, (x, f, _) in cases.items()}, "(stack, cells freezing)",
          flush=True)
    if args.check:
        check(cases, smi)
    if args.old_tree:
        old_and_new(load_old(args.old_tree), cases, smi)


if __name__ == "__main__":
    main()
