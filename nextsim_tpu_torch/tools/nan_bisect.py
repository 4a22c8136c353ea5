"""Per-phase NaN bisection (the counterpart of tools/nan_bisect.py).

Replays a run from a restart with each step split into its phases
(thermodynamics, the floe-size block, momentum, transport), checks every
state field for non-finite values after each phase, and reports the first
offending field and cell with the local state before that phase. Usage:

    python -m nextsim_tpu_torch.tools.nan_bisect [--device cuda|cpu] [--steps 80] \\
        [--config-files X.cfg] <overrides used for the run...> \\
        restart.input_path=<dir> restart.basename=<name>

The config is rebuilt from the same override syntax as the CLI; the
restart's grid must match it. The last line of the output is the report as
JSON: ``{"resumed_pcpt", "steps_clean", "first_bad"}``, where ``first_bad``
is null when every replayed step stayed finite.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

LOCAL_FIELDS = ("conc", "thick", "snow_thick", "damage", "conc_young", "h_young", "sst", "sss", "vt_u", "vt_v")


def first_bad(state):
    """(field, index, count) of the first non-finite field of ``state``, or None."""
    import torch

    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None or bool(torch.isfinite(v).all()):
            continue
        bad = ~np.isfinite(v.detach().cpu().numpy())
        return f.name, tuple(int(x) for x in np.argwhere(bad)[0]), int(bad.sum())
    return None


def _local(state, j, i):
    """The fields around cell (j, i) before the phase that broke them."""
    out = {}
    for name in LOCAL_FIELDS:
        a = getattr(state, name, None)
        if a is None:
            continue
        a = a.detach().cpu().numpy()
        out[name] = a[max(0, j - 1):j + 2, max(0, i - 1):i + 2].tolist()
    return out


def replay(sim, steps: int) -> dict:
    """Replay ``steps`` steps of ``sim`` phase by phase; the report."""
    from nextsim_tpu_torch.ops import momentum, thermo, transport

    report = {"resumed_pcpt": sim.pcpt, "steps_clean": 0, "first_bad": None}
    dyn = sim.dyn
    for _ in range(steps):
        forcing = sim._next_forcing()
        tinfo = sim.time_info()
        ga = dict(sim.grid_arrays)
        ga["cohesion"] = sim.c_fix + sim.c_alea * sim.state.random_number
        diag = {}
        phases = []
        if sim.use_thermo:
            phases.append(("thermo", lambda s: thermo.thermo_step(
                s, forcing, ga, sim.dt, sim.thermo_params, tinfo=tinfo,
                fsd_params=sim.fsd_params, fsd_bins=sim.fsd_bins)))
        if sim.fsd_params is not None:
            phases.append(("fsd", lambda s: (sim._fsd_block(s, forcing, diag), {})))
        if dyn.dynamics_type in ("bbm", "evp", "mevp"):
            phases.append(("momentum", lambda s: momentum.explicit_solve(s, forcing, ga, sim.dt, dyn)))
        elif dyn.dynamics_type == "free_drift":
            phases.append(("momentum", lambda s: (momentum.free_drift(s, forcing, ga, sim.dt, dyn), {})))
        if dyn.dynamics_type != "no_motion":
            phases.append(("transport", lambda s: transport.transport_and_ridge(s, ga, sim.dt, sim.transport_params)))
        state = sim.state
        for name, fn in phases:
            new, d = fn(state)
            diag.update(d)
            hit = first_bad(new)
            if hit is not None:
                field, idx, count = hit
                j, i = idx[-2], idx[-1]
                report["first_bad"] = {"step": sim.pcpt, "phase": name, "field": field, "index": list(idx),
                                       "count": count, "before": _local(state, j, i)}
                return report
            state = new
        sim.state = state
        sim.pcpt += 1
        report["steps_clean"] += 1
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="nextsim_tpu_torch.tools.nan_bisect")
    parser.add_argument("--config-files", action="append", default=[])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs on the host)")
    parser.add_argument("--steps", type=int, default=80, help="steps to replay")
    args, extra = parser.parse_known_args(argv)
    overrides = {}
    for ov in extra:
        k, _, v = ov.partition("=")
        overrides[k.lstrip("-")] = v
    overrides.setdefault("restart.start_from_restart", "true")
    overrides.setdefault("restart.type", "continue")
    overrides.setdefault("debugging.check_fields_fast", "false")

    from nextsim_tpu_torch.config import Config
    from nextsim_tpu_torch.model.simulator import Simulator

    cfg = Config.from_files(*args.config_files, overrides=overrides)
    sim = Simulator(cfg, device=args.device)  # reads the restart
    print(f"resumed at pcpt {sim.pcpt}", file=sys.stderr, flush=True)
    report = replay(sim, args.steps)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
