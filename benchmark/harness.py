"""One run of one cell: set-up, the measured window, the traced stretch, the
per-layer readers and the check against the plain reference.

Everything that belongs to a cell is found by name: its configuration in
``configs/<config>.json`` (the program's options, the input datasets, the
source), its traffic mix in ``traffic/<traffic>.json`` (read by the driver
the mix names, ``drivers/<driver>.py``), its per-layer metrics in
``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number or None), its
limits in ``limits/<workload>.json``. The program is ``nextsim_tpu_torch``,
driven through ``Config``, ``Simulator.step_chunk`` and
``BatchedEnsemble.step``.

The window runs whole calls until ``seconds`` have passed on the host's
clock, then synchronizes: a rate is every step of the window over the time
to the end of the last one. With ``trace`` the window's first calls
(``trace_calls`` of the mix) run under ``torch.profiler`` first; the
window's ``seconds`` then start after the trace has been read, and the
per-layer readers take their times from that untraced stretch. Over the
same stretch they get the change in each of the driver's counters, where
its ``Driver`` has ``counters()``, and the run's options as the program got
them.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import importlib
import json
import math
import os
import shutil
import time
import types
from pathlib import Path
from typing import Optional

import numpy as np

from benchmark.drivers import DAYS_IN_SEC

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"


# --- the cell, from BENCHMARK.json and the files it names ---------------------

def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell ``workload`` with its configuration, traffic mix, limits and
    the metrics it reports (end-to-end and per-layer), read from files."""
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file}; there are {sorted(cells)}")
    cell = cells[workload]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {
        "name": workload,
        "cell": cell,
        "config": json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "run_seconds": bench["run_seconds"],
    }


def reader(metric: str):
    """The per-layer reader of ``metric``: ``metrics/<metric>.py``'s ``read``."""
    return importlib.import_module(f"benchmark.metrics.{metric}").read


# --- the run's options from the seed ------------------------------------------

def first_day(config: dict) -> datetime.datetime:
    day = config.get("data_first_day") or config["options"]["simul.time_init"][:10]
    return datetime.datetime.fromisoformat(day)


def run_options(spec: dict, seed: int, run_dir: Path) -> dict:
    """The program's options for this run: the configuration's, the mix's
    overrides, the run's directory, and what the seed draws (the start hour,
    a constant wind)."""
    config, traffic = spec["config"], spec["traffic"]
    opts = dict(config["options"])
    opts.update(traffic.get("overrides", {}))
    opts["output.exporter_path"] = str(run_dir / "out")
    rng = np.random.default_rng(seed)
    if "start_hour" in traffic:
        lo, hi = traffic["start_hour"]
        hour = int(rng.integers(lo, hi))
        opts["simul.time_init"] = (first_day(config) + datetime.timedelta(hours=hour)).strftime("%Y-%m-%d %H:%M:%S")
    if "wind_speed" in traffic:
        lo, hi = traffic["wind_speed"]
        speed, theta = rng.uniform(lo, hi), rng.uniform(0.0, 2.0 * math.pi)
        opts["ideal_simul.constant_wind_u"] = float(speed * math.cos(theta))
        opts["ideal_simul.constant_wind_v"] = float(speed * math.sin(theta))
    return opts


def data_days(traffic: dict, dt: float, seconds: float, calls: Optional[int], steps_a_call: int) -> int:
    """Days of input data a run needs: the start hour's day, the window at
    the mix's fastest step (or ``calls`` calls), the warm call and a margin."""
    d = traffic["data"]
    steps = calls * steps_a_call if calls else seconds / (d["min_step_ms"] * 1e-3)
    steps += 2 * steps_a_call
    return math.ceil(1.0 + steps * dt * DAYS_IN_SEC + d["days_margin"])


# --- the run -------------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    """What a per-layer reader may read."""

    device: str
    dtype: str
    dyn_type: str
    substeps: int
    shape: tuple
    members: int
    steps: int  # model steps of the stretch the times below cover
    window_s: float
    timer: dict  # the program's Timer nodes: seconds over that stretch
    spans: dict  # the benchmark's spans: seconds over that stretch
    init_s: float
    capture: list  # the stats of each graph captured in set-up
    trace: Optional[object]  # tracing.Trace of the traced calls, or None
    options: types.MappingProxyType  # the run's options as the program got them, read-only
    counters: dict  # the change in each of the driver's cumulative counters over that stretch, or {}


def _timer_totals(timer) -> dict:
    out = {}

    def walk(node):
        out[node.name] = out.get(node.name, 0.0) + node.elapsed
        for c in node.children.values():
            walk(c)

    walk(timer._root)
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def seeded_field(seed: int, shape, device):
    """The per-cell cohesion draw of this seed, uniform in [0, 1), made on
    the device in float32 (the program and the reference get the same)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return torch.rand(shape, generator=g, dtype=torch.float32, device=device)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             calls: Optional[int] = None, control: bool = False, t_start: Optional[float] = None,
             cache: Path = CACHE, extra_options: Optional[dict] = None, log=print) -> dict:
    """One run of the cell ``spec`` (``load_cell``): the result's line as a
    dict, its ``checks`` last. ``calls`` runs that many calls in place of a
    timed window (a CPU rehearsal); ``control`` judges the cell's control
    (the reference in bfloat16) in the program's place (``checks`` then say
    how far it lies);
    ``extra_options`` override the configuration (a small rehearsal)."""
    import torch

    from benchmark import check, drivers, inputs, tracing

    t_start = time.perf_counter() if t_start is None else t_start
    traffic = spec["traffic"]
    run_dir = cache / "runs" / spec["name"]
    if run_dir.exists():
        shutil.rmtree(run_dir)
    run_dir.mkdir(parents=True)
    kind = drivers.load(traffic["driver"])
    opts = run_options(spec, seed, run_dir)
    opts.update(extra_options or {})

    # the input files: written once into the cache, not counted in set-up
    data = {"bytes_written": 0, "seconds": 0.0, "end": math.inf}
    if spec["config"]["datasets"]:
        dt = float(opts["simul.timestep"])
        days = data_days(traffic, dt, seconds, calls, kind.steps_a_call_bound(opts, traffic))
        day0 = first_day(spec["config"])
        got = inputs.ensure(cache / "data", spec["config"]["datasets"], day0, days)
        os.environ["NEXTSIM_DATA_DIR"] = str(got["dir"])
        data.update(bytes_written=got["bytes_written"], seconds=got["seconds"], days=days,
                    end=inputs.hours_since_1900(day0 + datetime.timedelta(days=days)) / 24.0)
        log(f"inputs: {got['dir'].name}, {got['bytes_written']} bytes written in {got['seconds']:.1f} s")

    # set-up: the kernels' build (its seconds also reported apart), the
    # program, the seed's cohesion field, the warm call
    build_s = build_kernels(device)
    log(f"kernels built or found: {build_s:.2f} s")
    driver = kind.Driver(opts, traffic, device, seed)
    field = seeded_field(seed, driver.shape, device)
    driver.seed_cohesion(field)

    def one_call() -> int:
        if driver.time_after_call() > data["end"] + 1e-9:
            raise RuntimeError(f"the run reached the end of its forcing data ({data.get('days')} days from "
                               f"{spec['config'].get('data_first_day')}): the window outran the input span")
        return driver.call()

    one_call()
    _sync(device)
    setup_s = time.perf_counter() - t_start - data["seconds"]

    # the window
    prof_trace = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        _sync(device)
        prof.__enter__()
        t0 = time.perf_counter()
        traced = 0
        for _ in range(int(traffic["trace_calls"])):
            with torch.profiler.record_function("bench.call"):
                traced += one_call()
        _sync(device)
        wall = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        prof_trace = tracing.from_profiler(prof, wall, traced)
        del prof
    timer0, spans0, counters0 = _timer_totals(driver.timer), dict(driver.spans), getattr(driver, "counters", dict)()
    steps = 0
    n_calls = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while (calls is None and time.perf_counter() < deadline) or (calls is not None and n_calls < calls):
        steps += one_call()
        n_calls += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    memory_peak = int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0
    timer1, counters1 = _timer_totals(driver.timer), getattr(driver, "counters", dict)()

    from nextsim_tpu_torch.utils import async_writer

    async_writer.flush()  # the window's snapshots on disk before the process may end
    member_steps = steps * driver.members
    sim = driver.sim
    ctx = Ctx(device=torch.device(device).type, dtype=driver.dtype,
              dyn_type=sim.dyn.dynamics_type, substeps=int(sim.dyn.substeps), shape=tuple(driver.shape),
              members=driver.members, steps=steps, window_s=window_s,
              timer={k: timer1[k] - timer0.get(k, 0.0) for k in timer1},
              spans={k: driver.spans[k] - spans0.get(k, 0.0) for k in driver.spans},
              init_s=driver.init_s, capture=driver.capture_stats(), trace=prof_trace,
              options=types.MappingProxyType(dict(opts)),
              counters={k: counters1[k] - counters0.get(k, 0) for k in counters1})

    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        days = member_steps * float(opts["simul.timestep"]) * DAYS_IN_SEC
        e2e = {"model_days_per_hour": days / (window_s / 3600.0), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}

    # the check: the program's results to the host, the program freed, the reference
    got = driver.result()
    got["seeded_field"] = field.cpu()
    del ctx, driver, sim
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.run(got, opts, spec["limits"], device, control=control)
    log(f"check: {time.perf_counter() - t_check:.1f} s")

    result = {
        "correct": check.is_correct(checks),
        "attempted": member_steps,
        "failed": 0,
        "metrics": metrics,
        "device": device_info(device, memory_peak, prof_trace),
        "inputs": {"bytes_written": data["bytes_written"], "seconds": data["seconds"]},
        "build_s": build_s,
        "steps": steps,
        "window_s": window_s,
    }
    if prof_trace is not None:
        bd = tracing.breakdown(prof_trace)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = checks
    return result


def build_kernels(device) -> float:
    """Seconds to build (or find built) the program's CUDA kernels: nvcc on
    a checkout's first run, a look at the build directory after. Part of
    set-up; the result line also gives it as ``build_s``."""
    import torch

    if torch.device(device).type != "cuda":
        return 0.0
    from nextsim_tpu_torch.ops import momentum_cuda

    t0 = time.perf_counter()
    momentum_cuda.build()
    return time.perf_counter() - t0


def device_info(device: str, memory_peak: int, trace) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
                "memory_peak_bytes": memory_peak}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.wall_s
    return info
