"""Checkpoint / resume (the counterpart of nextsim_tpu/output/restart.py).

Equivalent of the reference's writeRestart/readRestart (reference:
model/finiteelement.cpp:9503-9948): the full prognostic state + step counters
+ drifter state, named ``restart_<name>.npz`` (single-file analog of the
reference's {field,mesh}_<name>.{bin,dat} pair — no mesh needs saving because
the grid is static and reproducible from the config). Resume is
deterministic: the restored state is bitwise the saved one.

The npz layout and its ``__meta__`` block are the JAX package's, so a restart
moves between the two packages in both directions. ``restart.format=orbax``
(the JAX package's sharded checkpoint) is JAX-only and raises here.

On a device mesh every rank gathers the global state and rank 0 writes the
file; every rank reads the whole file and keeps its block, so a restart
moves between runs on any mesh and on one device.

Restart types (reference: options.cpp restart.type):
* extend   — continue for `simul.duration` from the restart's time
* continue — duration counted from the original time_init
* arbitrary— ignore restart time; use config time_init
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from nextsim_tpu_torch.core.state import State
from nextsim_tpu_torch.parallel.multihost import is_writer
from nextsim_tpu_torch.utils import dates


def _check_format(cfg) -> None:
    if cfg["restart.format"] != "npz":
        raise NotImplementedError(
            f"restart.format={cfg['restart.format']}: orbax checkpoints are "
            "JAX-only; the PyTorch port reads and writes restart.format=npz"
        )


def save_npz_restart(fname: str, meta: dict, arrays: dict, async_io: bool = False) -> str:
    """Write one npz restart payload (__meta__ JSON + host arrays), the one
    owner of the on-disk format that `read_restart` loads."""
    if async_io:
        from nextsim_tpu_torch.utils import async_writer

        async_writer.get_writer().submit(
            np.savez_compressed, fname, __meta__=json.dumps(meta), **arrays
        )
    else:
        np.savez_compressed(fname, __meta__=json.dumps(meta), **arrays)
    return fname


def restart_meta(sim) -> dict:
    """The meta block every restart carries (grid identity + counters)."""
    return {
        "pcpt": sim.pcpt,
        "time_init": sim.time_init,
        "current_time": sim.current_time,
        "grid": {"nx": sim.grid.nx, "ny": sim.grid.ny, "dx": sim.grid.dx,
                 "x0": sim.grid.x0, "y0": sim.grid.y0},
    }


def _restart_dir(cfg) -> str:
    return cfg["restart.input_path"] or os.path.join(cfg["output.exporter_path"], "restart")


def write_restart(sim, name: Optional[str] = None) -> str:
    cfg = sim.cfg
    _check_format(cfg)
    path = _restart_dir(cfg)
    if name is None:
        if cfg["restart.datetime_in_filename"]:
            name = dates.datenum_to_string(sim.current_time)
        else:
            name = str(sim.pcpt)
    hstate = sim.host_state()
    arrays = {f.name: getattr(hstate, f.name) for f in dataclasses.fields(hstate)
              if getattr(hstate, f.name) is not None}
    for i, d in enumerate(sim.drifters):
        arrays[f"__drifter{i}_x"] = d.x
        arrays[f"__drifter{i}_y"] = d.y
        arrays[f"__drifter{i}_id"] = d.ids
        arrays[f"__drifter{i}_alive"] = d.alive
    # WIM floe-number field (the WAVES-era M_nfloes prognostic participates
    # in the reference restart) and the spectrum, so a resumed run continues
    # the wave field instead of re-spinning it up
    if getattr(sim, "wim", None) is not None and sim._wim_nfloes is not None:
        arrays["__wim_nfloes"], arrays["__wim_sdf"] = sim.wim.gather((sim._wim_nfloes, sim.wim.sdf))
    fname = os.path.join(path, f"restart_{name}.npz")
    if not is_writer():
        return fname
    os.makedirs(path, exist_ok=True)
    return save_npz_restart(fname, restart_meta(sim), arrays, async_io=cfg["output.async_io"])


def read_restart(sim, basename: Optional[str] = None) -> None:
    """Restore state + counters into an initialised Simulator (reference:
    readRestart, fe.cpp:9701-9948)."""
    cfg = sim.cfg
    _check_format(cfg)
    basename = basename or cfg["restart.basename"]
    # a pending asynchronous write of this very file must land first
    from nextsim_tpu_torch.utils import async_writer

    async_writer.flush()
    fname = os.path.join(_restart_dir(cfg), f"restart_{basename}.npz")
    with np.load(fname, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        _apply_restart(sim, data, meta)


def _apply_restart(sim, data, meta) -> None:
    """Apply a loaded restart payload to an initialised Simulator."""
    cfg = sim.cfg
    g = meta["grid"]
    if (g["nx"], g["ny"]) != (sim.grid.nx, sim.grid.ny):
        raise ValueError(
            f"restart grid {g['nx']}x{g['ny']} != model grid "
            f"{sim.grid.nx}x{sim.grid.ny}"
        )
    kw = {}
    for f in dataclasses.fields(sim.state):
        kw[f.name] = (
            torch.as_tensor(np.array(data[f.name]), dtype=sim.dtype, device=sim.device)
            if f.name in data else None
        )
    sim.state = sim.to_blocks(State(**kw))
    for i, d in enumerate(sim.drifters):
        if d.ignore_restart:
            continue  # drifters.<flavour>_ignore_restart: re-init
        if f"__drifter{i}_x" in data:
            d.x = data[f"__drifter{i}_x"]
            d.y = data[f"__drifter{i}_y"]
            d.ids = data[f"__drifter{i}_id"]
            d.alive = data[f"__drifter{i}_alive"]

    if getattr(sim, "wim", None) is not None and "__wim_nfloes" in data:
        on_dev = lambda a: torch.as_tensor(np.array(a), dtype=sim.dtype, device=sim.device)  # noqa: E731
        sim._wim_nfloes = sim.wim.to_blocks(on_dev(data["__wim_nfloes"]))
        if "__wim_sdf" in data and data["__wim_sdf"].shape == tuple(sim.wim.sdf.shape[:2]) + sim.wim.shape:
            sim.wim.sdf = sim.wim.to_blocks(on_dev(data["__wim_sdf"]))

    rtype = cfg["restart.type"]
    if rtype == "arbitrary":
        pass  # keep config time_init and pcpt=0
    elif rtype == "extend":
        # restart time becomes the new time origin (fe.cpp restart extend)
        sim.time_init = meta["current_time"]
        sim.pcpt = 0
    elif rtype == "continue":
        sim.time_init = meta["time_init"]
        sim.pcpt = meta["pcpt"]
    else:
        raise ValueError(f"restart.type {rtype!r}")

    # check/export/restart batching measures from the restored counter, and
    # the WIM exchange re-anchors on the absolute 0, f, 2f grid
    if getattr(sim, "wim", None) is not None:
        sim._wim_last_pcpt = None
    sim._last_check_pcpt = sim.pcpt
    sim._last_export_pcpt = sim.pcpt
    sim._last_restart_pcpt = sim.pcpt

    if cfg["restart.restart_at_rest"]:
        sim.state = sim.state.replace(
            vt_u=torch.zeros_like(sim.state.vt_u),
            vt_v=torch.zeros_like(sim.state.vt_v),
        )
