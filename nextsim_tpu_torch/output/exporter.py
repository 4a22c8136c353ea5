"""Snapshot exporter.

The reference gathers fields to rank 0 and writes a raw little-endian binary
`.bin` plus a `.dat` text record file per snapshot (reference:
core/src/exporter.cpp:30-233; exportResults fe.cpp:14111-14325) named
``{field,mesh}_%Y%m%dT%H%M%SZ``. Here the canonical snapshot is a compressed
``.npz`` of the state pytree plus a JSON manifest; a reference-format
binary writer (same .bin/.dat layout) is provided for cross-validation
tooling (see output/ref_binary.py).

The counterpart of nextsim_tpu/output/exporter.py: the same files, from
host copies of the port's tensors (on a device mesh gathered from every
rank, and written by rank 0).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from nextsim_tpu_torch.core.variables import SPECS
from nextsim_tpu_torch.parallel.multihost import is_writer
from nextsim_tpu_torch.utils import dates


def state_to_arrays(state) -> dict:
    out = {}
    import dataclasses

    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:  # optional leaves (e.g. FSD when disabled)
            continue
        out[f.name] = np.asarray(v)
    return out


def export_snapshot(sim, name: Optional[str] = None) -> str:
    """Write one snapshot; returns the path.

    Honors ``output.variables`` (reference export names, e.g. Concentration,
    Thickness, M_VT — reference: options.cpp output.variables default list)
    unless ``output.export_fields`` selection is disabled, and appends the
    forcing planes when ``output.save_forcing_fields`` is set (reference:
    exportResults' M_external_data_elements debug export, fe.cpp:14190-14230).
    """
    cfg = sim.cfg
    path = cfg["output.exporter_path"]
    if name is None:
        if cfg["output.datetime_in_filename"]:
            name = dates.datenum_to_string(sim.current_time)
        else:
            name = str(sim.pcpt)
    if cfg["output.format"] == "reference":
        # reference binary Exporter format (core/src/exporter.cpp), honoring
        # output.exporter_precision (exporter.hpp float/double records)
        from nextsim_tpu_torch.output import ref_binary

        return ref_binary.write_state(
            sim, name, precision=cfg["output.exporter_precision"]
        )
    arrays = state_to_arrays(sim.host_state())
    if cfg["output.exporter_precision"] == "double":
        arrays = {k: np.asarray(v, np.float64) for k, v in arrays.items()}

    # variable selection by reference export name
    selected = set(cfg["output.variables"])
    if selected and selected != {"*"}:
        export_to_field = {}
        for fname, spec in SPECS.items():
            export_to_field.setdefault(spec.export_name, []).append(fname)
        # M_VT selects both velocity components; vt_u's export name is M_VT_x
        keep = set()
        for sel in selected:
            for exp, fields in export_to_field.items():
                if exp == sel or exp.startswith(sel + "_") or exp == "M_" + sel:
                    keep.update(fields)
        if keep:  # unknown-only selections fall back to everything
            arrays = {k: v for k, v in arrays.items() if k in keep or k not in SPECS}

    if cfg["output.save_diagnostics"] and getattr(sim, "diag", None):
        # all diagnostic planes of the last step (reference: exportResults
        # exports every diagnostic ModelVariable when output.save_diagnostics
        # is set, fe.cpp:7348-7352)
        diag = sim.gather(sim.diag)
        for k, v in diag.items():
            if v is not None and getattr(v, "ndim", 0) >= 2:
                arrays[f"diag_{k}"] = np.asarray(v)

    if cfg["output.save_forcing_fields"] and getattr(sim, "last_forcing", None) is not None:
        import dataclasses as _dc

        last_forcing = sim.gather(sim.last_forcing)
        for f in _dc.fields(last_forcing):
            v = getattr(last_forcing, f.name)
            if v is not None:
                arrays[f"forcing_{f.name}"] = np.asarray(v)
    fname = os.path.join(path, f"field_{name}.npz")
    if not is_writer():
        return fname
    os.makedirs(path, exist_ok=True)
    if cfg["output.async_io"]:
        from nextsim_tpu_torch.utils import async_writer

        async_writer.get_writer().submit(np.savez_compressed, fname, **arrays)
    else:
        np.savez_compressed(fname, **arrays)
    manifest = {
        "time": sim.current_time,
        "datetime": dates.datenum_to_string(sim.current_time, "%Y-%m-%dT%H:%M:%SZ"),
        "pcpt": sim.pcpt,
        "grid": {
            "nx": sim.grid.nx,
            "ny": sim.grid.ny,
            "dx": sim.grid.dx,
            "x0": sim.grid.x0,
            "y0": sim.grid.y0,
        },
        "fields": {k: list(v.shape) for k, v in arrays.items()},
        "export_names": {k: SPECS[k].export_name for k in arrays if k in SPECS},
    }
    with open(os.path.join(path, f"field_{name}.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return fname
