"""Outer-run field sources for nesting (the counterpart of
nextsim_tpu/model/nesting_source.py).

Two exchange formats, matching the two kinds of outer run:

* NetCDF (`NestingNetCDFSource`): the reference's own format —
  `nesting_[outer_mesh]_[yyyymmdd].nc` files on the outer model's
  curvilinear lat/lon grid, with time-bracketed linear interpolation and
  cross-grid spatial interpolation through the dataset layer (reference:
  forcingNesting fe.cpp:11060-11130; nesting_{nodes,ocean,ice,dynamics}
  _elements descriptors, dataset.cpp:3396-4212 — velocities carry no
  east/north rotation: both runs share the projection frame).
* npz snapshots (`NestingSource`): an outer nextsim_tpu run's exporter
  directory (`field_*.npz` + manifest), same grid, nearest-at-or-before
  snapshot.

`make_nesting_source` picks by inspecting `nesting.outer_mesh`: a directory
of snapshots selects npz mode; otherwise the value is `[dir/]name` naming
NetCDF files (dir defaults to NEXTSIM_DATA_DIR). Either source hands back
tensors of the simulator's dtype on its device.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def _tensor(arr, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr)).to(device=device, dtype=dtype)


class NestingSource:
    def __init__(self, directory: str, grid, dtype=torch.float32, device="cpu"):
        self.directory = directory
        self.grid = grid
        self.dtype = dtype
        self.device = torch.device(device)
        self._index = []  # (time, npz_path)
        self._cache: Dict[str, Dict] = {}
        if directory and os.path.isdir(directory):
            for man in sorted(glob.glob(os.path.join(directory, "field_*.json"))):
                try:
                    with open(man) as f:
                        meta = json.load(f)
                    self._index.append((meta["time"], man.replace(".json", ".npz")))
                except Exception:
                    continue
            self._index.sort()

    def fields_at(self, t: float) -> Optional[Dict[str, torch.Tensor]]:
        if not self._index:
            return None
        # nearest snapshot at or before t (falling back to the first)
        best = self._index[0][1]
        for tt, path in self._index:
            if tt <= t + 1e-9:
                best = path
            else:
                break
        if best not in self._cache:
            with np.load(best) as data:
                fields = {}
                for name in ("conc", "thick", "snow_thick", "damage",
                             "ridge_ratio", "vt_u", "vt_v", "sigma"):
                    if name in data:
                        fields[name] = _tensor(data[name], self.dtype, self.device)
            self._cache = {best: fields}  # keep one
        return self._cache[best]


def _nesting_spec(name: str):
    """Dataset descriptor for the reference's nesting files (the union of
    nesting_{ice,ocean,dynamics}_elements + nesting_nodes variable sets,
    dataset.cpp:3396-4212; all live in one daily file). Missing variables
    are skipped by the reader, so files with only a subset still work."""
    from nextsim_tpu_torch.forcing.datasets import DatasetSpec, DataVar, GridSpec

    return DatasetSpec(
        name=f"nesting_{name}",
        filename_mask=f"nesting_{name}_%Y%m%d.nc",
        frequency="daily",
        grid=GridSpec(kind="curvilinear"),
        variables=(
            # ice elements (dataset.cpp nesting_ice_elements)
            DataVar("sea_ice_thickness", "thick"),
            DataVar("sea_ice_area_fraction", "conc"),
            DataVar("surface_snow_thickness", "snow_thick"),
            DataVar("young_ice_thickness", "h_young"),
            DataVar("young_ice_area_fraction", "conc_young"),
            DataVar("surface_snow_thickness_on_young_ice", "hs_young"),
            # ocean elements (nesting_ocean_elements)
            DataVar("sea_surface_temperature", "sst"),
            DataVar("sea_surface_salinity", "sss"),
            # dynamics elements (nesting_dynamics_elements)
            DataVar("stress_tensor_first_component", "sigma1"),
            DataVar("stress_tensor_second_component", "sigma2"),
            DataVar("stress_tensor_third_component", "sigma3"),
            DataVar("sea_ice_damage", "damage"),
            DataVar("ridge_ratio", "ridge_ratio"),
            # nodes (nesting_nodes; no east/north rotation — the outer run
            # shares the projection frame, dataset.cpp:4360-4368)
            DataVar("sea_ice_x_velocity", "vt_u"),
            DataVar("sea_ice_y_velocity", "vt_v"),
        ),
        nodal_targets=("vt_u", "vt_v"),
    )


class NestingNetCDFSource:
    """Reference-format nesting ingest through the dataset layer."""

    def __init__(self, name: str, dirname: str, grid, dtype=torch.float32, device="cpu"):
        from nextsim_tpu_torch.forcing.datasets import _DatasetReader

        self.reader = _DatasetReader(_nesting_spec(name), grid, dirname)
        self.dtype = dtype
        self.device = torch.device(device)

    def fields_at(self, t: float) -> Optional[Dict[str, torch.Tensor]]:
        raw = dict(self.reader.fields_at(t))
        if not raw:
            return None
        out: Dict[str, torch.Tensor] = {}
        sig = [raw.pop(k, None) for k in ("sigma1", "sigma2", "sigma3")]
        if all(s is not None for s in sig):
            out["sigma"] = _tensor(np.stack(sig), self.dtype, self.device)
        for k, v in raw.items():
            out[k] = _tensor(v, self.dtype, self.device)
        return out


def make_nesting_source(cfg, grid, dtype=torch.float32, device="cpu"):
    """Pick the outer-run source format from nesting.outer_mesh (see module
    docstring)."""
    outer = cfg["nesting.outer_mesh"]
    if os.path.isdir(outer) and glob.glob(os.path.join(outer, "field_*.json")):
        return NestingSource(outer, grid, dtype, device)
    dirname, name = os.path.split(outer)
    if not dirname:
        dirname = os.environ.get("NEXTSIM_DATA_DIR", ".")
    return NestingNetCDFSource(name, dirname, grid, dtype, device)
