"""Minimal NetCDF reading without external netCDF libraries.

A copy of nextsim_tpu/forcing/netcdf_io.py, pinned to it by tests/test_torch_outputs.py.

The reference links NetCDF-C++4 (reference: model/Makefile); here classic
NetCDF3 is read via scipy and NetCDF4/HDF5 via h5py — covering every format
the reference's 52 dataset descriptors use. Returns plain numpy plus a tiny
attribute view, enough for the dataset layer.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class NCVar:
    def __init__(self, data, attrs: Dict):
        self._data = data
        self.attrs = attrs

    def __getitem__(self, idx):
        out = np.asarray(self._data[idx])
        scale = self.attrs.get("scale_factor")
        offset = self.attrs.get("add_offset")
        fill = self.attrs.get("_FillValue", self.attrs.get("missing_value"))
        if fill is not None and out.dtype.kind in "if":
            out = np.where(out == np.asarray(fill, out.dtype), np.nan, out)
        if scale is not None or offset is not None:
            out = out * (scale if scale is not None else 1.0) + (
                offset if offset is not None else 0.0
            )
        return out

    @property
    def shape(self):
        return self._data.shape

    @property
    def dimensions(self) -> List[str]:
        return self.attrs.get("__dims__", [])


class NCFile:
    """Dict-like: f.variables[name] -> NCVar; f.attrs global attributes."""

    def __init__(self, path: str):
        self.path = path
        self.variables: Dict[str, NCVar] = {}
        self.attrs: Dict = {}
        self._backing = None
        try:
            self._open_scipy(path)
        except Exception:
            self._open_h5py(path)

    def _open_scipy(self, path):
        from scipy.io import netcdf_file

        # mmap=True: a plane load reads its record, not the whole file (the
        # program's reader opens with mmap=False, which reads every variable
        # of the file at each open); the values are the same
        import warnings

        warnings.filterwarnings("ignore", "Cannot close a netcdf_file opened with mmap=True")
        f = netcdf_file(path, "r", mmap=True)
        self._backing = f
        for name, var in f.variables.items():
            attrs = {
                k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in var._attributes.items()
            }
            attrs["__dims__"] = list(var.dimensions)
            self.variables[name] = NCVar(var.data, attrs)
        self.attrs = {
            k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in f._attributes.items()
        }

    def _open_h5py(self, path):
        import h5py

        f = h5py.File(path, "r")
        self._backing = f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                attrs = {}
                for k, v in obj.attrs.items():
                    if isinstance(v, bytes):
                        v = v.decode()
                    elif isinstance(v, np.ndarray) and v.size == 1:
                        v = v.item()
                    attrs[k] = v
                dims = attrs.get("DIMENSION_LIST")
                attrs["__dims__"] = []
                self.variables[name.split("/")[-1]] = NCVar(obj, attrs)

        f.visititems(visit)
        self.attrs = dict(f.attrs)

    def close(self):
        if self._backing is not None:
            self._backing.close()
            self._backing = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
