"""Reference-format binary field files ({field,mesh}_*.bin/.dat).

Python wrapper of the native codec (native/ref_exporter.cpp), reproducing the
reference Exporter's file pair (reference: core/src/exporter.cpp:30-233;
exportResults fe.cpp:14111-14325):

* ``.bin``: records of [int32 count][count little-endian values]
* ``.dat``: one text line per record: ``Name type size min max``

`write_state` emits the model state with the reference's export names
(model/model_variable.cpp) so reference tooling (matlab/neXtSIM_bin_revert.m)
reads our output; `read_file` reads any reference-produced pair for
cross-validation. The native library is compiled on demand (g++, cached in
the repo's git-ignored native/build/); a numpy codec covers hosts without a
toolchain. The counterpart of nextsim_tpu/output/ref_binary.py: the same
codec source and build, fed host copies of the port's state.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Tuple

import numpy as np

_NATIVE_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "ref_exporter.cpp")
# its own library name: the JAX package builds libref_exporter.so from the
# same source, possibly at the same time
_NATIVE_SO = os.path.join(os.path.dirname(__file__), "..", "..", "native", "build",
                          "libref_exporter_torch.so")

_lib = None
_lib_failed = False


def _load_native():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        src = os.path.abspath(_NATIVE_SRC)
        so = os.path.abspath(_NATIVE_SO)
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", so, src],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(so)
        lib.rxw_open.restype = ctypes.c_void_p
        lib.rxw_open.argtypes = [ctypes.c_char_p]
        lib.rxw_close.argtypes = [ctypes.c_void_p]
        for fn, ctype in (
            ("rxw_write_floats", ctypes.POINTER(ctypes.c_float)),
            ("rxw_write_doubles", ctypes.POINTER(ctypes.c_double)),
            ("rxw_write_ints", ctypes.POINTER(ctypes.c_int32)),
        ):
            g = getattr(lib, fn)
            g.restype = ctypes.c_int
            g.argtypes = [ctypes.c_void_p, ctype, ctypes.c_int32]
        lib.rxr_open.restype = ctypes.c_void_p
        lib.rxr_open.argtypes = [ctypes.c_char_p]
        lib.rxr_close.argtypes = [ctypes.c_void_p]
        lib.rxr_record_size.restype = ctypes.c_int32
        lib.rxr_record_size.argtypes = [ctypes.c_void_p]
        for fn, ctype in (
            ("rxr_read_floats", ctypes.POINTER(ctypes.c_float)),
            ("rxr_read_doubles", ctypes.POINTER(ctypes.c_double)),
            ("rxr_read_ints", ctypes.POINTER(ctypes.c_int32)),
        ):
            g = getattr(lib, fn)
            g.restype = ctypes.c_int
            g.argtypes = [ctypes.c_void_p, ctype, ctypes.c_int32]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


_DTYPES = {"float": np.float32, "double": np.float64, "int": np.int32}


def write_file(path_base: str, records: List[Tuple[str, str, np.ndarray]]):
    """Write a .bin/.dat pair; records = [(name, type, 1-D array), ...]."""
    lib = _load_native()
    dat_lines = []
    if lib is not None:
        h = lib.rxw_open((path_base + ".bin").encode())
        if not h:
            raise IOError(f"cannot open {path_base}.bin")
        try:
            for name, typ, arr in records:
                a = np.ascontiguousarray(arr.ravel(), _DTYPES[typ])
                n = np.int32(a.size)
                if typ == "float":
                    rc = lib.rxw_write_floats(h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
                elif typ == "double":
                    rc = lib.rxw_write_doubles(h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
                else:
                    rc = lib.rxw_write_ints(h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
                if rc != 0:
                    raise IOError(f"write failed for {name}")
                dat_lines.append(_dat_line(name, typ, a))
        finally:
            lib.rxw_close(h)
    else:  # numpy fallback
        with open(path_base + ".bin", "wb") as f:
            for name, typ, arr in records:
                a = np.ascontiguousarray(arr.ravel(), _DTYPES[typ])
                f.write(np.int32(a.size).tobytes())
                f.write(a.tobytes())
                dat_lines.append(_dat_line(name, typ, a))
    with open(path_base + ".dat", "w") as f:
        f.write("\n".join(dat_lines) + "\n")


def _dat_line(name: str, typ: str, a: np.ndarray) -> str:
    lo = a.min() if a.size else 0
    hi = a.max() if a.size else 0
    return f"{name} {typ} {a.size:g} {lo:g} {hi:g}"


def read_file(path_base: str) -> Dict[str, np.ndarray]:
    """Read a .bin/.dat pair into {name: array} (reference: Exporter::
    loadFile/readRecord)."""
    names: List[Tuple[str, str, int]] = []
    with open(path_base + ".dat") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                names.append((parts[0], parts[1], int(float(parts[2]))))
    out: Dict[str, np.ndarray] = {}
    lib = _load_native()
    if lib is not None:
        h = lib.rxr_open((path_base + ".bin").encode())
        if not h:
            raise IOError(f"cannot open {path_base}.bin")
        try:
            for name, typ, size in names:
                n = lib.rxr_record_size(h)
                if n < 0:
                    raise IOError(f"unexpected EOF before record {name}")
                a = np.empty(n, _DTYPES[typ])
                if typ == "float":
                    rc = lib.rxr_read_floats(h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), np.int32(n))
                elif typ == "double":
                    rc = lib.rxr_read_doubles(h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), np.int32(n))
                else:
                    rc = lib.rxr_read_ints(h, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), np.int32(n))
                if rc != 0:
                    raise IOError(f"read failed for {name}")
                out[name] = a
        finally:
            lib.rxr_close(h)
    else:
        with open(path_base + ".bin", "rb") as f:
            for name, typ, size in names:
                n = np.frombuffer(f.read(4), np.int32)[0]
                out[name] = np.frombuffer(
                    f.read(int(n) * _DTYPES[typ]().itemsize), _DTYPES[typ]
                ).copy()
    return out


def write_state(sim, name: str, precision: str = "float") -> str:
    """Export the model state as a reference-style field_<name>.bin/.dat pair
    using the reference export names (reference: exportResults,
    fe.cpp:14111-14325). Stacked fields follow the reference's layout:
    Tice/M_sigma concatenated component-by-component; M_VT interleaved as
    [u...; v...]."""
    from nextsim_tpu_torch.core.variables import SPECS

    from nextsim_tpu_torch.parallel.multihost import is_writer

    path = os.path.join(sim.cfg["output.exporter_path"], f"field_{name}")
    records: List[Tuple[str, str, np.ndarray]] = []
    # Time and Misc records lead (fe.cpp:9638-9680 restart layout)
    records.append(("Time", "double", np.array([sim.current_time])))
    state = sim.host_state()
    for fname, spec in SPECS.items():
        arr = np.asarray(getattr(state, fname), np.float64)
        if fname in ("vt_u", "ut_u"):
            # pair with the v component under the reference's single name
            vname = fname.replace("_u", "_v")
            varr = np.asarray(getattr(state, vname), np.float64)
            ref = "M_VT" if fname == "vt_u" else "M_UT"
            records.append((ref, precision, np.concatenate([arr.ravel(), varr.ravel()])))
            continue
        if fname in ("vt_v", "ut_v"):
            continue
        records.append((spec.export_name, precision, arr.ravel()))
    if is_writer():  # every rank gathers (host_state), rank 0 writes
        os.makedirs(sim.cfg["output.exporter_path"], exist_ok=True)
        write_file(path, records)
    return path + ".bin"
