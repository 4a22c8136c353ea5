"""The momentum substep loop on the GPU: wrapper, plain version and loader
of the CUDA kernel in ``nextsim_tpu_torch/csrc/momentum_substep.cu``.

This module is the counterpart of nextsim_tpu/ops/momentum_pallas.py, whose
``substep_loop_blocked`` runs the substep loop as one blocked Pallas TPU
kernel. ``substep_loop`` keeps its contract: it takes exactly what
``momentum.explicit_solve`` builds (the namespace of loop-invariant planes
and the 8-plane carry) and returns the carry after ``steps`` substeps, the
mEVP displacement staying with the caller.

* A carry on the CPU runs ``substep_loop_reference``, the plain PyTorch
  loop over ``momentum._build_substep``. It is also the kernel's oracle on
  the card.
* A carry on a CUDA device runs the kernel, or raises: on a dtype other
  than float32/float64, on a plane of the wrong shape, dtype or device, or
  not contiguous, and on a failed build or launch. Nothing falls back to the
  plain version on the card.

The kernel is built with ``nvcc`` for sm_90a on first use, into
``nextsim_tpu_torch/build/`` (named by a hash of the source and flags), and
loaded with ctypes. ``launches`` counts the kernel launches the wrapper has
issued (two per substep: the cell stage and the node stage).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from nextsim_tpu_torch.core import constants as phys

#: kernel launches issued by ``substep_loop`` (two per substep)
launches = 0

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "momentum_substep.cu"
_BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

#: plane order of the kernel's pointer array (the Plane enum in the source)
_STATE = ("vt_u", "vt_v", "ut_u", "ut_v", "sxx", "syy", "sxy", "damage")
_CELL = ("volume", "conc", "thick", "cohesion", "bbm_expC", "bbm_pmax",
         "bbm_heal", "bbm_rtd", "evp_P")
_NODE = ("grad_ssh_u", "grad_ssh_v", "tau_ax", "tau_ay", "dte_over_mass_const",
         "beta_cor_const", "dom_cos", "dom_sin", "ocn_rot_x", "ocn_rot_y",
         "ocean_u", "ocean_v", "c_bu", "rlmass", "solve", "vtm_u", "vtm_v")
_PLANES = _STATE + _CELL + _NODE

#: loop-invariant planes each rheology reads (as momentum_pallas._CELL_PLANES
#: and _NODE_PLANES)
_CELL_USED = {
    "bbm": ("volume", "conc", "cohesion", "bbm_expC", "bbm_pmax", "bbm_heal", "bbm_rtd"),
    "evp": ("volume", "thick", "evp_P"),
    "mevp": ("volume", "thick", "evp_P"),
}
_NODE_USED = _NODE[:15]
_RHEOLOGY = {"bbm": 0, "evp": 1, "mevp": 2}


class _Params(ctypes.Structure):
    """Mirror of ``SubstepParams`` in the CUDA source."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "ny", "nx", "steps", "rheology", "pow_n", "pow_half", "pow_generic", "pad_"
    )] + [(n, ctypes.c_double) for n in (
        "pow_e", "r", "dte", "min_c", "lambda0", "young", "d0", "d1", "d2",
        "compr_strength", "tan_phi", "mult_cap", "re2", "ralpha1", "ralpha2",
        "delta_min", "cw", "u0", "b_mevp",
    )]


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def substep_loop_reference(consts, carry, steps: int, dte: float, dt: float,
                           dx: float, dyn_type: str, p):
    """``steps`` substeps of ``momentum._build_substep`` in plain PyTorch."""
    from nextsim_tpu_torch.ops import momentum

    body = momentum._build_substep(p, dyn_type, dte, dt, dx, consts)
    carry = tuple(carry)
    for _ in range(steps):
        carry = body(carry)
    return carry


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def substep_loop(consts, carry, steps: int, dte: float, dt: float, dx: float,
                 dyn_type: str, p):
    """Run the substep loop: the plain version for a carry on the CPU, the
    CUDA kernel for a carry on a CUDA device."""
    device = carry[0].device
    if device.type == "cpu":
        return substep_loop_reference(consts, carry, steps, dte, dt, dx, dyn_type, p)
    if device.type != "cuda":
        raise ValueError(f"substep_loop: no kernel for device {device}")
    return _substep_loop_cuda(consts, carry, steps, dte, dt, dx, dyn_type, p)


def _substep_loop_cuda(consts, carry, steps, dte, dt, dx, dyn_type, p):
    global launches
    if dyn_type not in _RHEOLOGY:
        raise ValueError(f"substep_loop: unknown rheology {dyn_type!r}")
    dtype = carry[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"substep_loop: the CUDA kernel takes float32 or float64, not {dtype}")
    device = carry[0].device
    ny1, nx1 = carry[0].shape
    ny, nx = ny1 - 1, nx1 - 1

    def check(name, a, shape):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"substep_loop: plane {name} is not a tensor")
        if tuple(a.shape) != shape or a.dtype != dtype or a.device != device:
            raise ValueError(
                f"substep_loop: plane {name} is {tuple(a.shape)} {a.dtype} on "
                f"{a.device}; the kernel needs {shape} {dtype} on {device}"
            )
        if not a.is_contiguous():
            raise ValueError(f"substep_loop: plane {name} is not contiguous")
        return a

    planes = {}
    for name, a in zip(_STATE, carry):
        shape = (ny1, nx1) if name.startswith(("vt", "ut")) else (ny, nx)
        # the kernel updates the carry in place: work on copies, so the
        # caller's tensors (e.g. the state's sigma) are left as they were
        planes[name] = check(name, a, shape).clone()
    for name in _CELL_USED[dyn_type]:
        planes[name] = check(name, getattr(consts, name), (ny, nx))
    node_names = _NODE_USED + (("vtm_u", "vtm_v") if dyn_type == "mevp" else ())
    for name in node_names:
        a = getattr(consts, name)
        if name == "solve" and isinstance(a, torch.Tensor) and a.dtype == torch.bool:
            a = a.to(dtype)  # the kernel tests solve > 0.5
        planes[name] = check(name, a, (ny1, nx1))

    ptrs = (ctypes.c_void_p * len(_PLANES))(
        *[planes[n].data_ptr() if n in planes else None for n in _PLANES]
    )
    params = _params(ny, nx, steps, dte, dt, dx, dyn_type, p)
    lib = _library()
    fn = lib.nextsim_substeps_f32 if dtype == torch.float32 else lib.nextsim_substeps_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ptrs, ctypes.byref(params), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(
            f"substep_loop: CUDA launch failed: {lib.nextsim_cuda_error_string(err).decode()}"
        )
    launches += 2 * steps
    return tuple(planes[n] for n in _STATE)


def _params(ny, nx, steps, dte, dt, dx, dyn_type, p) -> _Params:
    """The kernel's scalars, computed in double as the plain version's
    Python floats are (each rounds to the plane dtype inside the kernel)."""
    bbm, evp = p.bbm, p.evp
    e = bbm.exponent_relaxation_sigma - 1.0
    integer = e == int(e) and 0 <= int(e) <= 8
    half = not integer and (2.0 * e) == int(2.0 * e) and 0 < e < 8
    if dyn_type == "evp":
        T = dt / 3.0
        ralpha1, ralpha2 = 0.5 * dte / T, 0.5 * dte / T * evp.e * evp.e
    else:
        ralpha1 = ralpha2 = 1.0 / p.mevp_alpha
    d0, d1, d2 = bbm.dunit
    return _Params(
        ny=ny, nx=nx, steps=steps, rheology=_RHEOLOGY[dyn_type],
        pow_n=int(e) if integer else (int(e - 0.5) if half else 0),
        pow_half=int(half), pow_generic=int(not (integer or half)), pad_=0,
        pow_e=e, r=1.0 / (2.0 * dx), dte=dte,
        min_c=bbm.min_c_rheology, lambda0=bbm.undamaged_time_relaxation_sigma,
        young=bbm.young, d0=d0, d1=d1, d2=d2,
        compr_strength=bbm.compr_strength, tan_phi=bbm.tan_phi,
        mult_cap=1.0 - 1e-12,
        re2=1.0 / (evp.e * evp.e), ralpha1=ralpha1, ralpha2=ralpha2,
        delta_min=evp.delta_min,
        cw=phys.rhow * p.quad_drag_coef_water, u0=p.u0, b_mevp=p.mevp_beta + 1.0,
    )


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_lib = None
#: what nvcc printed for the last build made by this process (-Xptxas=-v:
#: registers, shared memory and spills per kernel), "" if it was cached
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "substep_loop: nvcc not found (on PATH, or under $CUDA_HOME/bin); "
        "the CUDA kernel is built from csrc/momentum_substep.cu on first use"
    )


def build() -> Path:
    """Compile the kernel into ``nextsim_tpu_torch/build/`` unless a library
    built from the same source and flags is there; returns its path."""
    global build_log
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmomentum_substep_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    res = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    build_log = res.stdout + res.stderr
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("nextsim_substeps_f32", "nextsim_substeps_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.nextsim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nextsim_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
