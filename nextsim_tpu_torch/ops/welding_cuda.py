"""Roach welding on the GPU: wrapper, plan table, gradient and loader of the
CUDA kernel in ``nextsim_tpu_torch/csrc/welding_roach.cu``.

The JAX package computes the welding of the floe size distribution as
XLA-fused ``jnp`` (nextsim_tpu/ops/fsd.py ``welding_roach``: a ``fori_loop``
of 256 masked substeps over every cell); it has no Pallas kernel there. The
port's plain version, ``fsd.welding_roach_reference``, gathers the active
cells and loops to their largest count, which reads back twice a call and
launches ~150 kernels a substep; copied as the JAX package writes it, it
would put ~39,000 kernels into every step. The kernel runs one thread a
cell, each to its own count, in one launch that reads nothing back, so a
step with welding can be captured in a CUDA graph, and a batched ensemble's
member-minor stack ``(nbins, N, ny, nx)`` is just more cells.

* ``fsd.welding_roach`` sends a stack on the card here: ``welding_roach``
  runs the kernel under ``torch.no_grad()``, or through ``WeldingRoach``
  where a gradient is recorded. It raises on what the kernel does not take
  (a dtype other than float32, float64 or bfloat16; planes of the wrong
  shape, dtype or device, or not contiguous; a device that is not CUDA) and
  on a failed build or launch. Nothing falls back to the plain version.
* ``WeldingRoach`` (a ``torch.autograd.Function``): the kernel forward, and
  a backward that recomputes ``fsd.welding_roach_reference`` on the saved
  input under ``torch.enable_grad()`` and differentiates it. The JAX
  ``fori_loop`` is differentiable, and a kernel launched through ctypes is
  invisible to autograd (ROADMAP C.3), so the step stays differentiable.
* The bins' plan (``fsd.welding_pairs``: every pair's merge bin, width,
  offset and valid flag, then the bin centres) is uploaded once per bins,
  dtype and device (``_plan``), so a captured call copies nothing from the
  host.
* ``ctot`` and ``c_broken`` stay torch reductions here, so the kernel sees
  the sums the plain version forms.

The kernel is built with ``nvcc`` for sm_90a (``--fmad=false``) on first use,
one library per bin count (``-DWELDING_NBINS``, up to 32 bins: the build
for more fails, naming the shared memory), into
``nextsim_tpu_torch/build/`` (``momentum_cuda.compile_library``), and loaded
with ctypes. ``launches`` counts the kernel's launches: one a call.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from nextsim_tpu_torch.ops import momentum_cuda

#: kernel launches made by ``_launch`` (one a ``welding_roach`` call)
launches = 0

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "welding_roach.cu"
#: the kernel's entry point for each plane dtype
_ENTRY = {torch.float32: "nextsim_welding_f32", torch.float64: "nextsim_welding_f64",
          torch.bfloat16: "nextsim_welding_bf16"}


class _Scalars(ctypes.Structure):
    """Mirror of ``WeldScalars`` in the CUDA source."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "dt_kappa", "scaled_up", "dt", "kappa", "broken_min", "total_min", "ndt_max",
    )] + [("cells", ctypes.c_longlong), ("nbins", ctypes.c_int), ("pad_", ctypes.c_int)]


def _scalars(dt: float, p, bins, cells: int) -> _Scalars:
    """The kernel's scalars, as the plain version's Python floats are."""
    from nextsim_tpu_torch.ops import fsd

    return _Scalars(dt_kappa=dt * p.welding_kappa, scaled_up=float(bins.scaled_up[-1]), dt=dt,
                    kappa=p.welding_kappa, broken_min=fsd.WELDING_BROKEN_MIN, total_min=fsd.WELDING_TOTAL_MIN,
                    ndt_max=float(fsd.WELDING_NDT_MAX), cells=cells, nbins=p.num_bins, pad_=0)


#: device copies of the bins' plan, made once: (bins, merge, table) by
#: (id(bins), nbins, dtype, device)
_PLANS = {}


def _plan(bins, n: int, dtype, device):
    """(merge bins (int32), table (dtype): the pairs' widths, offsets and
    valid flags, then the bin centres) on ``device``, uploaded at the first
    call for these bins."""
    from nextsim_tpu_torch.ops.fsd import welding_pairs

    key = (id(bins), n, dtype, str(device))
    hit = _PLANS.get(key)
    if hit is None or hit[0] is not bins:
        merge, width, off, valid = welding_pairs(bins, n)
        table = torch.as_tensor(width + off + valid + [float(v) for v in bins.scaled_centre[:n]],
                                dtype=dtype, device=device)
        hit = _PLANS[key] = (bins, torch.as_tensor(merge, dtype=torch.int32, device=device), table)
    return hit[1], hit[2]


def welding_roach(conc_fsd, dt: float, p, bins, freezing):
    """Roach welding of ``conc_fsd`` (nbins, ...) by the kernel: through
    ``WeldingRoach`` when a gradient is recorded for the stack, else under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and conc_fsd.requires_grad:
        return welding_roach_recorded(conc_fsd, dt, p, bins, freezing)
    with torch.no_grad():
        return weld(conc_fsd, dt, p, bins, freezing)


def weld(conc_fsd, dt: float, p, bins, freezing):
    """One launch of the kernel: the welded stack, a new tensor. The
    caller's sums of the bins (``ctot``, ``c_broken``) are taken here with
    torch, as the plain version takes them."""
    n = p.num_bins
    dtype = conc_fsd.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"welding_roach: the CUDA kernel takes float32, float64 or bfloat16, not {dtype}")
    if conc_fsd.ndim < 2 or conc_fsd.shape[0] != n:
        raise ValueError(f"welding_roach: a stack of {tuple(conc_fsd.shape)} for {n} bins")
    cells = tuple(conc_fsd.shape[1:])
    if tuple(freezing.shape) != cells or freezing.dtype != torch.bool or freezing.device != conc_fsd.device:
        raise ValueError(f"welding_roach: the freezing mask is {tuple(freezing.shape)} {freezing.dtype} on "
                         f"{freezing.device}; the kernel needs {cells} torch.bool on {conc_fsd.device}")
    if not (conc_fsd.is_contiguous() and freezing.is_contiguous()):
        raise ValueError("welding_roach: the stack and the freezing mask must be contiguous")
    ctot = conc_fsd.sum(dim=0)
    c_broken = conc_fsd[:-1].sum(dim=0)
    merge, table = _plan(bins, n, dtype, conc_fsd.device)
    out = torch.empty_like(conc_fsd)
    _launch(conc_fsd, out, ctot, c_broken, freezing, merge, table, _scalars(dt, p, bins, ctot.numel()))
    return out


def _launch(conc_fsd, out, ctot, c_broken, freezing, merge, table, scalars: _Scalars) -> None:
    """The kernel on the current stream of the stack's device; counts the
    launch; raises on a device that is not CUDA and on a failed build or
    launch."""
    global launches
    if conc_fsd.device.type != "cuda":
        raise ValueError(f"welding_roach: no kernel for device {conc_fsd.device}")
    lib = _library(scalars.nbins)
    fn = getattr(lib, _ENTRY[conc_fsd.dtype])
    with torch.cuda.device(conc_fsd.device):
        stream = torch.cuda.current_stream(conc_fsd.device).cuda_stream
        err = fn(conc_fsd.data_ptr(), out.data_ptr(), ctot.data_ptr(), c_broken.data_ptr(),
                 freezing.data_ptr(), merge.data_ptr(), table.data_ptr(), ctypes.byref(scalars),
                 ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"welding_roach: CUDA launch failed: {lib.nextsim_welding_error_string(err).decode()}")
    launches += 1


# ---------------------------------------------------------------------------
# Reverse mode
# ---------------------------------------------------------------------------

class WeldingRoach(torch.autograd.Function):
    """Roach welding with a recomputed backward: the kernel (``weld``)
    forward; backward, ``fsd.welding_roach_reference`` rebuilt from the
    saved input under ``torch.enable_grad()`` and differentiated with
    respect to it. The freezing mask gets no gradient."""

    @staticmethod
    def forward(ctx, conc_fsd, freezing, dt, p, bins):
        ctx.args = (dt, p, bins)
        ctx.save_for_backward(conc_fsd, freezing)
        return weld(conc_fsd, dt, p, bins, freezing)

    @staticmethod
    def backward(ctx, grad):
        from nextsim_tpu_torch.ops.fsd import welding_roach_reference

        dt, p, bins = ctx.args
        conc_fsd, freezing = ctx.saved_tensors
        x = conc_fsd.detach().requires_grad_(True)
        with torch.enable_grad():
            out = welding_roach_reference(x, dt, p, bins, freezing)
        (g,) = torch.autograd.grad(out, x, grad)
        return g, None, None, None, None


def welding_roach_recorded(conc_fsd, dt: float, p, bins, freezing):
    """Roach welding through ``WeldingRoach``: the kernel forward, the
    gradient flowing to ``conc_fsd``."""
    return WeldingRoach.apply(conc_fsd, freezing, dt, p, bins)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

#: the loaded library of each bin count
_libs = {}
#: what nvcc printed for the last build made by this process (-Xptxas=-v:
#: registers, shared memory and spills), "" if it was cached
build_log = ""


def build(nbins: int, flags=momentum_cuda._NVCC_FLAGS) -> Path:
    """Compile the kernel for ``nbins`` bins into ``nextsim_tpu_torch/build/``
    unless a library built from the same source and flags is there; returns
    its path."""
    global build_log
    out, log = momentum_cuda.compile_library(_SRC, "libwelding_roach", (*flags, f"-DWELDING_NBINS={int(nbins)}"))
    if log is not None:
        build_log = log
    return out


def load(path: Path):
    """The built library at ``path`` with its functions' argument types."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.POINTER(_Scalars), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.nextsim_welding_nbins.argtypes = []
    lib.nextsim_welding_nbins.restype = ctypes.c_int
    lib.nextsim_welding_error_string.argtypes = [ctypes.c_int]
    lib.nextsim_welding_error_string.restype = ctypes.c_char_p
    return lib


def _library(nbins: int):
    lib = _libs.get(nbins)
    if lib is None:
        lib = load(build(nbins))
        if lib.nextsim_welding_nbins() != nbins:
            raise RuntimeError(f"welding_roach: the library built for {nbins} bins takes "
                               f"{lib.nextsim_welding_nbins()}")
        _libs[nbins] = lib
    return lib
