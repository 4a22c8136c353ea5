"""Roach welding on the GPU: wrapper, plan, gradient and loader of the CUDA
kernel in ``nextsim_tpu_torch/csrc/welding_roach.cu``.

The JAX package computes the welding of the floe size distribution as
XLA-fused ``jnp`` (nextsim_tpu/ops/fsd.py ``welding_roach``: a ``fori_loop``
of 256 masked substeps over every cell); it has no Pallas kernel there. The
port's plain version, ``fsd.welding_roach_reference``, gathers the active
cells and loops to their largest count, which reads back twice a call and
launches ~150 kernels a substep; copied as the JAX package writes it, it
would put ~39,000 kernels into every step. The kernel reads nothing back:
a memset and two launches a call on the stream (pass 1 copies the inactive
cells and lists the active ones on the device, pass 2 welds the listed
cells packed into full warps, each to its own count), so a step with
welding can be captured in a CUDA graph, and a batched ensemble's
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
* The bins' plan (``fsd.welding_pairs``) is compiled into the kernel:
  every pair's merge bin and valid flag go to ``nvcc`` as -D strings
  (``plan_defines``), so each plan builds its own library. The values --
  the widths of the merge bins, the offsets of the pairs and the bin
  centres, ``torch.as_tensor`` of them in the plane dtype -- are a host
  table (``_plan``) copied into the launch's parameters, so a captured
  call copies nothing from the host.
* ``ctot`` and ``c_broken`` stay torch reductions here, so the kernel sees
  the sums the plain version forms; the active cells' list and its count
  are one int32 scratch tensor.

The kernel is built with ``nvcc`` for sm_90a (``--fmad=false``) on first use,
one library per plan (up to 32 bins), into ``nextsim_tpu_torch/build/``
(``momentum_cuda.compile_library``: the file's tag hashes the source and
the flags, the plan's among them), and loaded with ctypes. ``launches``
counts the kernels that the C launcher reports it launched:
``LAUNCHES_A_CALL`` (two) a call on a stack of cells, none on an empty one.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from nextsim_tpu_torch.ops import momentum_cuda

#: kernel launches made by ``_launch``, as the C launcher reports them
launches = 0
#: kernel launches a ``welding_roach`` call on a stack of cells makes: pass 1 and pass 2
LAUNCHES_A_CALL = 2

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


#: the bins' plan of each (bins, nbins): (bins, -D flags, {dtype: host table})
_PLANS = {}


def plan_defines(bins, n: int) -> tuple:
    """The -D flags that compile the plan of ``n`` bins into the kernel:
    the bin count, and every pair's merge bin (two digits) and valid flag
    (0 or 1), in ``fsd.welding_pairs``' order, each list one token (``m``
    or ``v`` and its digits: nvcc reads a comma in a -D value as the start
    of another definition)."""
    from nextsim_tpu_torch.ops.fsd import welding_pairs

    merge, _, _, valid = welding_pairs(bins, n)
    return (f"-DWELDING_NBINS={int(n)}", "-DWELDING_MERGE=m" + "".join(f"{a:02d}" for a in merge),
            "-DWELDING_VALID=v" + "".join("1" if ok else "0" for ok in valid))


def _plan(bins, n: int, dtype):
    """(the plan's -D flags, its host table in ``dtype``): the widths of
    merge bins 1..n (a pair's width is its merge bin's; 0 for a bin into
    which no pair merges), every pair's offset, then the bin centres, each
    ``torch.as_tensor`` of ``fsd.welding_pairs``' values, as the plain
    version makes its columns. Made once for these bins and dtype."""
    from nextsim_tpu_torch.ops.fsd import welding_pairs

    key = (id(bins), n)
    hit = _PLANS.get(key)
    if hit is None or hit[0] is not bins:
        hit = _PLANS[key] = (bins, plan_defines(bins, n), {})
    tables = hit[2]
    if dtype not in tables:
        merge, width, off, _ = welding_pairs(bins, n)
        by_bin = [0.0] * n
        for a, w in zip(merge, width):
            by_bin[a - 1] = w
        tables[dtype] = torch.as_tensor(by_bin + off + [float(v) for v in bins.scaled_centre[:n]], dtype=dtype)
    return hit[1], tables[dtype]


def welding_roach(conc_fsd, dt: float, p, bins, freezing):
    """Roach welding of ``conc_fsd`` (nbins, ...) by the kernel: through
    ``WeldingRoach`` when a gradient is recorded for the stack, else under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and conc_fsd.requires_grad:
        return welding_roach_recorded(conc_fsd, dt, p, bins, freezing)
    with torch.no_grad():
        return weld(conc_fsd, dt, p, bins, freezing)


def weld(conc_fsd, dt: float, p, bins, freezing):
    """One call of the kernel (``_launch``): the welded stack, a new
    tensor. The caller's sums of the bins (``ctot``, ``c_broken``) are
    taken here with torch, as the plain version takes them."""
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
    out = torch.empty_like(conc_fsd)
    defines, table = _plan(bins, n, dtype)
    work = torch.empty(ctot.numel() + 1, dtype=torch.int32, device=conc_fsd.device)
    _launch(conc_fsd, out, ctot, c_broken, freezing, work, defines, table, _scalars(dt, p, bins, ctot.numel()))
    return out


def _launch(conc_fsd, out, ctot, c_broken, freezing, work, defines, table, scalars: _Scalars) -> None:
    """The memset and both kernels on the current stream of the stack's
    device (``work``: the count, then the list of active cells; ``table``:
    the plan's values on the host); counts the kernels the launcher reports
    it launched; raises on a device that is not CUDA and on a failed build
    or launch."""
    global launches
    if conc_fsd.device.type != "cuda":
        raise ValueError(f"welding_roach: no kernel for device {conc_fsd.device}")
    lib = _library(defines)
    fn = getattr(lib, _ENTRY[conc_fsd.dtype])
    kernels = ctypes.c_int(0)
    with torch.cuda.device(conc_fsd.device):
        stream = torch.cuda.current_stream(conc_fsd.device).cuda_stream
        err = fn(conc_fsd.data_ptr(), out.data_ptr(), ctot.data_ptr(), c_broken.data_ptr(),
                 freezing.data_ptr(), work.data_ptr(), table.data_ptr(), ctypes.byref(scalars),
                 ctypes.c_void_p(stream), ctypes.byref(kernels))
    launches += kernels.value
    if err:
        raise RuntimeError(f"welding_roach: CUDA launch failed: {lib.nextsim_welding_error_string(err).decode()}")


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

#: the loaded library of each plan, by its -D flags
_libs = {}
#: what nvcc printed for the last build made by this process (-Xptxas=-v:
#: registers, stack frame, spills), "" if it was cached
build_log = ""


def build(defines, flags=momentum_cuda._NVCC_FLAGS) -> Path:
    """Compile the kernel for the plan ``defines`` (``plan_defines``) into
    ``nextsim_tpu_torch/build/`` unless a library built from the same
    source and flags is there; returns its path."""
    global build_log
    out, log = momentum_cuda.compile_library(_SRC, "libwelding_roach", (*flags, *defines))
    if log is not None:
        build_log = log
    return out


def load(path: Path):
    """The built library at ``path`` with its functions' argument types."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.POINTER(_Scalars), ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.nextsim_welding_nbins.argtypes = []
    lib.nextsim_welding_nbins.restype = ctypes.c_int
    lib.nextsim_welding_error_string.argtypes = [ctypes.c_int]
    lib.nextsim_welding_error_string.restype = ctypes.c_char_p
    return lib


def _library(defines):
    lib = _libs.get(defines)
    if lib is None:
        lib = _libs[defines] = load(build(defines))
    return lib
