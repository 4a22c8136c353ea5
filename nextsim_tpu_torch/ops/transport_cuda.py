"""Transport and ridging on the GPU: wrapper, gradient and loader of the
CUDA kernel in ``nextsim_tpu_torch/csrc/transport_ridge.cu``.

The JAX package computes transport as XLA-fused ``jnp``
(nextsim_tpu/ops/transport.py, advection.py); it has no Pallas kernel
there. The port's plain version, ``transport.transport_and_ridge_reference``,
is ~2,000 small elementwise kernels a call, each streaming one to three
planes through device memory. The kernel reads every input plane once and
writes every output plane once: one launch a call for the 27 tracers, the
divergence, ridging and the bounds, and one more for each stack of
floe-size bins.

* ``transport.transport_and_ridge`` sends a state on the card here:
  ``transport_and_ridge`` runs the kernel under ``torch.no_grad()``, or
  through ``TransportRidge`` (and ``AdvectStack`` for the bins) where a
  gradient is recorded for any plane it reads. It raises on what the kernel
  does not take (a dtype other than float32, float64 or bfloat16; planes of
  the wrong shape, dtype or device, or not contiguous; a grid spacing that is
  not a number; a device that is not CUDA) and on a failed build or launch.
  Nothing falls back to the plain version.
* What the plain version does besides, the wrapper does with the same torch
  operations: the SST/SSS diffusion when a diffusivity is set, and the
  floe-size bins' rescale (``fsd.update_fsd``) after their advection.
* A state's planes may carry leading axes (the batched ensemble's
  member-minor ``(N, ny, nx)``, its ``tice`` and ``sigma`` ``(3, N, ny,
  nx)``): they are more planes, the grid's ``mask`` and ``open_mask``
  ``(ny, nx)`` shared by all (a member stride of 0).
* ``TransportRidge`` / ``AdvectStack`` (``torch.autograd.Function``s): the
  kernel forward, and a backward that recomputes the plain version on the
  saved inputs under ``torch.enable_grad()`` and differentiates it, so a
  gradient through transport on the card is the plain version's.

The kernel is built with ``nvcc`` for sm_90a (``--fmad=false``) on first use
into ``nextsim_tpu_torch/build/`` (``momentum_cuda.compile_library``) and
loaded with ctypes. ``launches`` counts the kernels that the C launcher
reports it launched: ``LAUNCHES_A_CALL`` a call of the core, one more a
stack of bins.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from pathlib import Path

import torch

from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.ops import fsd, momentum_cuda, stencil, transport

#: kernel launches made by ``_launch``, as the C launcher reports them
launches = 0
#: kernel launches a ``transport_and_ridge`` call makes without floe-size bins
LAUNCHES_A_CALL = 1

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "transport_ridge.cu"
#: the entry points' suffix for each plane dtype
_ENTRY = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

#: the tracer planes in the kernel's order (the Plane enum): a State field,
#: or a component of a stacked one as ``field.k``
_PLANES = ("conc", "thick", "snow_thick", "h_young", "hs_young", "conc_young", "conc_myi", "thick_myi",
           "conc_summer", "thick_summer", "fyi_fraction", "conc_upd", "pond_volume", "lid_volume",
           "age_det", "age", "tice.0", "tice.1", "tice.2", "damage", "ridge_ratio", "tsurf_young", "sst", "sss",
           "sigma.0", "sigma.1", "sigma.2")
#: the State fields of the planes, in order
FIELDS = tuple(dict.fromkeys(name.split(".")[0] for name in _PLANES))
#: the fields only young ice changes; without it they are kept as they are
_YOUNG = ("h_young", "hs_young", "conc_young")
#: the diagnostics of a call
_DIAG = ("divergence", "del_ci_ridge_myi")


class _Geometry(ctypes.Structure):
    """Mirror of ``Geometry`` in the CUDA source."""

    _fields_ = [("vt_u", ctypes.c_void_p), ("vt_v", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("open_mask", ctypes.c_void_p), ("ny", ctypes.c_longlong), ("nx", ctypes.c_longlong),
                ("members", ctypes.c_longlong), ("dtdx", ctypes.c_double),
                ("second_order", ctypes.c_int), ("pad_", ctypes.c_int)]


class _Args(ctypes.Structure):
    """Mirror of ``TransportArgs`` in the CUDA source."""

    _fields_ = [("g", _Geometry), ("planes_in", ctypes.c_void_p * len(_PLANES)),
                ("planes_out", ctypes.c_void_p * len(_PLANES)), ("divergence", ctypes.c_void_p),
                ("del_ci_ridge_myi", ctypes.c_void_p)] + [(n, ctypes.c_double) for n in (
                    "dt", "dx", "min_h", "min_c", "mu_si_lf_c", "four_mu_si_lf_c", "tfr_ice",
                    "max_true_thickness", "ridge_young_aspect", "days_in_sec",
                )] + [("use_young_ice", ctypes.c_int), ("myi_with_young", ctypes.c_int)]


class _StackArgs(ctypes.Structure):
    """Mirror of ``StackArgs`` in the CUDA source."""

    _fields_ = [("g", _Geometry), ("q", ctypes.c_void_p), ("out", ctypes.c_void_p), ("planes", ctypes.c_longlong)]


def _number(name: str, v) -> float:
    if isinstance(v, torch.Tensor) or not isinstance(v, (int, float)):
        raise TypeError(f"transport_and_ridge: the CUDA kernel takes {name} as a number, not {type(v).__name__}")
    return float(v)


def _plane(src, name: str):
    """The plane ``name`` of ``_PLANES`` in a State or a dict of fields."""
    field, _, k = name.partition(".")
    t = src[field] if isinstance(src, dict) else getattr(src, field)
    return t[int(k)] if k else t


def _check(what: str, t, shape, like) -> None:
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape) or t.dtype != like.dtype \
            or t.device != like.device:
        got = (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"transport_and_ridge: {what} is {got}; the kernel needs {tuple(shape)} "
                         f"{like.dtype} on {like.device}")
    if not t.is_contiguous():
        raise ValueError(f"transport_and_ridge: {what} must be contiguous")


def _geometry(state, grid_arrays, dt: float, second_order: bool):
    """(the kernel's geometry, the plane shape (..., ny, nx)), the grid's
    planes and the velocities checked against ``state.conc``."""
    conc = state.conc
    if conc.dtype not in _ENTRY:
        raise TypeError(f"transport_and_ridge: the CUDA kernel takes float32, float64 or bfloat16, not {conc.dtype}")
    if conc.ndim < 2:
        raise ValueError(f"transport_and_ridge: a plane of {tuple(conc.shape)}")
    shape = tuple(conc.shape)
    lead, (ny, nx) = shape[:-2], shape[-2:]
    for name in ("vt_u", "vt_v"):
        _check(name, getattr(state, name), (*lead, ny + 1, nx + 1), conc)
    for name in ("mask", "open_mask"):
        _check(name, grid_arrays[name], (ny, nx), conc)
    dx = _number("delta_x", grid_arrays["delta_x"])
    dt = _number("dt", dt)
    g = _Geometry(ny=ny, nx=nx, members=math.prod(lead), dtdx=dt / dx, second_order=int(bool(second_order)), pad_=0)
    return g, shape, dx


def ridge(state, grid_arrays, dt: float, p) -> dict:
    """One call of the kernel: ``{field: new plane}`` for every field it
    changes (``tice`` and ``sigma`` as new stacks; without young ice
    ``h_young``, ``hs_young`` and ``conc_young`` are not among them), and
    the two diagnostics."""
    g, shape, dx = _geometry(state, grid_arrays, dt, p.second_order)
    young = bool(p.use_young_ice)
    for field in FIELDS:
        _check(field, getattr(state, field), (3, *shape) if field in ("tice", "sigma") else shape, state.conc)
    out = {f: torch.empty_like(getattr(state, f)) for f in FIELDS if young or f not in _YOUNG}
    for name in _DIAG:
        out[name] = torch.empty_like(state.conc)
    k = transport.scalars(p)
    args = _Args(g=g, dt=_number("dt", dt), dx=dx, min_h=_number("min_h", p.min_h), min_c=_number("min_c", p.min_c),
                 mu_si_lf_c=k["mu_si_lf_c"], four_mu_si_lf_c=4.0 * k["mu_si_lf_c"], tfr_ice=k["tfr_ice"],
                 max_true_thickness=_number("max_true_thickness", p.max_true_thickness),
                 ridge_young_aspect=_number("ridge_young_aspect", p.ridge_young_aspect),
                 days_in_sec=phys.days_in_sec, use_young_ice=int(young), myi_with_young=int(k["myi_with_young"]))
    ins = [_plane(state, n) for n in _PLANES] + [state.vt_u, state.vt_v, grid_arrays["mask"], grid_arrays["open_mask"]]
    outs = [_plane(out, n) if n.split(".")[0] in out else None for n in _PLANES] + [out[n] for n in _DIAG]
    _launch("transport", ins, outs, args)
    return out


def advect_stack(q, state, grid_arrays, dt: float, p):
    """The plain version's conservative advection of the stack ``q``
    ``(planes, ..., ny, nx)`` (the floe-size bins), kept where upd > 0.5:
    one launch, a new tensor."""
    g, shape, _ = _geometry(state, grid_arrays, dt, p.second_order)
    if q.ndim < 3:
        raise ValueError(f"transport_and_ridge: a stack of {tuple(q.shape)}")
    _check("the stack", q, (q.shape[0], *shape), state.conc)
    out = torch.empty_like(q)
    ins = [q, state.vt_u, state.vt_v, grid_arrays["mask"], grid_arrays["open_mask"]]
    _launch("advect_stack", ins, [out], _StackArgs(g=g, planes=q.shape[0]))
    return out


def _pointer(t) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(entry: str, ins, outs, args) -> None:
    """The kernel ``entry`` on the current stream of the planes' device:
    ``ins`` and ``outs`` are the tensors in the C interface's order (for
    ``transport``: the planes, then vt_u, vt_v, mask, open_mask, and the
    planes, then the two diagnostics; for ``advect_stack``: the stack, vt_u,
    vt_v, mask, open_mask, and the new stack), put into ``args``. Counts the
    kernels the launcher reports it launched; raises on a device that is
    not CUDA and on a failed build or launch."""
    global launches
    device = ins[0].device
    if device.type != "cuda":
        raise ValueError(f"transport_and_ridge: no kernel for device {device}")
    *planes, vt_u, vt_v, mask, open_mask = ins
    args.g.vt_u, args.g.vt_v, args.g.mask, args.g.open_mask = map(_pointer, (vt_u, vt_v, mask, open_mask))
    if entry == "transport":
        args.planes_in[:] = [_pointer(t) for t in planes]
        args.planes_out[:] = [_pointer(t) for t in outs[:len(_PLANES)]]
        args.divergence, args.del_ci_ridge_myi = map(_pointer, outs[len(_PLANES):])
    else:
        (args.q,), (args.out,) = map(_pointer, planes), map(_pointer, outs)
    lib = _library()
    fn = getattr(lib, f"nextsim_{entry}_{_ENTRY[ins[0].dtype]}")
    kernels = ctypes.c_int(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(args), ctypes.c_void_p(stream), ctypes.byref(kernels))
    launches += kernels.value
    if err:
        raise RuntimeError(f"transport_and_ridge: CUDA launch failed: {lib.nextsim_transport_error_string(err).decode()}")


# ---------------------------------------------------------------------------
# The call, and its reverse mode
# ---------------------------------------------------------------------------

def _inputs(state, grid_arrays) -> list:
    """What the kernel reads that a gradient may flow to."""
    return [getattr(state, f) for f in FIELDS] + [state.vt_u, state.vt_v, grid_arrays["mask"], grid_arrays["open_mask"]]


def _with_inputs(state, grid_arrays, xs):
    """``(state, grid_arrays)`` with the planes of ``_inputs`` replaced by ``xs``."""
    n = len(FIELDS)
    state = state.replace(**dict(zip(FIELDS, xs[:n])), vt_u=xs[n], vt_v=xs[n + 1], conc_fsd=None, conc_mech_fsd=None)
    return state, dict(grid_arrays, mask=xs[n + 2], open_mask=xs[n + 3])


def _keys(p) -> list:
    """The fields a call gives anew, then its diagnostics."""
    return [f for f in FIELDS if p.use_young_ice or f not in _YOUNG] + list(_DIAG)


def _core(p):
    """``p`` without the diffusion, which the wrapper applies after the kernel."""
    return dataclasses.replace(p, diffusivity_sst=0.0, diffusivity_sss=0.0)


class TransportRidge(torch.autograd.Function):
    """``ridge`` with a recomputed backward: the kernel forward; backward,
    ``transport.transport_and_ridge_reference`` (without the diffusion and
    the bins, which the wrapper does outside) rebuilt from the saved inputs
    under ``torch.enable_grad()`` and differentiated with respect to them."""

    @staticmethod
    def forward(ctx, state, grid_arrays, dt, p, *xs):
        ctx.args = (state, grid_arrays, dt, p)
        ctx.save_for_backward(*xs)
        s, ga = _with_inputs(state, grid_arrays, xs)
        out = ridge(s, ga, dt, p)
        return tuple(out[k] for k in _keys(p))

    @staticmethod
    def backward(ctx, *grads):
        state, grid_arrays, dt, p = ctx.args
        xs = [x.detach().requires_grad_(need) for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[4:])]
        with torch.enable_grad():
            s, ga = _with_inputs(state, grid_arrays, xs)
            new, diag = transport.transport_and_ridge_reference(s, ga, dt, _core(p))
            outs = [diag[k] if k in diag else getattr(new, k) for k in _keys(p)]
        return (None,) * 4 + _grads(outs, grads, xs)


def _grads(outs, grads, xs) -> tuple:
    """The gradient of ``outs`` (weighted by ``grads``) with respect to each
    of ``xs`` that requires one, None for the others."""
    pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    wrt = [x for x in xs if x.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True)
               if pairs and wrt else [None] * len(wrt))
    return tuple(next(got) if x.requires_grad else None for x in xs)


class AdvectStack(torch.autograd.Function):
    """``advect_stack`` with a recomputed backward: the plain conservative
    advection of the stack, kept where upd > 0.5, differentiated."""

    @staticmethod
    def forward(ctx, q, state, grid_arrays, dt, p, vt_u, vt_v, mask, open_mask):
        ctx.args = (dt, p, grid_arrays["delta_x"])
        ctx.save_for_backward(q, vt_u, vt_v, mask, open_mask)
        s = state.replace(vt_u=vt_u, vt_v=vt_v)
        return advect_stack(q, s, dict(grid_arrays, mask=mask, open_mask=open_mask), dt, p)

    @staticmethod
    def backward(ctx, grad):
        dt, p, dx = ctx.args
        need = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[5:]
        xs = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = transport.advect_stack_reference(*xs, dt, dx, p.second_order)
        g = _grads([out], [grad], xs)
        return (g[0], None, None, None, None) + g[1:]


def transport_and_ridge(state, grid_arrays, dt: float, p):
    """``transport.transport_and_ridge`` by the kernel: (state, diag), the
    plain version's. Through ``TransportRidge`` and ``AdvectStack`` where a
    gradient is recorded for any plane the kernel reads, else under
    ``torch.no_grad()``."""
    xs = _inputs(state, grid_arrays)
    bins = [n for n in ("conc_fsd", "conc_mech_fsd") if getattr(state, n) is not None]
    recorded = torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs + [getattr(state, n) for n in bins])
    if recorded:
        out = dict(zip(_keys(p), TransportRidge.apply(state, grid_arrays, dt, p, *xs)))
    else:
        with torch.no_grad():
            out = ridge(state, grid_arrays, dt, p)
    diag = {n: out.pop(n) for n in _DIAG}
    for name, d in (("sst", p.diffusivity_sst), ("sss", p.diffusivity_sss)):
        if d > 0.0:
            lap = stencil.laplacian_cells(out[name], grid_arrays["mask"], grid_arrays["delta_x"])
            out[name] = out[name] + dt * d * lap
    if bins:
        ctot_new = out["conc"] + out["conc_young"] if p.use_young_ice else out["conc"]
        for name in bins:
            q = getattr(state, name)
            if recorded:
                q = AdvectStack.apply(q, state, grid_arrays, dt, p, state.vt_u, state.vt_v, grid_arrays["mask"],
                                      grid_arrays["open_mask"])
            else:
                with torch.no_grad():
                    q = advect_stack(q, state, grid_arrays, dt, p)
            out[name] = fsd.update_fsd(q, ctot_new)
    return state.replace(**out), diag


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_lib = None
#: what nvcc printed for the last build made by this process (-Xptxas=-v:
#: registers, shared memory and spills per kernel), "" if it was cached
build_log = ""


def build(flags=momentum_cuda._NVCC_FLAGS) -> Path:
    """Compile the kernel into ``nextsim_tpu_torch/build/`` unless a library
    built from the same source and flags is there; returns its path."""
    global build_log
    out, log = momentum_cuda.compile_library(_SRC, "libtransport_ridge", flags)
    if log is not None:
        build_log = log
    return out


def load(path: Path):
    """The built library at ``path`` with its functions' argument types."""
    lib = ctypes.CDLL(str(path))
    for entry, args in (("transport", _Args), ("advect_stack", _StackArgs)):
        for suffix in _ENTRY.values():
            fn = getattr(lib, f"nextsim_{entry}_{suffix}")
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
    lib.nextsim_transport_error_string.argtypes = [ctypes.c_int]
    lib.nextsim_transport_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib
