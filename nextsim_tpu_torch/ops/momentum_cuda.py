"""The momentum substep loop on the GPU: wrapper, launch plan, plain versions
and loader of the CUDA kernel in ``nextsim_tpu_torch/csrc/momentum_substep.cu``.

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
  than float32, float64 or bfloat16, on a plane of the wrong shape, dtype or device, or
  not contiguous, on a plan that does not fit the shared memory, and on a
  failed build or launch. Nothing falls back to the plain version on the
  card.
* A loop on the card whose gradient is recorded goes through
  ``SubstepLoop``, a ``torch.autograd.Function``: the kernel forward, one
  launch a segment with the carry kept at each launch boundary, and a
  backward that recomputes one segment at a time with the plain body and
  differentiates it (``substep_loop_checkpointed``). The JAX package has no
  custom gradient here: ``jax.grad`` differentiates its XLA loop over the
  same body. Any other loop on the card runs under ``torch.no_grad()``: the
  kernel writes planes behind autograd's back, which must never reach a
  graph.

The kernel is temporally blocked: one launch advances every tile of the
grid by ``k`` substeps in shared memory, on the tile plus a halo of ``k``
points, reading one set of the 8 state planes and writing a second one
(ping-pong), so a loop is ``ceil(steps / k)`` launches. ``launch_plan``
computes the tile, ``k``, the grid of blocks, the shared-memory bytes and
the launches' substep counts; the kernel holds no second copy of that
arithmetic. ``substep_loop_blocked_reference`` follows the same plan tile
by tile in plain PyTorch: it pins the schedule (halo width, domain edges,
ragged tiles, the remainder launch, the ping-pong) on the CPU.

Members (the batched ensemble step, the counterpart of ``jax.vmap`` over the
Pallas call): a carry of planes ``(N, ny+1, nx+1)`` and ``(N, ny, nx)`` is N
members' loops, run as one loop of launches whose grid holds the tiles of
every member (``blockIdx.z``), so a loop is ``ceil(steps / k)`` launches
whatever N is. A loop-invariant plane is ``(N, ...)`` when it is the
member's own, or 2-D when all members share it (the grid's, a forcing field
that no member perturbs): the kernel reads it with a member stride of 0.
``launch_plan(..., members=N)`` counts the rounds of ``sms`` blocks over N x
the tiles. Inside a member nothing changes, so member m of a batched loop
equals the loop of member m alone bitwise, and the plain versions take the
leading member axis as it is. ``SubstepLoop`` (the gradient) takes one
member: a batched loop whose gradient is recorded raises ValueError.

A bfloat16 carry runs the kernel's bfloat16 build (``nextsim_substeps_bf16``):
bfloat16 planes and records (``record_len``: an odd number of 4-byte words
of 2-byte values), the arithmetic of the plain loop on bfloat16 tensors, one
rounding to bfloat16 a torch op and float32 scalars, so it equals the plain
bfloat16 loop bitwise; its plan counts 2-byte items. Nothing is upcast for a
launch.

The kernel is built with ``nvcc`` for sm_90a on first use, into
``nextsim_tpu_torch/build/`` (named by a hash of the source and flags), and
loaded with ctypes. ``launches`` counts the kernel launches the wrapper has
made: ``len(plan.launches)`` a loop (``launches_for``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

from nextsim_tpu_torch.core import constants as phys

#: kernel launches made by ``substep_loop`` (``launches_for`` a loop)
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
#: state planes each rheology updates; the others pass through the loop
_STATE_USED = {
    "bbm": _STATE,
    "evp": _STATE[:7],
    "mevp": ("vt_u", "vt_v", "sxx", "syy", "sxy"),
}
_RHEOLOGY = {"bbm": 0, "evp": 1, "mevp": 2}

#: dynamic shared memory one block may use on an H100 (sm_90: 227 KB)
SMEM_LIMIT = 232_448
#: streaming multiprocessors of an H100 SXM; the wrapper passes the device's own
H100_SMS = 132
#: threads a block may have: 1024 leave 64 registers a thread, which float64
#: arithmetic (two registers a value) would spill; bfloat16 computes in float
_MAX_THREADS = {torch.float32: 1024, torch.float64: 512, torch.bfloat16: 1024}
#: the kernel's entry point for each plane dtype
_ENTRY = {torch.float32: "nextsim_substeps_f32", torch.float64: "nextsim_substeps_f64",
          torch.bfloat16: "nextsim_substeps_bf16"}
#: most substeps a launch that ``launch_plan`` considers
_MAX_K = 8
#: most members a launch takes (the grid's z extent)
MAX_MEMBERS = 65535

# The cost model behind the default plan, in SM clocks, fitted to the
# kernel's own clock counters on an H100 (``python3 -m
# nextsim_tpu_torch.tools.tune_substep --clocks``; PERF.md has the
# readings). A block takes the time to load its box and to store its tile
# (device memory, all blocks at once), plus the time of every cell and node
# update of its shrinking regions; a launch takes one block's time for every
# round of ``sms`` blocks, plus the gap between dependent launches.
_CLK_PER_BYTE = 0.08     # load and store, per byte of a plane's box or tile
_CLK_PER_UPDATE = 3.0    # one cell or node update, bbm float32
_CLK_PER_STAGE = 1200.0  # least time of a stage: one pass of its dependent instructions
_CLK_PER_BLOCK = 1000.0  # start and drain of a block
_CLK_PER_LAUNCH = 6000.0
#: arithmetic of a cell + node update relative to bbm (97 + 94 operations)
_UPDATE_WEIGHT = {"bbm": 1.0, "evp": (51 + 94) / (97 + 94), "mevp": (51 + 94) / (97 + 94)}
_F64_UPDATE_WEIGHT = 2.2


def record_len(n_planes: int, itemsize: int) -> int:
    """Values in one shared-memory record of the kernel (``kRecord`` in the
    CUDA source): an odd number of 4-byte words, so that neighbouring
    threads fall into different banks: ``n_planes | 1`` values of 4 or 8
    bytes; for 2-byte values an even count whose half is odd."""
    if itemsize == 2:
        return ((n_planes + 1) // 2 | 1) * 2
    return n_planes | 1


def tile_planes(dyn_type: str) -> tuple:
    """Names of the planes the kernel keeps on a tile, in ``_PLANES`` order
    (``plane_used`` in the CUDA source)."""
    used = set(_STATE_USED[dyn_type]) | set(_CELL_USED[dyn_type]) | set(_NODE_USED)
    if dyn_type == "mevp":
        used |= {"vtm_u", "vtm_v"}
    return tuple(n for n in _PLANES if n in used)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one substep loop runs on the card: every block owns a tile of
    ``tile_h`` x ``tile_w`` nodes (and the cells of the same indices), loads
    it with a halo of ``k`` points and advances it ``launches[g]`` substeps
    in launch ``g``."""

    ny: int
    nx: int
    steps: int
    itemsize: int
    dyn_type: str
    tile_h: int
    tile_w: int
    k: int
    threads: int
    blocks_y: int
    blocks_x: int
    n_planes: int
    smem_bytes: int
    launches: tuple
    members: int = 1

    def tiles(self):
        """The tiles of one member as (j0, j1, i0, i1): nodes [j0, j1) x
        [i0, i1); a launch runs them for every member."""
        for by in range(self.blocks_y):
            for bx in range(self.blocks_x):
                j0, i0 = by * self.tile_h, bx * self.tile_w
                yield (j0, min(j0 + self.tile_h, self.ny + 1),
                       i0, min(i0 + self.tile_w, self.nx + 1))


def _best_tile(ny, nx, steps, itemsize, dyn_type, sms, smem_limit, heights, widths, ks, members=1):
    """(tile_h, tile_w, k) of least modelled time among the given candidates
    whose box fits ``smem_limit``, or None when none fits; the blocks of a
    launch are ``members`` x the tiles."""
    import numpy as np

    th = np.asarray(heights)[:, None, None]
    tw = np.asarray(widths)[None, :, None]
    k = np.asarray(ks)[None, None, :]
    n_planes = len(tile_planes(dyn_type))
    box = (th + 2 * k) * (tw + 2 * k)
    fits = box * (record_len(n_planes, itemsize) * itemsize) <= smem_limit
    if not fits.any():
        return None
    # cell and node stages of substeps 1..k: the box shrunk by s (cells by
    # s - 1 on the low side)
    weight = _UPDATE_WEIGHT[dyn_type] * (_F64_UPDATE_WEIGHT if itemsize == 8 else 1.0)
    stages = np.zeros(box.shape)
    for s in range(1, int(k.max()) + 1):
        cells = (th + 2 * k - 2 * s + 1) * (tw + 2 * k - 2 * s + 1)
        nodes = (th + 2 * k - 2 * s) * (tw + 2 * k - 2 * s)
        stages += (k >= s) * (np.maximum(_CLK_PER_UPDATE * weight * cells, _CLK_PER_STAGE)
                              + np.maximum(_CLK_PER_UPDATE * weight * nodes, _CLK_PER_STAGE))
    moved = box * n_planes + th * tw * len(_STATE_USED[dyn_type])
    block = _CLK_PER_BYTE * itemsize * moved + stages + _CLK_PER_BLOCK
    rounds = -(-(members * -(-(ny + 1) // th) * -(-(nx + 1) // tw)) // sms)
    launches = -(-max(steps, 1) // k)
    cost = np.where(fits, launches * (rounds * block + _CLK_PER_LAUNCH), np.inf)
    i, j, m = np.unravel_index(int(np.argmin(cost)), cost.shape)
    return int(th[i, 0, 0]), int(tw[0, j, 0]), int(k[0, 0, m])


@functools.lru_cache(maxsize=256)
def launch_plan(ny: int, nx: int, steps: int, dtype, dyn_type: str, tile=None,
                k=None, threads=None, sms: int = H100_SMS,
                smem_limit: int = SMEM_LIMIT, members: int = 1) -> LaunchPlan:
    """The launch plan of a ``steps``-substep loop on cells ``(ny, nx)``, for
    ``members`` states at once (a launch's blocks are ``members`` x the
    tiles).

    What is not given -- the ``tile`` (height, width) in nodes, the substeps
    a launch ``k`` -- is chosen for the least time under the module's cost
    model on a card of ``sms`` multiprocessors: large tiles and many substeps
    a launch cut the halo's share and the launches, while the number of
    blocks has to fill whole rounds of ``sms``. A given tile is cut to the
    grid and a given ``k`` to ``steps``; a given tile then shrinks, its
    longer side first, until the box of ``(tile_h + 2k) * (tile_w + 2k)``
    points times the rheology's planes fits ``smem_limit`` bytes. Raises
    ValueError when not even a tile of one node fits.
    """
    if dyn_type not in _RHEOLOGY:
        raise ValueError(f"substep_loop: unknown rheology {dyn_type!r}")
    if dtype not in _MAX_THREADS:
        raise TypeError(f"substep_loop: the CUDA kernel takes float32, float64 or bfloat16, not {dtype}")
    if ny < 1 or nx < 1 or steps < 0 or sms < 1 or not 1 <= members <= MAX_MEMBERS:
        raise ValueError(f"substep_loop: no plan for a {ny} x {nx} grid, {steps} substeps and "
                         f"{members} members (1 to {MAX_MEMBERS})")
    threads = _MAX_THREADS[dtype] if threads is None else threads
    if not 1 <= threads <= _MAX_THREADS[dtype]:
        raise ValueError(f"substep_loop: {threads} threads a block is no plan "
                         f"(1 to {_MAX_THREADS[dtype]} for {dtype})")
    if tile is not None and min(tile) < 1:
        raise ValueError(f"substep_loop: a tile of {tile[0]} x {tile[1]} nodes is no plan")
    itemsize = torch.finfo(dtype).bits // 8
    n_planes = len(tile_planes(dyn_type))

    def smem(h, w, halo):
        # one record per point of the box: its planes' values and the
        # padding to an odd number of words (kRecord in the CUDA source)
        return (h + 2 * halo) * (w + 2 * halo) * record_len(n_planes, itemsize) * itemsize

    most_k = max(1, steps)
    heights = range(1, min(ny + 1, 128) + 1) if tile is None else [min(tile[0], ny + 1)]
    widths = range(1, min(nx + 1, 128) + 1) if tile is None else [min(tile[1], nx + 1)]
    ks = range(1, min(_MAX_K, most_k) + 1) if k is None else [max(1, min(k, most_k))]
    best = _best_tile(ny, nx, steps, itemsize, dyn_type, sms, smem_limit, heights, widths, ks, members)
    th, tw, k = best if best is not None else (heights[-1], widths[-1], ks[0])
    while smem(th, tw, k) > smem_limit and (th > 1 or tw > 1):
        if th >= tw:
            th -= 1
        else:
            tw -= 1
    if tile is None and best is None or smem(th, tw, k) > smem_limit:
        raise ValueError(
            f"substep_loop: {k} substeps a launch need {smem(1, 1, k)} bytes of shared memory for "
            f"a tile of one node ({n_planes} planes of {itemsize} bytes), above {smem_limit}"
        )
    return LaunchPlan(
        ny=ny, nx=nx, steps=steps, itemsize=itemsize, dyn_type=dyn_type,
        tile_h=th, tile_w=tw, k=k, threads=threads,
        blocks_y=-(-(ny + 1) // th), blocks_x=-(-(nx + 1) // tw),
        n_planes=n_planes, smem_bytes=smem(th, tw, k),
        launches=(k,) * (steps // k) + ((steps % k,) if steps % k else ()), members=members,
    )


def launches_for(steps: int, ny: int, nx: int, dtype=torch.float32, dyn_type: str = "bbm",
                 sms: int = H100_SMS, members: int = 1) -> int:
    """Kernel launches of one ``steps``-substep loop under the default plan
    (of ``members`` members' loops at once)."""
    return len(launch_plan(ny, nx, steps, dtype, dyn_type, sms=sms, members=members).launches)


class _Plan(ctypes.Structure):
    """Mirror of ``SubstepPlan`` in the CUDA source."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "tile_h", "tile_w", "halo", "threads", "blocks_y", "blocks_x", "n_planes",
        "smem_bytes", "n_launches", "members",
    )]


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


def _box(a: torch.Tensor, r0: int, r1: int, c0: int, c1: int) -> torch.Tensor:
    """``a[..., r0:r1, c0:c1]`` with zeros where the box leaves the plane."""
    out = a.new_zeros(a.shape[:-2] + (r1 - r0, c1 - c0))
    rs, re = max(r0, 0), min(r1, a.shape[-2])
    cs, ce = max(c0, 0), min(c1, a.shape[-1])
    if re > rs and ce > cs:
        out[..., rs - r0:re - r0, cs - c0:ce - c0] = a[..., rs:re, cs:ce]
    return out


def substep_loop_blocked_reference(consts, carry, steps: int, dte: float, dt: float,
                                   dx: float, dyn_type: str, p, plan: LaunchPlan = None):
    """The kernel's schedule in plain PyTorch: for every launch of ``plan``
    and every tile, cut the tile and its halo of ``k`` points out of every
    plane (zeros outside the domain), run the launch's substeps of
    ``momentum._build_substep`` on the cut, and copy the tile alone into the
    other set of state planes. A batched carry (a leading member axis) is
    cut alike, every member's tile at once. Equals
    ``substep_loop_reference`` bitwise; the tests use it, no model path
    does."""
    from nextsim_tpu_torch.ops import momentum

    carry = tuple(carry)
    ny1, nx1 = carry[0].shape[-2:]
    ny, nx = ny1 - 1, nx1 - 1
    members = _members(carry)
    if plan is None:
        plan = launch_plan(ny, nx, steps, carry[0].dtype, dyn_type, members=members)
    if (plan.ny, plan.nx, plan.steps, plan.dyn_type, plan.members) != (ny, nx, steps, dyn_type, members):
        raise ValueError("substep_loop_blocked_reference: the plan is for another loop")
    slots = [[c.clone() for c in carry], [torch.empty_like(c) for c in carry]]
    for g, k in enumerate(plan.launches):
        src, dst = slots[g % 2], slots[(g + 1) % 2]
        for j0, j1, i0, i1 in plan.tiles():
            # node box [j0-k, j1+k) x [i0-k, i1+k); its cells lack the last
            # row and column
            nbox = (j0 - k, j1 + k, i0 - k, i1 + k)
            cbox = (j0 - k, j1 + k - 1, i0 - k, i1 + k - 1)

            def cut(a):
                if not isinstance(a, torch.Tensor) or a.ndim < 2:
                    return a
                return _box(a, *(nbox if tuple(a.shape[-2:]) == (ny1, nx1) else cbox))

            tile_consts = SimpleNamespace(**{n: cut(v) for n, v in vars(consts).items()})
            body = momentum._build_substep(p, dyn_type, dte, dt, dx, tile_consts)
            tile = tuple(cut(a) for a in src)
            for _ in range(k):
                tile = body(tile)
            for name, out, t in zip(_STATE, dst, tile):
                if name.startswith(("vt", "ut")):
                    out[..., j0:j1, i0:i1] = t[..., k:k + j1 - j0, k:k + i1 - i0]
                else:
                    cj, ci = min(j1, ny), min(i1, nx)
                    out[..., j0:cj, i0:ci] = t[..., k:k + cj - j0, k:k + ci - i0]
    return tuple(slots[len(plan.launches) % 2])


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def substep_loop(consts, carry, steps: int, dte: float, dt: float, dx: float,
                 dyn_type: str, p):
    """Run the substep loop: the plain version for a carry on the CPU, the
    CUDA kernel for a carry on a CUDA device. On the card, a loop whose
    gradient is recorded (grad mode on, and a carry plane, a plane the body
    reads or a tensor scalar of ``p`` requires grad) goes through
    ``substep_loop_checkpointed``; any other runs under ``torch.no_grad()``
    and returns planes that no graph holds. A batched carry (a leading
    member axis) runs every member at once; its gradient is not taken
    (ValueError)."""
    device = carry[0].device
    if _members(carry) > 1 and torch.is_grad_enabled() and any(
            t.requires_grad for t in _grad_inputs(consts, carry, p)):
        raise ValueError("substep_loop: a batched loop (a member axis) whose gradient is recorded; "
                         "momentum_cuda.SubstepLoop takes one member: differentiate each member's "
                         "Simulator.raw_step_fn")
    if device.type == "cpu":
        return substep_loop_reference(consts, carry, steps, dte, dt, dx, dyn_type, p)
    if device.type != "cuda":
        raise ValueError(f"substep_loop: no kernel for device {device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in _grad_inputs(consts, carry, p)):
        return substep_loop_checkpointed(consts, carry, steps, dte, dt, dx, dyn_type, p)
    with torch.no_grad():
        return _substep_loop_cuda(consts, carry, steps, dte, dt, dx, dyn_type, p)


def _members(carry) -> int:
    """Members of a carry: N for planes (N, h, w), 1 for 2-D planes."""
    return carry[0].shape[0] if carry[0].ndim == 3 else 1


def _kernel_inputs(consts, carry, dyn_type):
    """The carry's planes and the loop-invariant planes the kernel reads,
    by name, checked, and every plane's member stride in values (0 for a
    2-D plane that the members share): (state, consts, strides). Raises on
    what the kernel does not take."""
    if dyn_type not in _RHEOLOGY:
        raise ValueError(f"substep_loop: unknown rheology {dyn_type!r}")
    dtype = carry[0].dtype
    if dtype not in _ENTRY:
        raise TypeError(f"substep_loop: the CUDA kernel takes float32, float64 or bfloat16, not {dtype}")
    device = carry[0].device
    if carry[0].ndim not in (2, 3):
        raise ValueError(f"substep_loop: a carry plane is {tuple(carry[0].shape)}: (ny+1, nx+1) planes, "
                         "or (N, ny+1, nx+1) for N members")
    ny1, nx1 = carry[0].shape[-2:]
    ny, nx = ny1 - 1, nx1 - 1
    batch = tuple(carry[0].shape[:-2])
    strides = {}

    def check(name, a, shape, shared=True):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"substep_loop: plane {name} is not a tensor")
        want = (batch + shape,) + ((shape,) if shared and batch else ())
        if tuple(a.shape) not in want or a.dtype != dtype or a.device != device:
            raise ValueError(
                f"substep_loop: plane {name} is {tuple(a.shape)} {a.dtype} on "
                f"{a.device}; the kernel needs {' or '.join(map(str, want))} {dtype} on {device}"
            )
        if not a.is_contiguous():
            raise ValueError(f"substep_loop: plane {name} is not contiguous")
        strides[name] = a.shape[-2] * a.shape[-1] if a.ndim == 3 else 0
        return a

    state = {name: check(name, a, (ny1, nx1) if name.startswith(("vt", "ut")) else (ny, nx), shared=False)
             for name, a in zip(_STATE, carry)}
    planes = {}
    for name in _CELL_USED[dyn_type]:
        planes[name] = check(name, getattr(consts, name), (ny, nx))
    node_names = _NODE_USED + (("vtm_u", "vtm_v") if dyn_type == "mevp" else ())
    for name in node_names:
        a = getattr(consts, name)
        if name == "solve" and isinstance(a, torch.Tensor) and a.dtype == torch.bool:
            a = a.to(dtype)  # the kernel tests solve > 0.5
        planes[name] = check(name, a, (ny1, nx1))
    return state, planes, strides


def _default_plan(carry, steps, dyn_type) -> LaunchPlan:
    """``launch_plan`` of this loop for the carry's device."""
    device = carry[0].device
    ny1, nx1 = carry[0].shape[-2:]
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    return launch_plan(ny1 - 1, nx1 - 1, steps, carry[0].dtype, dyn_type, sms=sms, members=_members(carry))


def _launch(planes, second, plan: LaunchPlan, launch_steps, dte, dt, dx, dyn_type, p, strides):
    """Run ``launch_steps`` launches of the kernel under ``plan``: launch g
    reads the state planes of ``planes`` (g even) or ``second`` (g odd) and
    writes the other set; ``strides`` are the planes' member strides.
    Counts the launches; raises on a failed launch."""
    global launches
    lib = _library()
    ptrs = (ctypes.c_void_p * len(_PLANES))(
        *[planes[n].data_ptr() if n in planes else None for n in _PLANES]
    )
    ptrs_b = (ctypes.c_void_p * len(_STATE))(
        *[second[n].data_ptr() if n in second else None for n in _STATE]
    )
    c_plan = _Plan(
        tile_h=plan.tile_h, tile_w=plan.tile_w, halo=plan.k, threads=plan.threads,
        blocks_y=plan.blocks_y, blocks_x=plan.blocks_x, n_planes=plan.n_planes,
        smem_bytes=plan.smem_bytes, n_launches=len(launch_steps), members=plan.members,
    )
    c_steps = (ctypes.c_int * len(launch_steps))(*launch_steps)
    c_strides = (ctypes.c_longlong * len(_PLANES))(*[strides.get(n, 0) for n in _PLANES])
    params = _params(plan.ny, plan.nx, plan.steps, dte, dt, dx, dyn_type, p)
    device = planes["vt_u"].device
    fn = getattr(lib, _ENTRY[planes["vt_u"].dtype])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ptrs, ptrs_b, ctypes.byref(params), ctypes.byref(c_plan), c_steps, c_strides,
                 ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(
            f"substep_loop: CUDA launch failed: {lib.nextsim_cuda_error_string(err).decode()}"
        )
    launches += len(launch_steps)


def _check_plan(plan: LaunchPlan, carry, steps, dyn_type):
    ny1, nx1 = carry[0].shape[-2:]
    if (plan.ny, plan.nx, plan.steps, plan.dyn_type, plan.itemsize, plan.members) != (
            ny1 - 1, nx1 - 1, steps, dyn_type, carry[0].element_size(), _members(carry)):
        raise ValueError("substep_loop: the plan is for another loop")


def _substep_loop_cuda(consts, carry, steps, dte, dt, dx, dyn_type, p, plan: LaunchPlan = None):
    state, planes, strides = _kernel_inputs(consts, carry, dyn_type)
    plan = _default_plan(carry, steps, dyn_type) if plan is None else plan
    _check_plan(plan, carry, steps, dyn_type)
    _library()
    # the launches alternate between two sets of state planes: the first is
    # a copy, so the caller's tensors (e.g. the state's sigma) are left as
    # they were; a plane the rheology does not update stays in the first
    planes.update({n: a.clone() for n, a in state.items()})
    if not plan.launches:
        return tuple(planes[n] for n in _STATE)
    second = {n: torch.empty_like(planes[n]) for n in _STATE_USED[dyn_type]}
    _launch(planes, second, plan, plan.launches, dte, dt, dx, dyn_type, p, strides)
    result = second if len(plan.launches) % 2 else planes
    return tuple(result.get(n, planes[n]) for n in _STATE)


def _kernel_segment(consts, carry, k, dte, dt, dx, dyn_type, p, plan: LaunchPlan):
    """One launch of the kernel under ``plan``, ``k`` substeps from
    ``carry`` into new state planes (the carry is read, not written): the
    forward of ``substep_loop_checkpointed`` on the card."""
    state, planes, strides = _kernel_inputs(consts, carry, dyn_type)
    planes.update(state)
    second = {n: torch.empty_like(state[n]) for n in _STATE_USED[dyn_type]}
    _launch(planes, second, plan, (k,), dte, dt, dx, dyn_type, p, strides)
    return tuple(second.get(n, state[n]) for n in _STATE)


# ---------------------------------------------------------------------------
# Reverse mode
# ---------------------------------------------------------------------------

#: the loop-invariant planes ``momentum._build_substep`` reads
_BODY_CONSTS = _CELL + _NODE + ("time_relaxation_damage",)


def _param_tensors(p):
    """(path, tensor) of every scalar of ``p`` (a DynParams, its bbm and evp
    included) that is a tensor: a parameter a caller differentiates."""
    out = []
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, torch.Tensor):
            out.append(((f.name,), v))
        elif dataclasses.is_dataclass(v):
            out += [((f.name, g.name), getattr(v, g.name)) for g in dataclasses.fields(v)
                    if isinstance(getattr(v, g.name), torch.Tensor)]
    return out


def _with_params(p, paths, values):
    """``p`` with the scalars at ``paths`` replaced by ``values``."""
    for path, v in zip(paths, values):
        if len(path) == 1:
            p = dataclasses.replace(p, **{path[0]: v})
        else:
            inner = dataclasses.replace(getattr(p, path[0]), **{path[1]: v})
            p = dataclasses.replace(p, **{path[0]: inner})
    return p


def _grad_inputs(consts, carry, p):
    """Every tensor the loop's result depends on: the carry, the planes the
    body reads, the tensor scalars of ``p``."""
    planes = [getattr(consts, n, None) for n in _BODY_CONSTS]
    return [*carry, *(a for a in planes if isinstance(a, torch.Tensor)),
            *(t for _, t in _param_tensors(p))]


def _spec_inputs(spec, tensors):
    """The body's namespace of planes and the parameters, from the
    Function's inputs after the carry."""
    n_c = len(spec.const_names)
    consts = SimpleNamespace(**dict(spec.consts, **dict(zip(spec.const_names, tensors[:n_c]))))
    return consts, _with_params(spec.p, spec.param_paths, tensors[n_c:])


class SubstepLoop(torch.autograd.Function):
    """The substep loop with a checkpointed backward.

    Forward: ``spec.advance`` runs the loop segment by segment (on the card
    one kernel launch a segment, ``spec.segments`` = the plan's launches)
    and the carry at the start of every segment is kept: 8 planes a
    segment, ~140 MB at 464^2 in float32 for 20 segments.

    Backward: the segments last to first, each rebuilt from its checkpoint
    with the plain body (``momentum._build_substep``) under
    ``torch.enable_grad()`` and differentiated with ``torch.autograd.grad``
    with respect to its carry in, the planes the body reads and the tensor
    scalars of ``p``; the carry's gradient chains into the segment before,
    the others add up. Only one segment's graph lives at a time. Boolean
    planes (``solve``) get no gradient.

    The inputs after ``spec`` are the 8 carry planes, the body's planes
    (``spec.const_names``) and the tensor scalars (``spec.param_paths``).
    """

    @staticmethod
    def forward(ctx, spec, *inputs):
        carry = tuple(inputs[:8])
        consts, p = _spec_inputs(spec, inputs[8:])
        checkpoints = []
        for k in spec.segments:
            checkpoints.append(carry)
            carry = spec.advance(consts, carry, k, spec.dte, spec.dt, spec.dx, spec.dyn_type, p)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs[8:], *(t for c in checkpoints for t in c))
        # a plane the rheology leaves alone comes back as a copy, never as
        # the input itself
        return tuple(o.clone() if any(o is i for i in inputs) else o for o in carry)

    @staticmethod
    def backward(ctx, *grads):
        from nextsim_tpu_torch.ops import momentum

        spec = ctx.spec
        n_c, n_p = len(spec.const_names), len(spec.param_paths)
        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[1:]

        def leaf(t, grad):
            return t.detach().requires_grad_(grad and t.is_floating_point())

        extra = [leaf(t, w) for t, w in zip(saved[:n_c + n_p], wants[8:])]
        consts, p = _spec_inputs(spec, extra)
        body = momentum._build_substep(p, spec.dyn_type, spec.dte, spec.dt, spec.dx, consts)
        wrt = [t for t in extra if t.requires_grad]
        g_wrt = [None] * len(wrt)
        g_carry = list(grads)
        points = saved[n_c + n_p:]
        for seg in reversed(range(len(spec.segments))):
            if all(g is None for g in g_carry):
                break
            cin = tuple(leaf(t, True) for t in points[8 * seg:8 * seg + 8])
            with torch.enable_grad():
                out = cin
                for _ in range(spec.segments[seg]):
                    out = body(out)
            pairs = [(o, g) for o, g in zip(out, g_carry) if g is not None and o.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], [*cin, *wrt], [g for _, g in pairs],
                                      allow_unused=True)
            g_carry = list(got[:8])
            g_wrt = [a if b is None else b if a is None else a + b for a, b in zip(g_wrt, got[8:])]
        g_extra = iter(g_wrt)
        return (None, *g_carry, *(next(g_extra) if t.requires_grad else None for t in extra))


def substep_loop_checkpointed(consts, carry, steps: int, dte: float, dt: float, dx: float,
                              dyn_type: str, p, advance=None, segments=None):
    """The substep loop through ``SubstepLoop``: gradients flow to the carry,
    to the planes of ``consts`` the body reads and to the tensor scalars of
    ``p``, while the forward runs the kernel.

    ``advance(consts, carry, k, dte, dt, dx, dyn_type, p)`` runs one segment
    of ``k`` substeps. By default it is one launch of the CUDA kernel under
    the loop's default plan, and ``segments`` the plan's launches, the same
    launches as the forward-only path. The tests hand in
    ``substep_loop_reference`` to run the checkpoints and the recompute on
    the CPU; ``segments`` then defaults to the plan's launches too. It takes
    one member: a batched carry raises ValueError."""
    if _members(carry) > 1:
        raise ValueError("substep_loop_checkpointed: a batched carry (a member axis); SubstepLoop "
                         "takes one member")
    if advance is None:
        plan = _default_plan(carry, steps, dyn_type)
        _check_plan(plan, carry, steps, dyn_type)
        advance = functools.partial(_kernel_segment, plan=plan)
        segments = plan.launches
    elif segments is None:
        ny1, nx1 = carry[0].shape[-2:]
        segments = launch_plan(ny1 - 1, nx1 - 1, steps, carry[0].dtype, dyn_type).launches
    if sum(segments) != steps:
        raise ValueError(f"substep_loop: segments {segments} are not {steps} substeps")
    const_names = tuple(n for n in _BODY_CONSTS if isinstance(getattr(consts, n, None), torch.Tensor))
    params = _param_tensors(p)
    spec = SimpleNamespace(
        advance=advance, segments=tuple(segments), dte=dte, dt=dt, dx=dx, dyn_type=dyn_type,
        p=p, param_paths=tuple(path for path, _ in params), const_names=const_names,
        consts={n: getattr(consts, n, None) for n in _BODY_CONSTS if n not in const_names},
    )
    return SubstepLoop.apply(spec, *carry, *(getattr(consts, n) for n in const_names),
                             *(t for _, t in params))


def _params(ny, nx, steps, dte, dt, dx, dyn_type, p) -> _Params:
    """The kernel's scalars, computed in double as the plain version's
    Python floats are (each rounds to the plane dtype inside the kernel)."""
    # a scalar that is a tensor (a parameter a caller differentiates) is read
    # as a float here and nowhere else: its gradient comes from the plain
    # recompute of SubstepLoop.backward
    tensors = _param_tensors(p)
    p = _with_params(p, [path for path, _ in tensors], [float(t) for _, t in tensors])
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
        "nvcc not found (on PATH, or under $CUDA_HOME/bin); the CUDA kernels are "
        "built from nextsim_tpu_torch/csrc/ on first use"
    )


def build(flags=_NVCC_FLAGS) -> Path:
    """Compile the kernel into ``nextsim_tpu_torch/build/`` unless a library
    built from the same source and flags is there; returns its path."""
    global build_log
    out, log = compile_library(_SRC, "libmomentum_substep", flags)
    if log is not None:
        build_log = log
    return out


def library_path(src: Path, stem: str, flags) -> Path:
    """Where ``compile_library`` puts ``src`` built with ``flags``:
    ``<stem>_<tag>.so`` in the build directory, the tag a hash of the
    source and the flags."""
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"{stem}_{tag}.so"


def compile_library(src: Path, stem: str, flags) -> tuple:
    """``nvcc`` of ``src`` with ``flags`` into ``library_path``, unless
    that file is there: (its path, what nvcc printed, or None when it was
    there). The ranks of a mesh that start together may each compile it
    (seconds for a file with a plain C interface); each writes its own
    temporary file and renames it into place, so every rank loads a whole
    library."""
    out = library_path(src, stem, flags)
    if out.exists():
        return out, None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    res = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out, res.stdout + res.stderr


def load(path: Path):
    """The built library at ``path`` with its functions' argument types."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Params),
                       ctypes.POINTER(_Plan), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.nextsim_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nextsim_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib
