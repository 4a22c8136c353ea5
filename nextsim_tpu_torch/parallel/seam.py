"""Domain decomposition: one block of the grid per rank, with rings of the
neighbours' cells refreshed by exchange (the counterpart of
nextsim_tpu/parallel/seam.py).

The reference partitions its mesh over MPI ranks and refreshes a ghost ring
every substep (reference: FiniteElement::updateGhosts,
model/finiteelement.cpp:13963-14105, called from the momentum loop at
fe.cpp:10534). Here ``tpu.mesh_shape = DPYxDPX`` splits the (ny, nx) cells
into DPY x DPX blocks of By x Bx, one ``torch.distributed`` rank each
(parallel/distributed.py), and every rank runs the model's own operators,
unchanged, on its *ext block*.

Layout (``BlockLayout``). Rank r = a*DPX + b owns cell rows a*By .. a*By+By-1
and node rows a*By .. a*By+By (the matching columns likewise). Its ext block
adds a ring of W cells (W nodes beyond the seam node) on each side WHERE A
NEIGHBOUR EXISTS; at the domain's edge the block stops at the edge. So an
ext block is a small grid whose true edges pad exactly as the whole grid's
do: zero in ``stencil.pad1`` and the advection fluxes, edge-replicate in the
first-order intensive advection, the open boundary and the nesting weights
as they are. (The JAX package's uniform blocks are zero-filled beyond the
domain, which relies on the outermost cells being land; no single fill of a
ring would serve both of the port's paddings.) Seam nodes (row a*By) are
owned by both neighbours and computed redundantly from equal inputs, so they
agree bitwise and need no reconciliation.

Reach, and the ring width W. An operator on an ext block is wrong near the
block's edge where a neighbour exists (it pads where the grid goes on), and
the wrong layer widens by the operator's reach at each stage. Counting from
the step's start, where every plane is exact on the whole block:

* momentum setup (ops/momentum.py ``substep_setup``): the cell -> node sums
  and means (lumped mass, C_BU, the SSH gradient, the air drag) reach one
  node: the outermost node layer of the constants is wrong, and so is that
  of the initial velocity (``has_mass``);
* each substep: strain (cell from its 4 nodes) then stress divergence (node
  from its 4 cells) widens the wrong layer by one node and one cell, and
  the constants keep the outermost node wrong; so H substeps after an
  exchange of the carry the wrong layer is H nodes deep, and H + 1 in the
  first group, whose initial velocity was wrong in one node;
* each open-water smoother sweep (4-neighbour mean) widens it by one node
  (its mask and weights are wrong in the outermost one): H sweeps after an
  exchange, H nodes;
* transport (ops/transport.py): the van Leer MUSCL fluxes of the
  dimensionally split advection reach 2 cells, the SST/SSS diffusion one
  more: 3 cells;
* thermodynamics, the FSD block, ridging and the checks work cell by cell;
  the nesting sponge's node weight reaches one node (after transport, and
  followed by the step's last exchange).

So W = max(H + 1, 3), and every block must hold W of its own cells along a
split axis. (The first group's extra node matters only where ``has_mass``
differs at the block's edge, next to ice-free cells that carry no stress:
the sharded tests also pass with W = H, but W = H + 1 does not rely on
that.) The exchanges of one step (``Seam``): the carry's moving planes
(velocity, stress, damage) every H substeps, between the kernel's calls; the
velocity before every H smoother sweeps; the planes momentum changed (but
the displacement) after momentum; and every plane of the state at the end of
the step, after transport, ridging and the nesting sponge. The displacement
is read by nothing within a step, so the last exchange refreshes it.

The kernel between exchanges: ``Seam.substep_loop`` calls
``momentum_cuda.substep_loop`` for H substeps on the ext block, the CUDA
kernel on the card with the launch plan of the block's own shape, the plain
loop on the CPU. The kernel pads zeros beyond the planes it is given, as the
plain loop does, so it sees an ext block as it would a grid.

Inputs: every rank builds the same global fields as a single-device run
(init_state, forcing, nesting source, restart reads, the coupler's received
fields), on its own device and host, and keeps its ext block (``to_ext``).
That repeats the global host work, and the global planes pass through each
rank's device, on every rank. Outputs gather the owned blocks
(parallel/multihost.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nextsim_tpu_torch.core.state import State
from nextsim_tpu_torch.parallel import halo, multihost

#: reach (in cells) of transport, ridging and diffusion between the exchange
#: after momentum and the one at the end of the step
TRANSPORT_REACH = 3
#: ROADMAP item of what does not run on a mesh yet
GRADIENT_ITEM = "ROADMAP A.14c, gradients on a device mesh"


def mesh_shape(cfg) -> Tuple[int, int]:
    """(dpy, dpx) of ``tpu.mesh_shape`` ("DPYxDPX"; "" and "1x1" are one
    block)."""
    ms = str(cfg["tpu.mesh_shape"]).lower().strip()
    if ms in ("", "1x1"):
        return 1, 1
    try:
        dpy, dpx = (int(v) for v in ms.split("x"))
    except ValueError:
        raise ValueError(f"tpu.mesh_shape={ms!r} is not of the form DPYxDPX") from None
    if dpy < 1 or dpx < 1:
        raise ValueError(f"tpu.mesh_shape={ms!r}: both counts must be >= 1")
    return dpy, dpx


def ring_width(halo_depth: int) -> int:
    """W for ``tpu.halo_depth`` H (module docstring)."""
    return max(halo_depth + 1, TRANSPORT_REACH)


def _axis(pos: int, block: int, n: int, width: int) -> Tuple[int, int, int]:
    """(first, end, ring below) cell indices of a block's ext range along
    one axis of ``n`` cells."""
    first = max(pos * block - width, 0)
    return first, min((pos + 1) * block + width, n), pos * block - first


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """The ext block of rank (a, b) on a (dpy, dpx) mesh over (ny, nx) cells
    with rings of ``width`` cells (module docstring). Index tuples address
    the last two dimensions, so stacked planes (sigma, tice, the FSD bins)
    cut as the plain ones do."""

    ny: int
    nx: int
    dpy: int
    dpx: int
    a: int
    b: int
    width: int

    @property
    def By(self) -> int:
        return self.ny // self.dpy

    @property
    def Bx(self) -> int:
        return self.nx // self.dpx

    @property
    def rank(self) -> int:
        return self.a * self.dpx + self.b

    def for_rank(self, rank: int) -> "BlockLayout":
        a, b = divmod(rank, self.dpx)
        return dataclasses.replace(self, a=a, b=b)

    @property
    def rows(self):
        return _axis(self.a, self.By, self.ny, self.width)

    @property
    def cols(self):
        return _axis(self.b, self.Bx, self.nx, self.width)

    def global_shape(self, node: bool) -> Tuple[int, int]:
        return self.ny + node, self.nx + node

    def ext_shape(self, node: bool) -> Tuple[int, int]:
        (r0, r1, _), (c0, c1, _) = self.rows, self.cols
        return r1 - r0 + node, c1 - c0 + node

    def ext_index(self, node: bool) -> tuple:
        """The ext block's cells (or nodes) in a global plane."""
        (r0, r1, _), (c0, c1, _) = self.rows, self.cols
        return slice(r0, r1 + node), slice(c0, c1 + node)

    def own_index(self, node: bool) -> tuple:
        """The owned cells (nodes, both seams included) in an ext plane."""
        lo_y, lo_x = self.rows[2], self.cols[2]
        return slice(lo_y, lo_y + self.By + node), slice(lo_x, lo_x + self.Bx + node)

    def global_own_index(self, node: bool) -> tuple:
        """The owned cells (nodes) in a global plane."""
        a, b = self.a * self.By, self.b * self.Bx
        return slice(a, a + self.By + node), slice(b, b + self.Bx + node)

    def _kind(self, x, shapes) -> Optional[str]:
        if getattr(x, "ndim", 0) < 2:
            return None
        tail = tuple(x.shape[-2:])
        return "cell" if tail == shapes(False) else "node" if tail == shapes(True) else None

    def block_kind(self, x) -> Optional[str]:
        """"cell" or "node" for an ext-block plane, else None."""
        return self._kind(x, self.ext_shape)

    def to_ext(self, tree):
        """The ext block of every global plane of ``tree`` (a tensor, a numpy
        array, a dataclass, a dict or a tuple of them), as its own copy;
        other leaves pass through."""
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            kind = self._kind(tree, self.global_shape)
            if kind is None:
                return tree
            block = tree[(Ellipsis,) + self.ext_index(kind == "node")]
            return block.clone() if isinstance(block, torch.Tensor) else block.copy()
        return _map_tree(self.to_ext, tree)

    def owned(self, tree):
        """Views of the owned region of every ext-block plane of ``tree``."""
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            kind = self.block_kind(tree)
            return tree if kind is None else tree[(Ellipsis,) + self.own_index(kind == "node")]
        return _map_tree(self.owned, tree)

    def neighbours(self):
        """(south, north, west, east) ranks, None beyond the domain."""
        return halo._neighbours(self.rank, (self.dpy, self.dpx))

    def ring_strips(self, planes, axis: int):
        """(sends, recvs) of ``halo.exchange_strips`` that refresh the rings
        of ``planes`` (ext-block planes) along ``axis`` (0: y, 1: x). Strip
        g of a ring below is the neighbour's own row By - W + g; above, a
        cell ring's strip g is the neighbour's own row g and a node ring's
        its own row g + 1, past the shared seam."""
        south, north, west, east = self.neighbours()
        lo_rank, hi_rank = (south, north) if axis == 0 else (west, east)
        lo, block = (self.rows[2], self.By) if axis == 0 else (self.cols[2], self.Bx)
        w = self.width
        sends, recvs = {}, {}
        for i, p in enumerate(planes):
            kind = self.block_kind(p)
            if kind is None:
                raise ValueError(f"ring exchange: a plane of shape {tuple(p.shape)} is no ext block of {self}")
            e = int(kind == "node")

            def idx(s):
                return (Ellipsis, s, slice(None)) if axis == 0 else (Ellipsis, s)

            if lo_rank is not None:
                sends.setdefault(lo_rank, []).append((i, idx(slice(lo + e, lo + e + w))))
                recvs.setdefault(lo_rank, []).append((i, idx(slice(0, w))))
            if hi_rank is not None:
                sends.setdefault(hi_rank, []).append((i, idx(slice(lo + block - w, lo + block))))
                recvs.setdefault(hi_rank, []).append((i, idx(slice(lo + block + e, lo + block + e + w))))
        return sends, recvs


def _map_tree(fn, tree):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: fn(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(fn(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# host arrays: every rank's block at once (the JAX module's stacked form)
# ---------------------------------------------------------------------------

def _layouts(ny, nx, dpy, dpx, width):
    return [BlockLayout(ny, nx, dpy, dpx, a, b, width) for a in range(dpy) for b in range(dpx)]


def to_ext_cells(g, dpy: int, dpx: int, width: int):
    """Global (..., ny, nx) cell plane -> the ext blocks, in rank order."""
    return [lay.to_ext(g) for lay in _layouts(*g.shape[-2:], dpy, dpx, width)]


def to_ext_nodes(g, dpy: int, dpx: int, width: int):
    """Global (..., ny+1, nx+1) node plane -> the ext blocks, in rank order."""
    ny, nx = g.shape[-2] - 1, g.shape[-1] - 1
    return [lay.to_ext(g) for lay in _layouts(ny, nx, dpy, dpx, width)]


def _from_ext(blocks, ny, nx, dpy, dpx, width, node):
    first = blocks[0]
    out = np.empty(first.shape[:-2] + (ny + node, nx + node), dtype=first.dtype)
    for lay, blk in zip(_layouts(ny, nx, dpy, dpx, width), blocks):
        out[(Ellipsis,) + lay.global_own_index(node)] = blk[(Ellipsis,) + lay.own_index(node)]
    return out


def from_ext_cells(blocks, dpy: int, dpx: int, ny: int, nx: int, width: int):
    """The inverse of ``to_ext_cells``: every block's owned cells."""
    return _from_ext(blocks, ny, nx, dpy, dpx, width, False)


def from_ext_nodes(blocks, dpy: int, dpx: int, ny: int, nx: int, width: int):
    """The inverse of ``to_ext_nodes``; a seam node is read from the block
    above it or right of it (both owners hold it, bitwise equal)."""
    return _from_ext(blocks, ny, nx, dpy, dpx, width, True)


# ---------------------------------------------------------------------------
# the exchanger of one rank
# ---------------------------------------------------------------------------

class Seam:
    """One rank's side of a decomposed run: its ``BlockLayout``, the halo
    depth H (``tpu.halo_depth``: substeps, or smoother sweeps, between ring
    exchanges) and the exchange counters (``stats``: messages and bytes;
    ``exchanges``: ring exchanges; ``seconds``: their wall time, the card
    synchronized before each)."""

    def __init__(self, layout: BlockLayout, halo_depth: int):
        self.layout = layout
        self.halo_depth = int(halo_depth)
        self.stats = halo.ExchangeStats()
        self.exchanges = 0
        self.seconds = 0.0

    def to_blocks(self, tree):
        return self.layout.to_ext(tree)

    def owned(self, tree):
        return self.layout.owned(tree)

    def gather(self, tree):
        """Host copy of ``tree`` with the global value of every block
        (collective)."""
        return multihost.gather_to_host(tree, self.layout)

    def ring(self, planes) -> None:
        """Refresh the rings of ext-block ``planes`` (one dtype) in place
        from the owners: y, then x, so that corners arrive in two hops."""
        planes = [p for p in planes if p is not None]
        if torch.is_grad_enabled() and any(p.requires_grad for p in planes):
            raise NotImplementedError(f"the PyTorch port does not have {GRADIENT_ITEM} yet")
        if planes[0].device.type == "cuda":
            torch.cuda.synchronize(planes[0].device)
        t0 = time.perf_counter()
        for axis in (0, 1):
            halo.exchange_strips(planes, *self.layout.ring_strips(planes, axis), self.stats)
        self.seconds += time.perf_counter() - t0
        self.exchanges += 1

    def ring_state(self, state: State) -> State:
        """Refresh the rings of every plane of ``state``; returns it."""
        self.ring([getattr(state, f.name) for f in dataclasses.fields(state)])
        return state

    def substep_loop(self, consts, carry, steps: int, dte: float, dt: float, dx: float,
                     dyn_type: str, p):
        """``momentum_cuda.substep_loop`` on the ext block, H substeps a call,
        the carry's moving planes (velocity, stress and damage as the
        rheology updates them) exchanged between calls. The displacement is
        left to the caller's exchange."""
        from nextsim_tpu_torch.ops import momentum_cuda

        H = self.halo_depth
        if steps % H:
            raise ValueError(f"tpu.halo_depth={H} must divide dynamics.substeps={steps}")
        used = momentum_cuda._STATE_USED[dyn_type]
        moving = [i for i, n in enumerate(momentum_cuda._STATE) if n in used and not n.startswith("ut")]
        carry = tuple(carry)
        for g in range(steps // H):
            if g:
                self.ring([carry[i] for i in moving])
            carry = momentum_cuda.substep_loop(consts, carry, H, dte, dt, dx, dyn_type, p)
        return carry

    def max_all(self, t: torch.Tensor) -> np.ndarray:
        """Host copy of the elementwise max of ``t`` over the ranks."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def sum_all(self, t: torch.Tensor) -> np.ndarray:
        return self._reduce(t, dist.ReduceOp.SUM)

    def _reduce(self, t, op):
        t = t.detach().clone()
        if t.device.type == "cuda" and dist.get_backend() != "nccl":
            t = t.cpu()
        dist.all_reduce(t, op=op)
        return t.cpu().numpy()


def make_seam(cfg, grid) -> Optional[Seam]:
    """The rank's ``Seam`` for ``tpu.mesh_shape``, None for one block.
    Raises ValueError when the world's size is not the mesh's block count,
    when the grid does not divide into the blocks, or when the halo depth
    does not fit the blocks or the substeps."""
    dpy, dpx = mesh_shape(cfg)
    size = multihost.process_count()
    if dpy * dpx != size:
        raise ValueError(
            f"tpu.mesh_shape={dpy}x{dpx} runs one rank per block, {dpy * dpx} ranks, and this "
            f"world has {size}: start the run with torchrun --nproc-per-node {dpy * dpx} "
            "-m nextsim_tpu_torch ... (or set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT "
            "in each process)"
        )
    if size == 1:
        return None
    ny, nx = grid.shape
    if ny % dpy or nx % dpx:
        raise ValueError(
            f"grid {ny}x{nx} does not divide the ({dpy},{dpx}) device mesh: choose "
            f"grid.ny divisible by {dpy} and grid.nx divisible by {dpx}"
        )
    H = cfg["tpu.halo_depth"]
    if H < 1:
        raise ValueError(f"tpu.halo_depth={H} must be >= 1")
    substeps = cfg["dynamics.substeps"]
    if substeps % H:
        raise ValueError(f"tpu.halo_depth={H} must divide dynamics.substeps={substeps}")
    width = ring_width(H)
    By, Bx = ny // dpy, nx // dpx
    if (dpy > 1 and width > By) or (dpx > 1 and width > Bx):
        raise ValueError(
            f"tpu.halo_depth={H} needs rings of {width} cells, more than the {By}x{Bx} "
            f"blocks of the ({dpy},{dpx}) mesh hold"
        )
    a, b = divmod(multihost.process_index(), dpx)
    return Seam(BlockLayout(ny, nx, dpy, dpx, a, b, width), H)
