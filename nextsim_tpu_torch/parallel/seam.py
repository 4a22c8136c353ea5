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

The waves-in-ice module on a mesh (wim/wim.py, ``Wim(mesh=seam)``) keeps its
spectrum and its ice and medium planes on ext blocks of a layout of its own
(``Seam.derive``), because its padding is not the sea ice's:

* its reach: a WIM time step advects the spectrum with ``weno_advect``, two
  RK2 stages of the WENO operator. One stage reaches 2 cells along each
  axis (the face fluxes read cells i-2 .. i+1, the flux divergence and the
  limiter one face more, and the limiter couples the axes through the
  first-order update, so the box is 2 cells in both): 4 cells a time step.
  Attenuation, the moments and breaking work cell by cell. So the WIM's
  ring is ``WIM_RING`` = 4 cells, and its exchange (spectrum and the floe
  fields breaking changes) comes after every WIM time step;
* its edges: ``wim.advopt`` y-periodic (the default) or xy-periodic wraps
  the spectrum around the domain (``_pad``), so a block at a periodic edge
  has a ring there too, filled from the block at the opposite edge
  (``BlockLayout.periodic``; ``halo._neighbours`` wraps). The velocities
  ``ag_eff * cos`` and ``ag_eff * sin`` are padded xy-periodic whatever
  ``advopt`` says, but they are uniform (the open-water group speed of one
  frequency and direction), so a block pads them as the whole grid does
  with no exchange.

The conc and vol that feed the WIM come from the sea-ice blocks, whose ring
W may be narrower or wider than the WIM's: ``Seam.move`` copies the owned
cells into the other layout and refreshes its rings by its own exchange;
the wave stress and breakage go back the same way.

Gradients. ``Seam.ring`` refreshes the rings in place, unless a gradient is
recorded through one of its planes: then ``RingExchange`` (a
``torch.autograd.Function``) returns new planes. Its backward is the
exchange's adjoint: a ring's gradient goes back to the rank that owns those
cells and is added to its strip, and the ring's own gradient is zeroed, x
first, then y, so that a corner's gradient travels back in the two hops its
value came. The adjoint of ``to_ext`` (every rank copies its ext block out
of a global plane) is ``Seam.fold``: every rank's block gradient, rings and
seam nodes included, added into a global plane and summed over the ranks. A
loss summed over each rank's owned nodes counts a seam node twice (both
neighbours own it); ``BlockLayout.count_index`` gives each node to one rank.

Sub-groups. A batched ensemble on a ``(P, dpy, dpx)`` member mesh runs P
groups of dpy x dpx ranks, each with its own ``Seam``: its exchanges,
gathers and reductions name the group (``Seam.group``), and its layout's
neighbours are global ranks, the group's first rank (``BlockLayout.offset``)
plus the block's index. The group's batched step holds its members on the
member-minor layout, ext blocks with leading axes (a plane ``(N, ey, ex)``,
``sigma`` ``(3, N, ey, ex)``): a strip is cut on the last two axes, so one
ring carries every member's strips, and the substep kernel reads the
member stack of ext blocks with a member stride of one block.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nextsim_tpu_torch.core.state import State, host_array
from nextsim_tpu_torch.parallel import halo, multihost

#: reach (in cells) of transport, ridging and diffusion between the exchange
#: after momentum and the one at the end of the step
TRANSPORT_REACH = 3
#: reach (in cells) of one WIM time step: two RK2 stages of the WENO
#: operator, 2 cells each (module docstring)
WIM_RING = 2 * 2


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


def _axis(pos: int, block: int, n: int, width: int, wrap: bool) -> Tuple[int, int, int]:
    """(first, end, ring below) cell indices of a block's ext range along
    one axis of ``n`` cells; with ``wrap`` the range runs past the domain's
    edges (indices taken modulo ``n``)."""
    if wrap:
        return pos * block - width, (pos + 1) * block + width, width
    first = max(pos * block - width, 0)
    return first, min((pos + 1) * block + width, n), pos * block - first


def _cut(x, first: int, end: int, n: int, dim: int):
    """Elements ``first .. end - 1`` of dimension ``dim`` (-2 or -1) of
    ``x``, the indices taken modulo ``n`` (a slice where they stay inside)."""
    if 0 <= first and end <= n:
        return x[(Ellipsis, slice(first, end), slice(None)) if dim == -2 else (Ellipsis, slice(first, end))]
    idx = np.arange(first, end) % n
    if isinstance(x, torch.Tensor):
        return x.index_select(x.ndim + dim, torch.as_tensor(idx, device=x.device))
    return np.take(x, idx, axis=dim)


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """The ext block of rank (a, b) on a (dpy, dpx) mesh over (ny, nx) cells
    with rings of ``width`` cells (module docstring). Index tuples address
    the last two dimensions, so stacked planes (sigma, tice, the FSD bins,
    the WIM's spectrum) cut as the plain ones do. Along an axis flagged in
    ``periodic`` (y, x) with more than one block, the blocks at the domain's
    edges have rings there as well, from the opposite edge (cell planes
    only). Neighbours are global ranks: ``offset`` is the global rank of
    block 0 (the first rank of a member group)."""

    ny: int
    nx: int
    dpy: int
    dpx: int
    a: int
    b: int
    width: int
    periodic: Tuple[bool, bool] = (False, False)
    offset: int = 0

    @property
    def By(self) -> int:
        return self.ny // self.dpy

    @property
    def Bx(self) -> int:
        return self.nx // self.dpx

    @property
    def rank(self) -> int:
        """The block's index in the mesh (its rank within its group)."""
        return self.a * self.dpx + self.b

    def for_rank(self, rank: int) -> "BlockLayout":
        a, b = divmod(rank, self.dpx)
        return dataclasses.replace(self, a=a, b=b)

    @property
    def wraps(self) -> Tuple[bool, bool]:
        return self.periodic[0] and self.dpy > 1, self.periodic[1] and self.dpx > 1

    @property
    def rows(self):
        return _axis(self.a, self.By, self.ny, self.width, self.wraps[0])

    @property
    def cols(self):
        return _axis(self.b, self.Bx, self.nx, self.width, self.wraps[1])

    def global_shape(self, node: bool) -> Tuple[int, int]:
        return self.ny + node, self.nx + node

    def ext_shape(self, node: bool) -> Tuple[int, int]:
        (r0, r1, _), (c0, c1, _) = self.rows, self.cols
        return r1 - r0 + node, c1 - c0 + node

    def ext_index(self, node: bool) -> tuple:
        """The ext block's cells (or nodes) in a global plane (a layout that
        does not wrap)."""
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

    def count_index(self, node: bool) -> tuple:
        """The cells (nodes) of an ext plane that this rank counts in a sum
        over the domain: its owned cells; of the nodes, those of the seams
        above and right of it only where the domain ends there, so that
        every node is counted by one rank."""
        lo_y, lo_x = self.rows[2], self.cols[2]
        top = int(node and self.a == self.dpy - 1)
        right = int(node and self.b == self.dpx - 1)
        return slice(lo_y, lo_y + self.By + top), slice(lo_x, lo_x + self.Bx + right)

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
        other leaves pass through. On a tensor that requires grad the copy
        is in its graph (its adjoint is ``Seam.fold``)."""
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            kind = self._kind(tree, self.global_shape)
            if kind is None:
                return tree
            node = kind == "node"
            if node and any(self.wraps):
                raise ValueError(f"{self}: a periodic layout cuts cell planes only")
            (r0, r1, _), (c0, c1, _) = self.rows, self.cols
            block = _cut(_cut(tree, r0, r1 + node, self.ny + node, -2), c0, c1 + node, self.nx + node, -1)
            if isinstance(block, np.ndarray):
                return block.copy() if np.shares_memory(block, tree) else block
            # slices share the global plane's memory: the block gets its own
            shared = block.untyped_storage().data_ptr() == tree.untyped_storage().data_ptr()
            return block.clone() if shared else block
        return _map_tree(self.to_ext, tree)

    def owned(self, tree):
        """Views of the owned region of every ext-block plane of ``tree``."""
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            kind = self.block_kind(tree)
            return tree if kind is None else tree[(Ellipsis,) + self.own_index(kind == "node")]
        return _map_tree(self.owned, tree)

    def neighbours(self):
        """(south, north, west, east) global ranks, None beyond the domain."""
        return tuple(None if r is None else self.offset + r
                     for r in halo._neighbours(self.rank, (self.dpy, self.dpx), self.periodic))

    def ring_strips(self, planes, axis: int):
        """(sends, recvs) of ``halo.exchange_strips`` that refresh the rings
        of ``planes`` (ext-block planes) along ``axis`` (0: y, 1: x). Strip
        g of a ring below is the neighbour's own row By - W + g; above, a
        cell ring's strip g is the neighbour's own row g and a node ring's
        its own row g + 1, past the shared seam. A peer lists, plane by
        plane, what it sends up before what it sends down, and what it
        receives from below before what comes from above, so the lists pair
        also where one rank is both neighbours (two blocks on a periodic
        axis)."""
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

            if hi_rank is not None:
                sends.setdefault(hi_rank, []).append((i, idx(slice(lo + block - w, lo + block))))
            if lo_rank is not None:
                sends.setdefault(lo_rank, []).append((i, idx(slice(lo + e, lo + e + w))))
                recvs.setdefault(lo_rank, []).append((i, idx(slice(0, w))))
            if hi_rank is not None:
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

class RingExchange(torch.autograd.Function):
    """``Seam.ring`` as a function of its planes: the forward returns new
    planes whose rings hold the owners' strips; the backward sends each
    ring's gradient back to the owner of those cells, adds it to the
    owner's strip and zeroes the ring's own gradient, x first, then y
    (module docstring). Every rank of the group must run the backward, in
    the order of the forward's exchanges, as it runs the forward."""

    @staticmethod
    def forward(ctx, seam, *planes):
        out = [p.detach().clone() for p in planes]
        seam._exchange(out, (0, 1))
        ctx.seam = seam
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        g = [x.clone() for x in grads]
        ctx.seam._exchange(g, (1, 0), adjoint=True)
        return (None, *g)


class Seam:
    """One rank's side of a decomposed run: its ``BlockLayout``, the halo
    depth H (``tpu.halo_depth``: substeps, or smoother sweeps, between ring
    exchanges), its process ``group`` (None: the default one) and the
    exchange counters (``stats``: messages and bytes; ``exchanges``: ring
    exchanges; ``seconds``: their wall time, the card synchronized before
    each)."""

    def __init__(self, layout: BlockLayout, halo_depth: int, group=None):
        self.layout = layout
        self.halo_depth = int(halo_depth)
        self.group = group
        self.stats = halo.ExchangeStats()
        self.exchanges = 0
        self.seconds = 0.0

    def derive(self, width: int, periodic=(False, False)) -> "Seam":
        """A seam of the same blocks, ranks and group with rings of
        ``width`` cells and the ``periodic`` axes (the WIM's layout), and
        counters of its own. Raises ValueError when a split axis's blocks
        are narrower than the rings."""
        lay = dataclasses.replace(self.layout, width=int(width), periodic=tuple(periodic))
        if (lay.dpy > 1 and width > lay.By) or (lay.dpx > 1 and width > lay.Bx):
            raise ValueError(f"rings of {width} cells do not fit the {lay.By}x{lay.Bx} blocks "
                             f"of the ({lay.dpy},{lay.dpx}) mesh")
        return Seam(lay, self.halo_depth, self.group)

    def to_blocks(self, tree):
        return self.layout.to_ext(tree)

    def owned(self, tree):
        return self.layout.owned(tree)

    def gather(self, tree):
        """Host copy of ``tree`` with the global value of every block
        (collective over the group)."""
        return multihost.gather_to_host(tree, self.layout, self.group)

    def ring(self, planes) -> list:
        """Refresh the rings of ext-block ``planes`` (one dtype; None entries
        pass) from the owners: y, then x, so that corners arrive in two
        hops. Returns the planes: the same tensors, refreshed in place, or
        new ones from ``RingExchange`` when a gradient is recorded through
        one of them."""
        planes = list(planes)
        live = [i for i, p in enumerate(planes) if p is not None]
        ps = [planes[i] for i in live]
        if ps[0].device.type == "cuda":
            torch.cuda.synchronize(ps[0].device)
        t0 = time.perf_counter()
        if torch.is_grad_enabled() and any(p.requires_grad for p in ps):
            ps = RingExchange.apply(self, *ps)
        else:
            self._exchange(ps, (0, 1))
        self.seconds += time.perf_counter() - t0
        self.exchanges += 1
        for i, p in zip(live, ps):
            planes[i] = p
        return planes

    def _exchange(self, planes, axes, adjoint: bool = False) -> None:
        """The strips of ``planes`` along ``axes`` in turn, in place; with
        ``adjoint`` the rings' values are sent to their owners, added to the
        strips they came from, and the rings zeroed."""
        for axis in axes:
            sends, recvs = self.layout.ring_strips(planes, axis)
            if not adjoint:
                halo.exchange_strips(planes, sends, recvs, self.stats, group=self.group)
                continue
            halo.exchange_strips(planes, recvs, sends, self.stats, group=self.group, accumulate=True)
            for strips in recvs.values():
                for i, idx in strips:
                    planes[i][idx] = 0.0

    def ring_state(self, state: State) -> State:
        """``state`` with the rings of every plane refreshed."""
        names = [f.name for f in dataclasses.fields(state)]
        planes = self.ring([getattr(state, n) for n in names])
        return state.replace(**{n: p for n, p in zip(names, planes) if p is not None})

    def move(self, planes: Sequence[torch.Tensor], dst: "Seam") -> list:
        """``planes`` (ext blocks of this layout) as ext blocks of ``dst``'s
        layout over the same blocks: the owned cells copied, the rings
        refreshed by ``dst``'s exchange."""
        out = []
        for p in planes:
            kind = self.layout.block_kind(p)
            node = kind == "node"
            q = p.new_zeros(tuple(p.shape[:-2]) + dst.layout.ext_shape(node))
            q[(Ellipsis,) + dst.layout.own_index(node)] = self.layout.owned(p)
            out.append(q)
        return dst.ring(out)

    def fold(self, tree):
        """The adjoint of ``to_blocks``: for every ext-block plane of
        ``tree`` (a block gradient), the global plane with every rank's
        block added in where it was cut out, rings and seam nodes included
        (collective over the group). On the planes' device."""
        lay = self.layout

        def one(x):
            if not isinstance(x, torch.Tensor) or lay.block_kind(x) is None:
                return x
            node = lay.block_kind(x) == "node"
            out = x.new_zeros(tuple(x.shape[:-2]) + lay.global_shape(node))
            (r0, r1, _), (c0, c1, _) = lay.rows, lay.cols
            rows = torch.as_tensor(np.arange(r0, r1 + node) % (lay.ny + node), device=x.device)
            cols = torch.as_tensor(np.arange(c0, c1 + node) % (lay.nx + node), device=x.device)
            tmp = x.new_zeros(tuple(x.shape[:-1]) + (lay.nx + node,))
            tmp.index_add_(x.ndim - 1, cols, x.detach())
            out.index_add_(x.ndim - 2, rows, tmp)
            return self._all_reduce(out, dist.ReduceOp.SUM)

        return _map_tree(one, tree) if not isinstance(tree, torch.Tensor) else one(tree)

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
        carry = list(carry)
        for g in range(steps // H):
            if g:
                for i, plane in zip(moving, self.ring([carry[i] for i in moving])):
                    carry[i] = plane
            carry = list(momentum_cuda.substep_loop(consts, tuple(carry), H, dte, dt, dx, dyn_type, p))
        return tuple(carry)

    def max_all(self, t: torch.Tensor) -> np.ndarray:
        """Host copy of the elementwise max of ``t`` over the group."""
        return host_array(self._all_reduce(t.detach().clone(), dist.ReduceOp.MAX))

    def sum_all(self, t: torch.Tensor) -> np.ndarray:
        return host_array(self._all_reduce(t.detach().clone(), dist.ReduceOp.SUM))

    def _all_reduce(self, t, op) -> torch.Tensor:
        """``t`` reduced over the group in place (through the host when the
        backend takes host tensors only); returns it on ``t``'s device."""
        if t.device.type == "cuda" and dist.get_backend(self.group) != "nccl":
            host = t.cpu()
            dist.all_reduce(host, op=op, group=self.group)
            return t.copy_(host)
        dist.all_reduce(t, op=op, group=self.group)
        return t


def make_seam(cfg, grid, group=None) -> Optional[Seam]:
    """The rank's ``Seam`` for ``tpu.mesh_shape`` over ``group`` (the whole
    world when None), None for one block. Raises ValueError when the
    group's size is not the mesh's block count, when the grid does not
    divide into the blocks, or when the halo depth does not fit the blocks
    or the substeps."""
    dpy, dpx = mesh_shape(cfg)
    if group is None:
        size, index, offset = multihost.process_count(), multihost.process_index(), 0
    else:
        ranks = dist.get_process_group_ranks(group)
        size, index, offset = len(ranks), dist.get_rank(group), ranks[0]
        if list(ranks) != list(range(offset, offset + size)):
            raise ValueError(f"a mesh group must hold consecutive ranks, not {ranks}")
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
    a, b = divmod(index, dpx)
    return Seam(BlockLayout(ny, nx, dpy, dpx, a, b, width, offset=offset), H, group)
