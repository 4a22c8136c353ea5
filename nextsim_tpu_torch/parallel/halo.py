"""Ring exchange of 2-D planes between ranks (the counterpart of
nextsim_tpu/parallel/halo.py).

The structured-grid equivalent of the reference's updateGhosts
point-to-point exchange (reference: FiniteElement::updateGhosts /
initUpdateGhosts, model/finiteelement.cpp:13963-14105). The JAX package
moves strips with ``lax.ppermute`` inside ``shard_map``; here every rank is
a process and the strips go through ``torch.distributed.batch_isend_irecv``.

``exchange_strips`` is the transport: the strips of several planes bound for
one neighbour travel as one message, and what comes back is written into
the planes in place (or added to them, for the adjoint of an exchange).
The peers are ranks of a process group, the default one unless a sub-group
is named (a member group of a batched ensemble on a member mesh). Under
the gloo backend a plane on a card is staged through pinned host buffers
(gloo's point-to-point calls take host tensors); under NCCL the strips go
from card to card. ``ExchangeStats`` counts the messages and their bytes.

``exchange_halo``, ``extend_with_halo`` and ``strip_halo`` are the generic
uniform-halo form of the JAX module: a block with ``halo`` rows and columns
of ring on every side, filled from the face neighbours. Unlike the JAX one it
does not wrap around at the mesh's edge: a ring beyond the domain keeps what
``extend_with_halo`` put there (zeros). parallel/seam.py builds the model's
own layout on ``exchange_strips``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

#: one strip: (index of the plane, index of the strip within the plane)
Strip = Tuple[int, tuple]


@dataclasses.dataclass
class ExchangeStats:
    """Messages sent, their bytes, and the host buffers of the staging."""

    messages: int = 0
    bytes: int = 0
    pinned: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)

    def host_buffer(self, key, n: int, dtype) -> torch.Tensor:
        """A pinned host buffer of ``n`` elements, kept for the next call of
        the same size (a step exchanges a few plane sets, each many times)."""
        key = (key, n, dtype)
        buf = self.pinned.get(key)
        if buf is None:
            buf = self.pinned[key] = torch.empty(n, dtype=dtype, pin_memory=torch.cuda.is_available())
        return buf


def _staged(device) -> bool:
    return device.type == "cuda" and dist.get_backend() != "nccl"


def exchange_strips(planes: Sequence[torch.Tensor], sends: Dict[int, List[Strip]],
                    recvs: Dict[int, List[Strip]], stats: ExchangeStats = None, *,
                    group=None, accumulate: bool = False) -> None:
    """Send ``planes[i][index]`` of every strip in ``sends[peer]`` to
    ``peer``, and write what ``peer`` sends into the strips of
    ``recvs[peer]``, in place (add it with ``accumulate``). Both sides list
    a peer's strips in the same order and of the same sizes. The planes
    share one dtype and device. ``peer`` is a global rank of ``group``
    (the default group when None)."""
    if not sends and not recvs:
        return
    stats = ExchangeStats() if stats is None else stats
    dtype, device = planes[0].dtype, planes[0].device
    if any(p.dtype != dtype or p.device != device for p in planes):
        raise ValueError("exchange_strips: the planes must share one dtype and device")
    staged = _staged(device)
    ops, unpack = [], []
    for peer, strips in sends.items():
        buf = torch.cat([planes[i][idx].reshape(-1) for i, idx in strips])
        if staged:
            host = stats.host_buffer(("send", peer), buf.numel(), dtype)
            host.copy_(buf)
            buf = host
        ops.append(dist.P2POp(dist.isend, buf, peer, group=group))
        stats.messages += 1
        stats.bytes += buf.numel() * buf.element_size()
    for peer, strips in recvs.items():
        n = sum(planes[i][idx].numel() for i, idx in strips)
        if staged:
            buf = stats.host_buffer(("recv", peer), n, dtype)
        else:
            buf = torch.empty(n, dtype=dtype, device=device)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=group))
        unpack.append((buf, strips))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for buf, strips in unpack:
        buf = buf.to(device)
        off = 0
        for i, idx in strips:
            dst = planes[i][idx]
            src = buf[off:off + dst.numel()].view(dst.shape)
            dst.add_(src) if accumulate else dst.copy_(src)
            off += dst.numel()


def _neighbours(rank: int, mesh_shape, periodic=(False, False)):
    """(south, north, west, east) ranks of ``rank`` in a row-major
    (dpy, dpx) mesh, None beyond the edge. Along an axis flagged in
    ``periodic`` (y, x) with more than one block, the blocks at the edges
    are each other's neighbours (the wrap-around of a periodic domain); a
    single block along an axis has no neighbour there, periodic or not."""
    dpy, dpx = mesh_shape
    a, b = divmod(rank, dpx)

    def step(pos, n, d, wrap):
        q = pos + d
        if 0 <= q < n:
            return q
        return q % n if wrap and n > 1 else None

    south, north = step(a, dpy, -1, periodic[0]), step(a, dpy, 1, periodic[0])
    west, east = step(b, dpx, -1, periodic[1]), step(b, dpx, 1, periodic[1])
    return (None if south is None else south * dpx + b, None if north is None else north * dpx + b,
            None if west is None else a * dpx + west, None if east is None else a * dpx + east)


def exchange_halo(local: torch.Tensor, halo: int, mesh_shape, rank: int = None,
                  stats: ExchangeStats = None) -> torch.Tensor:
    """Refresh in place the ``halo``-wide rings of a halo-extended block
    (..., ny_loc + 2*halo, nx_loc + 2*halo) from its face neighbours'
    interiors, y before x so that corners arrive in two hops; returns it."""
    h = halo
    rank = dist.get_rank() if rank is None else rank
    south, north, west, east = _neighbours(rank, mesh_shape)
    ny, nx = local.shape[-2:]
    ell = (Ellipsis,)
    for lo, hi, n, ax in ((south, north, ny, 0), (west, east, nx, 1)):
        def strip(s):
            return ell + ((s, slice(None)) if ax == 0 else (slice(None), s))

        sends, recvs = {}, {}
        if lo is not None:
            sends[lo] = [(0, strip(slice(h, 2 * h)))]
            recvs[lo] = [(0, strip(slice(0, h)))]
        if hi is not None:
            sends[hi] = [(0, strip(slice(n - 2 * h, n - h)))]
            recvs[hi] = [(0, strip(slice(n - h, n)))]
        exchange_strips([local], sends, recvs, stats)
    return local


def extend_with_halo(local_interior: torch.Tensor, halo: int = 1) -> torch.Tensor:
    """Pad a block's interior with zero rings (filled by exchange_halo)."""
    return F.pad(local_interior, (halo, halo, halo, halo))


def strip_halo(local: torch.Tensor, halo: int = 1) -> torch.Tensor:
    return local[..., halo:-halo, halo:-halo]
