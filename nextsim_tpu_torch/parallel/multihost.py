"""Host-side data movement of a multi-rank run (the counterpart of
nextsim_tpu/parallel/multihost.py).

The reference gathers the distributed fields to rank 0 before its export,
restart and drifter paths touch the filesystem (reference:
gatherFieldsElement/gatherFieldsNode, model/finiteelement.cpp:2901-3557;
Exporter written on rank 0, fe.cpp:14111-14325). As in the JAX package,
:func:`gather_to_host` gives EVERY rank the global value (an all-gather), so
that all ranks take the same output decisions in lockstep, and
:func:`is_writer` gates the file writes to rank 0, apart from the
per-rank patches of ``moorings.parallel_output``.

IMPORTANT: with a block layout, gather_to_host is COLLECTIVE: every rank
of the layout's group must call it with the same tree, in the same order.
The Simulator runs the same host logic on every rank, which guarantees
that.

Sub-groups: a batched ensemble on a member mesh (ensemble/batched.py) runs
one group of ranks for each slot of members (a group of one block advances
its members by one batched step, a group of several blocks steps them one
by one). ``member_groups`` makes them
(every rank takes part in making every group, as ``dist.new_group`` asks),
``gather_to_host`` takes the group of the layout's blocks, and
``broadcast_host`` sends a host tree from one rank to all.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from nextsim_tpu_torch.core.state import host_array, to_host


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes the run's files (rank 0; reference:
    Exporter and restart written on rank 0, fe.cpp:14111-14325)."""
    return process_index() == 0


def _map(fn, tree):
    """``tree`` with every tensor leaf replaced by ``fn(leaf)``: a tensor, a
    dataclass, a dict or a tuple of them; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return tree


def member_groups(n_groups: int):
    """Split the world into ``n_groups`` groups of consecutive ranks, the
    same size each: (the groups, in order, and the index of this rank's).
    Collective: every rank calls it."""
    size = process_count()
    if size % n_groups:
        raise ValueError(f"{n_groups} groups do not divide a world of {size} ranks")
    per = size // n_groups
    groups = [dist.new_group(ranks=list(range(g * per, (g + 1) * per))) for g in range(n_groups)]
    return groups, process_index() // per


def gather_to_host(tree, layout=None, group=None):
    """Host numpy copy of ``tree`` (see ``_map``) with the GLOBAL value of
    every leaf that is a block of ``layout`` (a ``seam.BlockLayout``): the
    owned regions of the ranks of ``group`` (the default group when None),
    all-gathered (one collective call for each dtype) and put together.
    Other tensors are copied as they are. Without a layout it is
    ``to_host``."""
    if layout is None:
        return to_host(tree)
    blocks = []
    _map(lambda x: blocks.append(x) if layout.block_kind(x) else None, tree)
    size = dist.get_world_size(group)
    flat = {}
    for dtype in dict.fromkeys(x.dtype for x in blocks):
        mine = [layout.owned(x).reshape(-1) for x in blocks if x.dtype == dtype]
        buf = torch.cat(mine).detach()
        if buf.dtype == torch.bool:
            buf = buf.to(torch.uint8)
        if buf.device.type == "cuda" and dist.get_backend(group) != "nccl":
            buf = buf.cpu()
        parts = [torch.empty_like(buf) for _ in range(size)]
        dist.all_gather(parts, buf, group=group)
        flat[dtype] = [host_array(p) for p in parts]
    offsets = dict.fromkeys(flat, 0)
    ranks = [layout.for_rank(r) for r in range(size)]

    def assemble(x):
        if not layout.block_kind(x):
            return host_array(x)
        node = layout.block_kind(x) == "node"
        own_shape = layout.owned(x).shape
        n = int(np.prod(own_shape))
        dtype = x.dtype
        out = np.empty(tuple(x.shape[:-2]) + layout.global_shape(node),
                       dtype=flat[dtype][0].dtype)
        off = offsets[dtype]
        for r, lay in enumerate(ranks):
            out[(Ellipsis,) + lay.global_own_index(node)] = flat[dtype][r][off:off + n].reshape(own_shape)
        offsets[dtype] = off + n
        return out.astype(bool) if dtype == torch.bool else out

    return _map(assemble, tree)


def broadcast_host(arrays, src: int):
    """The dict of host numpy ``arrays`` of rank ``src`` on every rank
    (collective). Every rank passes a dict with the same keys, shapes and
    dtypes; the others' values are overwritten."""
    out = {}
    for key, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).reshape(-1)).clone()
        if dist.get_backend() == "nccl":  # NCCL moves device tensors only
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.broadcast(t, src=src)
        out[key] = t.cpu().numpy().view(a.dtype).reshape(a.shape)
    return out
