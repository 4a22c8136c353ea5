"""Rank functions of the spawned worlds of tests/test_torch_parallel.py and
tests/test_torch_multiprocess.py (``distributed.run_world`` imports them by
name in each rank). Imports no jax, so that the ranks start fast."""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from nextsim_tpu_torch import Config, Simulator
from nextsim_tpu_torch.parallel import halo, seam


def _laplacian(ext):
    """A 5-point stencil on a halo-extended block: its interior."""
    return ext[1:-1, :-2] + ext[1:-1, 2:] + ext[:-2, 1:-1] + ext[2:, 1:-1] - 4.0 * ext[1:-1, 1:-1]


def ring_exchanges(mesh_shape, ny, nx, width, dtype_name):
    """On this rank's block of a (ny, nx) grid split by ``mesh_shape``:
    the generic halo exchange of halo.py against the global 5-point stencil
    (zero beyond the domain), and ``Seam.ring`` on poisoned rings of a cell,
    a node and a stacked plane against the global planes' ext blocks. Raises
    on a difference."""
    torch.set_num_threads(1)
    dtype = getattr(torch, dtype_name)
    dpy, dpx = mesh_shape
    rng = np.random.default_rng(5)
    cell = torch.as_tensor(rng.normal(size=(ny, nx)), dtype=dtype)
    node = torch.as_tensor(rng.normal(size=(ny + 1, nx + 1)), dtype=dtype)
    stack = torch.as_tensor(rng.normal(size=(3, ny, nx)), dtype=dtype)
    a, b = divmod(dist.get_rank(), dpx)
    lay = seam.BlockLayout(ny, nx, dpy, dpx, a, b, width)

    # generic uniform halo: zero rings, refreshed, stencil, interior
    own = cell[lay.global_own_index(False)]
    ext = halo.exchange_halo(halo.extend_with_halo(own, 1), 1, mesh_shape)
    want = _laplacian(torch.nn.functional.pad(cell, (1, 1, 1, 1)))[lay.global_own_index(False)]
    torch.testing.assert_close(_laplacian(ext), want, rtol=0, atol=0)

    # the model's layout: rings poisoned, then one exchange
    planes = [lay.to_ext(x) for x in (cell, node, stack)]
    for p in planes:
        keep = p[(Ellipsis,) + lay.own_index(lay.block_kind(p) == "node")].clone()
        p.fill_(-999.0)
        p[(Ellipsis,) + lay.own_index(lay.block_kind(p) == "node")] = keep
    ex = seam.Seam(lay, 1)
    ex.ring(planes)
    for p, g in zip(planes, (cell, node, stack)):
        torch.testing.assert_close(p, lay.to_ext(g), rtol=0, atol=0)
    # one message to each face neighbour per axis
    n_peers = sum(r is not None for r in lay.neighbours())
    assert ex.stats.messages == n_peers and ex.exchanges == 1, (ex.stats, n_peers)


def run_cases(cases, out_dir, env=None):
    """Run each (name, overrides, steps) case on this world's mesh and save
    its gathered state and rank 0's exchange counters to
    ``out_dir/<name>.npz`` (rank 0 writes)."""
    torch.set_num_threads(1)
    os.environ.update(env or {})
    for name, over, steps in cases:
        sim = Simulator(Config(overrides=over), device="cpu")
        for _ in range(steps):
            sim.step()
        host = sim.host_state()
        if dist.get_rank() == 0:
            arrays = {f.name: getattr(host, f.name) for f in dataclasses.fields(host)
                      if getattr(host, f.name) is not None}
            np.savez(os.path.join(out_dir, f"{name}.npz"), __exchanges=sim.mesh.exchanges,
                     __messages=sim.mesh.stats.messages, __bytes=sim.mesh.stats.bytes, **arrays)
