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
        extra = {}
        if sim.wim is not None:  # the WIM's floe size, gathered from its own layout
            extra["__wim_dfloe"] = sim.wim.gather(sim.wim.ice["dfloe"])
        if dist.get_rank() == 0:
            arrays = {f.name: getattr(host, f.name) for f in dataclasses.fields(host)
                      if getattr(host, f.name) is not None}
            np.savez(os.path.join(out_dir, f"{name}.npz"), __exchanges=sim.mesh.exchanges,
                     __messages=sim.mesh.stats.messages, __bytes=sim.mesh.stats.bytes, **arrays, **extra)


# ---------------------------------------------------------------------------
# the waves-in-ice module, the batched ensemble and gradients on a mesh
# (tests/test_torch_parallel_waves.py, _ensemble.py, _grad.py)
# ---------------------------------------------------------------------------

class StripGrid:
    """tests/test_parallel.py's WIM strip: 16 x 64 cells of 4 km, no land."""

    shape = (16, 64)
    dx = 4e3
    mask = np.ones((16, 64))


class PatchGrid(StripGrid):
    """The strip with 5% of its cells land (a seeded draw)."""

    mask = (np.random.default_rng(2).random((16, 64)) > 0.05).astype(np.float64)


def patchy_wim_fields(shape):
    """(conc, vol, nfloes, swh, mwp, mwd) on ``shape``: ice on 55% of the
    cells (a seeded draw, so ice and open water meet every edge of the
    domain), floes of 30-400 m, waves of 1-4 m, 6-14 s from every
    direction."""
    rng = np.random.default_rng(7)
    conc = np.where(rng.random(shape) < 0.55, 0.5 + 0.5 * rng.random(shape), 0.0)
    vol = conc * (0.3 + 1.5 * rng.random(shape))
    nfloes = conc / (30.0 + 370.0 * rng.random(shape)) ** 2
    return (conc, vol, nfloes, 1.0 + 3.0 * rng.random(shape), 6.0 + 8.0 * rng.random(shape),
            -180.0 + 360.0 * rng.random(shape))


def ideal_setup(w):
    w.ideal_ice_fields(0.7)
    w.ideal_wave_fields(0.8)


def patchy_setup(w):
    conc, vol, nfloes, swh, mwp, mwd = (w.to_blocks(torch.as_tensor(a)) for a in patchy_wim_fields(w.shape))
    w.set_ice_fields(conc, vol, nfloes)
    w.set_wave_fields(swh, mwp, mwd)


def poked_setup(w):
    """The ideal fields with tests/test_grad.py's hazards placed so that
    they vary along y: an ice-free patch inside the pack (rows 5-8) and a
    dead-calm band in the wave zone (rows 2-4)."""
    ideal_setup(w)
    ny, nx = w.shape
    patch, calm = np.zeros((ny, nx)), np.zeros((ny, nx))
    patch[5:9, 40:52] = 1.0
    calm[2:5, :] = 1.0
    patch, calm = (w.to_blocks(torch.as_tensor(a, dtype=w.dtype)) > 0.5 for a in (patch, calm))
    ice = w.ice
    w.set_ice_fields(*(torch.where(patch, 0.0, ice[k]) for k in ("conc", "vol", "nfloes")))
    w.sdf = torch.where(calm, 0.0, w.sdf)


def _save(out_dir, name, arrays):
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)


def _rank_seam(ny, nx, dpy, dpx):
    """This rank's Seam of a (dpy, dpx) mesh over (ny, nx) cells (rings of
    one cell: a Wim derives its own)."""
    a, b = divmod(dist.get_rank(), dpx)
    return seam.Seam(seam.BlockLayout(ny, nx, dpy, dpx, a, b, 1), 1)


def wim_standalone(cases, out_dir):
    """Each (name, params kwargs, grid, setup, seconds) case: a ``Wim`` on
    this rank's block of a 2x2 mesh, set up by ``setup(wim)``, run for
    ``seconds``; rank 0 saves the gathered spectrum, floe fields and
    diagnostics."""
    from nextsim_tpu_torch.wim.wim import Wim, WimParams

    torch.set_num_threads(1)
    for name, kw, grid, setup, seconds in cases:
        w = Wim(WimParams(**kw), grid, torch.float64, device="cpu", mesh=_rank_seam(*grid.shape, 2, 2))
        setup(w)
        diag = w.run(seconds)
        _save(out_dir, name, w.gather(dict(sdf=w.sdf, **{f"ice_{k}": v for k, v in w.ice.items()},
                                           **{f"diag_{k}": v for k, v in diag.items()})))


def raw_step_cases(cases, out_dir):
    """Each (name, overrides) case: one ``raw_step_fn`` call from the
    initial state on the provider's forcing, and one ``step()`` of another
    Simulator; rank 0 saves both gathered states."""
    torch.set_num_threads(1)
    for name, over in cases:
        sim = Simulator(Config(overrides=over), device="cpu")
        forcing = sim._next_forcing()
        state, _, viol = sim.raw_step_fn(sim.state, forcing, sim.time_info())
        raw = sim.gather(state)
        flags = sim.mesh.max_all(viol)
        other = Simulator(Config(overrides=over), device="cpu")
        other.step()
        stepped = other.host_state()
        arrays = {f"raw_{f.name}": getattr(raw, f.name) for f in dataclasses.fields(raw)
                  if getattr(raw, f.name) is not None}
        arrays.update({f"step_{f.name}": getattr(stepped, f.name) for f in dataclasses.fields(stepped)
                       if getattr(stepped, f.name) is not None})
        _save(out_dir, name, dict(arrays, __viol=flags))


def ke_gradient(sim):
    """d(mean KE after one step)/d(wind_u) through ``sim.raw_step_fn`` from
    its state: on a mesh each rank's loss counts its own nodes (a seam node
    once), the wind is a leaf on this rank's ext block, and ``Seam.fold``
    adds the blocks' gradients into the global plane."""
    f = sim.forcing_provider(sim.current_time, sim.time_init)
    wind = sim.to_blocks(f.wind_u).detach().requires_grad_(True)
    state, _, _ = sim.raw_step_fn(sim.state, sim.to_blocks(f).replace(wind_u=wind), sim.time_info())
    ke = state.vt_u * state.vt_u + state.vt_v * state.vt_v
    n = (sim.grid.ny + 1) * (sim.grid.nx + 1)
    if sim.mesh is not None:
        ke = ke[sim.mesh.layout.count_index(True)]
    (g,) = torch.autograd.grad(ke.sum() / n, wind)
    return g if sim.mesh is None else sim.mesh.fold(g)


def mesh_gradients(cases, out_dir):
    """Each (name, overrides) case: ``ke_gradient`` on this world's mesh;
    rank 0 saves it."""
    torch.set_num_threads(1)
    for name, over in cases:
        sim = Simulator(Config(overrides=over), device="cpu")
        _save(out_dir, name, {"grad": ke_gradient(sim).numpy()})


def wim_loss_gradient(w, n_steps):
    """d(mean Hs + 1e3 mean tau_x after ``n_steps`` WIM steps)/d(ice
    volume) through ``Wim._run_scan`` (tests/test_grad.py's WIM loss), on
    ``w``'s blocks; on a mesh each rank counts its own cells and
    ``Seam.fold`` puts the gradient together."""
    from nextsim_tpu_torch.core import ties
    from nextsim_tpu_torch.wim import wim as pw

    vol = w.ice["vol"].detach().requires_grad_(True)
    ice = dict(w.ice, vol=vol, thick=torch.where(w.ice["mask"] > 0.5, vol / ties.maximum(w.ice["conc"], 1e-12), 0.0))
    medium = pw.update_wave_medium(ice["thick"], ice["mask"], w._sg_dev, w.p)
    steady = (torch.zeros_like(w.sdf), torch.zeros_like(w.land))
    _, _, diag = w._run_scan(w.sdf, ice, medium, steady, w._tensor(w.dt_cfl), n_steps)
    cells = diag["hs"] + 1e3 * diag["tau_x"]
    if w.mesh is not None:
        cells = w.mesh.owned(cells)
    (g,) = torch.autograd.grad(cells.sum() / (w.shape[0] * w.shape[1]), vol)
    return g if w.mesh is None else w.mesh.fold(g)


def wim_gradient(grid, kw, setup, n_steps, out_dir):
    """``wim_loss_gradient`` of a ``Wim`` on a 2x2 mesh; rank 0 saves it."""
    from nextsim_tpu_torch.wim.wim import Wim, WimParams

    torch.set_num_threads(1)
    w = Wim(WimParams(**kw), grid, torch.float64, device="cpu", mesh=_rank_seam(*grid.shape, 2, 2))
    setup(w)
    _save(out_dir, "wim_grad", {"grad": wim_loss_gradient(w, n_steps).numpy()})


def _summed(t):
    """``t`` summed over the ranks (through the host under gloo)."""
    host = t.detach().cpu().clone()
    dist.all_reduce(host)
    return host.to(t.device)


class _Replicate(torch.autograd.Function):
    """The identity forward; the gradient summed over the ranks backward
    (a global input every rank holds)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _summed(g)


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks forward; the identity backward (every rank
    holds the same output and backs it with the same gradient)."""

    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ring_gradcheck(ny, nx, width, kinds, device="cpu"):
    """``torch.autograd.gradcheck`` of a global function built on
    ``RingExchange`` on a (2, 1) mesh, float64: global planes of ``kinds``
    ("cell", "node", "stack": 3 stacked cell planes) cut to this rank's ext
    block, exchanged in one ring, and every rank's block (rings included)
    added back into a global plane, on ``device`` (a card's planes go
    through pinned host buffers under gloo). Raises when the analytical and
    numerical Jacobians differ."""
    from nextsim_tpu_torch.parallel.distributed import local_device

    torch.set_num_threads(1)
    device = local_device(device)
    lay = seam.BlockLayout(ny, nx, 2, 1, dist.get_rank(), 0, width)
    ex = seam.Seam(lay, 1)
    shapes = {"cell": (ny, nx), "node": (ny + 1, nx + 1), "stack": (3, ny, nx)}

    def place(block, node):
        out = block.new_zeros(tuple(block.shape[:-2]) + lay.global_shape(node))
        out[(Ellipsis,) + lay.ext_index(node)] = block
        return _SumOverRanks.apply(out)

    def f(*planes):
        blocks = ex.ring([lay.to_ext(_Replicate.apply(x)) for x in planes])
        return tuple(place(b, k == "node") for k, b in zip(kinds, blocks))

    gen = torch.Generator().manual_seed(4)
    args = [torch.randn(shapes[k], dtype=torch.float64, generator=gen).to(device).requires_grad_(True)
            for k in kinds]
    assert torch.autograd.gradcheck(f, args)
    assert ex.exchanges > 0 and ex.stats.messages > 0


def gradient_world(grad_cases, raw_cases, wim_args, out_dir):
    """``mesh_gradients``, ``raw_step_cases`` and ``wim_gradient`` in one
    world."""
    mesh_gradients(grad_cases, out_dir)
    raw_step_cases(raw_cases, out_dir)
    wim_gradient(*wim_args, out_dir)


def ensemble_cases(cases, out_dir):
    """Each (name, overrides, n, mesh, steps, read, write) case: a
    ``BatchedEnsemble`` of ``n`` members (seed 5) on the member mesh
    ``mesh``, from the checkpoint ``read`` when given, run ``steps`` steps,
    its checkpoint ``write`` when given; rank 0 saves every member's state,
    the mean of conc and vt_u, the spread, the noise arrays and how often
    the steps called the batched step and the member loop."""
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble

    torch.set_num_threads(1)
    for name, over, n, mesh, steps, read, write in cases:
        ens = BatchedEnsemble(Config(overrides=over), n, device="cpu", mesh=mesh, seed=5)
        if read:
            ens.read_restart(read)
        calls = {"batched": 0, "loop": 0}

        def counted(fn, key):
            def call(*args):
                calls[key] += 1
                return fn(*args)
            return call

        ens.sim.batched_step_fn = counted(ens.sim.batched_step_fn, "batched")
        ens.step_members = counted(ens.step_members, "loop")
        ens.run(steps)
        if write:
            ens.write_restart(write)
        members = [ens.member_state(m) for m in range(n)]
        arrays = {f"{m}_{f.name}": getattr(st, f.name).numpy() for m, st in enumerate(members)
                  for f in dataclasses.fields(st) if getattr(st, f.name) is not None}
        mean = ens.mean_state()
        arrays.update({f"mean_{k}": v.numpy() for k, v in (("conc", mean.conc), ("vt_u", mean.vt_u))})
        arrays.update({f"noise_{k}": v for k, v in ens._noise_arrays().items()})
        _save(out_dir, name, dict(arrays, **{f"spread_{k}": np.float64(v) for k, v in ens.spread().items()},
                                  __pcpt=ens.pcpt, __batched_calls=calls["batched"],
                                  __loop_calls=calls["loop"]))
