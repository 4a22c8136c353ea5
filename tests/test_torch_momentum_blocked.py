"""The blocked schedule of the CUDA substep kernel, pinned on the CPU.

``momentum_cuda.launch_plan`` decides how the kernel in
nextsim_tpu_torch/csrc/momentum_substep.cu runs a substep loop: tiles of
nodes with a halo of k points, k substeps a launch in shared memory, two
sets of state planes written in turns. ``substep_loop_blocked_reference``
follows the same plan tile by tile in plain PyTorch, so what the kernel's
schedule must get right is tested here without a GPU:

* the blocked loop equals the plain loop BITWISE (same elementwise
  arithmetic, only cut differently) for bbm, evp and mevp in float32 and
  float64, on a damaged, stressed, moving state with grounding, an SSH
  gradient and varying currents, over square and ragged grids, tiles small
  enough that corner, edge and interior tiles all occur, a grid smaller
  than a tile, k in {1, 3, 4} and step counts that are and are not
  multiples of k (``tests/test_momentum_pallas.py`` pins the Pallas
  blocking across tile configurations the same way);
* ``launch_plan``'s properties (hypothesis): the tiles cover every node
  and cell exactly once, the shared memory stays within the 232,448 bytes a
  block may use on an H100 for both dtypes up to 4096^2, the launches'
  substep counts sum to ``steps``, and it raises where nothing fits;
* through the JAX package: the same numpy planes through the Pallas kernel
  ``momentum_pallas.substep_loop_blocked`` in interpret mode and through
  the port's blocked reference, float32, 3 substeps, with the tight tier
  of tests/test_torch_momentum.py (relative 1e-5 of each field's magnitude:
  XLA contracts multiply-adds on the CPU, torch does not);
* members (the batched ensemble's loop, one launch for all members on the
  card): the blocked reference on a member axis under a multi-tile plan
  for 3 members, and the plain loop on it, equal each member's own plain
  loop bitwise (a plane the members share stays one 2-D plane); a plan for
  N members counts N x the tiles in its rounds of SMs; a batched loop whose
  gradient is recorded raises; and ``jax.vmap`` of the JAX
  ``explicit_solve`` with the Pallas kernel (interpret mode) over 2 members
  against the port's ``explicit_solve`` on the member-minor stack through
  the batched blocked reference, float32, 3 substeps, tight tier.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nextsim_tpu.ops import momentum as jmom
from nextsim_tpu.ops import momentum_pallas
from nextsim_tpu_torch import Config, Simulator
from nextsim_tpu_torch.core.state import member_minor
from nextsim_tpu_torch.ensemble.perturbation import stack_forcings
from nextsim_tpu_torch.ops import momentum, momentum_cuda
from test_torch_momentum import (CARRY, FIELDS, RTOL_F32, assert_close, capture_jax_loop,
                                 consts_to_torch, make_pair, to_torch)

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def make_loop(dyn_type, dtype_name, ny, nx, seed=0):
    """(consts, carry, sim) of one dynamics step on a ny x nx square with a
    damaged, stressed, moving state made from ``seed`` with numpy."""
    sim = Simulator(Config(overrides={
        "grid.preset": "square", "grid.nx": nx, "grid.ny": ny, "grid.resolution": 10e3,
        "simul.timestep": 200, "dynamics.substeps": 120, "dynamics.alea_factor": 0.33,
        "thermo.use_thermo_forcing": False, "setup.ice-type": "constant",
        "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
        "setup.dynamics-type": dyn_type, "ideal_simul.constant_wind_u": 15.0,
        "ideal_simul.constant_wind_v": -4.0, "ideal_simul.init_thickness": 2.0,
        "simul.spinup_duration": 0.0, "tpu.dtype": dtype_name,
    }), device="cpu")
    rng = np.random.default_rng(seed)
    dt = DTYPES[dtype_name]

    def cells(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (ny, nx)), dtype=dt)

    def nodes(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (ny + 1, nx + 1)), dtype=dt)

    mask = sim.grid_arrays["mask"]
    sim.state = sim.state.replace(
        damage=cells(0.0, 0.9) * mask, conc=(cells(0.0, 1.0) * mask).clamp(max=1.0),
        sigma=torch.stack([cells(-2e4, 5e3), cells(-2e4, 5e3), cells(-5e3, 5e3)]) * mask,
        vt_u=nodes(-0.3, 0.3) * sim.grid_arrays["node_mask"],
        vt_v=nodes(-0.3, 0.3) * sim.grid_arrays["node_mask"],
    )
    forcing = sim._next_forcing()
    depth = forcing.depth.clone()
    depth[:, : nx // 3] = 5.0  # a shelf that grounds 2 m of ice
    forcing = forcing.replace(depth=depth, ssh=nodes(-0.3, 0.3), ocean_u=nodes(-0.1, 0.1),
                              ocean_v=nodes(-0.1, 0.1))
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    consts, carry = momentum.substep_setup(sim.state, forcing, ga, sim.dt, sim.dyn)
    return consts, carry, sim


def run(fn, consts, carry, steps, sim, **kw):
    return fn(consts, carry, steps, sim.dt / sim.dyn.substeps, sim.dt, sim.grid.dx,
              sim.dyn.dynamics_type, sim.dyn, **kw)


# (ny, nx, tile, k, steps): square and ragged grids, tiles that leave corner,
# edge and interior tiles, a grid smaller than its tile, k in {1, 3, 4},
# steps that are and are not multiples of k
PLANS = [
    (33, 33, (8, 8), 4, 8),
    (33, 33, (8, 8), 3, 7),
    (33, 33, (16, 12), 1, 3),
    (70, 45, (16, 20), 4, 7),
    (70, 45, (23, 11), 3, 9),
    (45, 70, (64, 64), 4, 6),
    (9, 7, (36, 36), 4, 5),
    (33, 33, (8, 8), 4, 3),
]


@pytest.mark.parametrize("ny,nx,tile,k,steps", PLANS)
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_blocked_reference_equals_plain_bitwise(dyn_type, dtype_name, ny, nx, tile, k, steps):
    consts, carry, sim = make_loop(dyn_type, dtype_name, ny, nx)
    before = [c.clone() for c in carry]
    plan = momentum_cuda.launch_plan(ny, nx, steps, DTYPES[dtype_name], dyn_type, tile=tile, k=k)
    assert len(plan.launches) == -(-steps // min(k, steps))
    ref = run(momentum_cuda.substep_loop_reference, consts, carry, steps, sim)
    out = run(momentum_cuda.substep_loop_blocked_reference, consts, carry, steps, sim, plan=plan)
    if dyn_type == "bbm":
        assert float((ref[7] - carry[7]).abs().max()) > 0.0  # damage is active
    assert float((ref[0] - carry[0]).abs().max()) > 0.0
    for name, c, b in zip(CARRY, carry, before):  # the caller's planes are left alone
        assert torch.equal(c, b), name
    for name, o, r in zip(CARRY, out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        assert bool(torch.isfinite(r).all()), name
        assert torch.equal(o, r), f"{name}: max |diff| {float((o - r).abs().max()):.3e}"


def test_blocked_reference_needs_the_whole_halo(monkeypatch):
    """The bitwise test has teeth: with the outermost ring of every cut
    zeroed (a halo of k - 1 points where k substeps run) the blocked loop no
    longer equals the plain loop."""
    consts, carry, sim = make_loop("bbm", "float64", 33, 33)
    plan = momentum_cuda.launch_plan(33, 33, 4, torch.float64, "bbm", tile=(8, 8), k=4)
    ref = run(momentum_cuda.substep_loop_reference, consts, carry, 4, sim)
    out = run(momentum_cuda.substep_loop_blocked_reference, consts, carry, 4, sim, plan=plan)
    assert torch.equal(out[0], ref[0])
    whole = momentum_cuda._box
    monkeypatch.setattr(momentum_cuda, "_box", lambda a, r0, r1, c0, c1: torch.nn.functional.pad(
        whole(a, r0 + 1, r1 - 1, c0 + 1, c1 - 1), (1, 1, 1, 1)))
    out = run(momentum_cuda.substep_loop_blocked_reference, consts, carry, 4, sim, plan=plan)
    assert not torch.equal(out[0], ref[0])


def test_default_plan_and_zero_steps():
    consts, carry, sim = make_loop("bbm", "float32", 33, 33)
    ref = run(momentum_cuda.substep_loop_reference, consts, carry, 5, sim)
    out = run(momentum_cuda.substep_loop_blocked_reference, consts, carry, 5, sim)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    out = run(momentum_cuda.substep_loop_blocked_reference, consts, carry, 0, sim)
    for o, c in zip(out, carry):
        assert torch.equal(o, c) and o is not c
    with pytest.raises(ValueError, match="another loop"):
        run(momentum_cuda.substep_loop_blocked_reference, consts, carry, 5, sim,
            plan=momentum_cuda.launch_plan(33, 33, 6, torch.float32, "bbm"))


# ---------------------------------------------------------------------------
# launch_plan
# ---------------------------------------------------------------------------

@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(ny=st.integers(1, 4096), nx=st.integers(1, 4096), steps=st.integers(0, 500),
       dtype_name=st.sampled_from(["float32", "float64"]),
       dyn_type=st.sampled_from(["bbm", "evp", "mevp"]),
       tile=st.one_of(st.none(), st.tuples(st.integers(1, 300), st.integers(1, 300))),
       k=st.one_of(st.none(), st.integers(1, 12)), members=st.integers(1, 16))
def test_launch_plan_properties(ny, nx, steps, dtype_name, dyn_type, tile, k, members):
    dtype = DTYPES[dtype_name]
    plan = momentum_cuda.launch_plan(ny, nx, steps, dtype, dyn_type, tile=tile, k=k, members=members)
    assert plan.members == members
    # shared memory: the box of every plane the rheology keeps, within the limit
    assert plan.n_planes == len(momentum_cuda.tile_planes(dyn_type))
    assert plan.smem_bytes == ((plan.tile_h + 2 * plan.k) * (plan.tile_w + 2 * plan.k)
                               * (plan.n_planes | 1) * plan.itemsize)  # records of odd length
    assert plan.smem_bytes <= momentum_cuda.SMEM_LIMIT == 232_448
    assert 1 <= plan.threads <= (1024 if dtype == torch.float32 else 512)
    assert plan.tile_h >= 1 and plan.tile_w >= 1
    if tile is not None:
        assert plan.tile_h <= tile[0] and plan.tile_w <= tile[1]
    # launches: k substeps each, the remainder last
    assert sum(plan.launches) == steps and all(1 <= n <= plan.k for n in plan.launches)
    assert all(n == plan.k for n in plan.launches[:-1])
    assert len(plan.launches) == -(-steps // plan.k)
    if k is not None:
        assert plan.k == max(1, min(k, steps))
    # the tiles cover every node once (so every cell, which shares its
    # node's indices), in a grid of blocks_y x blocks_x
    tiles = list(plan.tiles())
    assert len(tiles) == plan.blocks_y * plan.blocks_x
    rows = sorted({(j0, j1) for j0, j1, _, _ in tiles})
    cols = sorted({(i0, i1) for _, _, i0, i1 in tiles})
    assert len(rows) == plan.blocks_y and len(cols) == plan.blocks_x
    for spans, n in ((rows, ny + 1), (cols, nx + 1)):
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(lo < hi for lo, hi in spans)


@pytest.mark.parametrize("ny,nx,tile", [(33, 33, (8, 8)), (70, 45, (16, 20)), (9, 7, (36, 36))])
def test_tiles_cover_every_node_and_cell_once(ny, nx, tile):
    plan = momentum_cuda.launch_plan(ny, nx, 7, torch.float32, "bbm", tile=tile, k=4)
    nodes, cells = np.zeros((ny + 1, nx + 1), int), np.zeros((ny, nx), int)
    for j0, j1, i0, i1 in plan.tiles():
        nodes[j0:j1, i0:i1] += 1
        cells[j0:min(j1, ny), i0:min(i1, nx)] += 1
    assert (nodes == 1).all() and (cells == 1).all()


def test_launch_plan_shrinks_the_tile_and_raises_where_nothing_fits():
    # a tile far too large for the shared memory shrinks, the longer side first
    plan = momentum_cuda.launch_plan(1216, 1216, 120, torch.float64, "bbm", tile=(200, 100), k=4)
    assert plan.smem_bytes <= momentum_cuda.SMEM_LIMIT
    assert (plan.tile_h + 1 + 8) * (plan.tile_w + 8) * 31 * 8 > momentum_cuda.SMEM_LIMIT or \
        (plan.tile_h + 8) * (plan.tile_w + 1 + 8) * 31 * 8 > momentum_cuda.SMEM_LIMIT
    assert abs(plan.tile_h - plan.tile_w) <= 1
    # the default plans fit as they are at the sizes the main path runs
    for dtype in DTYPES.values():
        for dyn_type in ("bbm", "evp", "mevp"):
            for n in (464, 608, 1216):
                p = momentum_cuda.launch_plan(n, n, 120, dtype, dyn_type)
                assert p.smem_bytes <= momentum_cuda.SMEM_LIMIT and sum(p.launches) == 120
                assert momentum_cuda.launches_for(120, n, n, dtype, dyn_type) == len(p.launches)
    # so many substeps a launch that the halo alone is too much
    with pytest.raises(ValueError, match="shared memory"):
        momentum_cuda.launch_plan(464, 464, 120, torch.float64, "bbm", k=100)
    with pytest.raises(ValueError, match="shared memory"):
        momentum_cuda.launch_plan(464, 464, 120, torch.float32, "bbm", smem_limit=1000)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        momentum_cuda.launch_plan(464, 464, 120, torch.float16, "bbm")
    with pytest.raises(ValueError, match="unknown rheology"):
        momentum_cuda.launch_plan(464, 464, 120, torch.float32, "free_drift")
    with pytest.raises(ValueError, match="threads"):
        momentum_cuda.launch_plan(464, 464, 120, torch.float64, "bbm", threads=1024)


def test_plan_mirrors_the_source():
    """The ctypes mirror of SubstepPlan and the planes kept on a tile follow
    the CUDA source."""
    import pathlib
    import re

    src = (pathlib.Path(momentum_cuda.__file__).parent.parent / "csrc" / "momentum_substep.cu").read_text()
    body = src[src.index("struct SubstepPlan {"):]
    body = body[:body.index("};")]
    names = [n.strip() for line in body.splitlines()[1:] if line.strip()
             for n in line.split("//")[0].strip().rstrip(";").split(None, 1)[1].split(",")]
    assert names == [n for n, _ in momentum_cuda._Plan._fields_]
    # plane_used of the source, transcribed: which planes a rheology keeps
    enum = src[src.index("enum Plane {"):]
    order = [w.strip() for line in enum[:enum.index("};")].splitlines()[1:]
             for w in line.split("//")[0].split(",") if w.strip()][:-1]
    q = {name: i for i, name in enumerate(order)}

    def plane_used(rheo, i):
        if i in (q["UT_U"], q["UT_V"]):
            return rheo != "mevp"
        if i == q["DAMAGE"]:
            return rheo == "bbm"
        if i < 8 or i == q["VOLUME"]:
            return True
        if i in (q["THICK"], q["EVP_P"]):
            return rheo != "bbm"
        if i < q["GRAD_SSH_U"]:
            return rheo == "bbm"
        if i in (q["VTM_U"], q["VTM_V"]):
            return rheo == "mevp"
        return True

    assert re.search(r"if \(q == UT_U \|\| q == UT_V\) return rheo != MEVP;\s+"
                     r"if \(q == DAMAGE\) return rheo == BBM;\s+"
                     r"if \(q < N_STATE \|\| q == VOLUME\) return true;\s+"
                     r"if \(q == THICK \|\| q == EVP_P\) return rheo != BBM;\s+"
                     r"if \(q < GRAD_SSH_U\) return rheo == BBM;.*\s+"
                     r"if \(q == VTM_U \|\| q == VTM_V\) return rheo == MEVP;\s+"
                     r"return true;", src)
    for rheo in ("bbm", "evp", "mevp"):
        kept = [momentum_cuda._PLANES[i] for i in range(len(order)) if plane_used(rheo, i)]
        assert tuple(kept) == momentum_cuda.tile_planes(rheo)
    assert [len(momentum_cuda.tile_planes(r)) for r in ("bbm", "evp", "mevp")] == [30, 25, 25]


# ---------------------------------------------------------------------------
# through the JAX package
# ---------------------------------------------------------------------------

def test_blocked_reference_matches_pallas_interpret(monkeypatch):
    """The same numpy planes through the blocked Pallas kernel (interpret
    mode, 16-row blocks, as tests/test_momentum_pallas.py runs it) and
    through the port's blocked reference with tiles of 12 x 9 nodes and 2
    substeps a launch: float32, 3 substeps, tight tier."""
    j, p = make_pair("bbm", substeps=3)
    c, carry0, dte, dt, dx = capture_jax_loop(monkeypatch, j)
    ref = momentum_pallas.substep_loop_blocked(
        c, carry0, 3, dte, dt, dx, "bbm", j.dyn,
        block_rows=16, group_substeps=8, interpret=True,
    )
    ny, nx = (n - 1 for n in carry0[0].shape)
    plan = momentum_cuda.launch_plan(ny, nx, 3, torch.float32, "bbm", tile=(12, 9), k=2)
    assert plan.launches == (2, 1) and plan.blocks_y * plan.blocks_x == 12
    out = momentum_cuda.substep_loop_blocked_reference(
        consts_to_torch(c), tuple(to_torch(x) for x in carry0), 3, dte, dt, dx, "bbm", p.dyn,
        plan=plan,
    )
    for name, r, o in zip(CARRY, ref, out):
        assert_close(r, o, RTOL_F32, name)


# ---------------------------------------------------------------------------
# members: the batched loop
# ---------------------------------------------------------------------------

def make_members(dyn_type, dtype_name, ny, nx, n=3):
    """(consts, carry, sim, [(consts, carry) of each member]) of ``n``
    members made from the seeds 0..n-1 by ``make_loop``: a plane that every
    member has equal stays one shared 2-D plane, the others are stacked on
    a member axis, as ``Simulator.batched_step_fn`` hands them on."""
    loops = [make_loop(dyn_type, dtype_name, ny, nx, seed=m) for m in range(n)]
    consts = {}
    for name in vars(loops[0][0]):
        vals = [getattr(c, name) for c, _, _ in loops]
        shared = not isinstance(vals[0], torch.Tensor) or all(torch.equal(v, vals[0]) for v in vals)
        consts[name] = vals[0] if shared else torch.stack(vals)
    carry = tuple(torch.stack(planes) for planes in zip(*(cr for _, cr, _ in loops)))
    return SimpleNamespace(**consts), carry, loops[0][2], [(c, cr) for c, cr, _ in loops]


@pytest.mark.parametrize("ny,nx,tile,k,steps", [PLANS[1], PLANS[3], PLANS[6]])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_batched_loop_equals_each_member_bitwise(dyn_type, dtype_name, ny, nx, tile, k, steps):
    consts, carry, sim, singles = make_members(dyn_type, dtype_name, ny, nx)
    shared = {n for n, v in vars(consts).items() if isinstance(v, torch.Tensor) and v.ndim == 2}
    assert {"rlmass", "beta_cor_const"} <= shared and "vtm_u" not in shared
    plan = momentum_cuda.launch_plan(ny, nx, steps, DTYPES[dtype_name], dyn_type, tile=tile, k=k, members=3)
    assert plan.members == 3 and plan.blocks_y * plan.blocks_x > 1 or (ny, nx) == (9, 7)
    blocked = run(momentum_cuda.substep_loop_blocked_reference, consts, carry, steps, sim, plan=plan)
    plain = run(momentum_cuda.substep_loop_reference, consts, carry, steps, sim)
    assert not torch.equal(plain[0][0], plain[0][1])  # the members differ
    for m, (c, cr) in enumerate(singles):
        ref = run(momentum_cuda.substep_loop_reference, c, cr, steps, sim)
        for name, b, p, r in zip(CARRY, blocked, plain, ref):
            assert b.shape == p.shape == (3,) + r.shape, name
            assert torch.equal(p[m], r), f"member {m} {name}: max |diff| {float((p[m] - r).abs().max()):.3e}"
            assert torch.equal(b[m], r), f"member {m} {name}: max |diff| {float((b[m] - r).abs().max()):.3e}"
    with pytest.raises(ValueError, match="another loop"):  # a plan for one member
        run(momentum_cuda.substep_loop_blocked_reference, consts, carry, steps, sim,
            plan=momentum_cuda.launch_plan(ny, nx, steps, DTYPES[dtype_name], dyn_type, tile=tile, k=k))


@pytest.mark.parametrize("members", [1, 2, 4, 12])
@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_launch_plan_counts_every_members_tiles_in_its_rounds(dtype_name, members):
    """A launch's blocks are N x the tiles: with N dividing the card's 132
    SMs, the plan for N members is the one-member plan of a card of 132 / N
    SMs; every plan fits the 232,448 bytes of shared memory a block may use
    on an H100."""
    dtype = DTYPES[dtype_name]
    for n in (464, 608):
        for dyn_type in ("bbm", "evp", "mevp"):
            plan = momentum_cuda.launch_plan(n, n, 120, dtype, dyn_type, members=members)
            assert plan.members == members
            assert plan.smem_bytes <= momentum_cuda.SMEM_LIMIT == 232_448 and sum(plan.launches) == 120
            one = momentum_cuda.launch_plan(n, n, 120, dtype, dyn_type, sms=momentum_cuda.H100_SMS // members)
            assert (plan.tile_h, plan.tile_w, plan.k) == (one.tile_h, one.tile_w, one.k)
            assert momentum_cuda.launches_for(120, n, n, dtype, dyn_type, members=members) == len(plan.launches)
    with pytest.raises(ValueError, match="members"):
        momentum_cuda.launch_plan(464, 464, 120, dtype, "bbm", members=0)


def test_batched_loop_refuses_a_recorded_gradient():
    """SubstepLoop takes one member: a batched loop whose gradient is
    recorded raises, on the CPU as on the card, and takes no other route;
    without a recorded gradient it runs."""
    consts, carry, sim, _ = make_members("bbm", "float64", 9, 7, n=2)
    tau = consts.tau_ax.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="batched loop"):
        run(momentum_cuda.substep_loop, SimpleNamespace(**dict(vars(consts), tau_ax=tau)), carry, 3, sim)
    with pytest.raises(ValueError, match="batched carry"):
        run(momentum_cuda.substep_loop_checkpointed, consts, carry, 3, sim,
            advance=momentum_cuda.substep_loop_reference)
    with torch.no_grad():
        out = run(momentum_cuda.substep_loop, SimpleNamespace(**dict(vars(consts), tau_ax=tau)), carry, 3, sim)
    assert out[0].shape == carry[0].shape and not out[0].requires_grad


def test_batched_blocked_reference_matches_vmapped_pallas_interpret(monkeypatch):
    """``jax.vmap`` of the JAX ``explicit_solve`` with the blocked Pallas
    kernel (interpret mode, 16-row blocks, as tests/test_momentum_pallas.py
    runs it) over 2 members, member 1 with its own wind and velocity, against
    the port's ``explicit_solve`` on the member-minor stack whose substep
    loop is the batched blocked reference (tiles of 12 x 9 nodes, 2
    substeps a launch): float32, 3 substeps, tight tier."""
    j, p = make_pair("bbm", substeps=3)
    # member 1: a stronger wind turned to the south-east and a smooth drift
    # of its own; steps of 45 s, substeps of 15 s as tests/test_momentum_pallas.py's
    # 300 s / 20 (DT's 100 s substeps are beyond the elastic waves' limit)
    dt = 45.0
    node = np.asarray(j.forcing.wind_u).shape
    wind_u = (np.asarray(j.forcing.wind_u) * 1.3).astype(np.float32)
    wind_v = np.full(node, -4.0, np.float32)
    jj, ii = np.meshgrid(*(np.linspace(0.0, np.pi, n) for n in node), indexing="ij")
    vt_u = (0.01 * np.sin(jj) * np.sin(ii) * np.asarray(j.ga["node_mask"])).astype(np.float32)
    j_states = jax.tree.map(lambda a, b: jnp.stack([a, b]), j.state, j.state.replace(vt_u=jnp.asarray(vt_u)))
    j_forcings = jax.tree.map(lambda a, b: jnp.stack([a, b]), j.forcing,
                              j.forcing.replace(wind_u=jnp.asarray(wind_u), wind_v=jnp.asarray(wind_v)))
    dyn = dataclasses.replace(j.dyn, substep_kernel="pallas", pallas_block_rows=16, pallas_group_substeps=8)
    ref = jax.vmap(lambda s, f: jmom.explicit_solve(s, f, j.ga, dt, dyn)[0])(j_states, j_forcings)

    states = p.state.replace(**{f.name: torch.stack([getattr(p.state, f.name)] * 2)
                                for f in dataclasses.fields(p.state) if getattr(p.state, f.name) is not None})
    states = states.replace(vt_u=torch.stack([p.state.vt_u, to_torch(vt_u)]))
    forcing = stack_forcings([p.forcing, p.forcing.replace(wind_u=to_torch(wind_u), wind_v=to_torch(wind_v))])
    assert forcing.wind_u.shape == (2,) + node and forcing.ocean_u.shape == node  # shared planes stay planes
    ny, nx = (n - 1 for n in node)
    plan = momentum_cuda.launch_plan(ny, nx, 3, torch.float32, "bbm", tile=(12, 9), k=2, members=2)
    assert plan.launches == (2, 1) and plan.blocks_y * plan.blocks_x == 12
    loops = []

    def batched_loop(consts, carry, *args):
        loops.append(carry[0].shape)
        return momentum_cuda.substep_loop_blocked_reference(consts, carry, *args, plan=plan)

    monkeypatch.setattr(momentum_cuda, "substep_loop", batched_loop)
    out, _ = momentum.explicit_solve(member_minor(states), forcing, p.ga, dt, p.dyn)
    assert loops == [(2,) + node]
    assert not np.allclose(np.asarray(ref.vt_u[0]), np.asarray(ref.vt_u[1]))
    assert float(jnp.abs(ref.vt_u).max()) < 1.0 and float(ref.damage.max()) > 0.0  # drift, damage grows
    for m in range(2):
        for name in FIELDS:
            got = getattr(out, name)
            assert_close(getattr(ref, name)[m], got[:, m] if name == "sigma" else got[m], RTOL_F32,
                         f"member {m} {name}")
