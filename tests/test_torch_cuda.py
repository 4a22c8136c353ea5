"""The CUDA substep kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and nvcc (marker ``gpu``) and skips
without them. This file imports no jax, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which sets up JAX.)

Thermodynamics has no hand kernel: one float64 ``thermo_step`` on the card
is held against the same step on the CPU (rtol 1e-12 of each field's
magnitude; CUDA's exp/log/pow/sqrt and its reciprocal-based division by a
Python scalar differ from the CPU's by an ulp or so), and a short thermo-on
run stays finite and goes through the substep kernel.

The dataset slice brings grounding (Lemieux C_BU on shallow water), an SSH
gradient and varying currents into the kernel's node stage: one test holds
the kernel against the plain version on such a state, and one checks that
``DatasetForcing`` hands the card the same planes as the CPU (bitwise).

The kernel is temporally blocked (k substeps a launch on a shared-memory
tile with a halo, ``momentum_cuda.launch_plan``): its launch counts are the
plan's, and it is also held against ``substep_loop_blocked_reference``, the
same plan in plain PyTorch, on a ragged grid with a remainder launch.

Tolerances: the kernel is built without multiply-add contraction and
transcribes the plain version's term order, and recomputing a halo point
gives the bits of computing it once, so bbm, evp and mevp agree bitwise
in every dtype: mEVP's ``(vtm - vt) / (beta + 1)`` is a division by a
Python scalar, which torch on CUDA computes as the product with its
reciprocal, and so does the kernel.

A device mesh's blocks: the kernel on ext blocks (rings of H + 1 cells,
cut at the domain's edge) in H-substep calls equals H-substep calls over the
whole grid on the owned cells, bitwise, for corner, edge and interior
blocks; so does a WIM time step on the WIM's layout of the blocks (rings of
4 cells, periodic where ``wim.advopt`` wraps). ``seam.RingExchange`` on
planes on the card passes gradcheck in a world of two ranks sharing it.

bfloat16: the kernel's bfloat16 build equals the plain bfloat16 loop and
its blocked reference bitwise, for the three rheologies; a plane of another
dtype raises; a bfloat16 Simulator steps through it; a bfloat16 gradient
goes through SubstepLoop.

Members (the batched ensemble): one batched launch of N members' loops
(``blockIdx.z`` the member, a 2-D plane shared with a member stride of 0)
equals N single launches and the plain loop bitwise, for the three
rheologies in float32, float64 and bfloat16, in the launches of one loop;
a bad member stride is refused by the kernel itself. The batched ensemble
step captured as a CUDA graph equals the eager batched step and the member
loop ``step_members`` bitwise, at 464^2 thermo on.

Roach welding (csrc/welding_roach.cu, ``welding_cuda``: a memset and two
launches a call, the active cells listed on the device and welded packed
into full warps, the bins' plan compiled in): the kernel equals the plain
version ``fsd.welding_roach_reference`` bitwise (NaN in the same places) in
float32, float64 and bfloat16, with unscaled areas (every active cell to
the cap of 256 substeps) and scaled ones (counts of their own, mixed within
a warp), with no active cell, every cell active, a cell count that is no
multiple of a block, under other plans in one process (other bin edges,
another count, undefined merge bins) and at 32 bins; one call on a
member-minor stack equals a call a member; an empty stack launches and
counts nothing; a kernel built for another bin count refuses the call; one call captured in a CUDA graph and replayed
twice gives the same bits twice (the count of active cells is zeroed by
each replay); a chunk of the FSD configuration captured as a CUDA graph
equals the eager loop bitwise and replays the welding launches; the
gradient through ``WeldingRoach`` equals plain autograd and is not the
identity; the batched ensemble step with welding equals ``step_members``
bitwise, one welding call for all members.

Transport and ridging (csrc/transport_ridge.cu, ``transport_cuda``: one
launch a call, one more a stack of floe-size bins): the kernel equals the
plain version ``transport.transport_and_ridge_reference`` bitwise on every
field and diagnostic (NaN in the same places) in float32, float64 and
bfloat16, for upwind2 and upwind, with and without young ice, at 1216^2
and at 37 x 53, where no tile divides; one launch on a member-minor stack
of 3 members equals each member's own call, the grid's mask shared by all;
the bins go through the stack entry; one call captured in a CUDA graph
replays twice; NaN in tracers, a stress and a velocity come out where the
plain version puts them; the gradient through
``TransportRidge`` and ``AdvectStack`` equals straight autograd; and the
main path (an eager step, a captured chunk) never runs the plain version
on the card and counts ``LAUNCHES_A_CALL`` a step.

The step's phases in a captured graph (``Captured.stats["phases"]``): a
3-step chunk's table lists every node in the step's phase order, its
``momentum.substeps`` holds the loop's launches alone, the marks add no
node, and a profiled replay aligns with the table.

Reverse mode on the card (``momentum_cuda.SubstepLoop``): the gradient
through ``substep_loop`` against straight autograd through the plain loop
on the card, for the three rheologies in float32 and float64, and the
regression test of the fault it repairs (a backward that took the kernel's
loop for the identity), at an even and an odd launch count.
"""

from types import SimpleNamespace

import pytest
import torch

from nextsim_tpu_torch import Config, Simulator
from nextsim_tpu_torch.core.state import to_host
from nextsim_tpu_torch.ops import fsd, momentum, momentum_cuda, thermo, welding_cuda
from nextsim_tpu_torch.parallel import seam

pytestmark = pytest.mark.gpu

SQUARE = {
    "grid.preset": "square", "grid.nx": 33, "grid.ny": 33, "grid.resolution": 10e3,
    "simul.timestep": 200, "dynamics.substeps": 40, "dynamics.alea_factor": 0.33,
    "thermo.use_thermo_forcing": False, "setup.ice-type": "constant",
    "setup.atmosphere-type": "constant", "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 10.0, "simul.spinup_duration": 0.0,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(dyn_type, dtype_name, **grid):
    sim = Simulator(Config(overrides=dict(SQUARE, **{"setup.dynamics-type": dyn_type,
                                                     "tpu.dtype": dtype_name}, **grid)), device="cuda")
    sim.step()  # a moving, stressed state
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    consts, carry = momentum.substep_setup(sim.state, sim._next_forcing(), ga, sim.dt, sim.dyn)
    return sim, consts, carry


def _loop(fn, sim, consts, carry, steps, **kw):
    return fn(consts, carry, steps, sim.dt / sim.dyn.substeps, sim.dt, sim.grid.dx,
              sim.dyn.dynamics_type, sim.dyn, **kw)


def _launches(sim, steps):
    """Launches of one ``steps``-substep loop of ``sim`` under the default plan."""
    return momentum_cuda.launches_for(steps, *sim.grid.shape, sim.dtype, sim.dyn.dynamics_type)


@pytest.mark.parametrize("steps", [3, 40])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_kernel_matches_plain(cuda, dyn_type, dtype_name, steps):
    sim, consts, carry = _setup(dyn_type, dtype_name)
    before = [c.clone() for c in carry]
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda.substep_loop, sim, consts, carry, steps)
    assert momentum_cuda.launches == launches + _launches(sim, steps) < launches + steps
    ref = _loop(momentum_cuda.substep_loop_reference, sim, consts, carry, steps)
    torch.cuda.synchronize()
    for c, b in zip(carry, before):  # the caller's planes are left alone
        torch.testing.assert_close(c, b, rtol=0, atol=0)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.device.type == "cuda"
        assert torch.equal(o, r)


@pytest.mark.parametrize("halo_depth", [1, 3])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_kernel_on_ext_blocks_equals_the_whole_grid(cuda, dyn_type, dtype_name, halo_depth):
    """A device mesh's substep loop without the ranks: on every block of a
    3x3 mesh over 36^2 cells (corner, edge and interior blocks), the
    constants set up on the ext block (rings of H + 1 cells, the domain's
    edge where no neighbour is) and the carry of the whole grid at the start
    of each group of H substeps, as an exchange leaves it; one kernel call of
    H substeps on the block gives the owned cells and nodes of H-substep
    calls over the whole grid, bitwise."""
    sim, consts, carry = _setup(dyn_type, dtype_name, **{"grid.nx": 36, "grid.ny": 36,
                                                          "ideal_simul.constant_wind_v": -6.0})
    forcing = sim._next_forcing()
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    starts = [carry]
    for _ in range(4):  # the whole grid, H substeps a call
        starts.append(_loop(momentum_cuda.substep_loop, sim, consts, starts[-1], halo_depth))
    for rank in range(9):
        lay = seam.BlockLayout(36, 36, 3, 3, *divmod(rank, 3), seam.ring_width(halo_depth))
        ext = lay.to_ext
        block_consts, _ = momentum.substep_setup(ext(sim.state), ext(forcing), ext(ga), sim.dt, sim.dyn)
        for g in range(4):
            out = _loop(momentum_cuda.substep_loop, sim, block_consts, ext(starts[g]), halo_depth)
            for name, o, r in zip(momentum_cuda._STATE, out, starts[g + 1]):
                torch.testing.assert_close(lay.owned(o), lay.owned(ext(r)), rtol=0, atol=0,
                                           msg=lambda m: f"block {rank}, group {g}, {name}: {m}")


@pytest.mark.parametrize("tile,k,steps", [(None, None, 11), (None, None, 121), ((16, 20), 4, 7),
                                          ((23, 11), 3, 10), ((5, 64), 6, 13), ((64, 64), 4, 6)])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_kernel_matches_blocked_reference_on_a_ragged_grid(cuda, dyn_type, dtype_name, tile, k, steps):
    """70 x 45 cells, tiles that do not divide it and step counts that are no
    multiple of k (a remainder launch): the kernel against the same plan in
    plain PyTorch and against the plain loop."""
    sim, consts, carry = _setup(dyn_type, dtype_name, **{"grid.nx": 45, "grid.ny": 70,
                                                          "ideal_simul.constant_wind_v": -6.0})
    plan = momentum_cuda.launch_plan(70, 45, steps, sim.dtype, dyn_type, tile=tile, k=k)
    assert steps % plan.k and plan.launches[-1] == steps % plan.k
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda._substep_loop_cuda, sim, consts, carry, steps, plan=plan)
    assert momentum_cuda.launches == launches + len(plan.launches) == launches + -(-steps // plan.k)
    blocked = _loop(momentum_cuda.substep_loop_blocked_reference, sim, consts, carry, steps, plan=plan)
    ref = _loop(momentum_cuda.substep_loop_reference, sim, consts, carry, steps)
    torch.cuda.synchronize()
    for o, b, r in zip(out, blocked, ref):
        assert bool(torch.isfinite(o).all())
        torch.testing.assert_close(b, r, rtol=0, atol=0)  # the schedule itself is exact
        assert torch.equal(o, b)


def test_kernel_rejects_a_plan_for_another_loop(cuda):
    sim, consts, carry = _setup("bbm", "float32")
    with pytest.raises(ValueError, match="another loop"):
        _loop(momentum_cuda._substep_loop_cuda, sim, consts, carry, 8,
              plan=momentum_cuda.launch_plan(33, 33, 9, torch.float32, "bbm"))
    with pytest.raises(ValueError, match="another loop"):
        _loop(momentum_cuda._substep_loop_cuda, sim, consts, carry, 8,
              plan=momentum_cuda.launch_plan(33, 33, 8, torch.float64, "bbm"))


def test_kernel_rejects_half_and_strided_planes(cuda):
    sim, consts, carry = _setup("bbm", "float32")
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        _loop(momentum_cuda.substep_loop, sim, consts, tuple(c.half() for c in carry), 3)
    strided = list(carry)
    strided[4] = carry[4].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        _loop(momentum_cuda.substep_loop, sim, consts, tuple(strided), 3)


def test_simulator_step_goes_through_the_kernel(cuda):
    sim = Simulator(Config(overrides=SQUARE), device="cuda")
    launches = momentum_cuda.launches
    sim.step_chunk(2)
    assert momentum_cuda.launches == launches + 2 * _launches(sim, sim.dyn.substeps)
    assert bool(torch.isfinite(sim.state.vt_u).all())


# ---------------------------------------------------------------------------
# bfloat16: the kernel's bfloat16 build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [3, 40])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_bf16_kernel_matches_plain(cuda, dyn_type, steps):
    """``nextsim_substeps_bf16`` against the plain bfloat16 loop on the card,
    bitwise: it rounds to bfloat16 where each torch op of the plain body
    rounds, keeps the scalars in float as torch does, and divides by mEVP's
    Python scalar through its reciprocal as torch on the card does."""
    sim, consts, carry = _setup(dyn_type, "bfloat16")
    assert carry[0].dtype == torch.bfloat16
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda.substep_loop, sim, consts, carry, steps)
    assert momentum_cuda.launches == launches + _launches(sim, steps)
    ref = _loop(momentum_cuda.substep_loop_reference, sim, consts, carry, steps)
    torch.cuda.synchronize()
    for name, o, r in zip(momentum_cuda._STATE, out, ref):
        assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all()), name
        assert torch.equal(o, r), name


@pytest.mark.parametrize("tile,k,steps", [(None, None, 11), ((16, 20), 4, 7), ((23, 11), 3, 10)])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_bf16_kernel_matches_blocked_reference_on_a_ragged_grid(cuda, dyn_type, tile, k, steps):
    """70 x 45 cells in bfloat16 (records of 2-byte values), tiles that do
    not divide the grid and a remainder launch: the kernel, the same plan in
    plain PyTorch and the plain loop, bitwise."""
    sim, consts, carry = _setup(dyn_type, "bfloat16", **{"grid.nx": 45, "grid.ny": 70,
                                                         "ideal_simul.constant_wind_v": -6.0})
    plan = momentum_cuda.launch_plan(70, 45, steps, torch.bfloat16, dyn_type, tile=tile, k=k)
    assert plan.itemsize == 2 and steps % plan.k
    out = _loop(momentum_cuda._substep_loop_cuda, sim, consts, carry, steps, plan=plan)
    blocked = _loop(momentum_cuda.substep_loop_blocked_reference, sim, consts, carry, steps, plan=plan)
    ref = _loop(momentum_cuda.substep_loop_reference, sim, consts, carry, steps)
    torch.cuda.synchronize()
    for o, b, r in zip(out, blocked, ref):
        assert torch.equal(b, r) and torch.equal(o, r)


def test_bf16_kernel_rejects_planes_of_another_dtype(cuda):
    """A bfloat16 carry with a float32 plane beside it (or the other way
    round) raises; nothing is cast behind the caller's back."""
    sim, consts, carry = _setup("bbm", "bfloat16")
    consts.tau_ax = consts.tau_ax.float()
    with pytest.raises(ValueError, match="plane tau_ax is .* torch.float32 .* the kernel needs .* torch.bfloat16"):
        _loop(momentum_cuda.substep_loop, sim, consts, carry, 3)
    sim32, consts32, carry32 = _setup("bbm", "float32")
    consts32.volume = consts32.volume.to(torch.bfloat16)
    with pytest.raises(ValueError, match="plane volume is .* torch.bfloat16"):
        _loop(momentum_cuda.substep_loop, sim32, consts32, carry32, 3)


def test_bf16_simulator_step_goes_through_the_kernel(cuda):
    """A ``tpu.dtype=bfloat16`` Simulator on the card: every plane stays
    bfloat16, finite, and each step launches the bfloat16 plan's launches."""
    sim = Simulator(Config(overrides=dict(SQUARE, **{"tpu.dtype": "bfloat16"})), device="cuda")
    launches = momentum_cuda.launches
    sim.step_chunk(2)
    assert momentum_cuda.launches == launches + 2 * _launches(sim, sim.dyn.substeps)
    import dataclasses

    for f in dataclasses.fields(sim.state):
        a = getattr(sim.state, f.name)
        if a is not None:
            assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()), f.name


def test_bf16_substep_loop_gradient_on_the_card(cuda):
    """A recorded gradient in bfloat16 goes through SubstepLoop: the bfloat16
    kernel forward, the plain body's recompute backward. The carry's
    gradient equals straight autograd through the plain loop bitwise (the
    kernel gives the plain loop's bits); the wind stress's and the volume's
    within 5% of their magnitude (bfloat16 sums, segment by segment)."""
    sim, consts, carry = _setup("bbm", "bfloat16")
    steps = sim.dyn.substeps
    leaves = tuple(c.detach().clone().requires_grad_(True) for c in carry)
    consts.tau_ax = consts.tau_ax.detach().clone().requires_grad_(True)
    consts.volume = consts.volume.detach().clone().requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    weights = [torch.randn(c.shape, generator=gen, device="cuda").to(torch.bfloat16) for c in carry]
    wrt = [*leaves, consts.tau_ax, consts.volume]
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda.substep_loop, sim, consts, leaves, steps)
    assert out[0].grad_fn.name() == "SubstepLoopBackward"
    assert momentum_cuda.launches == launches + _launches(sim, steps)
    got = _grads(out, wrt, weights)
    ref = _grads(_loop(momentum_cuda.substep_loop_reference, sim, consts, leaves, steps), wrt, weights)
    torch.cuda.synchronize()
    for i, (r, g) in enumerate(zip(ref, got)):
        if i < 8:
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        else:
            assert g.dtype == torch.bfloat16 and bool(torch.isfinite(r).all())
            torch.testing.assert_close(g.float(), r.float(), rtol=0, atol=0.05 * float(r.float().abs().max()))


# ---------------------------------------------------------------------------
# reverse mode: SubstepLoop (the kernel's forward, the plain body's recompute)
# ---------------------------------------------------------------------------

def _grad_setup(dyn_type, dtype_name):
    """(sim, consts, carry leaves, tensors to differentiate, output weights)
    of a 33^2 dynamics step: the carry as leaves, ``tau_ax`` and ``volume``
    as leaves, and the water drag coefficient as a tensor."""
    import dataclasses

    sim, consts, carry = _setup(dyn_type, dtype_name)
    sim.dyn = dataclasses.replace(sim.dyn, quad_drag_coef_water=torch.tensor(
        0.0055, dtype=sim.dtype, device="cuda", requires_grad=True))
    leaves = tuple(c.detach().clone().requires_grad_(True) for c in carry)
    consts.tau_ax = consts.tau_ax.detach().clone().requires_grad_(True)
    consts.volume = consts.volume.detach().clone().requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    weights = [torch.randn(c.shape, generator=gen, device="cuda", dtype=sim.dtype) for c in carry]
    wrt = [*leaves, consts.tau_ax, consts.volume, sim.dyn.quad_drag_coef_water]
    return sim, consts, leaves, wrt, weights


def _grads(out, wrt, weights):
    loss = sum((o * w).sum() for o, w in zip(out, weights))
    return torch.autograd.grad(loss, wrt, allow_unused=True)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_substep_loop_gradient_on_the_card_matches_straight_autograd(cuda, dyn_type, dtype_name):
    """``substep_loop`` on the card with a recorded gradient goes through
    SubstepLoop: the kernel's launches forward (counted, as many as the
    forward-only path), the plain body's recompute backward. Its gradients
    equal straight autograd through the plain loop on the card: the carry's
    bitwise for bbm and evp, whose kernel gives the plain loop's bits (NaN
    where the straight gradient is NaN: EVP's sqrt of a zero strain
    invariant on land); the planes' and the drag coefficient's within 1e-12
    (float64) / 1e-5 (float32) of their magnitude, summed segment by segment.
    mEVP's kernel differs from the plain loop by ulps (a division through
    its reciprocal), which the recompute starts from: 1e-5 of the magnitude
    for every gradient."""
    sim, consts, leaves, wrt, weights = _grad_setup(dyn_type, dtype_name)
    steps = sim.dyn.substeps
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda.substep_loop, sim, consts, leaves, steps)
    assert out[0].grad_fn.name() == "SubstepLoopBackward"
    assert momentum_cuda.launches == launches + _launches(sim, steps)
    got = _grads(out, wrt, weights)
    assert momentum_cuda.launches == launches + _launches(sim, steps)  # the backward runs no kernel
    ref = _grads(_loop(momentum_cuda.substep_loop_reference, sim, consts, leaves, steps), wrt, weights)
    torch.cuda.synchronize()
    rtol = 1e-12 if dtype_name == "float64" else 1e-5
    for i, (r, g) in enumerate(zip(ref, got)):
        if dyn_type == "mevp":
            torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.nan_to_num().abs().max()),
                                       equal_nan=True)
        elif i < 8:
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        else:
            assert bool(torch.isfinite(r).all()) and float(r.abs().max()) > 0.0
            torch.testing.assert_close(g, r, rtol=0, atol=rtol * float(r.abs().max()))


@pytest.mark.parametrize("steps", [16, 30])
def test_gradient_through_the_kernel_is_not_the_identity(cuda, steps):
    """The fault SubstepLoop repairs: the kernel wrote the loop's result into
    planes autograd saw as clones of the carry, so on an even launch count
    (16 substeps: 2 launches) a backward treated the loop as the identity
    and gave every loop-invariant plane a zero gradient, and on an odd one
    (30 substeps: 5 launches) the result had no graph at all. Now both equal
    straight autograd through the plain loop, the carry's gradient is not
    the identity and the wind stress's is nonzero."""
    sim, consts, leaves, wrt, weights = _grad_setup("bbm", "float32")
    assert _launches(sim, steps) % 2 == (steps == 30)
    out = _loop(momentum_cuda.substep_loop, sim, consts, leaves, steps)
    got = _grads(out, wrt, weights)
    ref = _grads(_loop(momentum_cuda.substep_loop_reference, sim, consts, leaves, steps), wrt, weights)
    torch.cuda.synchronize()
    assert not torch.equal(got[0], weights[0])  # d loss / d vt_u in: not the identity's
    g_tau = got[8]
    assert float(g_tau.abs().max()) > 0.0
    for i, (r, g) in enumerate(zip(ref, got)):
        if i < 8:
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.abs().max()))


def test_forward_only_loop_holds_no_graph(cuda):
    """Without a recorded gradient the card runs today's path: the same
    launches, and planes that no graph holds."""
    sim, consts, carry = _setup("bbm", "float32")
    with torch.no_grad():
        out = _loop(momentum_cuda.substep_loop, sim, consts, carry, 16)
    assert all(o.grad_fn is None and not o.requires_grad for o in out)
    out = _loop(momentum_cuda.substep_loop, sim, consts, carry, 16)  # grad mode on, nothing requires grad
    assert all(o.grad_fn is None for o in out)


THERMO = dict(SQUARE, **{"thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0,
                         "ideal_simul.init_concentration": 0.95, "ideal_simul.init_thickness": 1.5})


def test_thermo_step_on_the_card_matches_the_cpu_f64(cuda):
    sim = Simulator(Config(overrides=dict(THERMO, **{"tpu.dtype": "float64"})), device="cuda")
    sim.step()
    forcing = sim._next_forcing()
    tinfo = sim.time_info()
    out, diag = thermo.thermo_step(sim.state, forcing, sim.grid_arrays, sim.dt, sim.thermo_params, tinfo)
    move = lambda tree: type(tree)(**{f: None if v is None else torch.as_tensor(v)  # noqa: E731
                                       for f, v in vars(to_host(tree)).items()})
    cpu_ga = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in sim.grid_arrays.items()}
    ref, rdiag = thermo.thermo_step(move(sim.state), move(forcing), cpu_ga, sim.dt, sim.thermo_params, tinfo)
    for name, r in list(vars(ref).items()) + list(rdiag.items()):
        if r is None:
            continue
        o = getattr(out, name) if hasattr(out, name) else diag[name]
        assert o.device.type == "cuda"
        scale = float(r.abs().max())
        torch.testing.assert_close(o.cpu(), r, rtol=1e-12, atol=1e-12 * scale, msg=name)


def test_thermo_on_run_stays_finite(cuda):
    sim = Simulator(Config(overrides=THERMO), device="cuda")
    launches = momentum_cuda.launches
    sim.step_chunk(3)
    assert momentum_cuda.launches == launches + 3 * _launches(sim, sim.dyn.substeps)
    for name in ("conc", "thick", "tice", "sst", "sss", "conc_young", "h_young", "vt_u"):
        assert bool(torch.isfinite(getattr(sim.state, name)).all()), name
    assert float(sim.state.conc.max()) > 0.5 and "qa" in sim.diag


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_kernel_matches_plain_with_grounding_ssh_and_currents(cuda, dtype_name):
    """Shallow water under thick ice (C_BU > 0), a sloping SSH and varying
    currents: the terms of the node stage that constant forcing leaves at
    zero or uniform."""
    sim = Simulator(Config(overrides=dict(SQUARE, **{"tpu.dtype": dtype_name,
                                                     "ideal_simul.init_thickness": 2.0})), device="cuda")
    sim.step()
    forcing = sim._next_forcing()
    ny, nx = sim.grid.shape
    y, x = torch.meshgrid(torch.arange(ny + 1, device="cuda", dtype=sim.dtype),
                          torch.arange(nx + 1, device="cuda", dtype=sim.dtype), indexing="ij")
    depth = forcing.depth.clone()
    depth[:, : nx // 3] = 5.0  # a shelf that grounds 2 m of ice
    forcing = forcing.replace(depth=depth, ssh=0.3 * torch.sin(x / 7.0) * torch.cos(y / 5.0),
                              ocean_u=0.1 * torch.cos(y / 4.0), ocean_v=0.05 * torch.sin(x / 6.0))
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    consts, carry = momentum.substep_setup(sim.state, forcing, ga, sim.dt, sim.dyn)
    assert int((consts.c_bu > 0).sum()) > 10
    assert float(consts.grad_ssh_u.abs().max()) > 0.0 and float(consts.ocean_u.std()) > 0.0
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda.substep_loop, sim, consts, carry, 40)
    assert momentum_cuda.launches == launches + _launches(sim, 40)
    ref = _loop(momentum_cuda.substep_loop_reference, sim, consts, carry, 40)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


def _write_small_datasets(d):
    """Small ERA5 (nine yearly files), TOPAZ4 (curvilinear) and ETOPO files
    with smooth fields around 2015-10-16."""
    import numpy as np
    from scipy.io import netcdf_file

    from nextsim_tpu_torch.grid.projection import PolarStereo
    from nextsim_tpu_torch.utils.dates import string_to_datenum

    def write(path, dims, variables):
        path.parent.mkdir(parents=True, exist_ok=True)
        with netcdf_file(str(path), "w", version=2) as nc:
            for k, n in dims.items():
                nc.createDimension(k, n)
            for name, (vdims, arr, units) in variables.items():
                v = nc.createVariable(name, "f8" if arr.dtype == np.float64 else "f4", vdims)
                v[:] = arr
                if units:
                    v.units = units

    t0 = string_to_datenum("2015-10-16 00:00:00") * 24.0
    hours = t0 + np.arange(-1.0, 4.0)
    lats, lons = np.linspace(90.0, 40.0, 51), np.arange(0.0, 360.0, 2.0)
    lam, phi = (np.deg2rad(a) for a in np.meshgrid(lons, lats))
    era5 = {"u10": 8.0 * np.cos(lam), "v10": 6.0 * np.sin(2 * lam), "t2m": 250.0 + 20.0 * np.cos(phi),
            "d2m": 248.0 + 20.0 * np.cos(phi), "msl": 1.01e5 + 1e3 * np.sin(lam), "msdwswrf": 30.0 + 0 * lam,
            "msdwlwrf": 220.0 + 30.0 * np.cos(phi), "mtpr": 1e-5 + 0 * lam, "msr": 7e-6 + 0 * lam}
    for v, plane in era5.items():
        write(d / f"ERA5_{v}_y2015.nc", {"time": 5, "latitude": 51, "longitude": 180}, {
            "time": (("time",), hours, b"hours since 1900-01-01 00:00:00"),
            "latitude": (("latitude",), lats.astype(np.float32), None),
            "longitude": (("longitude",), lons.astype(np.float32), None),
            v: (("time", "latitude", "longitude"),
                np.stack([plane * (1 + 0.05 * k) for k in range(5)]).astype(np.float32), None)})
    proj = PolarStereo(lat0=90.0, lat_ts=60.0, lon0=-135.0)
    lat2, lon2 = (np.asarray(a) for a in proj.inverse(*np.meshgrid(np.linspace(-2e6, 2e6, 40),
                                                                    np.linspace(-2e6, 2e6, 36))))
    lam2 = np.deg2rad(lon2)
    topaz = {"uo": 0.1 * np.sin(lam2), "vo": 0.1 * np.cos(lam2), "zos": 0.2 * np.cos(2 * lam2),
             "thetao": -1.5 + 0 * lam2, "so": 33.0 + 0 * lam2, "mlotst": 20.0 + 0 * lam2,
             "siconc": np.clip((lat2 - 70.0) / 10.0, 0.0, 0.95), "sithick": 1.0 + 0 * lam2,
             "sisnthick": 0.1 + 0 * lam2}
    write(d / "2015" / "topaz_rean_201510.nc", {"time": 2, "y": 36, "x": 40}, {
        "time": (("time",), t0 + np.array([-12.0, 12.0]), b"hours since 1900-01-01 00:00:00"),
        "latitude": (("y", "x"), lat2, None), "longitude": (("y", "x"), lon2, None),
        **{v: (("time", "y", "x"), np.stack([a, 1.1 * a]).astype(np.float32), None) for v, a in topaz.items()}})
    elat, elon = np.arange(55.0, 90.01, 0.5), np.arange(-180.0, 180.0, 1.0)
    z = -3000.0 + 2900.0 * np.exp(-((elat[:, None] - 80.0) ** 2) / 20.0) * (np.cos(np.deg2rad(elon)) > 0.5)
    write(d / "ETOPO_Arctic_2arcmin.nc", {"lat": len(elat), "lon": len(elon)}, {
        "lat": (("lat",), elat.astype(np.float32), None), "lon": (("lon",), elon.astype(np.float32), None),
        "z": (("lat", "lon"), z.astype(np.float32), None)})


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_dataset_forcing_on_the_card_equals_the_cpu(cuda, dtype_name, tmp_path, monkeypatch):
    import dataclasses

    from nextsim_tpu_torch.forcing.datasets import DatasetForcing
    from nextsim_tpu_torch.grid.grid import Grid
    from nextsim_tpu_torch.utils.dates import string_to_datenum

    _write_small_datasets(tmp_path)
    monkeypatch.setenv("NEXTSIM_DATA_DIR", str(tmp_path))
    cfg = Config(overrides={"setup.atmosphere-type": "era5", "setup.ocean-type": "topaz4_rean",
                            "setup.bathymetry-type": "etopo", "simul.spinup_duration": 0.5})
    grid = Grid.square(nx=40, ny=36, dx=25e3, x0=-500e3, y0=-450e3)
    dt = {"float32": torch.float32, "float64": torch.float64}[dtype_name]
    gpu, cpu = DatasetForcing(cfg, grid, dt, device="cuda"), DatasetForcing(cfg, grid, dt, device="cpu")
    t_init = string_to_datenum("2015-10-16 00:00:00")
    for hours in (0.1, 1.5, 2.75):
        t = t_init + hours / 24.0
        a, b = gpu(t, t_init), cpu(t, t_init)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert x.device.type == "cuda" and x.dtype == dt, f.name
                torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0, msg=f.name)
    assert float(a.ocean_u.abs().max()) > 0.0 and float(a.wind_u.std()) > 0.0 and float(a.depth.std()) > 0.0


# ---------------------------------------------------------------------------
# the ring exchange and the WIM's blocks on the card
# ---------------------------------------------------------------------------

def test_ring_exchange_gradcheck_on_the_card(cuda):
    """``RingExchange`` on planes on the card (two ranks sharing it: gloo,
    the strips staged through pinned host memory) passes gradcheck in
    float64, for a cell, a node and three stacked planes in one ring."""
    import torch_mesh_worker as worker
    from nextsim_tpu_torch.parallel.distributed import run_world

    run_world(worker.ring_gradcheck, 2, args=(8, 5, 2, ("cell", "node", "stack"), "cuda"), device="cuda",
              timeout=300)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("advopt", ["y-periodic", "xy-periodic"])
def test_wim_step_on_ext_blocks_equals_the_whole_grid(cuda, advopt, dtype_name):
    """The WIM on a device mesh without the ranks: on every block of a 2x2
    mesh over the 16 x 64 strip, in the WIM's layout (rings of WIM_RING
    cells, periodic where ``advopt`` wraps), the whole grid's spectrum and
    floe fields cut as an exchange leaves them; one ``wim_time_step`` on
    the block gives the owned cells of the whole grid's step, bitwise,
    three steps running."""
    import torch_mesh_worker as worker
    from nextsim_tpu_torch.wim import wim as pw

    dtype = getattr(torch, dtype_name)
    w = pw.Wim(pw.WimParams(nwavefreq=5, nwavedirn=8, steady=True, advopt=advopt), worker.PatchGrid(), dtype,
               device="cuda")
    worker.patchy_setup(w)
    medium = pw.update_wave_medium(w.ice["thick"], w.ice["mask"], w._sg_dev, w.p)
    dt = w._tensor(w.dt_cfl)
    states = [(w.sdf, w.ice)]
    for _ in range(3):
        sdf, ice, _ = pw.wim_time_step(*states[-1], medium, w._sg_dev, w.p, dt, w.dx, w.land, w._steady_in)
        states.append((sdf, ice))
    for rank in range(4):
        lay = seam.BlockLayout(16, 64, 2, 2, *divmod(rank, 2), seam.WIM_RING,
                               (True, advopt == "xy-periodic"))
        ext = lay.to_ext
        steady = tuple(ext(x) for x in w._steady_in)
        for g in range(3):
            sdf, ice, _ = pw.wim_time_step(ext(states[g][0]), ext(states[g][1]), ext(medium), w._sg_dev, w.p, dt,
                                           w.dx, ext(w.land), steady, block=pw._freq_block(w.sdf))
            for name, o, r in [("sdf", sdf, states[g + 1][0])] + [(k, ice[k], states[g + 1][1][k])
                                                                   for k in ("dfloe", "nfloes", "broken")]:
                torch.testing.assert_close(lay.owned(o), lay.owned(ext(r)), rtol=0, atol=0,
                                           msg=lambda m: f"block {rank}, step {g}, {name}: {m}")


# ---------------------------------------------------------------------------
# the step and chunk programs: one CUDA graph replay a call
# ---------------------------------------------------------------------------

def _bench464(**over):
    from nextsim_tpu_torch.bench import bench_overrides

    return dict(bench_overrides(464), **{"simul.spinup_duration": 0.0, "ideal_simul.constant_wind_u": 20.0},
                **over)


def _equal_states(a, b, what):
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), (what, f.name)
        if x is not None:
            assert x.device.type == "cuda" and torch.equal(x, y), (what, f.name)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_captured_step_and_chunk_equal_the_eager_loop(cuda, dyn_type, dtype_name):
    """At 464^2 (bench.py's arctic, 120 substeps): ``step`` (the one-step
    graph) and ``step_chunk(3)`` (the three-step graph), each captured at
    its first call and replayed at the second, equal ``step_eager`` and
    ``step_chunk_eager`` bitwise; a replay counts its graph's kernel
    launches; a state taken before a replay keeps its values."""
    over = _bench464(**{"setup.dynamics-type": dyn_type, "tpu.dtype": dtype_name})
    a = Simulator(Config(overrides=over), device="cuda")
    b = Simulator(Config(overrides=over), device="cuda")
    per_step = _launches(a, a.dyn.substeps)
    for i, (k, run_a, run_b) in enumerate([(1, a.step, b.step_eager), (1, a.step, b.step_eager),
                                           (3, lambda: a.step_chunk(3), lambda: b.step_chunk_eager(3)),
                                           (3, lambda: a.step_chunk(3), lambda: b.step_chunk_eager(3))]):
        before, snap = a.state, a.state.vt_u.clone()
        launches = momentum_cuda.launches
        run_a()
        assert momentum_cuda.launches == launches + k * per_step, i
        run_b()
        _equal_states(a.state, b.state, f"call {i}")
        assert torch.equal(before.vt_u, snap), i
    assert len(a._program.graphs) == 2 and not b._program.graphs
    stats = a._program.stats
    assert stats["kernel_launches"] == 3 * per_step and (stats["nodes"] is None or stats["nodes"] > 3 * per_step)
    assert float(a.state.vt_u.abs().max()) > 0.0 and bool(torch.isfinite(a.state.vt_u).all())


def test_captured_thermo_chunk_across_a_day_boundary(cuda):
    """464^2, thermodynamics on, two 30-step chunks from 21:20: the second
    (a replay) crosses midnight (the day's end at its 18th step, the next
    day's start at its 19th), and its time flags reach the graph through its
    flag buffer; it equals the eager loop bitwise."""
    over = _bench464(**{"thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0,
                        "ideal_simul.init_concentration": 0.95, "ideal_simul.init_thickness": 1.5,
                        "simul.time_init": "2015-10-16 21:20:00", "tpu.steps_per_call": 30})
    a = Simulator(Config(overrides=over), device="cuda")
    b = Simulator(Config(overrides=over), device="cuda")
    for chunk in range(2):
        flags = a.time_flags([a.time_info_at(a.current_time + i * a.dt / 86400.0) for i in range(30)])
        a.step_chunk()
        b.step_chunk_eager()
        _equal_states(a.state, b.state, f"chunk {chunk}")
    day_end = flags[:, 1].nonzero().flatten().tolist()
    day_start = flags[:, 0].nonzero().flatten().tolist()
    assert day_end == [17] and day_start == [18], (day_end, day_start)
    assert len(a._program.graphs) == 1 and float(a.state.conc.max()) > 0.5


def test_captured_dataset_chunks_refresh_their_forcing(cuda, tmp_path, monkeypatch):
    """The dataset path (ERA5 + TOPAZ4 + ETOPO, thermo on) over two 3-step
    chunks whose forcing differs: the second chunk (a replay) equals the
    eager loop bitwise, so the static buffers took the new forcing."""
    from nextsim_tpu_torch.grid.grid import Grid

    _write_small_datasets(tmp_path)
    monkeypatch.setenv("NEXTSIM_DATA_DIR", str(tmp_path))
    over = dict(THERMO, **{"setup.atmosphere-type": "era5", "setup.ocean-type": "topaz4_rean",
                           "setup.bathymetry-type": "etopo", "simul.time_init": "2015-10-16 00:00:00",
                           "simul.spinup_duration": 0.0, "tpu.steps_per_call": 3})
    grid = Grid.square(nx=40, ny=36, dx=25e3, x0=-500e3, y0=-450e3)
    a = Simulator(Config(overrides=over), grid=grid, device="cuda")
    b = Simulator(Config(overrides=over), grid=grid, device="cuda")
    winds = []
    for chunk in range(2):
        a.step_chunk()
        b.step_chunk_eager()
        _equal_states(a.state, b.state, f"chunk {chunk}")
        winds.append(a.last_forcing.wind_u.clone())
    assert not torch.equal(winds[0], winds[1])
    assert len(a._program.graphs) == 1


#: the phases of a bbm step with thermodynamics on, in order
STEP_PHASES = ["thermo", "momentum.setup", "momentum.substeps", "momentum.smoother", "transport", "checks", "sums"]


def _phase_run_order(table):
    """The table's phases in the order they run, repeats of a phase merged."""
    out = []
    for phase, _kind, _n in table:
        if phase != "unattributed" and (not out or out[-1] != phase):
            out.append(phase)
    return out


def test_captured_chunk_carries_its_phase_table(cuda, monkeypatch):
    """At 464^2 thermo on, a 3-step chunk's graph: its phase table lists
    every node (``stats["nodes"]``) in the step's phase order, a few
    unattributed; ``momentum.substeps`` holds the loop's launches alone; the
    same chunk captured with the phases made no-ops (no marks recorded) has
    as many nodes; a profiled replay aligns with the table
    (``benchmark/phases.py``), its substep kernels where the table has them."""
    import contextlib

    from benchmark import phases, tracing
    from nextsim_tpu_torch.utils import timer

    over = _bench464(**{"thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0,
                        "ideal_simul.init_concentration": 0.95, "ideal_simul.init_thickness": 1.5})
    a = Simulator(Config(overrides=over), device="cuda")
    a.step_chunk(3)
    stats = a._program.stats
    table = stats["phases"]
    assert table is not None and sum(n for _, _, n in table) == stats["nodes"]
    assert stats["warmup_s"] > 0.0
    # the first step has no running sums yet (moorings off: the flags' max
    # starts at the second step)
    assert _phase_run_order(table) == STEP_PHASES[:-1] + STEP_PHASES * 2
    substeps = [r for r in table if r[0] == "momentum.substeps"]
    assert {r[1] for r in substeps} == {"kernel"}
    assert sum(r[2] for r in substeps) == 3 * _launches(a, a.dyn.substeps)
    assert sum(n for p, _, n in table if p == "unattributed") < 0.01 * stats["nodes"]

    with monkeypatch.context() as m:
        m.setattr(timer, "recording", lambda marks: contextlib.nullcontext())
        b = Simulator(Config(overrides=over), device="cuda")
        b.step_chunk(3)
    assert b._program.stats["nodes"] == stats["nodes"]
    assert {p for p, _, _ in b._program.stats["phases"]} == {"unattributed"}

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        a.step_chunk(3)
        torch.cuda.synchronize()
    trace = tracing.from_profiler(prof, 1.0, 3)
    got = phases.split(trace, [stats])
    assert got is not None and set(STEP_PHASES) <= set(got)
    assert got["momentum.substeps"]["kernels"] == 3 * _launches(a, a.dyn.substeps)
    assert sum(v["kernels"] for v in got.values()) == sum(n for _, k, n in table if k == "kernel")
    assert 0.0 < sum(v["s"] for v in got.values()) <= sum(e - s for _, s, e in trace.device)


# ---------------------------------------------------------------------------
# members: the batched launch and the batched ensemble step
# ---------------------------------------------------------------------------

def _member_setup(dyn_type, dtype_name, n=3):
    """n members' loops on the 33^2 square, each after a step under its own
    wind: (sim, consts, carry, [(consts, carry) of each member]); a plane
    every member has equal stays one shared 2-D plane, the others are
    stacked on a member axis."""
    loops = [_setup(dyn_type, dtype_name, **{"ideal_simul.constant_wind_u": 8.0 + 3.0 * m,
                                             "ideal_simul.constant_wind_v": -2.0 * m}) for m in range(n)]
    consts = {}
    for name in vars(loops[0][1]):
        vals = [getattr(c, name) for _, c, _ in loops]
        shared = not isinstance(vals[0], torch.Tensor) or all(torch.equal(v, vals[0]) for v in vals)
        consts[name] = vals[0] if shared else torch.stack(vals)
    carry = tuple(torch.stack(planes) for planes in zip(*(cr for _, _, cr in loops)))
    return loops[0][0], SimpleNamespace(**consts), carry, [(c, cr) for _, c, cr in loops]


@pytest.mark.parametrize("steps", [3, 40])
@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_batched_kernel_equals_single_launches_and_the_plain_loop(cuda, dyn_type, dtype_name, steps):
    sim, consts, carry, singles = _member_setup(dyn_type, dtype_name)
    assert any(isinstance(v, torch.Tensor) and v.ndim == 2 for v in vars(consts).values())
    launches = momentum_cuda.launches
    out = _loop(momentum_cuda.substep_loop, sim, consts, carry, steps)
    assert momentum_cuda.launches == launches + momentum_cuda.launches_for(
        steps, 33, 33, sim.dtype, dyn_type, members=3)
    plain = _loop(momentum_cuda.substep_loop_reference, sim, consts, carry, steps)
    torch.cuda.synchronize()
    assert not torch.equal(out[0][0], out[0][2])
    for m, (c, cr) in enumerate(singles):
        one = _loop(momentum_cuda.substep_loop, sim, c, cr, steps)
        for name, o, p, r in zip(momentum_cuda._STATE, out, plain, one):
            assert o.shape == (3,) + r.shape and bool(torch.isfinite(o).all()), name
            assert torch.equal(o[m], r), f"member {m} {name}: batched launch vs single launch"
            assert torch.equal(o[m], p[m]), f"member {m} {name}: batched launch vs plain loop"


def test_batched_kernel_refuses_a_bad_member_stride(cuda):
    """The kernel's own check: a written state plane that all members would
    share (stride 0), or a stride that is no plane's size, is
    cudaErrorInvalidValue; the wrapper refuses a plane of another member
    count before that."""
    sim, consts, carry, _ = _member_setup("bbm", "float32", n=2)
    state, planes, strides = momentum_cuda._kernel_inputs(consts, carry, "bbm")
    planes.update(state)
    plan = momentum_cuda._default_plan(carry, 3, "bbm")
    second = {n: torch.empty_like(state[n]) for n in momentum_cuda._STATE}
    for bad in ({"sxx": 0}, {"conc": 7}):
        with pytest.raises(RuntimeError, match="invalid argument"):
            momentum_cuda._launch(planes, second, plan, (3,), sim.dt / 40, sim.dt, sim.grid.dx, "bbm",
                                  sim.dyn, dict(strides, **bad))
    three = SimpleNamespace(**dict(vars(consts), tau_ax=torch.stack([consts.tau_ax[0]] * 3)))
    with pytest.raises(ValueError, match="tau_ax"):
        _loop(momentum_cuda.substep_loop, sim, three, carry, 3)


@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_captured_batched_step_equals_eager_and_the_member_loop(cuda, dyn_type):
    """464^2 thermo on, 3 members (the control and 2 perturbed), 3 steps:
    ``step`` (one replay of the batched step's graph, captured at its first
    call) equals the eager batched step and ``step_members`` bitwise, every
    member; a batched step launches the kernel one loop's worth for all
    members, the member loop three."""
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble

    over = _bench464(**{"setup.dynamics-type": dyn_type, "thermo.use_thermo_forcing": True,
                        "ideal_simul.init_SST_limit": 10.0})
    ens = [BatchedEnsemble(Config(overrides=over), 3, device="cuda") for _ in range(3)]
    ens[1]._program.capture = False  # the eager batched step
    per_loop = momentum_cuda.launches_for(ens[0].sim.dyn.substeps, 464, 464, ens[0].sim.dtype, dyn_type, members=3)
    one_loop = _launches(ens[0].sim, ens[0].sim.dyn.substeps)
    for step in range(3):
        for e, run, want in ((ens[0], ens[0].step, per_loop), (ens[1], ens[1].step, per_loop),
                             (ens[2], ens[2].step_members, 3 * one_loop)):
            launches = momentum_cuda.launches
            run()
            assert momentum_cuda.launches == launches + want, step
        for k in range(3):
            for other in ens[1:]:
                _equal_states(ens[0].member_state(k), other.member_state(k), f"step {step}, member {k}")
    assert len(ens[0]._program.graphs) == 1 and not ens[1]._program.graphs
    assert ens[0]._program.stats["kernel_launches"] == per_loop and not ens[0].violations.any()
    assert not torch.equal(ens[0].member_state(1).vt_u, ens[0].member_state(2).vt_u)


# ---------------------------------------------------------------------------
# Roach welding
# ---------------------------------------------------------------------------

WELD_BINS = 6
WELD_DT = 900.0
# 24^2 of full ice with thermodynamics and a 6-bin FSD with Roach welding:
# the ice grows at the second step, where welding acts on broken floes
WELD_SIM = {
    "grid.preset": "square", "grid.nx": 24, "grid.ny": 24, "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00", "dynamics.substeps": 20,
    "thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0, "setup.ice-type": "constant",
    "setup.atmosphere-type": "constant", "setup.ocean-type": "constant", "ideal_simul.constant_wind_u": 10.0,
    "simul.spinup_duration": 0.0, "wave_coupling.num_fsd_bins": WELD_BINS, "wave_coupling.welding_type": "roach",
}


def _weld_params(scaled=False, n=WELD_BINS):
    p = fsd.FSDParams(num_bins=n, bin_cst_width=40.0, welding_type="roach", welding_use_scaled_area=scaled)
    return p, fsd.make_bins(p)


def _weld_stack(seed, dtype_name, shape=(48, 48), n=WELD_BINS):
    """An FSD with open water, unbroken, empty and broken cells and a
    freezing mask, on the card: (conc_fsd, freezing)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ctot = rng.uniform(0.0, 1.0, shape) * (rng.uniform(0, 1, shape) > 0.2)
    w = rng.uniform(0.0, 1.0, (n,) + shape) ** 3
    unbroken = rng.uniform(0, 1, shape) > 0.7
    w[:-1, unbroken] = 0.0
    w[-1, unbroken] = 1.0
    cf = w / w.sum(0) * ctot
    dtype = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}[dtype_name]
    return (torch.tensor(cf, dtype=dtype, device="cuda"),
            torch.as_tensor(rng.uniform(0, 1, shape) > 0.3, device="cuda"))


def _seed_broken(states, seed=8):
    """Member-first FSD stacks spread over the bins from a numpy seed."""
    import numpy as np

    cf = states.conc_fsd
    w = torch.as_tensor(np.random.default_rng(seed).uniform(0.0, 1.0, cf.shape), dtype=cf.dtype, device=cf.device)
    axis = 1 if cf.ndim == 4 else 0
    return states.replace(conc_fsd=(w / w.sum(axis, keepdim=True) * cf.sum(axis, keepdim=True)).contiguous())


def _same(a, b):
    """Bitwise equal where a value is a number, NaN in the same places
    (unscaled areas overflow in a few cells of these random stacks, in the
    plain version as in the kernel)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_welding_kernel_equals_plain(cuda, dtype_name, scaled):
    p, bins = _weld_params(scaled)
    cf, freezing = _weld_stack(1, dtype_name)
    launches = welding_cuda.launches
    out = fsd.welding_roach(cf, WELD_DT, p, bins, freezing)
    assert welding_cuda.launches == launches + welding_cuda.LAUNCHES_A_CALL
    ref = fsd.welding_roach_reference(cf, WELD_DT, p, bins, freezing)
    active = freezing & (cf[:-1].sum(0) > 0.01) & (cf.sum(0) > 0.1)
    assert int(active.sum()) > 100 and not torch.equal(ref, cf)
    assert out.dtype == cf.dtype and _same(out, ref)
    assert float(torch.isfinite(ref).float().mean()) > 0.99


def _weld_case(case, dtype_name, p, bins, shape=(48, 48), seed=11):
    """(conc_fsd, freezing) on the card for one of the kernel's cases."""
    import numpy as np

    if case == "scattered, mixed counts":  # a fifth of the cells, at random
        cf, freezing = _weld_stack(seed, dtype_name, shape=shape, n=p.num_bins)
        rng = np.random.default_rng(seed + 1)
        return cf, freezing & torch.as_tensor(rng.uniform(0, 1, shape) < 0.2, device="cuda")
    if case == "no active cell":
        cf, freezing = _weld_stack(seed, dtype_name, shape=shape, n=p.num_bins)
        return cf, torch.zeros_like(freezing)
    # every cell active: broken floes (the last bin under half) and ctot > 0.1
    rng = np.random.default_rng(seed)
    ctot = rng.uniform(0.2, 1.0, shape)
    w = rng.uniform(0.1, 1.0, (p.num_bins,) + shape)
    w[-1] *= 0.2
    dtype = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}[dtype_name]
    cf = torch.tensor(w / w.sum(0) * ctot, dtype=dtype, device="cuda")
    return cf, torch.ones(shape, dtype=torch.bool, device="cuda")


def _weld_equals_plain(cf, freezing, p, bins):
    """One kernel call against the plain version: bitwise, NaN in the same
    places; returns (the result, the number of active cells)."""
    launches = welding_cuda.launches
    out = fsd.welding_roach(cf, WELD_DT, p, bins, freezing)
    assert welding_cuda.launches == launches + welding_cuda.LAUNCHES_A_CALL
    ref = fsd.welding_roach_reference(cf, WELD_DT, p, bins, freezing)
    assert out.dtype == cf.dtype and _same(out, ref)
    return out, int((freezing & (cf[:-1].sum(0) > 0.01) & (cf.sum(0) > 0.1)).sum())


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("case, shape", [("no active cell", (48, 48)), ("every cell active", (48, 48)),
                                         ("scattered, mixed counts", (48, 48)),
                                         ("every cell active", (37, 29))])  # 1,073 cells: no multiple of a block
def test_welding_kernel_cases(cuda, case, shape, dtype_name):
    p, bins = _weld_params(True)
    cf, freezing = _weld_case(case, dtype_name, p, bins, shape)
    out, active = _weld_equals_plain(cf, freezing, p, bins)
    cells = shape[0] * shape[1]
    assert cells % 64 or shape == (48, 48)
    if case == "no active cell":
        assert active == 0 and torch.equal(out, cf)
    elif case == "every cell active":
        assert active == cells and not torch.equal(out, cf)
    else:
        on = freezing & (cf[:-1].sum(0) > 0.01) & (cf.sum(0) > 0.1)
        ndt = torch.ceil(WELD_DT * p.welding_kappa * cf.sum(0).double() * float(bins.scaled_up[-1]) + 0.5)
        assert 50 < active < cells // 3 and len(torch.unique(ndt[on])) > 5  # counts mixed within warps
        assert not torch.equal(out, cf)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_welding_kernel_under_other_plans_in_one_process(cuda, dtype_name):
    """Other bin edges at the same count, another count and undefined merge
    bins: each plan builds its own library, every call equals the plain
    version."""
    import dataclasses

    p, bins = _weld_params(True)
    alpha = bins.alpha_merge.copy()
    alpha[3, 1] = alpha[5, 0] = -999
    plans = {"6 bins of 40 m": (p, bins), "undefined merge bins": (p, dataclasses.replace(bins, alpha_merge=alpha))}
    for name, kw in (("6 bins of 10 m", dict(bin_cst_width=10.0)), ("7 bins", dict(num_bins=7))):
        q = fsd.FSDParams(**dict(dict(num_bins=WELD_BINS, bin_cst_width=40.0, welding_type="roach",
                                      welding_use_scaled_area=True), **kw))
        plans[name] = (q, fsd.make_bins(q))
    defines = {welding_cuda.plan_defines(b, q.num_bins) for q, b in plans.values()}
    assert len(defines) == len(plans)
    for name, (q, b) in plans.items():
        cf, freezing = _weld_stack(12, dtype_name, shape=(24, 24), n=q.num_bins)
        _, active = _weld_equals_plain(cf, freezing, q, b)
        assert active > 50, name
    assert defines <= set(welding_cuda._libs)


@pytest.mark.parametrize("dtype_name", ["float64", "float32", "bfloat16"])
def test_welding_kernel_at_32_bins(cuda, dtype_name):
    """The most bins the kernel takes, unscaled areas (every active cell to
    the cap of 256 substeps): float64 holds ~130 doubles a cell."""
    p, bins = _weld_params(False, n=32)
    cf, freezing = _weld_stack(13, dtype_name, shape=(24, 24), n=32)
    out, active = _weld_equals_plain(cf, freezing, p, bins)
    assert active > 50 and not torch.equal(out, cf)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_captured_welding_call_replays_twice(cuda, dtype_name):
    """One call captured in a CUDA graph (the memset and both kernels):
    two replays give the plain version's bits, the second the first's (a
    count of active cells that were not zeroed would grow)."""
    p, bins = _weld_params(True)
    cf, freezing = _weld_stack(14, dtype_name)
    ref = fsd.welding_roach_reference(cf, WELD_DT, p, bins, freezing)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the build and a warm call outside the capture
        fsd.welding_roach(cf, WELD_DT, p, bins, freezing)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = welding_cuda.launches
    with torch.cuda.graph(graph):
        out = fsd.welding_roach(cf, WELD_DT, p, bins, freezing)
    assert welding_cuda.launches == launches + welding_cuda.LAUNCHES_A_CALL
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert _same(first, ref) and _same(out, first) and not torch.equal(first, cf)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_batched_welding_launch_equals_single_launches(cuda, dtype_name):
    p, bins = _weld_params(True)
    members = [_weld_stack(seed, dtype_name, shape=(24, 24)) for seed in (2, 3, 4)]
    cf = torch.stack([c for c, _ in members], dim=1)
    freezing = torch.stack([f for _, f in members])
    launches = welding_cuda.launches
    out = fsd.welding_roach(cf, WELD_DT, p, bins, freezing)
    assert welding_cuda.launches == launches + welding_cuda.LAUNCHES_A_CALL
    for m, (c, f) in enumerate(members):
        assert torch.equal(out[:, m], fsd.welding_roach(c, WELD_DT, p, bins, f)), m
    assert torch.equal(out, fsd.welding_roach_reference(cf, WELD_DT, p, bins, freezing))


def test_welding_empty_stack_launches_nothing(cuda):
    """A stack of no cells: the C launcher returns before the memset and
    both kernels and reports none, so nothing is counted."""
    p, bins = _weld_params()
    cf = torch.zeros((WELD_BINS, 0, 7), device="cuda")
    launches = welding_cuda.launches
    out = fsd.welding_roach(cf, WELD_DT, p, bins, torch.zeros((0, 7), dtype=torch.bool, device="cuda"))
    assert tuple(out.shape) == (WELD_BINS, 0, 7) and welding_cuda.launches == launches


def test_welding_kernel_refuses_another_bin_count(cuda, monkeypatch):
    """A library is built for one bin count: called with another, the
    kernel itself refuses (cudaErrorInvalidValue), and nothing is counted."""
    six = welding_cuda._library(welding_cuda.plan_defines(_weld_params()[1], WELD_BINS))
    assert six.nextsim_welding_nbins() == WELD_BINS
    monkeypatch.setattr(welding_cuda, "_library", lambda defines: six)
    p, bins = _weld_params(n=WELD_BINS + 1)
    cf, freezing = _weld_stack(5, "float32", n=WELD_BINS + 1)
    launches = welding_cuda.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        fsd.welding_roach(cf, WELD_DT, p, bins, freezing)
    assert welding_cuda.launches == launches


def test_welding_gradient_on_the_card(cuda):
    """float64: the gradient through WeldingRoach (the kernel forward) equals
    straight autograd through the plain version on the card, bitwise, and
    welding moves it away from the identity."""
    p, bins = _weld_params(True)
    cf, freezing = _weld_stack(6, "float64", shape=(24, 24))
    w = torch.rand(cf.shape, dtype=cf.dtype, device="cuda", generator=torch.Generator("cuda").manual_seed(3))

    def grad_of(fn):
        leaf = cf.clone().requires_grad_(True)
        out = fn(leaf)
        (g,) = torch.autograd.grad((out * w).sum(), leaf)
        return out, g

    launches = welding_cuda.launches
    out, got = grad_of(lambda x: fsd.welding_roach(x, WELD_DT, p, bins, freezing))
    assert welding_cuda.launches == launches + welding_cuda.LAUNCHES_A_CALL
    assert type(out.grad_fn).__name__ == "WeldingRoachBackward"
    ref, plain = grad_of(lambda x: fsd.welding_roach_reference(x, WELD_DT, p, bins, freezing))
    assert torch.equal(out.detach(), ref.detach()) and torch.equal(got, plain)
    assert float((got - w).abs().max()) > 1e-6


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_captured_welding_chunk_equals_the_eager_loop(cuda, dtype_name):
    """The FSD configuration (no eager reason now): two 2-step chunks, the
    second a replay, equal the eager loop bitwise; the graph holds one
    welding call a step, and welding acts."""
    over = dict(WELD_SIM, **{"tpu.dtype": dtype_name})
    a = Simulator(Config(overrides=over), device="cuda")
    b = Simulator(Config(overrides=over), device="cuda")
    assert a.eager_reason is None
    a.state = _seed_broken(a.state)
    b.state = _seed_broken(b.state)
    before = a.state.conc_fsd.clone()
    for chunk in range(2):
        launches = welding_cuda.launches
        a.step_chunk(2)
        assert welding_cuda.launches == launches + 2 * welding_cuda.LAUNCHES_A_CALL, chunk
        b.step_chunk_eager(2)
        _equal_states(a.state, b.state, f"chunk {chunk}")
    assert len(a._program.graphs) == 1 and a._program.stats["welding_launches"] == 2 * welding_cuda.LAUNCHES_A_CALL
    assert not torch.equal(a.state.conc_fsd, before)


def test_batched_step_with_welding_equals_the_member_loop(cuda):
    """3 members (the control and 2 perturbed) of the FSD configuration, 3
    steps: the batched step (one graph replay) equals ``step_members``
    bitwise, every member; a batched step calls the welding kernel once
    for all members, the member loop once a member."""
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble

    a = BatchedEnsemble(Config(overrides=WELD_SIM), 3, device="cuda")
    b = BatchedEnsemble(Config(overrides=WELD_SIM), 3, device="cuda")
    a.states = _seed_broken(a.states)
    b.states = _seed_broken(b.states)
    for step in range(3):
        for run, calls in ((a.step, 1), (b.step_members, 3)):
            launches = welding_cuda.launches
            run()
            assert welding_cuda.launches == launches + calls * welding_cuda.LAUNCHES_A_CALL, step
        for k in range(3):
            _equal_states(a.member_state(k), b.member_state(k), f"step {step}, member {k}")
    assert len(a._program.graphs) == 1 and a._program.stats["welding_launches"] == welding_cuda.LAUNCHES_A_CALL


# ---------------------------------------------------------------------------
# a perturbed member's noise inside the step and chunk graphs
# ---------------------------------------------------------------------------

def _pert464(dtype_name="float32", member=2):
    return Simulator(Config(overrides=_bench464(**{
        "thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0,
        "statevector.ensemble_member": member, "tpu.dtype": dtype_name})), device="cuda")


def _same_stream(a, b, what):
    """State, AR(1) carry, generator and last perturbed forcing, bitwise."""
    _equal_states(a.state, b.state, what)
    assert torch.equal(a._pert_state, b._pert_state), what
    assert torch.equal(a._ens_pert.generator.get_state(), b._ens_pert.generator.get_state()), what
    for name in ("tair", "mslp", "precip", "wind_u", "wind_v"):
        assert torch.equal(getattr(a.last_forcing, name), getattr(b.last_forcing, name)), (what, name)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_captured_perturbed_step_and_chunk_equal_the_eager_loop(cuda, dtype_name):
    """464^2 thermo on, bbm, member 2: ``step`` (the one-step graph) and
    ``step_chunk(3)`` (the three-step graph), each captured at its first
    call (the warm-up draws eagerly) and replayed at the second, with the
    member's generator registered, equal the eager loop bitwise: state,
    carry, generator state and the last perturbed forcing."""
    a, b = _pert464(dtype_name), _pert464(dtype_name)
    assert a.eager_reason is None
    per_step = _launches(a, a.dyn.substeps)
    for i, (k, run_a, run_b) in enumerate([(1, a.step, b.step_eager), (1, a.step, b.step_eager),
                                           (3, lambda: a.step_chunk(3), lambda: b.step_chunk_eager(3)),
                                           (3, lambda: a.step_chunk(3), lambda: b.step_chunk_eager(3))]):
        launches = momentum_cuda.launches
        run_a()
        assert momentum_cuda.launches == launches + k * per_step, i
        run_b()
        _same_stream(a, b, f"call {i}")
    assert len(a._program.graphs) == 2 and a._program.stats["generators"] == 1


def test_perturbed_replays_draw_new_noise_and_set_state_rewinds_them(cuda):
    """Replays of the one-step graph: each draws new noise (the generator's
    offset moves by the graph's increment, the perturbation of the constant
    forcing changes); ``set_state`` back to an earlier generator state,
    with the state and carry of then, makes the next replay repeat that
    step's draws bitwise."""
    sim = _pert464()
    sim.step()  # the warm-up and the capture
    base = sim._ens_pert.provider(sim.current_time, sim.time_init)
    noise, gens = [], []
    for _ in range(2):
        gens.append(sim._ens_pert.generator.get_state())
        sim.step()
        noise.append(sim.last_forcing.tair - base.tair)
    assert not torch.equal(noise[0], noise[1]) and not torch.equal(gens[0], gens[1])
    assert len(sim._program.graphs) == 1
    snap = (sim.state, sim._pert_state.clone(), sim._ens_pert.generator.get_state(), sim.pcpt)
    sim.step()
    first = (sim.state, sim._pert_state.clone(), sim.last_forcing.tair.clone(), sim._ens_pert.generator.get_state())
    sim.state, sim._pert_state, sim.pcpt = snap[0], snap[1].clone(), snap[3]
    sim._ens_pert.generator.set_state(snap[2])
    sim.step()
    _equal_states(first[0], sim.state, "rewound replay")
    assert torch.equal(first[1], sim._pert_state) and torch.equal(first[2], sim.last_forcing.tair)
    assert torch.equal(first[3], sim._ens_pert.generator.get_state())


def test_captured_batched_draws_equal_the_member_loop_across_a_restore(cuda):
    """464^2 thermo on, 3 members (2 perturbed): the batched step's graph
    draws every member's noise (the generators registered) and equals
    ``step_members`` bitwise; a snapshot of the stack, carry and generator
    states restored before a replay repeats it bitwise, as phase 19 and a
    checkpoint rely on."""
    from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble

    over = _bench464(**{"thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0})
    a = BatchedEnsemble(Config(overrides=over), 3, device="cuda")
    b = BatchedEnsemble(Config(overrides=over), 3, device="cuda")
    a._member_forcings = None  # the batched step draws in its graph
    for step in range(3):
        if step == 2:
            snap = (a.states, a._ran.clone(), [g.get_state() for g in a.generators], a.pcpt)
            a.step()
            once = a.states
            a.states, a._ran, a.pcpt = snap[0], snap[1].clone(), snap[3]
            for g, st in zip(a.generators, snap[2]):
                g.set_state(st)
        a.step()
        b.step_members()
        for k in range(3):
            _equal_states(a.member_state(k), b.member_state(k), f"step {step}, member {k}")
        assert torch.equal(a._ran, b._ran), step
    _equal_states(once, a.states, "the restored replay")
    assert len(a._program.graphs) == 1 and a._program.stats["generators"] == 2
    assert not torch.equal(a.member_state(1).vt_u, a.member_state(2).vt_u)


# ---------------------------------------------------------------------------
# transport and ridging: one launch of csrc/transport_ridge.cu a call
# ---------------------------------------------------------------------------

TR_DT, TR_DX = 900.0, 5e3
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _transport_state(shape, dtype_name, seed=0, members=None, bins=0):
    """A moving state on the card with every branch of transport in reach:
    open water, fronts of tiny values (subnormal limiter products in
    float32), young ice that ridges, land and an open boundary. Its planes
    carry a leading member axis when ``members`` is given (member-minor),
    ``bins`` floe-size bins when given. Returns (state, grid_arrays)."""
    import numpy as np

    from nextsim_tpu_torch.core.state import State, state_from_numpy

    rng = np.random.default_rng(seed)
    lead = () if members is None else (members,)
    ny, nx = shape
    cell, node = lead + (ny, nx), lead + (ny + 1, nx + 1)
    ice = rng.uniform(0, 1, cell) > 0.2
    u = lambda lo, hi, s=cell: rng.uniform(lo, hi, s)  # noqa: E731
    conc = u(0.5, 1.0) * ice
    tiny = 10.0 ** u(-36, -8)
    a = dict(
        conc=conc, thick=u(0.2, 2.0) * ice, snow_thick=u(0.0, 0.3) * ice, damage=u(0.0, 1.0),
        ridge_ratio=u(0.0, 0.3) * ice, tice=rng.uniform(-20.0, -0.3, (3,) + cell),
        sigma=rng.uniform(-3e4, 3e4, (3,) + cell), sst=u(-1.9, 2.0), sss=u(30.0, 35.0), tsurf_young=u(-10.0, 0.5),
        h_young=u(0.0, 0.05) * ice, hs_young=np.where(u(0, 1) > 0.7, tiny, u(0.0, 0.01)) * ice,
        conc_young=u(0.0, 0.25) * ice, random_number=u(0, 1), fyi_fraction=u(0.0, 1.2) * ice,
        age_det=u(0.0, 3e7) * ice, age=u(0.0, 3e7) * ice, conc_upd=u(-0.05, 0.05), conc_myi=u(0.0, 0.6) * ice,
        thick_myi=u(-0.1, 1.0) * ice, conc_summer=u(0.0, 1.1), thick_summer=u(-0.1, 2.0), pond_volume=u(-0.01, 0.1),
        lid_volume=u(-0.01, 0.05), vt_u=u(-0.5, 0.5, node), vt_v=u(-0.5, 0.5, node),
    )
    for f in State.__dataclass_fields__:
        if f not in a and f not in ("conc_fsd", "conc_mech_fsd"):
            a[f] = np.zeros(node if f in ("ut_u", "ut_v") else cell)
    if bins:
        w = rng.uniform(0.0, 1.0, (bins,) + cell) ** 2
        a["conc_fsd"] = w / w.sum(0) * (conc + a["conc_young"])
        a["conc_mech_fsd"] = a["conc_fsd"][::-1].copy()
    state = state_from_numpy(a, device="cuda", dtype=DTYPES[dtype_name])
    mask = (rng.uniform(0, 1, (ny, nx)) > 0.1).astype(float)
    mask[:, 0] = 0.0
    open_mask = np.zeros((ny, nx))
    open_mask[-1, :] = 1.0
    on = lambda x: torch.as_tensor(x, dtype=DTYPES[dtype_name], device="cuda")  # noqa: E731
    return state, {"mask": on(mask), "open_mask": on(open_mask * mask), "delta_x": TR_DX}


def _transport_params(second_order=True, young=True):
    from nextsim_tpu_torch.ops.transport import TransportParams

    return TransportParams(second_order=second_order, use_young_ice=young, newice_type=4 if young else 1)


def _same_transport(got, ref, what=""):
    """Two (state, diag) results: every field and diagnostic bitwise equal
    where a number, NaN in the same places."""
    import dataclasses

    (a, da), (b, db) = got, ref
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), (what, f.name)
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape and _same(x.detach(), y.detach()), (what, f.name)
    assert set(da) == set(db) and all(_same(da[k], db[k]) for k in da), what


@pytest.mark.parametrize("shape", [(37, 53), (1216, 1216)])
@pytest.mark.parametrize("young", [True, False])
@pytest.mark.parametrize("second_order", [True, False])
@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_transport_kernel_equals_plain(cuda, dtype_name, second_order, young, shape):
    from nextsim_tpu_torch.ops import transport, transport_cuda

    state, ga = _transport_state(shape, dtype_name, seed=1 + second_order + 2 * young)
    p = _transport_params(second_order, young)
    launches = transport_cuda.launches
    got = transport.transport_and_ridge(state, ga, TR_DT, p)
    assert transport_cuda.launches == launches + transport_cuda.LAUNCHES_A_CALL
    ref = transport.transport_and_ridge_reference(state, ga, TR_DT, p)
    _same_transport(got, ref)
    assert not torch.equal(ref[0].conc, state.conc) and not torch.equal(ref[0].sigma, state.sigma)
    assert (got[0].h_young is state.h_young) == (not young)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_transport_kernel_on_a_member_stack(cuda, dtype_name):
    """One launch on a member-minor stack of 3 members equals the plain
    version on the stack and each member's own call, the grid's mask shared
    by all (a member stride of 0)."""
    from nextsim_tpu_torch.ops import transport, transport_cuda

    stack, ga = _transport_state((45, 70), dtype_name, seed=5, members=3)
    p = _transport_params()
    launches = transport_cuda.launches
    got = transport.transport_and_ridge(stack, ga, TR_DT, p)
    assert transport_cuda.launches == launches + transport_cuda.LAUNCHES_A_CALL
    _same_transport(got, transport.transport_and_ridge_reference(stack, ga, TR_DT, p), "stack")

    def member(s, m):
        return s.replace(**{f: (t[:, m] if t.ndim == 4 else t[m]).contiguous() for f, t in vars(s).items()
                            if isinstance(t, torch.Tensor)})

    for m in range(3):
        one = transport.transport_and_ridge(member(stack, m), ga, TR_DT, p)
        _same_transport((member(got[0], m), {k: v[m] for k, v in got[1].items()}), one, f"member {m}")


@pytest.mark.parametrize("second_order", [True, False])
@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_transport_kernel_carries_fsd_bins(cuda, dtype_name, second_order):
    """Floe-size bins (both stacks, on a 2-member stack) through the stack
    entry: a launch a stack besides the core's, the plain version's bits."""
    from nextsim_tpu_torch.ops import transport, transport_cuda

    state, ga = _transport_state((40, 33), dtype_name, seed=7, members=2, bins=5)
    p = _transport_params(second_order)
    launches = transport_cuda.launches
    got = transport.transport_and_ridge(state, ga, TR_DT, p)
    assert transport_cuda.launches == launches + transport_cuda.LAUNCHES_A_CALL + 2
    _same_transport(got, transport.transport_and_ridge_reference(state, ga, TR_DT, p))
    assert not torch.equal(got[0].conc_fsd, state.conc_fsd)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_captured_transport_call_replays_twice(cuda, dtype_name):
    from nextsim_tpu_torch.ops import transport, transport_cuda

    state, ga = _transport_state((64, 96), dtype_name, seed=9)
    p = _transport_params()
    ref = transport.transport_and_ridge_reference(state, ga, TR_DT, p)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the build and a warm call outside the capture
        transport.transport_and_ridge(state, ga, TR_DT, p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = transport_cuda.launches
    with torch.cuda.graph(graph):
        got = transport.transport_and_ridge(state, ga, TR_DT, p)
    assert transport_cuda.launches == launches + transport_cuda.LAUNCHES_A_CALL
    graph.replay()
    first = got[0].conc.clone()
    graph.replay()
    torch.cuda.synchronize()
    _same_transport(got, ref)
    assert torch.equal(first, got[0].conc)


def test_transport_kernel_passes_nans_as_the_plain_version(cuda):
    """NaN in tracers, a stress and a velocity: the kernel's NaN where the
    plain version's (clamp, minimum and the gates pass them), so the
    step's checks still see one."""
    from nextsim_tpu_torch.ops import transport

    for dtype_name in ("float32", "bfloat16", "float64"):
        state, ga = _transport_state((48, 40), dtype_name, seed=13)
        nan = float("nan")
        fields = {f: getattr(state, f).clone() for f in ("conc", "thick", "damage", "sst", "sigma", "tice", "conc_young",
                                                         "vt_u", "hs_young")}
        fields["conc"][5, 7] = nan
        fields["thick"][20, 30] = nan
        fields["damage"][0, 0] = nan
        fields["sst"][47, 39] = nan
        fields["sigma"][1, 12, 12] = nan
        fields["tice"][1, 30, 10] = nan
        fields["conc_young"][40, 20] = nan
        fields["hs_young"][8, 8] = nan
        fields["vt_u"][25, 25] = nan
        state = state.replace(**fields)
        p = _transport_params()
        got = transport.transport_and_ridge(state, ga, TR_DT, p)
        ref = transport.transport_and_ridge_reference(state, ga, TR_DT, p)
        _same_transport(got, ref, dtype_name)
        assert bool(torch.isnan(got[0].conc).any()) and bool(torch.isnan(got[0].sigma).any()), dtype_name


def test_transport_gradient_on_the_card(cuda):
    """float64: the gradient through TransportRidge and AdvectStack (the
    kernel forward) equals straight autograd through the plain version on
    the card: bitwise for the state's planes and the bins; the velocities,
    which both Functions read, sum the two parts in another order (1e-14 of
    the largest)."""
    from nextsim_tpu_torch.ops import transport, transport_cuda

    base, ga = _transport_state((36, 44), "float64", seed=17, bins=3)
    p = _transport_params()
    wrt = ("conc", "thick", "tice", "sigma", "damage", "vt_u", "vt_v", "conc_fsd")
    gen = torch.Generator("cuda").manual_seed(4)

    def grads(fn):
        leaves = {f: getattr(base, f).clone().requires_grad_(True) for f in wrt}
        out, diag = fn(base.replace(**leaves), ga, TR_DT, p)
        gen.manual_seed(4)
        loss = sum((torch.rand(getattr(out, f).shape, dtype=torch.float64, device="cuda", generator=gen)
                    * getattr(out, f)).sum() for f in wrt[:5] + ("age", "ridge_ratio", "conc_fsd", "conc_mech_fsd"))
        loss = loss + 1e3 * diag["divergence"].sum() + diag["del_ci_ridge_myi"].sum()
        return out, torch.autograd.grad(loss, list(leaves.values()))

    launches = transport_cuda.launches
    out, got = grads(transport.transport_and_ridge)
    assert transport_cuda.launches == launches + transport_cuda.LAUNCHES_A_CALL + 2
    assert type(out.conc.grad_fn).__name__ == "TransportRidgeBackward"
    _, ref = grads(transport.transport_and_ridge_reference)
    for name, r, g in zip(wrt, ref, got):
        assert float(r.abs().max()) > 0.0, name
        if name in ("vt_u", "vt_v"):
            torch.testing.assert_close(g, r, rtol=0.0, atol=1e-14 * float(r.abs().max()), msg=name)
        else:
            assert torch.equal(r, g), name


def test_main_path_goes_through_the_transport_kernel(cuda, monkeypatch):
    """464^2 (bench.py's arctic, thermo on): an eager step and a captured
    3-step chunk never run the plain version on the card; the eager step
    launches LAUNCHES_A_CALL, the chunk's capture records three calls'
    launches and each replay counts them."""
    from nextsim_tpu_torch.ops import transport, transport_cuda

    def plain(*args):
        raise AssertionError("the plain transport ran on the card")

    over = _bench464(**{"thermo.use_thermo_forcing": True, "ideal_simul.init_SST_limit": 10.0})
    a = Simulator(Config(overrides=over), device="cuda")
    monkeypatch.setattr(transport, "transport_and_ridge_reference", plain)
    launches = transport_cuda.launches
    a.step_eager()
    assert transport_cuda.launches == launches + transport_cuda.LAUNCHES_A_CALL
    a.step_chunk(3)
    assert a._program.stats["transport_launches"] == 3 * transport_cuda.LAUNCHES_A_CALL
    launches = transport_cuda.launches
    a.step_chunk(3)
    assert transport_cuda.launches == launches + 3 * transport_cuda.LAUNCHES_A_CALL
    assert bool(torch.isfinite(a.state.conc).all()) and float(a.state.vt_u.abs().max()) > 0.0
