"""Reverse mode through the PyTorch port's dynamics, on the CPU: the
counterparts of tests/test_grad.py's dynamics tests, and the tests of
``momentum_cuda.SubstepLoop``, the checkpointed Function that carries the
substep loop's gradient on the card.

Each counterpart of a tests/test_grad.py function
(a) asserts on the port, in float32, what the JAX test asserts on the JAX
    package: finite, nonzero, and the directional finite difference at the
    JAX test's own rtol;
(b) holds the port's gradient to the JAX package's on the same numpy inputs
    in float64 (the scoped ``jax.enable_x64(True)``, ``tpu.dtype=float64``)
    within the tolerance of the forward parity tests: 1e-6 of the
    gradient's magnitude over 30 substeps and over the 3-step rollout
    (ROADMAP C, traps: ulp differences between the frameworks grow in a
    BBM loop). Measured: 1.3e-15 (one step), 2.0e-15 (the thickness),
    5.1e-15 (the rollout).

``SubstepLoop`` with the plain loop standing in for the kernel
(``advance=substep_loop_reference``) equals straight autograd through the
plain loop: bitwise for the carry, whose gradient goes through the same
operations in the same order (NaN where the straight gradient is NaN: EVP
and mEVP take ``sqrt`` of an exactly zero strain invariant on land, in the
JAX package too), and within 1e-12 relative for the loop-invariant planes
and a tensor parameter, whose sums are associated segment by segment.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.config import Config as JConfig
from nextsim_tpu.model.simulator import Simulator as JSimulator
from nextsim_tpu.ops import momentum as jmom
from nextsim_tpu_torch import Config as PConfig
from nextsim_tpu_torch import Simulator as PSimulator
from nextsim_tpu_torch import state_from_numpy
from nextsim_tpu_torch.ops import momentum as pmom
from nextsim_tpu_torch.ops import momentum_cuda
from test_torch_momentum import jax_to_numpy

torch.set_num_threads(1)

#: |port - jax| <= RTOL_F64 * max|jax| in float64, over 30 substeps and rollouts
RTOL_F64 = 1e-6

# tests/test_grad.py's configuration (_sim)
GRAD_CFG = {
    "grid.preset": "square", "grid.nx": 16, "grid.ny": 16,
    "grid.resolution": 10e3,
    "simul.timestep": 200, "simul.time_init": "2015-10-16 00:00:00",
    "dynamics.substeps": 30,
    "thermo.use_thermo_forcing": False,
    "setup.ice-type": "constant",
    "setup.atmosphere-type": "constant",
    "setup.ocean-type": "constant",
    "ideal_simul.constant_wind_u": 8.0,
    "simul.spinup_duration": 0.0,
    "tpu.donate_state": False,
}


def port_sim(over, tmp_path, dtype_name="float32"):
    cfg = dict(over, **{"tpu.dtype": dtype_name, "output.exporter_path": str(tmp_path / "port")})
    return PSimulator(PConfig(overrides=cfg), device="cpu")


def jax_grad_f64(over, tmp_path, make_loss, arg):
    """``jax.grad`` of ``make_loss(jsim, forcing, tinfo)`` at ``arg(jsim,
    forcing)`` in float64, and JAX's initial state as numpy."""
    with jax.enable_x64(True):
        cfg = dict(over, **{"tpu.dtype": "float64", "output.exporter_path": str(tmp_path / "jax")})
        jsim = JSimulator(JConfig(cfg))
        f = jsim.forcing_provider(jsim.current_time, jsim.time_init)
        loss = make_loss(jsim, f, jsim.time_info())
        g = np.asarray(jax.jit(jax.grad(loss))(arg(jsim, f)))
        state = jax_to_numpy(jsim.state)
    assert g.dtype == np.float64
    return g, state


def port_f64(over, tmp_path, state):
    """The port's Simulator in float64 on the JAX package's initial state."""
    psim = port_sim(over, tmp_path, "float64")
    psim.state = state_from_numpy(state, device="cpu")
    return psim


def grad_of(loss, x):
    x = x.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    return g


def assert_grad_close(ref, got, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(got).all(), what
    scale = float(np.abs(ref).max())
    if scale == 0.0:  # e.g. d/d wind through the thermodynamics at exactly zero wind
        assert not got.any(), what
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale, err_msg=what)


def ke(s):
    return (s.vt_u ** 2 + s.vt_v ** 2).mean()


# ---------------------------------------------------------------------------
# the counterparts of tests/test_grad.py's dynamics tests
# ---------------------------------------------------------------------------

def test_grad_through_full_step_finite_and_matches_fd(tmp_path):
    """d(mean KE after one step)/d(wind) through ``raw_step_fn``: finite,
    nonzero, its directional derivative matches a central difference (rtol
    0.15, as in JAX); and equal to JAX's in float64."""
    sim = port_sim(GRAD_CFG, tmp_path)
    f = sim.forcing_provider(sim.current_time, sim.time_init)
    ti = sim.time_info()

    def loss(wind_u):
        s2, _, _ = sim.raw_step_fn(sim.state, f.replace(wind_u=wind_u), ti)
        return ke(s2)

    g = grad_of(loss, f.wind_u)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.standard_normal(tuple(f.wind_u.shape)).astype(np.float32))
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(f.wind_u + eps * d)) - float(loss(f.wind_u - eps * d))) / (2 * eps)
    ad = float((g * d).sum())
    assert fd != 0.0
    np.testing.assert_allclose(ad, fd, rtol=0.15)

    def jloss(jsim, jf, jti):
        def loss(wind_u):
            s2, _, _ = jsim.raw_step_fn(jsim.state, jf.replace(wind_u=wind_u), jti)
            return jnp.mean(s2.vt_u ** 2 + s2.vt_v ** 2)
        return loss

    ref, state = jax_grad_f64(GRAD_CFG, tmp_path, jloss, lambda jsim, jf: jf.wind_u)
    psim = port_f64(GRAD_CFG, tmp_path, state)
    pf = psim.forcing_provider(psim.current_time, psim.time_init)
    pti = psim.time_info()
    got = grad_of(lambda w: ke(psim.raw_step_fn(psim.state, pf.replace(wind_u=w), pti)[0]), pf.wind_u)
    assert_grad_close(ref, got, RTOL_F64, "d KE / d wind_u")


def test_grad_wrt_initial_state_finite(tmp_path):
    """The adjoint sensitivity to the initial thickness (slab mass,
    Pmax = P h^1.5, transport) is finite; and equal to JAX's in float64."""
    sim = port_sim(GRAD_CFG, tmp_path)
    f = sim.forcing_provider(sim.current_time, sim.time_init)
    ti = sim.time_info()

    def loss_of(psim, pf, pti):
        def loss(thick):
            s2, _, _ = psim.raw_step_fn(psim.state.replace(thick=thick), pf, pti)
            return ke(s2) + s2.damage.mean()
        return loss

    g = grad_of(loss_of(sim, f, ti), sim.state.thick)
    assert torch.isfinite(g).all()

    def jloss(jsim, jf, jti):
        def loss(thick):
            s2, _, _ = jsim.raw_step_fn(jsim.state.replace(thick=thick), jf, jti)
            return jnp.mean(s2.vt_u ** 2 + s2.vt_v ** 2) + jnp.mean(s2.damage)
        return loss

    ref, state = jax_grad_f64(GRAD_CFG, tmp_path, jloss, lambda jsim, jf: jsim.state.thick)
    psim = port_f64(GRAD_CFG, tmp_path, state)
    pf = psim.forcing_provider(psim.current_time, psim.time_init)
    got = grad_of(loss_of(psim, pf, psim.time_info()), psim.state.thick)
    assert_grad_close(ref, got, RTOL_F64, "d loss / d thick")


def test_grad_through_multi_step_rollout(tmp_path):
    """Gradients survive a 3-step rollout (a variational window): finite,
    nonzero; and equal to JAX's scan in float64."""
    def loss_of(psim, pf, pti):
        def loss(wind_u):
            f2 = pf.replace(wind_u=wind_u)
            s = psim.state
            for _ in range(3):
                s, _, _ = psim.raw_step_fn(s, f2, pti)
            return ke(s)
        return loss

    sim = port_sim(GRAD_CFG, tmp_path)
    f = sim.forcing_provider(sim.current_time, sim.time_init)
    g = grad_of(loss_of(sim, f, sim.time_info()), f.wind_u)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0

    def jloss(jsim, jf, jti):
        def loss(wind_u):
            f2 = jf.replace(wind_u=wind_u)

            def body(s, _):
                s2, _, _ = jsim.raw_step_fn(s, f2, jti)
                return s2, None

            s_final, _ = jax.lax.scan(body, jsim.state, None, length=3)
            return jnp.mean(s_final.vt_u ** 2 + s_final.vt_v ** 2)
        return loss

    ref, state = jax_grad_f64(GRAD_CFG, tmp_path, jloss, lambda jsim, jf: jf.wind_u)
    psim = port_f64(GRAD_CFG, tmp_path, state)
    pf = psim.forcing_provider(psim.current_time, psim.time_init)
    got = grad_of(loss_of(psim, pf, psim.time_info()), pf.wind_u)
    assert_grad_close(ref, got, RTOL_F64, "3-step rollout")


def _sign_descent(grad, cdw=0.0080, n=30, stationary=None):
    """tests/test_grad.py's calibration loop: sign descent from a 45% error
    with the step halved on every sign flip. Returns (cdw, signs).

    With ``stationary``, a gradient within ``stationary`` times the first
    one's magnitude counts as zero and the iterate stays (sign 0). The
    descent reaches the true 0.0055 exactly at its sixth step, where the
    gradient is rounding noise: 0.0 in the port, 9.7e-22 in the JAX package
    (whose observations come from another compiled program than its
    gradient), against 2.3e-6 at the first guess. JAX's rule, ``1 if g > 0
    else -1``, would send the two packages to either side of the optimum on
    that noise, so the float64 comparison stops both there."""
    step, prev_sign, signs, g0 = 5e-4, 0, [], None
    for _ in range(n):
        g = grad(cdw)
        g0 = abs(g) if g0 is None else g0
        if stationary is not None and abs(g) <= stationary * g0:
            signs.append(0)
            continue
        s = 1 if g > 0 else -1
        if prev_sign and s != prev_sign:
            step *= 0.5
        cdw -= s * step
        prev_sign = s
        signs.append(s)
    return cdw, signs


def _port_drag_misfit(sim, dtype):
    """(misfit(cdw), d misfit/d cdw) of the port: velocities after one
    ``explicit_solve`` against those of the true cdw = 0.0055."""
    f = sim.forcing_provider(sim.current_time, sim.time_init)
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)

    def forward(cdw):
        p = dataclasses.replace(sim.dyn, quad_drag_coef_water=cdw)
        s2, _ = pmom.explicit_solve(sim.state, f, ga, sim.dt, p)
        return s2.vt_u, s2.vt_v

    with torch.no_grad():
        obs_u, obs_v = forward(0.0055)

    def misfit(cdw):
        u, v = forward(cdw)
        return ((u - obs_u) ** 2 + (v - obs_v) ** 2).mean()

    def grad(cdw):
        c = torch.tensor(cdw, dtype=dtype, requires_grad=True)
        (g,) = torch.autograd.grad(misfit(c), c)
        return float(g)

    return (lambda cdw: float(misfit(cdw))), grad


def test_gradient_recovers_drag_coefficient(tmp_path):
    """Parameter estimation through the adjoint: the sign descent on the
    ocean drag coefficient (a tensor ``quad_drag_coef_water`` through
    ``explicit_solve``) recovers it within 10% and cuts the misfit 5x; in
    float64 the port takes JAX's 30 signs and ends on its cdw (1e-12)."""
    sim = port_sim(GRAD_CFG, tmp_path)
    misfit, grad = _port_drag_misfit(sim, torch.float32)
    m0 = misfit(0.0080)
    cdw, _ = _sign_descent(grad)
    assert abs(cdw - 0.0055) / 0.0055 < 0.10, cdw
    assert misfit(cdw) < 0.2 * m0

    with jax.enable_x64(True):
        cfg = dict(GRAD_CFG, **{"tpu.dtype": "float64", "output.exporter_path": str(tmp_path / "jax")})
        jsim = JSimulator(JConfig(cfg))
        jf = jsim.forcing_provider(jsim.current_time, jsim.time_init)
        jga = dict(jsim.grid_arrays)
        jga["cohesion"] = jsim.c_fix + jsim.c_alea * jsim.state.random_number

        def jforward(cdw):
            p = dataclasses.replace(jsim.dyn, quad_drag_coef_water=cdw)
            s2, _ = jmom.explicit_solve(jsim.state, jf, jga, jsim.dt, p)
            return s2.vt_u, s2.vt_v

        obs_u, obs_v = jax.jit(jforward)(0.0055)
        jgrad = jax.jit(jax.grad(
            lambda cdw: jnp.mean((jforward(cdw)[0] - obs_u) ** 2 + (jforward(cdw)[1] - obs_v) ** 2)))
        j_cdw, j_signs = _sign_descent(lambda c: float(jgrad(jnp.float64(c))), stationary=1e-12)
        state = jax_to_numpy(jsim.state)
    psim = port_f64(GRAD_CFG, tmp_path, state)
    _, pgrad = _port_drag_misfit(psim, torch.float64)
    p_cdw, p_signs = _sign_descent(pgrad, stationary=1e-12)
    assert p_signs == j_signs
    assert p_signs[:5] == [1] * 5 and set(p_signs[5:]) == {0}
    assert abs(p_cdw - j_cdw) <= 1e-12
    assert abs(p_cdw - 0.0055) / 0.0055 < 0.10


# ---------------------------------------------------------------------------
# gradients at a tie (core/ties.py)
# ---------------------------------------------------------------------------

def test_tie_gradients_match_jax():
    """``ties.maximum/minimum/clip`` give ``torch.clamp``'s values, bitwise,
    with and without a recorded gradient, and ``jnp.maximum/minimum/clip``'s
    gradient, which splits at a tie (``torch.clamp`` passes all of it). The
    upwind advection of an intensive tracer, where faces with exactly zero
    velocity are ties, has JAX's gradient in float64 (1e-12)."""
    from nextsim_tpu.ops import advection as jadv
    from nextsim_tpu_torch.core import ties
    from nextsim_tpu_torch.ops import advection as padv

    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0])
    cases = [
        (ties.maximum, lambda t: torch.clamp(t, min=0.0), lambda a: jnp.maximum(a, 0.0), (0.0,)),
        (ties.minimum, lambda t: torch.clamp(t, max=1.0), lambda a: jnp.minimum(a, 1.0), (1.0,)),
        (ties.clip, lambda t: torch.clamp(t, 0.0, 1.0), lambda a: jnp.clip(a, 0.0, 1.0), (0.0, 1.0)),
    ]
    with jax.enable_x64(True):
        for fn, clamp, jfn, bounds in cases:
            t = torch.from_numpy(x).requires_grad_(True)
            out = fn(t, *bounds)
            assert torch.equal(out, clamp(t)) and torch.equal(fn(t.detach(), *bounds), clamp(t.detach()))
            (g,) = torch.autograd.grad(out.sum(), t)
            ref = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a)))(jnp.asarray(x)))
            np.testing.assert_array_equal(g.numpy(), ref)
            assert 0.5 in ref  # a tie was hit
            t = torch.from_numpy(x).requires_grad_(True)
            (gc,) = torch.autograd.grad(clamp(t).sum(), t)
            assert not np.array_equal(gc.numpy(), ref)  # clamp's tie gradient is not JAX's

        rng = np.random.default_rng(3)
        ny, nx = 6, 7
        q = rng.random((ny, nx))
        u = rng.standard_normal((ny, nx + 1))
        v = rng.standard_normal((ny + 1, nx))
        u[:, ::2] = 0.0  # faces at rest: ties of maximum(u, 0)
        v[1::2, :] = 0.0
        mask = np.ones((ny, nx))
        w = rng.standard_normal((ny, nx))

        def jloss(u, v):
            return jnp.sum(jnp.asarray(w) * jadv.advect_intensive(jnp.asarray(q), u, v, 60.0, 1e4,
                                                                  jnp.asarray(mask)))

        refs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    tu, tv = (torch.from_numpy(a).requires_grad_(True) for a in (u, v))
    out = padv.advect_intensive(torch.from_numpy(q), tu, tv, 60.0, 1e4, torch.from_numpy(mask))
    got = torch.autograd.grad((torch.from_numpy(w) * out).sum(), (tu, tv))
    for name, r, g in zip(("u_face", "v_face"), refs, got):
        assert_grad_close(np.asarray(r), g, 1e-12, name)


# ---------------------------------------------------------------------------
# SubstepLoop: the checkpointed Function, with the plain loop as its forward
# ---------------------------------------------------------------------------

def _loop_setup(dyn_type, nx=16, ny=16, substeps=30, wind=8.0, steps_before=2, dt=200.0):
    """(consts, carry, p, sim) of a float64 dynamics step after a few steps
    (stress, damage and velocities non-zero), with the wind and the drag
    coefficient as tensors that require grad."""
    over = dict(GRAD_CFG, **{"grid.nx": nx, "grid.ny": ny, "dynamics.substeps": substeps,
                             "setup.dynamics-type": dyn_type, "tpu.dtype": "float64",
                             "ideal_simul.constant_wind_u": wind, "simul.timestep": dt})
    sim = PSimulator(PConfig(overrides=over), device="cpu")
    for _ in range(steps_before):
        sim.step()
    ga = dict(sim.grid_arrays, cohesion=sim.c_fix + sim.c_alea * sim.state.random_number)
    f = sim.forcing_provider(sim.current_time, sim.time_init)
    f = f.replace(wind_u=f.wind_u.clone().requires_grad_(True))
    p = dataclasses.replace(sim.dyn, quad_drag_coef_water=torch.tensor(
        0.0055, dtype=torch.float64, requires_grad=True))
    consts, carry = pmom.substep_setup(sim.state, f, ga, sim.dt, p)
    consts.volume = consts.volume.detach().requires_grad_(True)
    return consts, carry, p, sim, f


@pytest.mark.parametrize("dyn_type", ["bbm", "evp", "mevp"])
def test_substep_loop_function_equals_straight_autograd(dyn_type):
    consts, carry, p, sim, f = _loop_setup(dyn_type)
    steps = p.substeps
    leaves = tuple(c.detach().requires_grad_(True) for c in carry)
    args = (consts, leaves, steps, sim.dt / steps, sim.dt, sim.grid.dx, dyn_type, p)
    rng = np.random.default_rng(7)
    weights = [torch.from_numpy(rng.standard_normal(tuple(c.shape))) for c in carry]
    wrt = [*leaves, f.wind_u, consts.volume, p.quad_drag_coef_water]

    def grads(out):
        loss = sum((o * w).sum() for o, w in zip(out, weights))
        return torch.autograd.grad(loss, wrt, allow_unused=True, retain_graph=True)

    ref = grads(momentum_cuda.substep_loop_reference(*args))
    segments = (8, 8, 8, 6)
    out = momentum_cuda.substep_loop_checkpointed(
        *args, advance=momentum_cuda.substep_loop_reference, segments=segments)
    assert out[0].grad_fn.name() == "SubstepLoopBackward"
    got = grads(out)
    for name, r, g in zip(momentum_cuda._STATE, ref[:8], got[:8]):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True, msg=name)
    for name, r, g in zip(("wind_u", "volume", "quad_drag_coef_water"), ref[8:], got[8:]):
        assert torch.isfinite(r).all() and float(r.abs().max()) > 0.0, name
        torch.testing.assert_close(g, r, rtol=0, atol=1e-12 * float(r.abs().max()), msg=name)


def test_substep_loop_function_gradcheck():
    """``torch.autograd.gradcheck`` of SubstepLoop (plain forward, segments
    of 2 and 1 substeps) in float64 on an 8 x 6 grid over 3 substeps, with
    respect to the carry, two planes the body reads and the drag
    coefficient (30 s steps: 10 s substeps keep the 10 km grid CFL-safe)."""
    consts, carry, p, sim, f = _loop_setup("bbm", nx=6, ny=8, substeps=3, steps_before=2, dt=30.0)
    names = ("tau_ax", "volume")
    cdw = p.quad_drag_coef_water

    def fn(*xs):
        c = SimpleNamespace(**vars(consts))
        for n, x in zip(names, xs[8:10]):
            setattr(c, n, x)
        q = dataclasses.replace(p, quad_drag_coef_water=xs[10])
        return momentum_cuda.substep_loop_checkpointed(
            c, xs[:8], 3, sim.dt / 3, sim.dt, sim.grid.dx, "bbm", q,
            advance=momentum_cuda.substep_loop_reference, segments=(2, 1))

    inputs = [c.detach().clone().requires_grad_(True) for c in carry]
    inputs += [getattr(consts, n).detach().clone().requires_grad_(True) for n in names]
    inputs.append(cdw.detach().clone().requires_grad_(True))
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_substep_loop_on_the_cpu_is_plain_autograd():
    """On the CPU ``substep_loop`` is the plain loop, its graph the plain
    operations (no SubstepLoop node), and a segment list that is not the
    loop raises."""
    consts, carry, p, sim, f = _loop_setup("bbm", substeps=4, steps_before=0)
    args = (consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx, "bbm", p)
    launches = momentum_cuda.launches
    out = momentum_cuda.substep_loop(*args)
    assert momentum_cuda.launches == launches
    assert out[0].grad_fn is not None and out[0].grad_fn.name() != "SubstepLoopBackward"
    with pytest.raises(ValueError, match="segments"):
        momentum_cuda.substep_loop_checkpointed(
            *args, advance=momentum_cuda.substep_loop_reference, segments=(2, 1))


def test_checkpointed_loop_without_nvcc_raises(monkeypatch, tmp_path):
    """SubstepLoop's default forward is the kernel: with no nvcc to build it,
    a recorded loop raises and launches nothing; it never runs the plain
    loop in the kernel's place."""
    monkeypatch.setattr(momentum_cuda, "_lib", None)
    monkeypatch.setattr(momentum_cuda, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(momentum_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    consts, carry, p, sim, f = _loop_setup("bbm", substeps=4, steps_before=0)
    launches = momentum_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        momentum_cuda.substep_loop_checkpointed(consts, carry, 4, sim.dt / 4, sim.dt, sim.grid.dx, "bbm", p)
    assert momentum_cuda.launches == launches
