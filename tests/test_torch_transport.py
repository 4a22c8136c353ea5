"""Parity of the PyTorch port's advection and transport (nextsim_tpu_torch/
ops/advection.py, ops/transport.py) with the JAX package's, on the CPU in
float32 from the same numpy inputs, op by op.

Advection is +,-,*,/ and selects only, in the same order: bitwise. The
transport step adds a sqrt (the enthalpy inversion), which torch's CPU
rounds differently on a small share of inputs (tests/test_torch_rheology.py):
rtol 1e-6 of each field's magnitude there.

The CUDA kernel's wrapper (ops/transport_cuda.py) off the card, its launch
emulated by the plain version: the dispatch, the gradient through its
``torch.autograd.Function``s, what it refuses, its build without nvcc, and
its ctypes structs and plane table against the CUDA source.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsim_tpu.ops import advection as jadv
from nextsim_tpu.ops import transport as jtr
from nextsim_tpu_torch import state_from_numpy
from nextsim_tpu_torch.ops import advection as tadv
from nextsim_tpu_torch.ops import transport as ttr
from test_torch_momentum import assert_close, jax_to_numpy, make_pair

NY, NX = 19, 27
DT, DX = 300.0, 10e3


def _velocity_and_tracer(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, (NY + 1, NX + 1)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (NY + 1, NX + 1)).astype(np.float32)
    q = rng.uniform(0.0, 1.0, (NY, NX)).astype(np.float32)
    q[rng.random((NY, NX)) < 0.2] = 0.0  # fronts for the limiter
    mask = np.ones((NY, NX), np.float32)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = 0.0
    return u, v, q, mask


def test_face_velocities_and_divergence():
    u, v, _, _ = _velocity_and_tracer(0)
    jf = jadv.face_velocities(jnp.asarray(u), jnp.asarray(v))
    tf = tadv.face_velocities(torch.from_numpy(u), torch.from_numpy(v))
    for r, o in zip(jf, tf):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        tadv.divergence(*tf, DX).numpy(), np.asarray(jadv.divergence(*jf, DX))
    )


@pytest.mark.parametrize("second_order", [True, False])
@pytest.mark.parametrize("form", ["conservative", "intensive"])
def test_advection_matches_jax_bitwise(form, second_order):
    u, v, q, mask = _velocity_and_tracer(1 + second_order)
    jf = jadv.face_velocities(jnp.asarray(u), jnp.asarray(v))
    tf = tadv.face_velocities(torch.from_numpy(u), torch.from_numpy(v))
    jfn = getattr(jadv, f"advect_{form}")
    tfn = getattr(tadv, f"advect_{form}")
    ref = jfn(jnp.asarray(q), *jf, DT, DX, jnp.asarray(mask), second_order)
    out = tfn(torch.from_numpy(q), *tf, DT, DX, torch.from_numpy(mask), second_order)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("form", ["conservative", "intensive"])
def test_limiter_counts_a_subnormal_product_as_zero(form):
    """A front of tiny values (1e-36 to 1e-8, as snow on young ice that has
    almost melted): the product of two neighbouring differences is a
    subnormal float32 on many cells. XLA flushes it, so the JAX package's
    slope is zero there; the port's limiter must give the same bits, and
    no tracer may leave the advection below zero (it did, by 1e-31, and
    failed checkFieldsFast on hs_young in a toy wave run)."""
    rng = np.random.default_rng(3)
    ny, nx = 6, 64
    q = (10.0 ** np.sort(rng.uniform(-36, -8, (ny, nx)), axis=1)).astype(np.float32)
    dm, dp = q[:, 1:-1] - q[:, :-2], q[:, 2:] - q[:, 1:-1]
    with np.errstate(under="ignore"):
        prod = dm * dp
    assert ((prod > 0) & (prod < np.finfo(np.float32).tiny)).sum() > 20
    ref = jadv._vanleer_slope(jnp.asarray(q[:, :-2]), jnp.asarray(q[:, 1:-1]), jnp.asarray(q[:, 2:]))
    out = tadv._vanleer_slope(torch.from_numpy(q[:, :-2]), torch.from_numpy(q[:, 1:-1]), torch.from_numpy(q[:, 2:]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    u = np.full((ny, nx + 1), 0.4, np.float32)
    u[:, 0] = u[:, -1] = 0.0
    v = np.zeros((ny + 1, nx), np.float32)
    mask = np.ones((ny, nx), np.float32)
    args = (q, u, v, mask)
    ref = getattr(jadv, f"advect_{form}")(*map(jnp.asarray, args[:3]), 1.0, 1.0, jnp.asarray(mask), True)
    out = getattr(tadv, f"advect_{form}")(*map(torch.from_numpy, args[:3]), 1.0, 1.0, torch.from_numpy(mask), True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert float(out.min()) >= 0.0


def _moving_state(j, seed):
    """The toy state with random velocities, ice fields, stress, damage and
    tracers in their physical ranges (young ice included, so the ridging
    branches run)."""
    rng = np.random.default_rng(seed)
    s = jax_to_numpy(j.state)
    cell = s["conc"].shape
    node = s["vt_u"].shape
    nm = np.asarray(j.ga["node_mask"]) * (1.0 - np.asarray(j.ga["node_dirichlet"]))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    s.update(
        vt_u=f32(rng.uniform(-0.4, 0.4, node) * nm),
        vt_v=f32(rng.uniform(-0.4, 0.4, node) * nm),
        conc=f32(rng.uniform(0.5, 1.0, cell)),
        thick=f32(rng.uniform(0.2, 2.0, cell)),
        snow_thick=f32(rng.uniform(0.0, 0.3, cell)),
        conc_young=f32(rng.uniform(0.0, 0.2, cell)),
        h_young=f32(rng.uniform(0.0, 0.05, cell)),
        hs_young=f32(rng.uniform(0.0, 0.01, cell)),
        damage=f32(rng.uniform(0.0, 1.0, cell)),
        ridge_ratio=f32(rng.uniform(0.0, 0.3, cell)),
        sigma=f32(rng.uniform(-3e4, 3e4, (3,) + cell)),
        tice=f32(rng.uniform(-20.0, -0.3, (3,) + cell)),
        age=f32(rng.uniform(0.0, 3e7, cell)),
        age_det=f32(rng.uniform(0.0, 3e7, cell)),
        conc_myi=f32(rng.uniform(0.0, 0.5, cell)),
        thick_myi=f32(rng.uniform(0.0, 1.0, cell)),
    )
    return s


@pytest.mark.parametrize("second_order", [True, False])
def test_transport_and_ridge_matches_jax(second_order):
    j, p = make_pair("bbm")
    s = _moving_state(j, 3)
    jstate = j.state.replace(**{k: jnp.asarray(v) for k, v in s.items()})
    tp_j = jtr.TransportParams(second_order=second_order, diffusivity_sst=100.0)
    tp_t = ttr.TransportParams(second_order=second_order, diffusivity_sst=100.0)
    ref, rdiag = jtr.transport_and_ridge(jstate, j.ga, DT, tp_j)
    out, odiag = ttr.transport_and_ridge(state_from_numpy(s, device="cpu"), p.ga, DT, tp_t)
    for f in dataclasses.fields(ref):
        r = getattr(ref, f.name)
        if r is None:
            assert getattr(out, f.name) is None
            continue
        assert_close(r, getattr(out, f.name), 1e-6, f.name)
    for k in rdiag:
        assert_close(rdiag[k], odiag[k], 1e-6, k)


def test_transport_raises_on_fsd_bins():
    """Transport used to raise on floe-size bins; it now carries them (the
    parity of that branch is in tests/test_torch_fsd.py): no error, and the
    bins close on the new total concentration."""
    _, p = make_pair("bbm")
    half = torch.stack([0.5 * p.state.conc, 0.5 * p.state.conc])
    out, _ = ttr.transport_and_ridge(p.state.replace(conc_fsd=half), p.ga, DT, ttr.TransportParams())
    assert out.conc_fsd.shape == half.shape and out.conc_mech_fsd is None
    torch.testing.assert_close(out.conc_fsd.sum(0), out.conc + out.conc_young, rtol=0, atol=1e-6)


def test_transport_params_from_config():
    from nextsim_tpu.config import Config as JConfig
    from nextsim_tpu_torch import Config as PConfig

    over = {"numerics.advection_scheme": "upwind", "thermo.diffusivity_sss": 5.0}
    assert dataclasses.asdict(ttr.TransportParams.from_config(PConfig(overrides=over))) == \
        dataclasses.asdict(jtr.TransportParams.from_config(JConfig(overrides=over)))


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper (ops/transport_cuda.py), off the card
# ---------------------------------------------------------------------------

import ctypes  # noqa: E402
import re  # noqa: E402
from pathlib import Path  # noqa: E402

from nextsim_tpu_torch.ops import momentum_cuda, transport_cuda  # noqa: E402


def _torch_state(seed=3, **over):
    """The toy state of ``_moving_state`` in the port, on the CPU, with the
    grid's arrays; ``over`` replaces fields."""
    j, p = make_pair("bbm")
    s = _moving_state(j, seed)
    return state_from_numpy(s, device="cpu").replace(**over), p.ga


def emulator(p, dt, calls):
    """Stands in for ``transport_cuda._launch`` off the card: checks the
    scalars the wrapper hands the kernel against ``p`` and ``dt``, and writes
    what the kernel computes -- the plain version on the planes it is given,
    in the C interface's order -- into the planes it would write. Appends
    whether a gradient was being recorded."""
    from nextsim_tpu_torch.core import constants as phys

    def launch(entry, ins, outs, args):
        calls.append((entry, torch.is_grad_enabled()))
        *planes, vt_u, vt_v, mask, open_mask = ins
        dx = float(args.dx) if entry == "transport" else DX
        assert args.g.dtdx == dt / dx and args.g.second_order == int(p.second_order)
        if entry == "advect_stack":
            outs[0].copy_(ttr.advect_stack_reference(planes[0], vt_u, vt_v, mask, open_mask, dt, dx, p.second_order))
            return
        mu = p.freezingpoint_mu * phys.si * phys.Lf / phys.C
        assert (args.mu_si_lf_c, args.four_mu_si_lf_c, args.tfr_ice) == (mu, 4.0 * mu, -p.freezingpoint_mu * phys.si)
        assert (args.use_young_ice, args.myi_with_young, args.dt) == (int(p.use_young_ice), 1, dt)
        fields = {}
        for name, t in zip(transport_cuda._PLANES, planes):
            field, _, k = name.partition(".")
            fields.setdefault(field, []).append(t)
        base, _ = _torch_state()
        state = base.replace(**{f: torch.stack(v) if len(v) > 1 else v[0] for f, v in fields.items()},
                             vt_u=vt_u, vt_v=vt_v)
        ga = {"mask": mask, "open_mask": open_mask, "delta_x": dx}
        core = dataclasses.replace(p, diffusivity_sst=0.0, diffusivity_sss=0.0)
        new, diag = ttr.transport_and_ridge_reference(state, ga, dt, core)
        for name, o in zip(transport_cuda._PLANES + transport_cuda._DIAG, outs):
            if o is not None:
                o.copy_(diag[name] if name in diag else transport_cuda._plane(new, name))

    return launch


def _assert_same_state(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None) == (y is None), f.name
        if x is not None:
            assert torch.equal(x.detach(), y.detach()), f.name


@pytest.mark.parametrize("young", [True, False])
def test_dispatch(monkeypatch, young):
    """The CPU takes the plain version and launches nothing; a state that
    takes the kernel goes to the launch under no_grad, one launch for the
    core and one a stack of bins, the wrapper doing the diffusion and the
    bins' rescale; where a gradient is recorded through TransportRidge,
    with the values of the plain version."""
    state, ga = _torch_state(conc_fsd=None)
    half = torch.stack([0.5 * state.conc, 0.25 * state.conc, 0.25 * state.conc])
    state = state.replace(conc_fsd=half, conc_mech_fsd=half.flip(0).contiguous())
    p = ttr.TransportParams(use_young_ice=young, diffusivity_sst=100.0)
    calls = []
    launches = transport_cuda.launches
    ref, rdiag = ttr.transport_and_ridge(state, ga, DT, p)
    plain, pdiag = ttr.transport_and_ridge_reference(state, ga, DT, p)
    _assert_same_state(ref, plain)
    assert transport_cuda.launches == launches and all(torch.equal(rdiag[k], pdiag[k]) for k in pdiag)
    monkeypatch.setattr(transport_cuda, "_launch", emulator(p, DT, calls))
    monkeypatch.setattr(ttr, "_kernel_for", lambda t: True)
    out, diag = ttr.transport_and_ridge(state, ga, DT, p)
    _assert_same_state(out, plain)
    assert all(torch.equal(diag[k], pdiag[k]) for k in pdiag)
    assert calls == [("transport", False), ("advect_stack", False), ("advect_stack", False)]
    if not young:
        assert out.h_young is state.h_young and out.conc_young is state.conc_young
    leaf = state.conc.clone().requires_grad_(True)
    out, _ = ttr.transport_and_ridge(state.replace(conc=leaf), ga, DT, p)
    assert type(out.thick.grad_fn).__name__ == "TransportRidgeBackward"
    _assert_same_state(out, plain)
    assert calls[3:] == [("transport", False)] + [("advect_stack", False)] * 2


def test_recorded_gradient_equals_plain_autograd(monkeypatch):
    """TransportRidge and AdvectStack (the forward emulated from the plain
    version) give straight autograd's gradient through the plain version
    in float64, young ice on, second order: bitwise for the state's planes
    and the bins; the velocities, which both Functions read, sum the two
    Functions' parts in another order than one graph does (1e-14 of the
    largest)."""
    torch.manual_seed(0)
    base, ga = _torch_state(conc_fsd=None)
    base = base.replace(**{f: getattr(base, f).double() for f in transport_cuda.FIELDS + ("vt_u", "vt_v")})
    ga = dict(ga, mask=ga["mask"].double(), open_mask=ga["open_mask"].double())
    bins = torch.stack([0.6 * base.conc, 0.4 * base.conc])
    p = ttr.TransportParams()
    wrt = ("conc", "thick", "tice", "sigma", "damage", "vt_u", "vt_v")

    def grads(fn):
        leaves = {f: getattr(base, f).clone().requires_grad_(True) for f in wrt}
        b = bins.clone().requires_grad_(True)
        out, diag = fn(base.replace(conc_fsd=b, **leaves), ga, DT, p)
        loss = sum((w * getattr(out, f)).sum() for f, w in zip(
            ("conc", "thick", "tice", "sigma", "age", "conc_fsd", "ridge_ratio", "damage"),
            (1.0, 2.0, -0.5, 1e-5, 3.0, 0.7, 1.5, 0.3)))
        loss = loss + diag["divergence"].sum() * 1e3 + diag["del_ci_ridge_myi"].sum()
        return torch.autograd.grad(loss, [*leaves.values(), b])

    ref = grads(ttr.transport_and_ridge_reference)
    monkeypatch.setattr(transport_cuda, "_launch", emulator(p, DT, []))
    monkeypatch.setattr(ttr, "_kernel_for", lambda t: True)
    got = grads(ttr.transport_and_ridge)
    for name, r, g in zip(wrt + ("conc_fsd",), ref, got):
        assert float(r.abs().max()) > 0.0, name
        if name in ("vt_u", "vt_v"):
            torch.testing.assert_close(g, r, rtol=0.0, atol=1e-14 * float(r.abs().max()), msg=name)
        else:
            assert torch.equal(r, g), name
        assert float(r.abs().max()) > 0.0, name


def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    state, ga = _torch_state()
    p = ttr.TransportParams()
    monkeypatch.setattr(transport_cuda, "_launch", lambda *a: None)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        transport_cuda.ridge(state.replace(conc=state.conc.half()), ga, DT, p)
    with pytest.raises(ValueError, match="sigma is"):
        transport_cuda.ridge(state.replace(sigma=state.sigma[:2]), ga, DT, p)
    with pytest.raises(ValueError, match="mask is"):
        transport_cuda.ridge(state, dict(ga, mask=ga["mask"].double()), DT, p)
    with pytest.raises(ValueError, match="vt_u is"):
        transport_cuda.ridge(state.replace(vt_u=state.vt_u[:-1]), ga, DT, p)
    with pytest.raises(ValueError, match="contiguous"):
        transport_cuda.ridge(state.replace(damage=state.damage.T.contiguous().T), ga, DT, p)
    with pytest.raises(TypeError, match="delta_x as a number"):
        transport_cuda.ridge(state, dict(ga, delta_x=torch.tensor(DX)), DT, p)
    with pytest.raises(ValueError, match="a stack of"):
        transport_cuda.advect_stack(state.conc, state, ga, DT, p)
    monkeypatch.undo()
    launches = transport_cuda.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        transport_cuda.ridge(state, ga, DT, p)
    assert transport_cuda.launches == launches


def test_kernel_request_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc to build the kernel its build raises; the wrapper never
    falls back to the plain version."""
    monkeypatch.setattr(transport_cuda, "_lib", None)
    monkeypatch.setattr(momentum_cuda, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(momentum_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        transport_cuda._library()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


_CTYPES = {"double": ctypes.c_double, "long long": ctypes.c_longlong, "int": ctypes.c_int,
           "Geometry": transport_cuda._Geometry}


def _c_struct(src: str, name: str) -> list:
    """(field, ctypes type, count or None) of ``struct name`` in the CUDA
    source, in order."""
    body = src[src.index(f"struct {name} {{") + len(f"struct {name} {{"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"((?:const\s+)?(?:long long|void|double|int|Geometry)\s*\*?)\s*(.+)$", decl)
        ctype = m.group(1).strip()
        kind = ctypes.c_void_p if ctype.endswith("*") else _CTYPES[ctype]
        for var in (v.strip() for v in m.group(2).split(",")):
            vname, _, dim = var.partition("[")
            fields.append((vname.strip().lstrip("*"), kind, dim.rstrip("]") or None))
    return fields


def _py_struct(cls) -> list:
    return [(n, t._type_, t._length_) if issubclass(t, ctypes.Array) else (n, t, None) for n, t in cls._fields_]


def test_parameter_structs_and_plane_order_mirror_the_cuda_source():
    src = Path(transport_cuda._SRC).read_text()
    enum = src[src.index("enum Plane {") + len("enum Plane {"):]
    order = [w.strip() for w in re.sub(r"//[^\n]*", "", enum[:enum.index("};")]).split(",") if w.strip()]
    assert order[-1] == "N_PLANES"
    assert [w.lower() for w in order[:-1]] == [n.replace(".", "") .replace("sigma0", "sxx").replace("sigma1", "syy")
                                               .replace("sigma2", "sxy") for n in transport_cuda._PLANES]
    for c_name, cls in (("Geometry", transport_cuda._Geometry), ("TransportArgs", transport_cuda._Args),
                        ("StackArgs", transport_cuda._StackArgs)):
        c = [(n, k, None if d is None else (len(order) - 1 if d == "N_PLANES" else int(d)))
             for n, k, d in _c_struct(src, c_name)]
        assert c == _py_struct(cls), c_name


def test_plane_table_covers_every_field_transport_changes():
    """Every State field the plain version gives anew (young ice on, floe-size
    bins carried) is a plane of the kernel's table or a stack of bins; every
    field of the table is one it changes."""
    state, ga = _torch_state(conc_fsd=None)
    state = state.replace(conc_fsd=torch.stack([0.5 * state.conc, 0.5 * state.conc]))
    new, diag = ttr.transport_and_ridge_reference(state, ga, DT, ttr.TransportParams())
    changed = {f.name for f in dataclasses.fields(new) if getattr(new, f.name) is not getattr(state, f.name)}
    assert changed - {"conc_fsd"} == set(transport_cuda.FIELDS)
    assert set(diag) == set(transport_cuda._DIAG)
