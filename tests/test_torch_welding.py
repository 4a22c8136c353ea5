"""Roach welding of the port (ops/fsd.py ``welding_roach`` and
``welding_roach_reference``, ops/welding_cuda.py) on the CPU.

The CUDA kernel (csrc/welding_roach.cu) runs on the card only
(tests/test_torch_cuda.py holds it to the plain version bitwise there).
Here:

* the plain version against the JAX package's ``welding_roach`` (a
  ``fori_loop`` of 256 masked substeps) on a 24^2 stack with open water,
  unbroken, empty and broken cells: rtol 1e-9 of the magnitude in float64
  (under the scoped ``jax.enable_x64(True)``), 1e-4 in float32 (a sum of
  ~20 pair terms over up to 256 substeps), as tests/test_torch_fsd.py;
* a batched ensemble's member-minor stack (6, 3, 24, 24) equals each
  member welded alone, bitwise: the plain version is cell by cell;
* the wrapper's plan table and scalars: ``welding_cuda.weld`` with the
  launch replaced by ``emulate_kernel`` -- the kernel's function written in
  torch operations from the very table and scalars the wrapper hands the
  kernel, every cell to the cap of masked substeps -- equals the plain
  version bitwise in float32, float64 and bfloat16;
* ``WeldingRoach`` with its forward swapped for the plain one equals plain
  autograd bitwise, and the JAX package's ``jax.grad`` through its
  ``welding_roach`` within 1e-9 in float64;
* the dispatch: a stack on the CPU takes the plain version, one that takes
  the kernel goes to the launch (through ``WeldingRoach`` where a gradient
  is recorded); what the wrapper refuses; no nvcc raises.
"""

import jax
import numpy as np
import pytest
import torch

from nextsim_tpu.ops import fsd as jfsd
from nextsim_tpu_torch.ops import fsd as pfsd
from nextsim_tpu_torch.ops import momentum_cuda, welding_cuda
from test_torch_fsd import NB, both, fields, params
from test_torch_momentum import assert_close
from test_torch_thermo import DT, jax_scope

torch.set_num_threads(1)

SHAPE = (24, 24)
TDT = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def emulate_kernel(conc_fsd, out, ctot, c_broken, freezing, merge, table, s):
    """Stands in for ``welding_cuda._launch`` off the card: what the kernel
    computes, from the plan table (``merge``; widths, offsets and valid
    flags of the pairs, then the bin centres) and the scalars ``s`` that the
    wrapper hands it, in the plain version's torch operations: every cell
    through ``s.ndt_max`` masked substeps, each stopping at its own count,
    written into ``out``. Reads nothing back from the device."""
    n = s.nbins
    pairs = n * (n + 1) // 2
    width, off, valid, centre = table[:pairs], table[pairs:2 * pairs], table[2 * pairs:3 * pairs], table[3 * pairs:]
    c = conc_fsd.reshape(n, -1)
    tot = ctot.reshape(-1)
    active = freezing.reshape(-1) & (c_broken.reshape(-1) > s.broken_min) & (tot > s.total_min)
    ndt = torch.clamp(torch.ceil(tot * s.dt_kappa * s.scaled_up + 0.5), 1.0, s.ndt_max)
    step = (s.dt / ndt)[None] * s.kappa
    zero_row = torch.zeros_like(c[:1])
    for t in range(int(s.ndt_max)):
        live = active & (t < ndt)
        suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(c, (0,)), 0), (0,)), zero_row])
        lead = centre[:, None] * c * tot[None]
        coag = torch.zeros_like(c)
        q = 0
        for ky in range(n):
            rows = slice(q, q + n - ky)
            q += n - ky
            a = merge[rows].long()
            term = lead[ky] * (suffix[a] + (c[a - 1] / width[rows, None]) * off[rows, None])
            coag[ky:] += term * valid[rows, None]
        upd = c - step * (coag - torch.cat([zero_row, coag[:-1]]))
        c = torch.where(live[None], torch.clamp(upd, min=0.0), c)
    out.copy_(c.reshape(out.shape))


def _stack(seed, dtype_name, shape=SHAPE):
    d = fields(seed, shape=shape)
    return (torch.tensor(d["cf"], dtype=TDT[dtype_name]), torch.from_numpy(d["freezing"].copy()), d)


def _active(cf, freezing):
    return freezing & (cf[:-1].sum(0) > 0.01) & (cf.sum(0) > 0.1)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("scaled", [False, True])
def test_reference_matches_jax(scaled, dtype_name):
    d = fields(7, shape=SHAPE)
    jp, jb, pp, pb = params(welding_type="roach", welding_use_scaled_area=scaled)
    with jax_scope(dtype_name):
        (jc, pc), (jf, pf) = both(dtype_name, d["cf"], d["freezing"])
        ref = np.asarray(jfsd.welding_roach(jc, DT, jp, jb, jf))
    out = pfsd.welding_roach_reference(pc, DT, pp, pb, pf)
    active = _active(pc, pf).numpy()
    assert active.sum() > 50 and (~active).sum() > 50
    assert_close(ref, out, {"float64": 1e-9, "float32": 1e-4}[dtype_name], "welding")
    assert (np.abs(out.numpy() - pc.numpy())[:, active].max(0) > 1e-4).all()


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_member_minor_stack_equals_each_member_alone(dtype_name):
    """(nbins, N, ny, nx), members drawn from three seeds: member m of the
    stack is member m welded alone, bitwise."""
    _, _, pp, pb = params(welding_type="roach", welding_use_scaled_area=True)
    members = [_stack(seed, dtype_name)[:2] for seed in (1, 2, 3)]
    cf = torch.stack([c for c, _ in members], dim=1)
    freezing = torch.stack([f for _, f in members])
    assert tuple(cf.shape) == (NB, 3) + SHAPE
    out = pfsd.welding_roach_reference(cf, DT, pp, pb, freezing)
    for m, (c, f) in enumerate(members):
        alone = pfsd.welding_roach_reference(c, DT, pp, pb, f)
        assert torch.equal(out[:, m], alone), m
        assert not torch.equal(alone, c)


# ---------------------------------------------------------------------------
# the wrapper: plan table, scalars, dispatch, gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("scaled", [False, True])
def test_plan_table_and_scalars_give_the_plain_version(scaled, dtype_name, monkeypatch):
    _, _, pp, pb = params(welding_type="roach", welding_use_scaled_area=scaled)
    cf, freezing, _ = _stack(4, dtype_name, shape=(12, 12))
    monkeypatch.setattr(welding_cuda, "_launch", emulate_kernel)
    launches = welding_cuda.launches
    out = welding_cuda.weld(cf, DT, pp, pb, freezing)
    ref = pfsd.welding_roach_reference(cf, DT, pp, pb, freezing)
    assert out.dtype == cf.dtype and int(_active(cf, freezing).sum()) > 10
    assert torch.equal(out, ref) and not torch.equal(out, cf)
    assert welding_cuda.launches == launches  # the stand-in counts nothing


def test_dispatch(monkeypatch):
    """The CPU takes the plain version; a stack that takes the kernel goes
    to the launch, under no_grad, or through WeldingRoach where a gradient
    is recorded."""
    _, _, pp, pb = params(welding_type="roach", welding_use_scaled_area=True)
    cf, freezing, _ = _stack(5, "float64", shape=(12, 12))
    calls = []

    def launch(*args):
        calls.append(torch.is_grad_enabled())
        emulate_kernel(*args)

    monkeypatch.setattr(welding_cuda, "_launch", launch)
    ref = pfsd.welding_roach(cf, DT, pp, pb, freezing)
    assert not calls and torch.equal(ref, pfsd.welding_roach_reference(cf, DT, pp, pb, freezing))
    monkeypatch.setattr(pfsd, "_kernel_for", lambda t: True)
    assert torch.equal(pfsd.welding_roach(cf, DT, pp, pb, freezing), ref) and calls == [False]
    leaf = cf.clone().requires_grad_(True)
    out = pfsd.welding_roach(leaf, DT, pp, pb, freezing)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "WeldingRoachBackward"
    assert torch.equal(out.detach(), ref) and calls == [False, False]


def _loss_weights(shape, seed=9):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape)


def test_recorded_gradient_equals_plain_autograd_and_jax(monkeypatch):
    """float64: WeldingRoach with the plain forward against straight
    autograd through the plain version (bitwise), and against jax.grad of
    the JAX package's welding_roach (1e-9 of the magnitude); the gradient
    is not the identity."""
    jp, jb, pp, pb = params(welding_type="roach", welding_use_scaled_area=True)
    cf, freezing, d = _stack(6, "float64", shape=(12, 12))
    w = _loss_weights(cf.shape)
    tw = torch.tensor(w)

    def grad_of(fn):
        leaf = cf.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((fn(leaf) * tw).sum(), leaf)
        return g

    monkeypatch.setattr(welding_cuda, "weld", pfsd.welding_roach_reference)
    got = grad_of(lambda x: welding_cuda.welding_roach_recorded(x, DT, pp, pb, freezing))
    monkeypatch.undo()
    plain = grad_of(lambda x: pfsd.welding_roach_reference(x, DT, pp, pb, freezing))
    assert torch.equal(got, plain)
    active = _active(cf, freezing)
    assert (got - tw).abs()[:, active].max() > 1e-6  # welding moves the gradient
    assert torch.equal(got[:, ~active], tw[:, ~active])
    with jax.enable_x64(True):
        jf = jax.numpy.asarray(d["freezing"])
        ref = jax.grad(lambda c: (jfsd.welding_roach(c, DT, jp, jb, jf) * w).sum())(jax.numpy.asarray(d["cf"]))
    assert_close(np.asarray(ref), got, 1e-9, "gradient")


def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    _, _, pp, pb = params(welding_type="roach")
    cf, freezing, _ = _stack(2, "float32", shape=(8, 8))
    monkeypatch.setattr(welding_cuda, "_launch", emulate_kernel)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        welding_cuda.weld(cf.half(), DT, pp, pb, freezing)
    with pytest.raises(ValueError, match="for 6 bins"):
        welding_cuda.weld(cf[:-1], DT, pp, pb, freezing)
    with pytest.raises(ValueError, match="freezing mask"):
        welding_cuda.weld(cf, DT, pp, pb, freezing.float())
    with pytest.raises(ValueError, match="contiguous"):
        welding_cuda.weld(cf.transpose(1, 2), DT, pp, pb, freezing.T)
    monkeypatch.undo()
    launches = welding_cuda.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        welding_cuda.weld(cf, DT, pp, pb, freezing)
    assert welding_cuda.launches == launches


def test_kernel_request_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc to build the kernel its build raises; the wrapper never
    falls back to the plain version."""
    monkeypatch.setattr(welding_cuda, "_libs", {})
    monkeypatch.setattr(momentum_cuda, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(momentum_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        welding_cuda._library(NB)
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
