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
* the wrapper's plan and scalars: ``welding_cuda.weld`` with the launch
  replaced by ``emulate_kernel`` -- the kernel's arithmetic written in
  torch operations from the very -D flags (parsed back), host table and
  scalars the wrapper hands the kernel: pass 1 copies the inactive cells
  and lists the active ones in a shuffled order (as the atomic list may
  order them), pass 2 welds the listed cells to the cap of masked
  substeps with one division a merge bin and a product by 0 on an invalid
  pair only, and scatters them back -- equals the plain version bitwise in
  float32, float64 and bfloat16, also on bins with undefined merge bins;
* the plan: its flags hold ``welding_pairs``' merge bins and valid flags
  (the default 20-bin configuration and the tests' bins), two plans give
  two library tags and one plan one, and the table has the bits of
  ``torch.as_tensor`` of the pairs' values in each dtype;
* the kernel's quotient without a division (a rounded reciprocal and two
  fma corrections) equals the IEEE division in exact arithmetic, in float
  and double over its range and, formed in double, for every float; the
  emulation's fma rounds once; its quotients with the switch outside that
  range (``exact_quotient``) equal torch's division, and tiny bins weld
  through it to the plain version's bits;
* ``WeldingRoach`` with its forward swapped for the plain one equals plain
  autograd bitwise, and the JAX package's ``jax.grad`` through its
  ``welding_roach`` within 1e-9 in float64;
* the dispatch: a stack on the CPU takes the plain version, one that takes
  the kernel goes to the launch (through ``WeldingRoach`` where a gradient
  is recorded); what the wrapper refuses; no nvcc raises.
"""

import dataclasses
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from nextsim_tpu.ops import fsd as jfsd
from nextsim_tpu_torch import Config
from nextsim_tpu_torch.ops import fsd as pfsd
from nextsim_tpu_torch.ops import momentum_cuda, welding_cuda
from test_torch_fsd import NB, both, fields, params
from test_torch_momentum import assert_close
from test_torch_thermo import DT, jax_scope

torch.set_num_threads(1)

SHAPE = (24, 24)
TDT = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def parse_defines(defines):
    """(nbins, merge bins, valid flags) read back from ``plan_defines``."""
    d = dict(f[len("-D"):].split("=", 1) for f in defines)
    merge, valid = d["WELDING_MERGE"], d["WELDING_VALID"]
    assert merge[0] == "m" and valid[0] == "v" and len(merge) == 1 + 2 * (len(valid) - 1)
    return (int(d["WELDING_NBINS"]), [int(merge[i:i + 2]) for i in range(1, len(merge), 2)],
            [f == "1" for f in valid[1:]])


def _two_sum(a, b):
    """(a + b rounded, its exact error)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_product(a, b):
    """(a * b rounded, its exact error) of doubles (Veltkamp's split)."""
    p = a * b
    ca, cb = 134217729.0 * a, 134217729.0 * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_odd(a, b):
    """a + b of doubles rounded to odd: where inexact, the neighbour whose
    last bit is 1."""
    s, e = _two_sum(a, b)
    away = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    return torch.where((e != 0) & (s.view(torch.int64) % 2 == 0), torch.nextafter(s, away), s)


def fma(a, b, c):
    """The card's fma(a, b, c), rounded once (float: the exact product in
    double plus c rounded to odd, then to float, as 53 >= 2 * 24 + 2 bits
    allow; double: Boldo and Melquiond's emulation through rounding to odd).
    Exact where nothing under- or overflows."""
    if a.dtype == torch.float32:
        return _add_odd(a.double() * b.double(), c.double()).float()
    uh, ul = _two_product(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_odd(tl, ul)


#: the kernel's ``Exact`` (lo, hi) of each type a quotient is formed in
EXACT = {torch.float32: (2.0 ** -90, 2.0 ** 90), torch.float64: (2.0 ** -960, 2.0 ** 960)}


def corrected_quotients(x, w):
    """The kernel's ``markstein`` in the type of ``x``: x * y with y = 1 / w
    rounded once, then two corrections q' = fma(fma(-w, q, x), y, q)."""
    y = 1.0 / w
    q = x * y
    q = fma(fma(-w, q, x), y, q)
    return fma(fma(-w, q, x), y, q)


def kernel_quotients(c, width):
    """The kernel's quotients c[k] / width[k] of one substep, for bins ``c``
    (k, cells) of a plane dtype: ``quotient`` (the corrections in the type
    torch computes the plane's operators in) where the dividend and the
    quotient lie in ``Exact``'s range, a zero, an infinity or a NaN its own
    quotient; every quotient of a cell that met another dividend taken
    again by ``exact_quotient`` (a float's: the corrections in double,
    rounded once to float; a double's: the IEEE division). Returns
    (quotients, the cells that took ``exact_quotient``)."""
    op = torch.float64 if c.dtype == torch.float64 else torch.float32
    lo, hi = EXACT[op]
    x = c.to(op)
    q = corrected_quotients(x, width.to(op)[:, None])
    own = (x == 0) | ~torch.isfinite(x)
    exact = (x.abs() >= lo) & (x.abs() <= hi) & (q.abs() >= lo) & (q.abs() <= hi)
    again = (~(exact | own)).any(0)
    d = torch.where(own, c, q.to(c.dtype))
    if c.dtype == torch.float64:
        redo = c / width[:, None]
    else:
        redo = torch.where(own, c, corrected_quotients(c.double(), width.double()[:, None]).float().to(c.dtype))
    return torch.where(again[None], redo, d), again


#: substeps of listed cells that took ``exact_quotient``, summed by ``emulate_kernel``
DIVIDED = {"cell-substeps": 0}


def emulate_kernel(conc_fsd, out, ctot, c_broken, freezing, work, defines, table, s, seed=0):
    """Stands in for ``welding_cuda._launch`` off the card: what the two
    passes compute, from the -D flags (parsed back), the host table (the
    merge bins' widths, the pairs' offsets, the bin centres) and the
    scalars ``s`` that the wrapper hands the kernel, in torch operations.
    Pass 1 writes the active cells' count and list into ``work``, the list
    in an order shuffled from ``seed`` (as the atomic list may order
    them); pass 2 gathers the cells in the list's order, runs the listed
    ones through ``s.ndt_max`` masked substeps, each stopping at its own
    count, with one quotient a merge bin (``kernel_quotients``) and the
    valid flag only as a product by 0 on an invalid pair, and scatters them
    back into ``out``,
    where every other cell keeps its value. Reads nothing back from the
    device: every shape is the stack's."""
    n, merge, valid = parse_defines(defines)
    pairs = n * (n + 1) // 2
    assert n == s.nbins and len(merge) == len(valid) == pairs and table.numel() == 2 * n + pairs
    width, off, centre = table[:n], table[n:n + pairs], table[n + pairs:]
    c_all, tot_all = conc_fsd.reshape(n, -1), ctot.reshape(-1)
    # pass 1: the active cells first, in a shuffled order, then the rest
    active = freezing.reshape(-1) & (c_broken.reshape(-1) > s.broken_min) & (tot_all > s.total_min)
    key = torch.rand(active.shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    order = torch.argsort(torch.where(active, key, key + 2.0))
    work[0] = active.sum()
    work[1:] = order.to(work.dtype)
    # pass 2 on the cells in the list's order: those past the count do not weld
    listed = active[order]
    c, tot = c_all[:, order], tot_all[order]
    ndt = torch.clamp(torch.ceil(tot * s.dt_kappa * s.scaled_up + 0.5), 1.0, s.ndt_max)
    step = (s.dt / ndt)[None] * s.kappa
    zero_row = torch.zeros_like(c[:1])
    used = torch.as_tensor(sorted(set(merge)))
    merge_t, valid_t = torch.as_tensor(merge), torch.as_tensor(valid)
    for t in range(int(s.ndt_max)):
        live = listed & (t < ndt)
        suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(c, (0,)), 0), (0,)), zero_row])
        d = torch.zeros_like(suffix)
        d[used], divided = kernel_quotients(c[used - 1], width[used - 1])  # one quotient a merge bin
        DIVIDED["cell-substeps"] = (divided & live).sum() + DIVIDED["cell-substeps"]  # a tensor: no read-back
        lead = centre[:, None] * c * tot[None]
        coag = torch.zeros_like(c)
        q = 0
        for ky in range(n):
            rows = slice(q, q + n - ky)
            q += n - ky
            a = merge_t[rows]
            term = lead[ky] * (suffix[a] + d[a] * off[rows, None])
            term = torch.where(valid_t[rows, None], term, term * 0.0)
            coag[ky:] += term
        upd = c - step * (coag - torch.cat([zero_row, coag[:-1]]))
        c = torch.where(live[None], torch.clamp(upd, min=0.0), c)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel())
    out.copy_(c[:, back].reshape(out.shape))


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


def _undefined(bins, cells=((3, 1), (5, 0), (5, 5), (4, 2))):
    """``bins`` with the merge bins of the pairs (kx, ky) in ``cells``
    undefined: no configuration has such a pair, the plan allows it."""
    alpha = bins.alpha_merge.copy()
    for kx, ky in cells:
        alpha[kx, ky] = -999
    return dataclasses.replace(bins, alpha_merge=alpha)


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_undefined_merge_bins_give_the_plain_version(dtype_name, monkeypatch):
    """Invalid pairs: the kernel's product by 0 on those alone equals the
    plain version's product of every pair of their rows by the flag."""
    _, _, pp, pb = params(welding_type="roach", welding_use_scaled_area=True)
    bins = _undefined(pb)
    assert pfsd.welding_pairs(bins, NB)[3].count(0.0) == 4
    cf, freezing, _ = _stack(8, dtype_name, shape=(12, 12))
    monkeypatch.setattr(welding_cuda, "_launch", emulate_kernel)
    out = welding_cuda.weld(cf, DT, pp, bins, freezing)
    ref = pfsd.welding_roach_reference(cf, DT, pp, bins, freezing)
    assert torch.equal(out, ref) and not torch.equal(ref, pfsd.welding_roach_reference(cf, DT, pp, pb, freezing))


def _bins_20():
    """The 20-bin FSD of the wave path (the configuration's defaults)."""
    p = pfsd.FSDParams.from_config(Config(overrides={"wave_coupling.num_fsd_bins": 20,
                                                     "wave_coupling.welding_type": "roach"}))
    return p, pfsd.make_bins(p)


@pytest.mark.parametrize("which", ["20 bins", "the tests' bins", "scaled areas", "undefined merge bins"])
def test_plan_defines_hold_the_pairs(which):
    """The -D flags read back give ``welding_pairs``' merge bins and valid
    flags, pair by pair."""
    if which == "20 bins":
        pp, pb = _bins_20()
    else:
        _, _, pp, pb = params(welding_type="roach", welding_use_scaled_area=which == "scaled areas")
        if which == "undefined merge bins":
            pb = _undefined(pb)
    n = pp.num_bins
    defines = welding_cuda.plan_defines(pb, n)
    merge, _, _, valid = pfsd.welding_pairs(pb, n)
    assert parse_defines(defines) == (n, merge, [v == 1.0 for v in valid])
    assert len(merge) == n * (n + 1) // 2 and all(1 <= a <= n for a in merge)
    assert not any("," in f or " " in f for f in defines)  # one token a list
    assert (which == "undefined merge bins") == (0.0 in valid)


def test_one_library_a_plan(monkeypatch, tmp_path):
    """Two plans (other bin edges at the same count; another count;
    undefined merge bins) give two library tags, one plan (bins made
    twice) one, and ``_library`` builds once a plan."""
    _, _, pp, pb = params(welding_type="roach")
    plans = {"6 bins": welding_cuda.plan_defines(pb, NB),
             "6 bins again": welding_cuda.plan_defines(pfsd.make_bins(pp), NB),
             "6 bins of 10 m": welding_cuda.plan_defines(params(welding_type="roach", bin_cst_width=10.0)[3], NB),
             "7 bins": welding_cuda.plan_defines(params(welding_type="roach", num_bins=7)[3], 7),
             "undefined": welding_cuda.plan_defines(_undefined(pb), NB)}
    path = {k: momentum_cuda.library_path(welding_cuda._SRC, "libwelding_roach", (*momentum_cuda._NVCC_FLAGS, *d))
            for k, d in plans.items()}
    assert path["6 bins"] == path["6 bins again"]
    assert len({path[k] for k in plans if k != "6 bins again"}) == 4
    built = []
    monkeypatch.setattr(welding_cuda, "_libs", {})
    monkeypatch.setattr(welding_cuda, "build", lambda d: built.append(d) or tmp_path / f"{len(built)}.so")
    monkeypatch.setattr(welding_cuda, "load", lambda path: path)
    libs = [welding_cuda._library(plans[k]) for k in ("6 bins", "6 bins again", "7 bins", "6 bins")]
    assert built == [plans["6 bins"], plans["7 bins"]] and libs[0] is libs[1] is libs[3] != libs[2]


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("which", ["the tests' bins", "20 bins"])
def test_plan_table_has_the_plain_versions_bits(which, dtype_name):
    """The host table copied into the kernel's parameters: the merge bins'
    widths, the pairs' offsets and the bin centres with the bits of
    ``torch.as_tensor`` of ``welding_pairs``' values in the dtype, which
    are the plain version's columns (``fsd._welding_plan``)."""
    pp, pb = _bins_20() if which == "20 bins" else params(welding_type="roach")[2:]
    n, dtype = pp.num_bins, TDT[dtype_name]
    pairs = n * (n + 1) // 2
    defines, table = welding_cuda._plan(pb, n, dtype)
    merge, width, off, _ = pfsd.welding_pairs(pb, n)
    assert defines == welding_cuda.plan_defines(pb, n)
    assert table.dtype == dtype and table.device.type == "cpu" and table.numel() == 2 * n + pairs
    assert torch.equal(_bits(table[n:n + pairs]), _bits(torch.as_tensor(off, dtype=dtype)))
    assert torch.equal(_bits(table[n + pairs:]), _bits(torch.as_tensor(list(pb.scaled_centre), dtype=dtype)))
    # each pair's width is the width of its merge bin in the table
    assert torch.equal(_bits(table[torch.as_tensor(merge) - 1]), _bits(torch.as_tensor(width, dtype=dtype)))
    plain = pfsd._welding_plan(pb, n, dtype, "cpu")
    assert torch.equal(_bits(torch.cat([w[:, 0] for _, _, w, _, _ in plain])),
                       _bits(table[torch.as_tensor(merge) - 1]))
    assert torch.equal(_bits(torch.cat([o[:, 0] for _, _, _, o, _ in plain])), _bits(table[n:n + pairs]))
    assert welding_cuda._plan(pb, n, dtype)[1] is table  # made once


def _round(x, bits):
    """The Fraction ``x`` rounded to ``bits`` significant bits, to nearest
    even (no under- or overflow)."""
    if x == 0:
        return x
    a = abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    e += (Fraction(2) ** (e + 1) <= a) - (Fraction(2) ** e > a)  # 2^e <= a < 2^(e+1)
    m = a * Fraction(2) ** (bits - 1 - e)
    n, rest = divmod(m.numerator, m.denominator)
    n += 2 * rest > m.denominator or (2 * rest == m.denominator and n % 2)
    return (1 if x > 0 else -1) * n / Fraction(2) ** (bits - 1 - e)


def _markstein(x, w, bits):
    """The kernel's ``markstein(x, w, 1/w rounded)`` in exact arithmetic
    rounded as the card rounds (``bits`` significant bits, no under- or
    overflow); asserts that the last remainder is exact."""
    x, w = Fraction(float(x)), Fraction(float(w))
    y = _round(1 / w, bits)
    q0 = _round(x * y, bits)
    q1 = _round(_round(x - w * q0, bits) * y + q0, bits)
    r = x - w * q1
    assert _round(r, bits) == r
    return _round(r * y + q1, bits)


def _plan_widths(np_dtype):
    widths = set()
    for kw in ({}, {"welding_use_scaled_area": True}, {"num_bins": 20, "bin_cst_width": 10.0},
               {"num_bins": 32, "bin_cst_width": 10.0}):
        _, _, pp, pb = params(welding_type="roach", **kw)
        widths.update(np_dtype(w) for w in pfsd.welding_pairs(pb, pp.num_bins)[1])
    return sorted(widths)


@pytest.mark.parametrize("dtype_name, bits, lim", [("float32", 24, 90), ("float64", 53, 960)])
def test_kernels_quotient_is_the_ieee_division(dtype_name, bits, lim):
    """The kernel's quotient without a division (csrc/welding_roach.cu
    ``markstein``): q0 = a * y with y = 1/w rounded once and two
    corrections q' = fma(fma(-w, q, a), y, q), in exact arithmetic rounded
    as the card rounds, equal the IEEE quotient a / w, for the merge bins'
    widths of four plans and a log-uniform over the kernel's exact range
    (``Exact``) and at and just below powers of two times w, where the
    quotient's ulp changes (one correction is not enough there)."""
    np_dtype = {"float32": np.float32, "float64": np.float64}[dtype_name]
    rng = np.random.default_rng(5)
    for w in _plan_widths(np_dtype):
        a = list(np_dtype(2.0) ** rng.uniform(-lim, lim, 60).astype(np_dtype))
        for k in range(-8, 9):  # a / w at and just below 2^k
            edge = np_dtype(w * np_dtype(2.0 ** k))
            a += [edge, np.nextafter(edge, np_dtype(0)), np.nextafter(edge, np_dtype(np.inf))]
            a += list(edge * (1 - rng.uniform(0, 1e-6, 4)).astype(np_dtype))
        for x in a:
            assert _markstein(x, w, bits) == Fraction(float(x / w)), (float(w), float(x))


def test_kernels_float_quotient_through_double_is_the_ieee_division():
    """``exact_quotient`` of a float: ``markstein`` in double, rounded once
    to float, equals float's IEEE quotient for every float dividend,
    subnormals and the largest included, and the merge bins' widths."""
    rng = np.random.default_rng(6)
    for w in _plan_widths(np.float32):
        a = list(np.float32(2.0) ** rng.uniform(-149, 128, 80).astype(np.float32))
        a += [np.float32(1e-45), np.float32(3e-39), np.finfo(np.float32).max, np.finfo(np.float32).tiny]
        a += list((w * np.float32(2.0) ** rng.integers(-140, 100, 20).astype(np.float32)).astype(np.float32))
        for x in a:
            x = np.float32(x)
            with np.errstate(over="ignore"):  # a quotient past float's largest is inf in both
                want, got = x / w, np.float32(float(_markstein(x, w, 53)))
            assert got == want, (float(w), float(x))


@pytest.mark.parametrize("dtype_name, bits, lim", [("float32", 24, 40), ("float64", 53, 400)])
def test_fma_emulation_rounds_once(dtype_name, bits, lim):
    """``fma`` (the card's fma written in torch operations, which
    ``kernel_quotients`` forms the kernel's corrections with) equals a * b
    + c in exact arithmetic rounded once, on random operands and where c
    nearly cancels a * b (no result under- or overflows)."""
    dtype, np_dtype = TDT[dtype_name], {"float32": np.float32, "float64": np.float64}[dtype_name]
    rng = np.random.default_rng(11)
    n = 400
    mag = lambda: rng.uniform(1, 2, n) * 2.0 ** rng.integers(-lim, lim, n)  # noqa: E731
    a = torch.as_tensor((mag() * rng.choice([-1, 1], n)).astype(np_dtype))
    b = torch.as_tensor(mag().astype(np_dtype))
    near = -(a.double() * b.double()).to(dtype) * torch.as_tensor(1 + rng.uniform(-1e-6, 1e-6, n)).to(dtype)
    c = torch.where(torch.arange(n) % 2 == 0, near, torch.as_tensor(mag().astype(np_dtype))).to(dtype)
    got = fma(a, b, c)
    for i in range(n):
        x, y, z = (Fraction(float(t[i])) for t in (a, b, c))
        assert Fraction(float(got[i])) == _round(x * y + z, bits), (float(a[i]), float(b[i]), float(c[i]))


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_kernel_quotients_are_the_ieee_division(dtype_name):
    """``kernel_quotients`` equals torch's division bitwise (NaN in the same
    places) for the 20-bin plan's widths, on normal dividends, zeros,
    infinities and NaN, and tiny dividends (to the least subnormal) under
    ``Exact``'s range, which only their cells take again by
    ``exact_quotient``; the corrections alone miss some of those (in float
    and double: the remainder underflows), so the switch is what makes
    them exact."""
    dtype = TDT[dtype_name]
    op = torch.float64 if dtype == torch.float64 else torch.float32
    _, pb = _bins_20()
    width = torch.as_tensor(sorted(set(pfsd.welding_pairs(pb, 20)[1])), dtype=dtype)
    k = width.numel()
    rng = np.random.default_rng(12)
    least = -1074 if op == torch.float64 else -149
    normal = torch.as_tensor(rng.uniform(0.0, 1.0, (k, 50)) * 10.0 ** rng.integers(-12, 3, (k, 50)), dtype=dtype)
    tiny = torch.as_tensor(2.0 ** rng.uniform(least, np.log2(EXACT[op][0]) + 2, (k, 4000)), dtype=dtype)
    c = torch.cat([normal, tiny], 1)
    c[0, :3] = torch.as_tensor([0.0, float("inf"), float("nan")], dtype=dtype)
    d, again = kernel_quotients(c, width)
    want = c / width[:, None]
    assert torch.equal(torch.isnan(d), torch.isnan(want))
    assert torch.equal(d.nan_to_num(0.0), want.nan_to_num(0.0))
    assert not again[:50].any() and again[50:].float().mean() > 0.9
    missed = corrected_quotients(c.to(op), width.to(op)[:, None]).to(dtype) != want
    missed[0, 1:3] = False  # the corrections give NaN for an infinity, and NaN != NaN
    assert not missed[:, :50].any() and (dtype == torch.bfloat16 or missed[:, 50:].any())


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "bfloat16"])
def test_tiny_bins_give_the_plain_version(dtype_name, monkeypatch):
    """Active cells whose upper bins hold tiny dividends (a freeze-up's
    decaying bins: under 2^-90 in float, near double's least normal
    quotient in double, where the corrections alone miss some) weld
    through ``exact_quotient`` to the plain version's bits."""
    _, _, pp, pb = params(welding_type="roach")
    cf, freezing, _ = _stack(4, dtype_name, shape=(12, 12))
    lower = cf[:NB // 2].sum(0) > 0.1  # active still with tiny upper bins
    active = torch.nonzero((_active(cf, freezing) & lower).flatten()).flatten()
    assert len(active) > 10
    width = torch.as_tensor(pfsd.welding_pairs(pb, NB)[1][:NB], dtype=torch.float64)
    rng = np.random.default_rng(13)
    scale = 2.0 ** rng.uniform(-1026, -1016, (NB // 2, len(active))) if dtype_name == "float64" else \
        2.0 ** rng.uniform(-150, -100, (NB // 2, len(active)))
    flat = cf.reshape(NB, -1)
    flat[NB // 2:, active] = torch.as_tensor(scale * width[NB // 2:, None].numpy(), dtype=cf.dtype)
    assert bool(_active(cf, freezing).flatten()[active].all())
    monkeypatch.setattr(welding_cuda, "_launch", emulate_kernel)
    monkeypatch.setitem(DIVIDED, "cell-substeps", 0)
    out = welding_cuda.weld(cf, DT, pp, pb, freezing)
    assert int(DIVIDED["cell-substeps"]) >= len(active)
    assert torch.equal(out, pfsd.welding_roach_reference(cf, DT, pp, pb, freezing))


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
    _, _, _, pb = params(welding_type="roach")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        welding_cuda._library(welding_cuda.plan_defines(pb, NB))
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
