"""Ensemble forcing perturbations (the counterpart of
nextsim_tpu/ensemble/perturbation.py).

The reference's EnKF perturbation generator (reference:
modules/enkf/perturbation/src/mod_random_forcing.F90:1-813 and mod_pseudo.F90
pseudo2D — Evensen (1994) spectral pseudo-random fields), hooked into forcing
loading under #ifdef ENSEMBLE (reference: model/externaldata.cpp:244-278).

Spatially correlated unit fields come from a Gaussian spectrum with random
phases through ``torch.fft.irfft2``, on the device; they evolve as an AR(1)
red process in time with alpha = exp(-dt/tcorr) (mod_random_forcing.F90:
316-326) and perturb sea-level pressure, air temperature, precipitation and
dew point with the namelist variances (modules/enkf/perturbation/nml/
pseudo2D.nml). With prsflg=2 the wind gets the geostrophic wind of the SLP
perturbation, scaled to the target wind variance (mod_random_forcing.F90:
356-370).

The draw and the spectrum are separate: ``draw_phases`` takes the phases from
a member's ``torch.Generator`` (seeded ``seed * 1000003 + member``, one stream
a member, drawn on the device), and ``spectral_noise`` turns phases into unit
fields. A member's stream is the same whether it runs alone in a
``Simulator`` or inside ``BatchedEnsemble``: each member draws from its own
generator, with a spectral call of its own (``stack_forcings`` then puts the
members' forcings on a member axis).

The draws ride the step programs, as in the JAX package's chunk program:
``apply`` (``(ran, base forcing) -> (ran', perturbed forcing)``, one draw)
runs inside ``Simulator._chunk_body`` and the batched ensemble's body, and
on the card inside their CUDA graphs, with the generators registered
(``model/captured.py``). ``init_state`` stays a host call, made once before
the first program call. ``EnsembleForcing._ran`` and ``.generator`` are a
member's single carry: the eager provider call (``__call__``) and the
programs read and write the same two, so steps, chunks and eager steps
interleave as one stream (the JAX package keeps two carries, ROADMAP C).
The warm-up call before a capture fills ``_amplitude``'s cache and cuFFT's
plan for the shape, so a capture creates neither.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from benchmark.reference.plain.core import constants as phys
from benchmark.reference.plain.ops import stencil


@dataclasses.dataclass(frozen=True)
class PerturbationParams:
    """Defaults from modules/enkf/perturbation/nml/pseudo2D.nml."""

    scorr_km: float = 1000.0  # horizontal decorrelation length [km] (scorr)
    tcorr_days: float = 2.0  # temporal decorrelation [days] (tcorr)
    vslp: float = 10.0  # SLP variance [hPa^2]
    vwndspd: float = 0.64  # wind speed variance [(m/s)^2]
    vairtmp: float = 9.0  # air temperature variance [K^2]
    vprecip: float = 1.0  # relative precip variance
    vrelhum: float = 1.0  # humidity variance (applied to dew point, K^2)
    prsflg: int = 2


def member_generator(seed: int, member: int, device) -> torch.Generator:
    """The random stream of one ensemble member, on ``device`` (reference:
    set_random_seed2 + member id)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed * 1000003 + member)
    return g


@functools.lru_cache(maxsize=8)
def _amplitude(shape, rh_cells: float, dtype, device) -> torch.Tensor:
    """Spectral amplitudes of the half plane (ny, nx//2+1): a Gaussian
    spectrum exp(-k^2 rh^2 c), with c such that the spatial autocorrelation
    at distance rh is exp(-1) (corr(r) = exp(-r^2/rh^2) has the spectrum
    exp(-pi^2 k^2 rh^2), k in cycles a cell)."""
    ny, nx = shape
    ky = torch.fft.fftfreq(ny, dtype=dtype, device=device)[:, None]
    kx = torch.fft.rfftfreq(nx, dtype=dtype, device=device)[None, :]
    sig2 = (math.pi * rh_cells) ** 2 / 2.0
    log_amp = -(kx**2 + ky**2) * sig2
    # normalise in log space: with rh larger than the domain every raw
    # amplitude underflows in float32, so shift by the largest non-DC mode
    log_amp[0, 0] = -math.inf  # zero-mean field: no DC
    return torch.exp(log_amp - log_amp.max())


def draw_phases(generator: torch.Generator, n: int, shape, *, dtype, device) -> torch.Tensor:
    """``n`` planes of phases uniform in [0, 2 pi) on the half plane of a
    (ny, nx) field, (n, ny, nx//2+1), from ``generator``."""
    ny, nx = shape
    u = torch.rand((n, ny, nx // 2 + 1), generator=generator, dtype=dtype, device=device)
    return 2.0 * math.pi * u


def spectral_noise(phase: torch.Tensor, shape, rh_cells: float) -> torch.Tensor:
    """Unit-variance random fields with a Gaussian spatial correlation of
    decorrelation length ``rh_cells`` grid cells, one for each (ny, nx//2+1)
    plane of ``phase`` (leading dimensions are kept): the torch.fft
    equivalent of pseudo2D, mod_pseudo.F90:14-240. Each field is divided by
    its own population standard deviation."""
    amp = _amplitude(tuple(shape), float(rh_cells), phase.dtype, phase.device)
    field = torch.fft.irfft2(torch.complex(amp * torch.cos(phase), amp * torch.sin(phase)), s=tuple(shape))
    std = torch.std(field, dim=(-2, -1), correction=0, keepdim=True) + 1e-30
    return field / std


def stack_forcings(forcings):
    """The forcings of a batched ensemble's members as one ``Forcing`` for
    ``Simulator.batched_step_fn``: a leaf that every member shares (the same
    tensor, as the perturbed members' forcings pass on the control's
    unperturbed fields, or None) stays as it is, so it is read once for all
    members; a leaf that differs is stacked with the member axis before the
    plane's two axes, ``(N, ny, nx)``."""
    first = forcings[0]
    kw = {}
    for f in dataclasses.fields(first):
        leaves = [getattr(x, f.name) for x in forcings]
        if any(leaf is not leaves[0] for leaf in leaves):
            kw[f.name] = torch.stack(leaves, dim=-3)
    return first.replace(**kw)


class EnsembleForcing:
    """Wraps a forcing provider, adding the perturbations of one member."""

    FIELDS = ("slp", "airtmp", "precip", "relhum")

    def __init__(self, provider, grid, cfg, params: Optional[PerturbationParams] = None, seed: int = 11,
                 *, dtype, device):
        self.provider = provider
        self.grid = grid
        self.p = params or PerturbationParams()
        self.member = cfg["statevector.ensemble_member"]
        self.dt_days = cfg["simul.timestep"] / 86400.0
        self.dtype = dtype
        self.device = torch.device(device)
        self.generator = member_generator(seed, self.member, self.device)
        self.rh_cells = self.p.scorr_km * 1e3 / grid.dx
        self.alpha = math.exp(-self.dt_days / self.p.tcorr_days)
        self._ran: Optional[torch.Tensor] = None

    def _draw_stack(self, generator: torch.Generator) -> torch.Tensor:
        """Fresh unit fields for all perturbed quantities of the member whose
        stream ``generator`` is, stacked (4, ny, nx). A member's fields come
        from a call of their own, also in a batched ensemble: on the card an
        FFT over several members' phases rounded a member's fields otherwise
        (2.4e-7 in float32 at 464^2), and a batched member must equal its
        Simulator bitwise."""
        phase = draw_phases(generator, len(self.FIELDS), self.grid.shape, dtype=self.dtype, device=self.device)
        return spectral_noise(phase, self.grid.shape, self.rh_cells)

    def _advance(self, ran, fresh, f):
        """Pure: advance the AR(1) red process (mod_random_forcing.F90
        ran_update_ran1) with the fresh unit fields and apply every
        perturbation to the forcing ``f``: (ran', f')."""
        p = self.p
        a = self.alpha
        b = math.sqrt(max(0.0, 1.0 - a * a))
        ran = a * ran + b * fresh

        idx = {n: i for i, n in enumerate(self.FIELDS)}
        slp_pert_pa = 100.0 * math.sqrt(p.vslp) * ran[idx["slp"]]  # hPa->Pa
        updates = dict(
            mslp=f.mslp + slp_pert_pa,
            tair=f.tair + math.sqrt(p.vairtmp) * ran[idx["airtmp"]],
            precip=torch.clamp(f.precip * (1.0 + math.sqrt(p.vprecip) * ran[idx["precip"]]), min=0.0),
        )
        if f.dair is not None:
            updates["dair"] = f.dair + math.sqrt(p.vrelhum) * ran[idx["relhum"]]

        if p.prsflg == 2:
            # geostrophic wind from the SLP perturbation, scaled so the wind
            # perturbation magnitude matches sqrt(vwndspd)/3
            # (mod_random_forcing.F90:356-370)
            fcor = 2.0 * math.sin(math.radians(40.0)) * 2.0 * math.pi / 86400.0
            wprsfac = 100.0 * math.sqrt(p.vslp) / (self.rh_cells * self.grid.dx)
            wprsfac = wprsfac / fcor
            wprsfac = math.sqrt(p.vwndspd) / (3.0 * wprsfac)
            dx = self.grid.dx
            dpdx = (slp_pert_pa - torch.roll(slp_pert_pa, 1, dims=1)) / dx * wprsfac
            dpdy = (slp_pert_pa - torch.roll(slp_pert_pa, 1, dims=0)) / dx * wprsfac
            du = -dpdy / (fcor * phys.rhoa)
            dv = dpdx / (fcor * phys.rhoa)
            # cell -> node (wind lives on nodes)
            ones = torch.ones_like(du)
            updates["wind_u"] = f.wind_u + stencil.node_mean_of_cells(du, ones)
            updates["wind_v"] = f.wind_v + stencil.node_mean_of_cells(dv, ones)

        return ran, f.replace(**updates)

    def init_state(self) -> torch.Tensor:
        """The initial AR(1) carry (4, ny, nx): one draw, a host call made
        once before the first step."""
        return self._draw_stack(self.generator)

    def apply(self, ran, forcing):
        """Advance the AR(1) carry one model step with one draw of the
        member's stream and perturb ``forcing``: (ran', forcing'). Pure but
        for the generator; reads nothing back, so a CUDA graph holds it."""
        return self._advance(ran, self._draw_stack(self.generator), forcing)

    def __call__(self, t_days: float, time_init_days: float):
        f = self.provider(t_days, time_init_days)
        if self.member <= 0:
            return f  # member 0 = unperturbed control
        if self._ran is None:
            self._ran = self.init_state()
        self._ran, out = self.apply(self._ran, f)
        return out
