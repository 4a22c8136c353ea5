"""The reference model: the frozen plain code of ``plain/`` driven step by
step in float64.

``Reference(options, device)`` builds, from the run's options and the input
files under ``NEXTSIM_DATA_DIR``, everything the program derives from them:
the grid and its arrays, the parameters, the forcing provider and its
interpolation weights. ``init_state`` recomputes the start, ``forcing(t)``
a step's forcing from the raw files, ``step`` one model step (thermodynamics,
the momentum solve with the plain substep loop, transport and ridging), and
``follow`` a call of k steps from a state. ``perturb`` recomputes a batched
ensemble member's noise from its AR(1) carry and its generator's state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.plain.config.schema import Config
from benchmark.reference.plain.core import constants as phys
from benchmark.reference.plain.core.state import State
from benchmark.reference.plain.ensemble import perturbation
from benchmark.reference.plain.forcing.providers import make_provider
from benchmark.reference.plain.grid.grid import Grid
from benchmark.reference.plain.model import init_state as init_mod
from benchmark.reference.plain.model import params
from benchmark.reference.plain.model.params_thermo import thermo_params
from benchmark.reference.plain.ops import momentum, thermo, transport
from benchmark.reference.plain.utils import dates

class Reference:
    def __init__(self, options: dict, device):
        cfg = Config(overrides=options)
        for what in ("nextwim.use_wim", "nesting.use_nesting", "coupler.with_waves"):
            if cfg[what]:
                raise NotImplementedError(f"the reference does not run {what}")
        if cfg["wave_coupling.num_fsd_bins"] > 0 or cfg["setup.ocean-type"] == "coupled":
            raise NotImplementedError("the reference does not run the floe-size distribution or a coupler")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype = torch.float64
        self.grid = Grid.from_config(cfg)
        self.dt = float(cfg["simul.timestep"])
        self.time_init = dates.string_to_datenum(cfg["simul.time_init"])
        self.dyn = params.dyn_params(cfg, self.grid.dx)
        self.c_fix, self.c_alea = params.cohesion_params(cfg, self.grid.dx)
        self.thermo = thermo_params(cfg) if cfg["thermo.use_thermo_forcing"] else None
        self.transport = transport.TransportParams.from_config(cfg)
        node_lat, _ = self.grid.node_latlon()

        def on_dev(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.grid_arrays = {
            "mask": on_dev(self.grid.mask), "open_mask": on_dev(self.grid.open_mask),
            "node_mask": on_dev(self.grid.node_mask), "node_dirichlet": on_dev(self.grid.node_dirichlet),
            "node_lat": on_dev(node_lat), "delta_x": self.grid.dx,
        }
        self.provider = make_provider(cfg, self.grid, dtype, device=self.device)

    # -- time ---------------------------------------------------------------
    def time_after(self, pcpt: int) -> float:
        return self.time_init + pcpt * self.dt * dates.DAYS_IN_SEC

    def time_info(self, t: float) -> dict:
        """The step's time flags as host numbers, from the model time ``t``."""
        n_day = max(1, round(phys.days_in_sec / self.dt))
        step_in_day = 1 + round(n_day * (t % 1.0))
        md = dates.datenum_to_string(t, "%m%d")
        midnight = abs(t % 1.0) < 1e-9
        flags = {
            "is_day_start": step_in_day == 1, "is_day_end": step_in_day == n_day,
            "is_0915": md == "0915" and midnight, "is_0801": md == "0801" and midnight,
            "is_myi_reset_date": md == self.cfg["age.reset_date"] and midnight,
        }
        return {k: 1.0 if v else 0.0 for k, v in flags.items()}

    # -- the model ------------------------------------------------------------
    def init_state(self, random_number) -> State:
        """The initial state from the input files, with the run's cohesion draw."""
        return init_mod.init_state(self.cfg, self.grid, dtype=self.dtype, device=self.device,
                                   random_number=random_number)

    def forcing(self, pcpt: int):
        """The forcing of the step that starts after ``pcpt`` steps (the
        provider is asked for the step's end time)."""
        return self.provider(self.time_after(pcpt + 1), self.time_init)

    def step(self, state: State, forcing, tinfo: dict) -> State:
        ga = dict(self.grid_arrays)
        ga["cohesion"] = self.c_fix + self.c_alea * state.random_number
        if self.thermo is not None:
            state, _ = thermo.thermo_step(state, forcing, ga, self.dt, self.thermo, tinfo=tinfo)
        kind = self.dyn.dynamics_type
        if kind in ("bbm", "evp", "mevp"):
            state, _ = momentum.explicit_solve(state, forcing, ga, self.dt, self.dyn)
        elif kind == "free_drift":
            state = momentum.free_drift(state, forcing, ga, self.dt, self.dyn)
        if kind != "no_motion":
            state, _ = transport.transport_and_ridge(state, ga, self.dt, self.transport)
        return state

    @torch.no_grad()
    def follow(self, state: State, pcpt: int, k: int):
        """``k`` steps from ``state``, the first after ``pcpt`` steps: (the
        state after them, the last step's forcing)."""
        forcing = None
        for i in range(k):
            forcing = self.forcing(pcpt + i)
            state = self.step(state, forcing, self.time_info(self.time_after(pcpt + i)))
        return state, forcing

    # -- ensemble noise ---------------------------------------------------------
    def noise(self, seed: int):
        """The perturbation engine of a batched ensemble seeded ``seed``."""
        cfg = Config(overrides=dict(self.cfg.as_dict(), **{"statevector.ensemble_member": 1}))
        return perturbation.EnsembleForcing(self.provider, self.grid, cfg, seed=seed, dtype=self.dtype,
                                            device=self.device)

    def perturb(self, engine, base, ran, generator_state, draw_dtype):
        """A perturbed member's forcing for one step: its carry ``ran``
        advanced with one draw of its stream, the draw made from the
        generator state the program had before the step, in the program's
        dtype (the stream's own bits), the rest in the reference's."""
        g = torch.Generator(device=self.device)
        g.set_state(generator_state)
        shape = self.grid.shape
        phase = perturbation.draw_phases(g, len(engine.FIELDS), shape, dtype=draw_dtype, device=self.device)
        fresh = perturbation.spectral_noise(phase.to(self.dtype), shape, engine.rh_cells)
        return engine._advance(ran.to(self.dtype), fresh, base)


def planes(tree) -> dict:
    """The tensor leaves of a State or Forcing by name."""
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)}


#: a plane whose reference is nought to rounding: its largest magnitude under
#: this, in the model's SI units (a nanometre of ice, a billionth of a
#: concentration, a nanopascal); no gap can be taken of it, and it reads 0
#: as long as the program leaves it under ``MOVED``
NOUGHT = 1e-9
MOVED = 1e-6

#: the reading of a plane that is not finite, or that the program moves
#: where the reference leaves it nought: over any limit, and finite, so that
#: the result line stays JSON
FAR = 1e30


#: a property of one kind of ice, compared where that ice is: the plane
#: times the ice's concentration (its volume for a ratio of volumes), over
#: the larger of that product's norm and the weight's. Where the ice
#: vanishes its property is set by rounding: float64 keeps a nanometre of
#: ice that float32 rounds to none, whose temperature is then computed in
#: one and left at freezing in the other, and ``1 - (1 - r) * thick /
#: (thick + new ice)`` flips between r and 1
WEIGHTED = {"tice": "conc", "drag_ui": "conc", "drag_ti": "conc", "age_det": "conc", "fyi_fraction": "conc",
            "ridge_ratio": "thick",
            "tsurf_young": "conc_young", "drag_ui_young": "conc_young", "drag_ti_young": "conc_young"}


def _weighted(program: dict, reference: dict, name: str):
    """(program plane, reference plane) in float64 on the reference's
    device, a plane of ``WEIGHTED`` times its weight; or the plane's
    reading where no gap is taken: ``FAR`` where the program is not finite,
    and where the reference is nought, 0 or ``FAR`` as the program leaves it
    under ``MOVED`` or not."""
    r = reference[name].to(torch.float64)
    p = program[name].to(device=r.device, dtype=torch.float64)
    if not bool(torch.isfinite(p).all()):
        return FAR
    if float(r.abs().max()) < NOUGHT:
        return 0.0 if float(p.abs().max()) < MOVED else FAR
    weight = WEIGHTED.get(name)
    if weight in reference and weight in program:
        r = r * reference[weight].to(torch.float64)
        p = p * program[weight].to(device=r.device, dtype=torch.float64)
    return p, r


def relative_gaps(program: dict, reference: dict) -> dict:
    """Per plane: the norm of the difference over the larger of the two
    norms, in float64 (a plane of ``WEIGHTED`` times its weight, and then
    over the larger of that and the weight's norm); ``_weighted`` reads the
    planes that take no gap."""
    out = {}
    for name in reference:
        pr = _weighted(program, reference, name)
        if isinstance(pr, float):
            out[name] = pr
            continue
        p, r = pr
        scale = max(float(torch.linalg.vector_norm(r)), float(torch.linalg.vector_norm(p)))
        weight = WEIGHTED.get(name)
        if weight in reference and weight in program:
            scale = max(scale, float(torch.linalg.vector_norm(reference[weight].to(torch.float64))))
        out[name] = float(torch.linalg.vector_norm(p - r)) / scale if scale > 0 else 0.0
    return out


#: the quantiles of a plane's differences over its support that
#: ``state_bulk_gap`` and ``state_tail_gap`` read: a fault on more than 10%,
#: or 1%, of a field's support reads in them
BULK, TAIL = 0.9, 0.99


def tail_gaps(program: dict, reference: dict, q: float) -> dict:
    """Per plane: the ``q`` quantile of the absolute difference over the
    plane's own support (the points where either side is not 0), over the
    reference's root mean square there (a plane of ``WEIGHTED`` times its
    weight, over the larger of that and the weight's). Land and open water,
    nought on both sides, do not dilute it, so a fault confined to a
    region, a coast or the fronts reads in it; ``_weighted`` reads the
    planes that take no gap."""
    out = {}
    for name in reference:
        pr = _weighted(program, reference, name)
        if isinstance(pr, float):
            out[name] = pr
            continue
        p, r = pr
        support = (p != 0) | (r != 0)
        e = (p - r).abs()[support]
        rms = float(r[support].pow(2).mean().sqrt())
        weight = WEIGHTED.get(name)
        if weight in reference and weight in program:
            w = reference[weight].to(torch.float64).expand_as(r)
            rms = max(rms, float(w[support].pow(2).mean().sqrt()))
        k = max(1, math.ceil(q * e.numel()))
        out[name] = float(torch.kthvalue(e.cpu(), k).values) / rms if rms > 0 else 0.0
    return out


def state_gaps(program: dict, reference: dict) -> dict:
    """The state's numbers, each per plane: ``state_gap`` (``relative_gaps``),
    ``state_bulk_gap`` and ``state_tail_gap`` (``tail_gaps`` at ``BULK`` and
    ``TAIL``)."""
    return {"state_gap": relative_gaps(program, reference),
            "state_bulk_gap": tail_gaps(program, reference, BULK),
            "state_tail_gap": tail_gaps(program, reference, TAIL)}
