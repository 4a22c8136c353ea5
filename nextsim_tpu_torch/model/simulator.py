"""The Simulator: init -> step loop -> outputs (the counterpart of
nextsim_tpu/model/simulator.py).

One model step, as FiniteElement::step (reference: model/finiteelement.cpp:
7963-8289):

    forcing (+ the coupler's received fields, the outer run's fields when
    nested, and every ``nextwim.couplingfreq`` steps a waves-in-ice run over
    the coming window: wave stress and floe breakage)  ->
    thermodynamics (pointwise)  ->  floe-size distribution (welding,
    breakup, damage)  ->  dynamics (momentum substeps)  ->
    transport (advection + ridging)  ->  nesting sponge  ->
    checkFieldsFast violations

On the card a step and a chunk of ``tpu.steps_per_call`` steps are each one
replay of a captured CUDA graph (``model/captured.py``), as the JAX package
jits ``_build_step_fn`` and scans ``_build_chunk_fn``. The host first
gathers the chunk's k inputs in the JAX package's order: the provider's k
forcing bundles, the WIM exchange (before the chunk's first step) and its
fields, the coupler's received fields, the outer run's fields, and the k
time-flag sets (``time_flags``, one device tensor). The graph copies them
into its static buffers (a tensor already there is not copied again) and
runs the k steps: thermodynamics, the FSD, the substep kernel's launches and
the rest of the momentum solve, transport and ridging, nesting, the checks,
and the moorings' and coupler's sums over the chunk (``_chunk_body``). The
host then adds those sums to the running means once a chunk. ``step`` is
the program of one step, so ``run`` replays a graph for every
``tpu.steps_per_call``, 1 included. On the CPU the same body runs eagerly.
The violation flags are maxed on the device and read back once per chunk
(or per ``tpu.check_interval`` steps); every output is checked once per step
or chunk, and ``run`` clamps the chunk length so that it divides each exact
output cadence, as the JAX package does.

A perturbed ensemble member (``statevector.ensemble_member > 0``) is
captured too, as the JAX package's ``chunk_fn_pert``: the host gathers the
unperturbed provider's forcing (``EnsembleForcing.provider``) with the
overlays, and the body draws the member's noise, advances its AR(1) carry
(``_pert_state``) and perturbs each step's forcing before the step and the
moorings' sums read it, the generator registered with the graph. The
overlays write other fields than the noise, so perturbing after them gives
the bits of the eager loop, which perturbs first. Only a device mesh keeps
the eager step loop (``step_eager``, ``step_chunk_eager``, also the captured
program's oracle) and logs why at its first step: its rings go through
torch.distributed. FSD Roach welding is one call of a CUDA kernel on the card
(``fsd.welding_roach``: a memset and two launches), which reads nothing
back, so the wave path is captured too.

``batched_step_fn`` steps N members at once, the JAX package's ``jax.vmap``
of the step that its batched ensemble jits (``ensemble/batched.py``), for
every configuration: the step on a member-minor stack (a plane ``(N, ny,
nx)``, or ``(N, ey, ex)`` ext blocks on a device mesh; ``tice``, ``sigma``
and ``conc_fsd`` ``(c, N, ...)``), one substep loop of kernel launches and
one welding call for all members, the mesh's rings carrying every
member's strips in one exchange. The WIM, the coupler and nesting are not
run per member there, as in the JAX package: the batched step takes the
provider's forcing and no outer fields.

A device mesh (``tpu.mesh_shape = DPYxDPX``) runs one torch.distributed
rank per block (parallel/seam.py): each rank holds its ext block of the
state, the grid arrays and every step's forcing, the step exchanges rings
through ``self.mesh`` (a ``seam.Seam``; ``step`` and ``raw_step_fn``
alike), and the outputs gather the owned blocks (``gather``) and are written
by rank 0. ``tpu.partition_mode`` gspmd and shard_map run this one schedule.
The waves-in-ice module runs on the same blocks in a layout of its own
(``Wim(mesh=...)``: its ring, its periodic edges); on its own grid
(``nextwim.coupling-option=naive``) every rank runs that whole grid from
gathered fields and keeps its block of the results. Gradients flow through
the exchanges (``seam.RingExchange``).

A bfloat16 state (``tpu.dtype=bfloat16``), as in the JAX package:

* every ``State`` plane, every grid array (``mask``, ``open_mask``,
  ``node_mask``, ``node_dirichlet``, ``node_lat``) and every forcing plane
  is ``torch.bfloat16``; the dataset providers interpolate in float64, as
  in float32, and round once to bfloat16;
* the plain code runs unchanged on bfloat16 tensors: each eager torch op
  computes in float32 (its "opmath") and rounds its result to bfloat16,
  and a Python scalar stays a float32 operand. That is not XLA's rounding
  (JAX rounds a weak-typed Python scalar to bfloat16 first, and XLA may keep
  float32 between the ops of a fusion), so the port is not held bitwise to
  the JAX package in bfloat16 but to a yardstick: within twice the JAX
  package's own bfloat16-to-float32 distance (tests/test_torch_bf16.py);
* it is held bitwise between its substep kernel (a bfloat16 build that
  rounds where the plain loop's torch ops round, with a bfloat16 carry
  after every substep, as the plain loop and the JAX loop keep it) and its
  plain loop on the card, and between a device mesh and one device;
* the host gets a bfloat16 plane as float32 (exact); the restarts and
  snapshots hold the JAX package's raw ``|V2`` records, the moorings
  float32 as the JAX package's do;
* the WIM and a perturbed ensemble member (``statevector.ensemble_member >
  0``, so a ``BatchedEnsemble`` of more than one member) raise
  ``NotImplementedError``: the JAX package's bfloat16 run fails there
  (its scan carry turns float32). Nothing is skipped silently.

The options that tune JAX's compilation and TPU kernels
(``tpu.donate_state``, ``tpu.compilation_cache_dir``, ``tpu.substep_kernel``,
``tpu.substep_unroll``, ``tpu.pallas_*``) have no counterpart here.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from nextsim_tpu_torch.config import Config
from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.core.state import State, member_first, member_minor, state_from_numpy, to_host
from nextsim_tpu_torch.forcing.providers import make_provider
from nextsim_tpu_torch.grid.grid import Grid
from nextsim_tpu_torch.model import checks, init_state, params
from nextsim_tpu_torch.model.captured import Captured
from nextsim_tpu_torch.model.nesting_source import make_nesting_source
from nextsim_tpu_torch.model.params_thermo import thermo_params
from nextsim_tpu_torch.ops import fsd as fsd_ops
from nextsim_tpu_torch.ops import momentum, nesting, stencil, thermo, transport
from nextsim_tpu_torch.output.drifters import instantiate_drifters
from nextsim_tpu_torch.parallel import multihost, seam
from nextsim_tpu_torch.utils import async_writer, dates
from nextsim_tpu_torch.utils.logging import get_logger
from nextsim_tpu_torch.utils.timer import Timer, phase

_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}

#: the per-step time flags of ``time_info``, in the column order of ``time_flags``
TIME_FLAGS = ("is_day_start", "is_day_end", "is_0915", "is_0801", "is_myi_reset_date")


#: what a bfloat16 run refuses: the JAX package's own run fails there
_BF16_FAILS_IN_JAX = (
    "; the JAX package's bfloat16 run fails there too (TypeError: its scan carry "
    "turns float32), so the port has no reference to hold it to"
)


def _unported(cfg) -> Optional[str]:
    """The first configured subsystem the port does not run, with the
    reason, or None."""
    bf16 = cfg["tpu.dtype"] == "bfloat16"
    rules = [
        (bf16 and cfg["nextwim.use_wim"], "tpu.dtype=bfloat16 with nextwim.use_wim" + _BF16_FAILS_IN_JAX),
        (bf16 and cfg["statevector.ensemble_member"] > 0,
         "tpu.dtype=bfloat16 with statevector.ensemble_member > 0 (perturbed forcing)" + _BF16_FAILS_IN_JAX),
    ]
    for on, what in rules:
        if on:
            return what
    return None


class Simulator:
    def __init__(self, cfg: Config, grid: Optional[Grid] = None, device="cuda", *, group=None):
        """``group``: the process group whose ranks hold the blocks of
        ``tpu.mesh_shape`` (a member group of a batched ensemble on a member
        mesh); the whole world when None."""
        what = _unported(cfg)
        if what is not None:
            raise NotImplementedError(f"the PyTorch port does not run {what}")
        self.cfg = cfg
        self.log = get_logger(cfg["debugging.log-level"], cfg["debugging.log-all"])
        self.timer = Timer()
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg["tpu.dtype"]]
        self.grid = grid if grid is not None else Grid.from_config(cfg)
        # one rank per block of tpu.mesh_shape, None for one block
        self.mesh = seam.make_seam(cfg, self.grid, group)
        self._forcing_blocks = (None, None)

        # --- time bookkeeping (host) -------------------------------------
        self.dt = float(cfg["simul.timestep"])  # seconds
        time_init_str = cfg["simul.time_init"]
        self.time_init = dates.string_to_datenum(time_init_str) if time_init_str else 0.0
        self.duration_days = cfg["simul.duration"]
        self.maxiteration = cfg["debugging.maxiteration"]
        self.pcpt = 0  # step counter (reference pcpt)

        # --- parameters ---------------------------------------------------
        self.dyn = params.dyn_params(cfg, self.grid.dx)
        self.c_fix, self.c_alea = params.cohesion_params(cfg, self.grid.dx)
        self.use_thermo = cfg["thermo.use_thermo_forcing"]
        self.thermo_params = thermo_params(cfg) if self.use_thermo else None
        self.transport_params = transport.TransportParams.from_config(cfg)
        self.check_fast = cfg["debugging.check_fields_fast"]
        self._chunk_k = max(1, cfg["tpu.steps_per_call"])

        # --- static grid arrays on the device ------------------------------
        node_lat, _ = self.grid.node_latlon()
        on_dev = functools.partial(torch.as_tensor, dtype=self.dtype, device=self.device)
        self.grid_arrays = {
            "mask": on_dev(self.grid.mask),
            "open_mask": on_dev(self.grid.open_mask),
            "node_mask": on_dev(self.grid.node_mask),
            "node_dirichlet": on_dev(self.grid.node_dirichlet),
            "node_lat": on_dev(node_lat),
            "delta_x": self.grid.dx,
        }

        # --- state + forcing ----------------------------------------------
        self.state = init_state.init_state(cfg, self.grid, dtype=self.dtype, device=self.device)
        # FSD (reference: initFsd fe.cpp:7399-7585; OASIS-gated there,
        # enabled here whenever wave_coupling.num_fsd_bins > 0)
        self.fsd_params = None
        self.fsd_bins = None
        if cfg["wave_coupling.num_fsd_bins"] > 0:
            self.fsd_params = fsd_ops.FSDParams.from_config(cfg)
            self.fsd_bins = fsd_ops.make_bins(self.fsd_params)
            cf = fsd_ops.init_fsd(self.fsd_params, self.state.conc + self.state.conc_young)
            self.state = self.state.replace(
                conc_fsd=cf,
                conc_mech_fsd=cf.clone() if self.fsd_params.distinguish_mech_fsd else None,
            )
        # a rank keeps its ext block of the global grid arrays and state
        self.grid_arrays = self.to_blocks(self.grid_arrays)
        self.state = self.to_blocks(self.state)
        self.forcing_provider = make_provider(cfg, self.grid, self.dtype, device=self.device)
        # ensemble member > 0: perturbed forcing (reference: #ifdef ENSEMBLE,
        # externaldata.cpp:244-278; modules/enkf/perturbation). The AR(1)
        # chain advances once a step: in the provider call on the eager
        # path, in the body on the program path (``_pert_state``)
        self._ens_pert = None
        if cfg["statevector.ensemble_member"] > 0:
            from nextsim_tpu_torch.ensemble.perturbation import EnsembleForcing

            self._ens_pert = EnsembleForcing(self.forcing_provider, self.grid, cfg,
                                             dtype=self.dtype, device=self.device)
            self.forcing_provider = self._ens_pert

        # nesting sponge (reference: forcingNesting fe.cpp:11060-11130):
        # (params, per-cell weight on the device, outer-run source)
        self.nesting = None
        self._nest_keys = None
        self._nest_partial_warned = False
        if cfg["nesting.use_nesting"]:
            npar = nesting.NestingParams.from_config(cfg)
            dist = nesting.distance_to_open_boundary(self.grid)
            weight = self.to_blocks(on_dev(nesting.nudge_weight(dist, npar, self.dt)))
            source = make_nesting_source(cfg, self.grid, self.dtype, device=self.device)
            self.nesting = (npar, weight, source)
        self.diag = {}
        self.last_forcing = None
        self._pending_viol = None
        self._last_check_pcpt = 0

        # --- output subsystems (reference: initMoorings fe.cpp:9037;
        # instantiateDrifters fe.cpp:13565; checkOutputs fe.cpp:8316) ------
        self.moorings = None
        if cfg["moorings.use_moorings"]:
            from nextsim_tpu_torch.output.moorings import Moorings

            self.moorings = Moorings(cfg, self.grid, self.time_init,
                                     process_rank=multihost.process_index(),
                                     process_count=multihost.process_count(), mesh=self.mesh)
        self.drifters = instantiate_drifters(cfg, self.grid, self.gather(self.state.conc), self.time_init)
        self._drifter_last_move = self.time_init
        self._drifter_ut_prev = None
        # coupling exchange (reference: initOASIS fe.cpp:7585-7860)
        self.coupler = None
        if cfg["setup.ocean-type"] == "coupled" or cfg["coupler.with_waves"]:
            from nextsim_tpu_torch.coupling import Coupler

            self.coupler = Coupler(cfg, self.grid, self.time_init,
                                   dtype=self.dtype, device=self.device, mesh=self.mesh)

        # waves-in-ice module (reference: modules/wim; nextwim.* options in
        # options_wim.cpp). coupling-option=break_on_mesh/run_on_mesh run
        # co-located on the model grid; =naive runs the WIM on its own grid
        # (wimgrid.*) with a mask-aware regrid each exchange (reference
        # gridinfo.cpp mesh<->grid interpolation).
        self.wim = None
        self.wim_diag = None
        self._wim_regrid = None
        if cfg["nextwim.use_wim"]:
            from nextsim_tpu_torch.wim import Wim, WimParams

            wim_grid = self.grid
            if cfg["nextwim.coupling-option"] == "naive":
                from nextsim_tpu_torch.wim.regrid import Regridder, make_wim_grid

                wim_grid = make_wim_grid(cfg, self.grid)
                self._wim_regrid = Regridder(self.grid, wim_grid, self.dtype, device=self.device)
            # co-located on a device mesh: the WIM's own layout of this
            # rank's block; on its own grid: that whole grid on every rank
            self.wim = Wim(WimParams.from_config(cfg), wim_grid, self.dtype, device=self.device,
                           mesh=self.mesh if self._wim_regrid is None else None)
            self.wim_couplingfreq = max(1, cfg["nextwim.couplingfreq"])
            self._wim_stress = None
            self._wim_wlbk = None
            self._wim_nfloes = None
            self._wim_dmax = None
            self._wim_last_pcpt = None
            # cells around each node, for the cell -> node mean of the stress
            self._wim_node_count = self.to_blocks(torch.clamp(
                stencil.cells_to_node_sum(
                    torch.ones(self.grid.shape, dtype=self.dtype, device=self.device)),
                min=1.0,
            ))

        # the step and chunk program: one CUDA graph replay a call on the
        # card, or the eager loop where a graph cannot hold the step
        self.eager_reason = self._eager_reason()
        self._eager_logged = False
        self._program = Captured(self._chunk_body, name="step program", log=self.log,
                                 capture=self.eager_reason is None,
                                 generators=[] if self._ens_pert is None else [self._ens_pert.generator])
        self._flags = {}

        opd = cfg["output.output_per_day"]
        if opd > 0:
            self.export_interval_steps = max(1, int(round(phys.days_in_sec / opd / self.dt)))
        elif opd < 0:
            self.export_interval_steps = 1
        else:
            self.export_interval_steps = 0
        self._last_export_pcpt = 0
        self._last_restart_pcpt = 0
        if cfg["restart.write_interval_restart"]:
            iv = cfg["restart.output_interval"]
            if cfg["restart.output_interval_units"] == "time_steps":
                self.restart_interval_steps = max(1, int(iv))
            else:
                self.restart_interval_steps = max(1, int(round(iv * phys.days_in_sec / self.dt)))
        else:
            self.restart_interval_steps = 0

        if cfg["restart.start_from_restart"]:
            from nextsim_tpu_torch.output.restart import read_restart

            read_restart(self)
            if cfg["restart.check_restart"]:
                # audit the restarted fields (reference: M_check_restart ->
                # checkFields at init, fe.cpp:7065-7070)
                self._check_fields_detailed()
            # DataAssimilation at restart (reference: init() fe.cpp:7055-7058
            # -> DataAssimilation fe.cpp:509-525: slab ocean then ice, then
            # consistency check)
            if cfg["setup.use_assimilation"]:
                self.data_assimilation()
        if cfg["restart.write_initial_restart"]:
            from nextsim_tpu_torch.output.restart import write_restart

            write_restart(self, name="initial")

    # ------------------------------------------------------------------
    @property
    def _pert_state(self) -> Optional[torch.Tensor]:
        """A perturbed member's AR(1) carry (4, ny, nx), None before its first
        draw (the JAX package's name): the ``EnsembleForcing``'s own, which
        the eager provider call advances too."""
        return None if self._ens_pert is None else self._ens_pert._ran

    @_pert_state.setter
    def _pert_state(self, ran) -> None:
        self._ens_pert._ran = ran

    def host_state(self) -> State:
        """The GLOBAL state as host numpy arrays, for host consumers (IO,
        checks); collective on a device mesh."""
        return self.gather(self.state)

    def gather(self, tree):
        """Host numpy copy of ``tree`` (tensors, a dataclass, a dict or a
        tuple of them) with the global value of every block on a device mesh
        (collective: every rank calls it in the same order)."""
        return to_host(tree) if self.mesh is None else self.mesh.gather(tree)

    def to_blocks(self, tree):
        """The rank's ext block of every global plane of ``tree`` on a
        device mesh; ``tree`` itself on one device."""
        return tree if self.mesh is None else self.mesh.to_blocks(tree)

    def _global_state(self) -> State:
        """The global state on the device (gathered on a device mesh)."""
        if self.mesh is None:
            return self.state
        host = self.host_state()
        return state_from_numpy({f: getattr(host, f) for f in host.__dataclass_fields__},
                                device=self.device, dtype=self.dtype)

    def _step_fn(self, state, forcing, tinfo, nest=None, exchanger=None, members=False):
        """One model step on the device: (state', diag, violation flags).
        ``nest`` holds the outer run's fields to relax toward, or is None;
        ``exchanger`` is the rank's ``seam.Seam`` on a device mesh (state,
        forcing and grid arrays are then ext blocks, and the flags count
        the owned cells), else None. ``members``: the state is a batched one
        in the member-minor layout (``batched_step_fn``), and the flags are
        each member's."""
        ga = dict(self.grid_arrays)
        # cohesion field for this step (reference: calcCohesion, fe.cpp:3909-3914)
        ga["cohesion"] = self.c_fix + self.c_alea * state.random_number
        dyn = self.dyn
        diag = {}
        # ---- thermodynamics (reference: fe.cpp:8140 -> thermo()) ---------
        if self.use_thermo:
            with phase("thermo"):
                state, tdiag = thermo.thermo_step(state, forcing, ga, self.dt, self.thermo_params,
                                                  tinfo=tinfo, fsd_params=self.fsd_params,
                                                  fsd_bins=self.fsd_bins)
            diag.update(tdiag)
        if self.fsd_params is not None:
            with phase("fsd"):
                state = self._fsd_block(state, forcing, diag)
        # ---- dynamics (reference: fe.cpp:8197-8221) ----------------------
        if dyn.dynamics_type in ("bbm", "evp", "mevp"):
            state, mdiag = momentum.explicit_solve(state, forcing, ga, self.dt, dyn, exchanger)
            diag.update(mdiag)
        elif dyn.dynamics_type == "free_drift":
            state = momentum.free_drift(state, forcing, ga, self.dt, dyn)
        # ---- transport + ridging (fe.cpp:8221, 3919) ---------------------
        if dyn.dynamics_type != "no_motion":
            with phase("transport"):
                state, vdiag = transport.transport_and_ridge(
                    state, ga, self.dt, self.transport_params
                )
            diag.update(vdiag)
        # ---- nesting sponge: relax toward the outer run (reference:
        # nestingIce/nestingDynamics each step, fe.cpp:8172-8192)
        if nest is not None:
            npar, weight, _source = self.nesting
            with phase("nesting"):
                state = nesting.apply_nesting(state, nest, weight, npar)
        owned = None
        with phase("checks"):
            if exchanger is not None:
                state = exchanger.ring_state(state)
                owned = exchanger.owned
            viol = checks.violations(state, use_young_ice=dyn.use_young_ice, owned=owned, members=members)
        return state, diag, viol

    def raw_step_fn(self, state, forcing, tinfo, nest=None):
        """The JAX package's name for the step function: (state', diag,
        violation flags), the step ``step()`` takes, on a device mesh with
        its exchanges (state and forcing are then this rank's ext blocks).
        Differentiable end to end (thermodynamics, the substep loop,
        transport, the exchanges); on the card the substep loop's gradient
        goes through ``momentum_cuda.SubstepLoop``, and on a mesh the
        rings' through ``seam.RingExchange``."""
        return self._step_fn(state, forcing, tinfo, nest, self.mesh)

    def batched_step_fn(self, states, forcing, tinfo):
        """N members' steps at once, the JAX package's ``jax.vmap(raw_step_fn,
        in_axes=(0, 0, None))``: ``states`` a member-first stack (every field
        ``(N, ...)``), ``forcing`` a ``Forcing`` whose leaves are ``(N, ...)``
        where the members' differ and the plane itself where they share it
        (``ensemble.perturbation.stack_forcings``), ``tinfo`` the members'
        common time flags. Returns (states', diag, violation flags (N,
        checks)), the states member-first, diag's planes ``(N, ...)``.

        The step runs once on the member-minor layout (``core.state.
        member_minor``): every operator takes planes with leading axes, the
        grid arrays and shared forcing planes broadcast, and the substep
        loop is one loop of kernel launches for all members on the card. On
        a device mesh the planes are ext blocks, the rings exchange every
        member's strips at once (``self.mesh``), and the flags count each
        member's owned cells. Member m's result equals ``raw_step_fn`` on
        member m alone bitwise. Not differentiable (the batched substep loop
        refuses a gradient)."""
        state, diag, viol = self._step_fn(member_minor(states), forcing, tinfo, exchanger=self.mesh,
                                          members=True)
        return member_first(state), diag, viol

    def _fsd_block(self, state, forcing, diag):
        """The floe-size distribution's part of a step: rescale to the new
        total concentration, welding on freezing, breakup under waves and
        its damage feedback (reference: weldingRoach in thermo
        fe.cpp:5782-5797; redistributeFSD at coupling steps; updateFSD from
        step()). Adds the floe-size diagnostics to ``diag``."""
        fp, fb = self.fsd_params, self.fsd_bins
        ctot = state.conc + state.conc_young
        cf = fsd_ops.update_fsd(state.conc_fsd, ctot)
        if self.use_thermo and fp.welding_type == "roach":
            del_hi = diag.get("del_hi")
            freezing = del_hi > 0.0 if del_hi is not None else torch.zeros_like(ctot, dtype=torch.bool)
            cf = fsd_ops.welding_roach(cf, self.dt, fp, fb, freezing)
            cf = fsd_ops.update_fsd(cf, ctot)
        damage = state.damage
        if forcing.wlbk is not None:
            cf, broke = fsd_ops.wave_breakup(
                cf, state.thick, state.conc, state.h_young,
                state.conc_young, forcing.wlbk, self.dt, fp, fb,
            )
            damage = fsd_ops.fsd_damage(cf, damage, fp, broke)
        mech = state.conc_mech_fsd
        if mech is not None:
            # after breakup both coincide (fe.cpp:4424)
            mech = cf if forcing.wlbk is not None else fsd_ops.update_fsd(mech, ctot)
        # floe-size diagnostics for moorings (reference dmax/dmean
        # GridOutput variables, gridoutput.hpp:219-220)
        diag["dmax"], diag["dmean"] = fsd_ops.dmax_dmean(cf, fp, fb)
        return state.replace(conc_fsd=cf, conc_mech_fsd=mech, damage=damage)

    def _eager_reason(self) -> Optional[str]:
        """Why this configuration keeps the eager step loop on the card, or
        None when a step and a chunk are graph replays."""
        if self.mesh is not None:
            return ("a device mesh exchanges rings through torch.distributed inside the step "
                    "(NCCL graphs on a mesh: ROADMAP)")
        return None

    def _log_eager(self) -> None:
        if not self._eager_logged:
            self._eager_logged = True
            self.log.info(f"step and step_chunk run the eager step loop on {self.device}: {self.eager_reason}")

    def _step_inputs(self, i: int = 0, wim_gate: bool = True, chunked: bool = False, perturbed: bool = True):
        """The inputs of the step ``i`` steps after the current one:
        (forcing, nest, time flags as host numbers). The provider's forcing
        (a perturbed member's unperturbed one unless ``perturbed``), the
        coupler's received fields, the outer run's fields, the WIM exchange
        when ``wim_gate`` is set and one is due.

        The overlays follow the JAX package path by path: ``step`` applies
        the WIM's fields last, so they win over a received ``wlbk`` or wave
        stress; ``step_chunk`` (``chunked``) runs the WIM exchange on the
        provider's forcing and applies its fields first, so the received and
        nested fields win."""
        t = self.time_after(i)
        forcing = self._next_forcing(t, perturbed)
        if chunked and self.wim is not None:
            forcing = self._wim_forcing(forcing, wim_gate)
        if self.coupler is not None:
            forcing = self.coupler.apply_received(forcing)
        nest = None
        if self.nesting is not None:
            outer = self.to_blocks(self.nesting[2].fields_at(t + self.dt * dates.DAYS_IN_SEC))
            if self.cfg["nesting.use_ocean_nesting"] and outer and "sst" in outer and "sss" in outer:
                # outer-run SST/SSS become the slab-ocean nudging targets
                # (reference: forcingOcean ocean-nesting branch,
                # fe.cpp:11133-11143)
                forcing = forcing.replace(ocean_temp=outer["sst"], ocean_salt=outer["sss"])
            nest = self._nest_fields(outer)
        if not chunked and self.wim is not None:
            forcing = self._wim_forcing(forcing, wim_gate)
        return forcing, nest, self.time_info_at(t)

    def _wim_diag(self) -> dict:
        """The WIM's diagnostics for the moorings, held constant between
        couplings: what a step's diag takes where it has none of its own."""
        out = {}
        if self.wim is not None:
            if self._wim_stress is not None:
                out["tauwix"], out["tauwiy"] = self._wim_stress
            if self.fsd_params is None and self._wim_dmax is not None:
                out["dmax"] = self._wim_dmax
        return out

    def _advance(self, wim_gate: bool = True, chunked: bool = False) -> None:
        """One eager step: its inputs (host, timed as "forcing"), the device
        step, the step counter; violations and the coupler's sums accumulate
        on the device. The Timer node "enqueue" is the host's time to issue
        the step, not the device's: nothing synchronizes."""
        self.timer.tick("forcing")
        forcing, nest, tinfo = self._step_inputs(0, wim_gate, chunked)
        self.timer.tock("forcing")
        self.timer.tick("enqueue")
        self.state, self.diag, viol = self.raw_step_fn(self.state, forcing, tinfo, nest)
        self.last_forcing = forcing  # for output.save_forcing_fields
        for key, v in self._wim_diag().items():
            self.diag.setdefault(key, v)
        self.pcpt += 1
        if self.coupler is not None:
            # (reference: OASIS put block, fe.cpp:8226-8265)
            self.coupler.accumulate(self.state, self.diag)
        if self.check_fast:
            prev = self._pending_viol
            self._pending_viol = viol if prev is None else torch.maximum(prev, viol)
        self.timer.tock("enqueue")

    # ------------------------------------------------------------------
    def _extract(self, state, diag, forcing) -> dict:
        """What a step adds to the running sums: every moorings variable
        (``Moorings._extract``) and the coupler's sent fields (``__cpl_``
        + name), as the JAX chunk program's ``extract``."""
        out = {}
        if self.moorings is not None:
            for name in self.moorings.names:
                d = self.moorings._extract(name, state, diag, forcing)
                if d:
                    out.update(d)
        if self.coupler is not None:
            from nextsim_tpu_torch.coupling.exchange import SENT_FIELDS

            for name, (src, field) in SENT_FIELDS.items():
                arr = getattr(state, field, None) if src == "state" else diag.get(field)
                if arr is not None:
                    out["__cpl_" + name] = arr
        return out

    def _chunk_body(self, state, forcings, flags, nests, wim_diag, ran=None):
        """k model steps on the device, the body of the step and chunk
        programs (JAX ``_build_chunk_fn``'s ``chunk_fn``): (state, the last
        step's diag, the violation flags maxed over the steps, the sums of
        ``_extract`` over the steps, the last step's ``_extract``).
        ``flags[i]`` holds step i's time flags in ``TIME_FLAGS`` order;
        ``nests`` is None or step i's outer fields (or None) at i;
        ``wim_diag`` the WIM's diagnostics (``_wim_diag``). With ``ran``, a
        perturbed member's AR(1) carry (JAX ``chunk_fn_pert``), each step
        first advances it with one draw and perturbs its forcing, which the
        step and ``_extract`` read; two more results then: the carry and the
        last perturbed forcing."""
        acc = viol = diag = None
        for i, forcing in enumerate(forcings):
            tinfo = {key: flags[i, j] for j, key in enumerate(TIME_FLAGS)}
            if ran is not None:
                with phase("perturb"):
                    ran, forcing = self._ens_pert.apply(ran, forcing)
            state, diag, vl = self.raw_step_fn(state, forcing, tinfo, None if nests is None else nests[i])
            for key, v in wim_diag.items():
                diag.setdefault(key, v)
            with phase("sums"):
                ex = self._extract(state, diag, forcing)
                acc = ex if acc is None else {key: acc[key] + ex[key] for key in acc}
                viol = vl if viol is None else torch.maximum(viol, vl)
        if ran is not None:
            return state, diag, viol, acc, ex, ran, forcing
        return state, diag, viol, acc, ex

    def _run_program(self, k: int, chunked: bool) -> None:
        """k steps as one call of the step program: the inputs gathered on
        the host (timed as "forcing"; a perturbed member's unperturbed
        forcing), one graph replay on the card (a perturbed member's carry
        in and out, its first draw made here once), then the step counter,
        the sums into the moorings' and coupler's running means, the
        violation flags. The Timer node "enqueue" is host time: the
        copy-in, the graph launch and the output copies as issued, not as
        the device runs them."""
        pert = self._ens_pert
        self.timer.tick("forcing")
        steps = [self._step_inputs(i, wim_gate=i == 0 or not chunked, chunked=chunked, perturbed=False)
                 for i in range(k)]
        forcings = [f for f, _, _ in steps]
        nests = [n for _, n, _ in steps]
        flags = self.time_flags([ti for _, _, ti in steps])
        self.timer.tock("forcing")
        self.timer.tick("enqueue")
        args = (self.state, forcings, flags, None if all(n is None for n in nests) else nests, self._wim_diag())
        if pert is None:
            self.state, self.diag, viol, acc, last = self._program(*args)
            self.last_forcing = forcings[-1]  # for output.save_forcing_fields
        else:
            if self._pert_state is None:
                self._pert_state = pert.init_state()
            self.state, self.diag, viol, acc, last, self._pert_state, self.last_forcing = self._program(
                *args, self._pert_state)
        self.pcpt += k
        if self.coupler is not None:
            self.coupler.add_sums({key[6:]: v for key, v in acc.items() if key.startswith("__cpl_")}, k)
        if self.moorings is not None:
            self.moorings.add_chunk({key: v for key, v in acc.items() if not key.startswith("__cpl_")},
                                    {key: v for key, v in last.items() if not key.startswith("__cpl_")}, k)
        if self.check_fast:
            prev = self._pending_viol
            self._pending_viol = viol if prev is None else torch.maximum(prev, viol)
        self.timer.tock("enqueue")

    def _wim_forcing(self, forcing, wim_gate: bool):
        """The WIM exchange when ``wim_gate`` is set and one is due, then its
        fields overlaid on ``forcing``."""
        if wim_gate and self._wim_due():
            self.timer.tick("wim")
            self._wim_exchange(forcing)
            self.timer.tock("wim")
        return self._apply_wim_forcing(forcing)

    def _wim_due(self) -> bool:
        """WIM coupling cadence, shared by the per-step and chunked paths
        (reference: exact-step WIM coupling, nextwim.couplingfreq;
        modules/wim/src/wimdiscr.cpp:822-1210). Boundary-crossing on pcpt:
        with the run() clamp forcing k to divide couplingfreq this fires at
        exactly steps 0, f, 2f, ... on both paths; a direct step_chunk
        caller with a non-dividing k still never exchanges MORE often than
        configured. A fresh or restarted simulator anchors on the absolute
        0, f, 2f grid — a resume at a non-multiple pcpt (restart intervals
        need not align) waits for the next multiple exactly like the
        unbroken run, so restart continuation stays deterministic."""
        f = self.wim_couplingfreq
        last = getattr(self, "_wim_last_pcpt", None)
        if last is None:
            last = ((self.pcpt - 1) // f) * f if self.pcpt > 0 else -f
        if self.pcpt - last >= f:
            self._wim_last_pcpt = self.pcpt
            return True
        self._wim_last_pcpt = last
        return False

    def _wim_exchange(self, forcing=None) -> None:
        """Run the WIM over the next coupling window and harvest wave stress
        + floe breakage (reference WAVES coupling: nextwim.coupling-option
        break_on_mesh — breaking applied directly to the sea-ice state;
        collapsed onto one grid here since the model grid is structured)."""
        cfg = self.cfg
        p = self.wim.p
        rg = self._wim_regrid
        conc = self.state.conc + self.state.conc_young
        vol = self.state.thick + self.state.h_young  # effective thickness = volume
        # incident waves: from the wave forcing dataset when present
        # (wimsetup.wave-type=ww3a/eraiw_1deg), else the configured constant
        # sea state over open water (wave-type=set_in_wim)
        waves = []
        if forcing is not None and getattr(forcing, "swh", None) is not None:
            waves = [forcing.swh, forcing.mwp, forcing.mwd]
        conc, vol, *waves = self._wim_inputs([conc, vol, *waves])
        if self._wim_nfloes is None:
            # unbroken pack on first call (dfloepackinit, iceinfo.hpp:61)
            self._wim_nfloes = torch.where(conc >= p.cice_min, conc / p.dfloe_pack_init**2, 0.0)
        self.wim.set_ice_fields(conc, vol, self._wim_nfloes)
        if waves:
            self.wim.set_wave_fields(*waves)
        else:
            ones = torch.ones_like(conc)
            self.wim.set_wave_fields(ones * p.hs_inc, ones * p.tp_inc, ones * p.mwd_inc)
        diag = self.wim.run(self.wim_couplingfreq * self.dt)
        self._wim_nfloes = self.wim.ice["nfloes"]
        broken = self.wim.ice["broken"]
        dfloe = dmax = self.wim.ice["dfloe"]
        tau_x, tau_y = diag["tau_x"], diag["tau_y"]
        if rg is not None:
            # WIM on its own grid: ice fields over, stress/breakage back
            # (reference gridinfo.cpp mesh<->grid interpolation)
            tau_x, tau_y = rg.to_model(tau_x), rg.to_model(tau_y)
            broken = rg.to_model(broken)
            dmax = rg.to_model(dfloe)
            # blend the broken-zone floe size only where breakage reached the
            # model grid, so pack-size bleed from bilinear edges can't dilute
            # the breaking wavelength below
            dfloe = torch.where(broken > 0.0, dmax, p.dfloe_pack_init)
            # on a device mesh every rank ran the whole WIM grid: its block
            tau_x, tau_y, broken, dfloe, dmax = self.to_blocks((tau_x, tau_y, broken, dfloe, dmax))
        elif self.wim.mesh is not None:
            tau_x, tau_y, broken, dfloe = self.wim.mesh.move([tau_x, tau_y, broken, dfloe], self.mesh)
            dmax = dfloe
        self._wim_dmax = dmax  # the moorings' dmax without an FSD

        if cfg["nextwim.applywavestress"]:
            # cell stress -> node average for the momentum solver
            cnt = self._wim_node_count
            self._wim_stress = (
                stencil.cells_to_node_sum(tau_x) / cnt,
                stencil.cells_to_node_sum(tau_y) / cnt,
            )
        if self.fsd_params is not None:
            # feed breakage into the FSD pipeline through the wlbk entry
            # point (same one the WW3-coupled wave field uses). wlbk is a
            # breaking WAVELENGTH in metres with >=499 meaning "no breaking
            # waves" (fsd.wave_breakup); WIM breaking sets dfloe = lam/2, so
            # the wavelength over the broken zone is 2*dfloe.
            self._wim_wlbk = torch.where(broken > 0.0, 2.0 * dfloe, 500.0)
        elif cfg["nextwim.wim_damage_mesh"]:
            # no FSD: raise damage directly where floes broke
            # (nextwim.wim_damage_value, options_wim.cpp)
            dmg = torch.maximum(self.state.damage, broken * cfg["nextwim.wim_damage_value"])
            self.state = self.state.replace(damage=dmg)
        self.wim_diag = diag

    def _wim_inputs(self, planes):
        """Model-grid cell planes (this rank's ext blocks on a device mesh)
        as the WIM takes them: regridded to its own grid (gathered first on
        a mesh, where every rank runs that whole grid), moved into the WIM's
        layout of the blocks, or as they are."""
        rg = self._wim_regrid
        if rg is None:
            return planes if self.wim.mesh is None else self.mesh.move(planes, self.wim.mesh)
        if self.mesh is not None:
            planes = [torch.as_tensor(a, device=self.device) for a in self.gather(tuple(planes))]
        return [rg.to_wim(x) for x in planes]

    def _apply_wim_forcing(self, forcing):
        """Overlay the last WIM exchange (wave stress, FSD breaking
        wavelength) onto the forcing bundle; each is independent of the
        other (applywavestress may be off while FSD breakup is on)."""
        repl = {}
        if self._wim_stress is not None:
            repl["tau_wi_u"] = self._wim_stress[0]
            repl["tau_wi_v"] = self._wim_stress[1]
        if self._wim_wlbk is not None:
            repl["wlbk"] = self._wim_wlbk
        return forcing.replace(**repl) if repl else forcing

    def _next_forcing(self, t: Optional[float] = None, perturbed: bool = True):
        """The provider's forcing for the step that starts at ``t`` (default:
        now), a perturbed member's unperturbed one unless ``perturbed``; on
        a device mesh its ext block, cut once for a provider that returns
        the same bundle again."""
        t = self.current_time if t is None else t
        provider = self.forcing_provider if perturbed or self._ens_pert is None else self._ens_pert.provider
        forcing = provider(t + self.dt * dates.DAYS_IN_SEC, self.time_init)
        if self.mesh is None:
            return forcing
        if self._forcing_blocks[0] is not forcing:
            self._forcing_blocks = (forcing, self.to_blocks(forcing))
        return self._forcing_blocks[1]

    def _nest_fields(self, outer):
        """The outer fields to relax toward this step, or None to skip the
        relaxation: no outer data yet, or a record missing fields that an
        earlier record had (a partial set would relax the missing fields
        toward zero in the JAX package's fixed-structure program, which
        turns such steps off instead). A record with new fields extends the
        set."""
        if not outer:
            return None
        keys = self._nest_keys
        if keys is None or any(k not in keys for k in outer):
            if keys is not None:
                self.log.info(
                    f"nesting: outer data gained fields {sorted(set(outer) - set(keys))}; "
                    "extending the relaxation set"
                )
            self._nest_keys = keys = tuple(sorted(set(outer) | set(keys or ())))
        if any(k not in outer for k in keys):
            if not self._nest_partial_warned:
                self._nest_partial_warned = True
                self.log.info(
                    f"nesting: outer record missing fields {sorted(set(keys) - set(outer))}; "
                    "relaxation skipped for such steps"
                )
            return None
        return {k: outer[k] for k in keys}

    def step(self) -> None:
        """Advance one model step: one replay of the one-step program on the
        card (a perturbed member's draw inside it), the eager step where
        ``eager_reason`` says why."""
        if self.eager_reason is not None:
            self._log_eager()
            self.step_eager()
            return
        self.timer.tick("step")
        self._run_program(1, chunked=False)
        self._after_steps(self.cfg["tpu.check_interval"])

    def step_eager(self) -> None:
        """One model step through the eager loop (the oracle of ``step``)."""
        self.timer.tick("step")
        self._advance()
        self._after_steps(self.cfg["tpu.check_interval"], moorings_means=True)

    def step_chunk(self, k: Optional[int] = None) -> None:
        """Advance ``k`` steps (default ``tpu.steps_per_call``) as one replay
        of the k-step program on the card (``_build_chunk_fn``), reading the
        violation flags back once at the end of the chunk. The WIM exchange
        and the coupler's put/get happen at chunk boundaries only (``run``
        clamps k to divide their cadences): the WIM is consulted before the
        chunk's first step, the coupler after its last, and the coupler's
        received fields win over the WIM's (see ``_step_inputs``)."""
        k = self._chunk_k if k is None else k
        if self.eager_reason is not None:
            self._log_eager()
            self.step_chunk_eager(k)
            return
        self.timer.tick("step")
        self._run_program(k, chunked=True)
        self._after_steps(max(self.cfg["tpu.check_interval"], k))

    def step_chunk_eager(self, k: Optional[int] = None) -> None:
        """``k`` steps through the eager loop, one ``_advance`` a step (the
        oracle of ``step_chunk``)."""
        k = self._chunk_k if k is None else k
        self.timer.tick("step")
        for i in range(k):
            self._advance(wim_gate=i == 0, chunked=True)
            if self.moorings is not None:
                self.timer.tick("enqueue")
                self.moorings.update_means(self.state, self.diag, self.last_forcing)
                self.timer.tock("enqueue")
        self._after_steps(max(self.cfg["tpu.check_interval"], k))

    def _after_steps(self, interval: int, moorings_means: bool = False) -> None:
        """After a step or a chunk: the coupler's put/get when its window
        closed, the outputs (the moorings' running means too when
        ``moorings_means``), the violation read-back once ``interval`` steps
        have passed (boundary-crossing: chunked pcpt strides can step over a
        multiple of the interval; finalise() flushes the tail), the debug
        checks; closes the "step" timer."""
        if self.coupler is not None:
            self.coupler.maybe_exchange(self.current_time)
        self.timer.tick("outputs")
        self._check_outputs(skip_moorings_means=not moorings_means)
        self.timer.tock("outputs")
        if self.check_fast and (interval <= 1 or self.pcpt - self._last_check_pcpt >= interval):
            self._flush_pending_viol()
        self._debug_checks()
        self.timer.tock("step")

    # ------------------------------------------------------------------
    def _build_step_fn(self) -> Callable:
        """The one-step program (JAX ``_build_step_fn``): ``(state, forcing,
        tinfo, nest=None) -> (state, diag, violation flags)``, one graph
        replay on the card, the eager step on the CPU. It steps the forcing
        as given, a perturbed member's too (JAX's step function takes the
        perturbed forcing from its provider)."""

        def step_fn(state, forcing, tinfo, nest=None):
            out = self._program(state, [forcing], self.time_flags([tinfo]),
                                None if nest is None else [nest], {})
            return out[:3]

        return step_fn

    def _build_chunk_fn(self, k: int) -> Callable:
        """The k-step program (JAX ``_build_chunk_fn``): ``(state, forcing0,
        forcings_rest, tinfo0, tinfos_rest, nest0=None, nests_rest=None) ->
        (state, diag, viol, acc, last_extract)``; for a perturbed member
        JAX's ``chunk_fn_pert``, ``(state, forcing0, forcings_rest, tinfo0,
        tinfos_rest, pert_state, nest0=None, nests_rest=None) -> (state,
        diag, viol, acc, last_extract, pert_state, last_forcing)`` on the
        unperturbed forcing, ``pert_state`` the AR(1) carry
        (``EnsembleForcing.init_state`` before the first call; the
        generator advances by k draws). ``forcings_rest`` is a
        ``Forcing`` whose planes stack the k - 1 later steps on a leading
        axis (or a list of k - 1 bundles), ``tinfos_rest`` a dict of k - 1
        flags a key, ``nests_rest`` stacks the outer fields likewise. ``acc``
        sums ``_extract`` over the k steps (moorings variables, the coupler's
        ``__cpl_`` fields), ``last_extract`` is the last step's. One graph
        replay on the card, the eager body on the CPU."""

        def rest(tree, n):
            if tree is None or isinstance(tree, (list, tuple)):
                return list(tree) if tree is not None else [None] * n
            if isinstance(tree, dict):
                return [{key: v[i] for key, v in tree.items()} for i in range(n)]
            return [tree.replace(**{f: getattr(tree, f)[i] for f in tree.__dataclass_fields__
                                    if isinstance(getattr(tree, f), torch.Tensor)}) for i in range(n)]

        def program(state, forcing0, forcings_rest, tinfo0, tinfos_rest, nest0, nests_rest, *pert):
            forcings = [forcing0, *rest(forcings_rest, k - 1)]
            tinfos = [tinfo0, *rest(tinfos_rest, k - 1)]
            nests = [nest0, *rest(nests_rest, k - 1)]
            return self._program(state, forcings, self.time_flags(tinfos),
                                 None if all(n is None for n in nests) else nests, self._wim_diag(), *pert)

        def chunk_fn(state, forcing0, forcings_rest, tinfo0, tinfos_rest, nest0=None, nests_rest=None):
            return program(state, forcing0, forcings_rest, tinfo0, tinfos_rest, nest0, nests_rest)

        def chunk_fn_pert(state, forcing0, forcings_rest, tinfo0, tinfos_rest, pert_state, nest0=None,
                          nests_rest=None):
            return program(state, forcing0, forcings_rest, tinfo0, tinfos_rest, nest0, nests_rest, pert_state)

        return chunk_fn if self._ens_pert is None else chunk_fn_pert

    def _debug_checks(self) -> None:
        if self.cfg["debugging.check_velocity_fields"]:
            owned = None if self.mesh is None else self.mesh.owned
            n_rogue, max_rel = checks.check_velocity_fields(
                self.state, self.grid_arrays["node_mask"], owned=owned)
            if self.mesh is not None:
                n_rogue, max_rel = self.mesh.sum_all(n_rogue), self.mesh.max_all(max_rel)
            if int(n_rogue) > 0:
                self.log.debug(
                    f"Rogue velocity step={self.pcpt}: {int(n_rogue)} nodes, "
                    f"max rel_error={float(max_rel):.2f}"
                )
        if self.cfg["debugging.check_fields"]:
            self._check_fields_detailed()

    def _flush_pending_viol(self) -> None:
        """Read the accumulated violation flags back and crash-dump on any
        hit (reference: checkFieldsFast throw, fe.cpp:14647-14654)."""
        self._last_check_pcpt = self.pcpt
        pv, self._pending_viol = self._pending_viol, None
        if pv is None:
            return
        flags = pv.cpu().numpy() if self.mesh is None else self.mesh.max_all(pv)
        if flags.any():
            self._crash_dump(checks.describe(flags, self.dyn.use_young_ice))

    def _check_fields_detailed(self) -> None:
        """Slow per-element audit behind debugging.check_fields (reference:
        checkFields, fe.cpp:14661-14860), incl. the targeted single-cell
        printout behind debugging.test_element_number."""
        hstate = self.host_state()
        lf = self.gather(self.last_forcing)
        itest = self.cfg["debugging.test_element_number"]
        if itest >= 0:
            j, i = divmod(int(itest), self.grid.nx)
            self.log.debug(checks.detailed_report(hstate, j, i, lf))
        msgs = checks.check_fields(hstate, lf, self.dyn.use_young_ice)
        if msgs:
            self._crash_dump(msgs)

    def data_assimilation(self) -> None:
        """Full restart-time data assimilation (reference: DataAssimilation,
        fe.cpp:509-525): assimilateSlabOcean then assimilateIce (the OSISAF/
        AMSR2/NIC blends, fe.cpp:12124-12404), then checkConsistency."""
        from nextsim_tpu_torch.model.init_ice_datasets import (
            assimilate_ice,
            assimilate_slab_ocean,
        )

        # on the global state and grid, as on one device
        mask = torch.as_tensor(self.grid.mask, dtype=self.dtype, device=self.device)
        forcing = self.forcing_provider(self.current_time, self.time_init)
        mu = self.cfg["thermo.freezingpoint_mu"]
        fp = lambda sss: -mu * sss  # noqa: E731  (linear freezing point)
        state = assimilate_slab_ocean(
            self.cfg, self._global_state(), forcing.ocean_temp, forcing.ocean_salt, fp
        )
        state = assimilate_ice(self.cfg, self.grid, state, mask, self.time_init)
        self.state = self.to_blocks(init_state.check_consistency(self.cfg, state, mask))

    def assimilate(self, obs_conc) -> None:
        """Assimilate an observed concentration analysis (host array or
        tensor) into the state (reference: DataAssimilation/assimilateIce,
        fe.cpp:509-525, 11634-11662): replace conc, track conc_upd,
        re-check consistency."""
        from nextsim_tpu_torch.model.init_ice_datasets import assimilate_conc

        mask = torch.as_tensor(self.grid.mask, dtype=self.dtype, device=self.device)
        state = assimilate_conc(self._global_state(), obs_conc, mask, min_h=self.cfg["dynamics.min_h"])
        self.state = self.to_blocks(init_state.check_consistency(self.cfg, state, mask))

    def _check_outputs(self, skip_moorings_means: bool = False) -> None:
        """Per-step output handling (reference: checkOutputs, fe.cpp:
        8316-8450: moorings means/append, drifters move/IO, snapshots,
        interval restarts)."""
        t = self.current_time
        if self.moorings is not None:
            if not skip_moorings_means:
                # accumulated on the device; the one host copy happens when
                # a record is written
                self.moorings.update_means(self.state, self.diag, self.last_forcing)
            self.moorings.maybe_output(self)
        if self.drifters:
            # move drifters with the accumulated displacement (UT) at the
            # finest drifter cadence: one host copy of the three planes they
            # need per move (reference: buoys ride M_UT between outputs)
            cadence = min(d.output_dt_days for d in self.drifters)
            cadence = max(cadence, self.dt * dates.DAYS_IN_SEC)
            if t - self._drifter_last_move >= cadence - 1e-9:
                ut_u, ut_v, conc = self.gather((self.state.ut_u, self.state.ut_v, self.state.conc))
                if self._drifter_ut_prev is None:
                    self._drifter_ut_prev = (np.zeros_like(ut_u), np.zeros_like(ut_v))
                du = ut_u - self._drifter_ut_prev[0]
                dv = ut_v - self._drifter_ut_prev[1]
                self._drifter_ut_prev = (ut_u, ut_v)
                self._drifter_last_move = t
                for d in self.drifters:
                    if t < d.active_from - 1e-9:
                        continue  # fixed-init drifters (RGPS/SIDFEx) wait
                    if d.maybe_reseed(t, conc):
                        continue  # fresh 48 h window: seeded at t, no move
                    d.move_by_displacement(du, dv)
                    if hasattr(d, "update_transient"):
                        d.update_transient(t, conc)
                    d.mask_by_conc(conc)
                    d.maybe_output(t)
        # interval checks by boundary-crossing, not modulo (chunked stepping
        # advances pcpt k at a time)
        if (
            self.export_interval_steps
            and self.pcpt - self._last_export_pcpt >= self.export_interval_steps
        ):
            from nextsim_tpu_torch.output.exporter import export_snapshot

            self._last_export_pcpt = self.pcpt
            export_snapshot(self)
        if (
            self.restart_interval_steps
            and self.pcpt - self._last_restart_pcpt >= self.restart_interval_steps
        ):
            from nextsim_tpu_torch.output.restart import write_restart

            self._last_restart_pcpt = self.pcpt
            write_restart(self)

    def finalise(self) -> None:
        """End-of-run outputs (reference: fe.cpp:8497-8508 + finalise)."""
        # violations since the last readback are checked BEFORE the final
        # artifacts are written, so a NaN tail window cannot persist a
        # corrupt "final" restart with exit 0
        if self.check_fast:
            self._flush_pending_viol()
        cfg = self.cfg
        if cfg["output.export_fields"] and self.export_interval_steps:
            from nextsim_tpu_torch.output.exporter import export_snapshot

            export_snapshot(self, name="final")
        if cfg["restart.write_final_restart"]:
            from nextsim_tpu_torch.output.restart import write_restart

            write_restart(self, name="final")
        for d in self.drifters:
            if d.records and multihost.is_writer():
                d.write_netcdf(os.path.join(cfg["output.exporter_path"], f"Drifters_{d.tag}.nc"))
        # every asynchronously-submitted snapshot/restart must be on disk
        # (and any worker IO error surfaced) before the run is declared done
        async_writer.flush()
        self.log.info("\n" + self.timer.print_all())

    def _crash_dump(self, msgs: List[str]) -> None:
        """Export a crash snapshot then raise (reference: fe.cpp:14647-14654)."""
        try:
            from nextsim_tpu_torch.output.exporter import export_snapshot

            export_snapshot(self, name="crash")
            async_writer.flush()  # the dump must land before the raise
        except Exception as e:  # noqa: BLE001 - best-effort crash dump
            self.log.error(f"crash export failed: {e}")
        stats = checks.field_stats(self.state)
        raise RuntimeError("; ".join(msgs) + f"; field stats: {stats}")

    def _clamped_chunk(self, k: int) -> int:
        """The largest chunk length <= k that divides every exact cadence
        in steps: the coupler put window (reference: coupler.timestep,
        fe.cpp:8226-8265), the finest drifter cadence (checkMoveDrifters
        timing, fe.cpp:8375-8403), the WIM coupling frequency
        (nextwim.couplingfreq; wimdiscr.cpp:822-1210), the moorings output
        window and the snapshot interval (gridoutput.cpp +
        fe.cpp:8316-8450). Interval
        restarts stay boundary-crossing (a late restart is still an exact
        state)."""
        step_days = self.dt * dates.DAYS_IN_SEC
        cadences = {}
        if self.coupler is not None:
            cadences["coupler window"] = max(1, round(self.coupler.dt_cpl / self.dt))
        if self.drifters:
            cad_days = min(d.output_dt_days for d in self.drifters)
            cadences["finest drifter cadence"] = max(1, round(cad_days / step_days))
        if self.wim is not None:
            cadences["WIM coupling frequency"] = self.wim_couplingfreq
        if self.moorings is not None:
            cadences["moorings output window"] = max(
                1, round(self.moorings.output_dt_days / step_days)
            )
        if self.export_interval_steps:
            cadences["snapshot interval"] = self.export_interval_steps
        if not cadences:
            return k
        g = 0
        for v in cadences.values():
            g = math.gcd(g, v)
        k_new = min(k, g)
        while g % k_new:
            k_new -= 1
        if k_new != k:
            detail = ", ".join(f"{name}={v} steps" for name, v in cadences.items())
            self.log.info(
                f"tpu.steps_per_call clamped {k}->{k_new}: k must divide every "
                f"exact cadence ({detail})"
            )
        return k_new

    def run(self, callbacks: Optional[List[Callable]] = None) -> State:
        """Main loop (reference: FiniteElement::run, fe.cpp:8450-8509)."""
        n_steps = int(self.duration_days * phys.days_in_sec / self.dt)
        if self.maxiteration > 0:
            n_steps = min(n_steps, self.maxiteration)
        k = self._chunk_k
        if k > 1:
            k = self._chunk_k = self._clamped_chunk(k)
        self.log.info(f"run: {n_steps} steps of {self.dt}s" + (f" ({k}/call)" if k > 1 else ""))
        ptime = max(1, n_steps * self.cfg["debugging.ptime_percent"] // 100)
        profile_dir = self.cfg["debugging.profile_dir"]
        profiler = None
        if profile_dir:
            # torch.profiler trace of the whole main loop (host + device
            # timelines), the analog of the reference's gperftools hook
            # (run.sh:64-78); written as a Chrome trace, beside it each
            # captured graph's phase table (phases.json), which names the
            # phase of each of a replay's kernels in order
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.__enter__()
        try:
            i = 0
            while i < n_steps:
                if k > 1 and i + k <= n_steps:
                    self.step_chunk()
                    i += k
                else:
                    self.step()
                    i += 1
                for cb in callbacks or ():
                    cb(self)
                if i % ptime < k and i >= ptime:
                    self.log.info(
                        f"---------------------- TIME STEP {self.pcpt} : "
                        f"{dates.datenum_to_string(self.current_time)} "
                        f"({100 * i // n_steps}%)"
                    )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            if profiler is not None:
                profiler.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                with open(os.path.join(profile_dir, "phases.json"), "w") as f:
                    json.dump([{"program": self._program.name, "nodes": g.stats["nodes"],
                                "phases": g.stats["phases"]} for g in self._program.graphs.values()], f)
        self.finalise()
        return self.state

    # ------------------------------------------------------------------
    @property
    def current_time(self) -> float:
        """Model time in days since 1900-01-01 (reference M_current_time)."""
        return self.time_after(0)

    def time_after(self, i: int) -> float:
        """``current_time`` after ``i`` more steps, rounded as the step loop
        rounds it: a chunk's forcing and flags take the times (and so the
        time-interpolation weights) of the steps it replaces, bit for bit."""
        return self.time_init + (self.pcpt + i) * self.dt * dates.DAYS_IN_SEC

    def time_info(self):
        """Per-step time flags for the thermo tracers (reference:
        fe.cpp:5655-5660 step_in_day; 5999, 6061, 6050 date checks)."""
        return self.time_info_at(self.current_time)

    def time_flags(self, tinfos) -> torch.Tensor:
        """The time flags of a chunk's k steps (``time_info`` dicts) as one
        (k, 5) device tensor in ``TIME_FLAGS`` order and the state's dtype,
        the form the step program takes (the JAX package stacks its traced
        flags likewise). One tensor per pattern of flags is kept, so a chunk
        with the flags of an earlier one copies nothing to the device."""
        key = tuple(float(ti[name]) for ti in tinfos for name in TIME_FLAGS)
        hit = self._flags.get(key)
        if hit is None:
            if len(self._flags) >= 64:
                self._flags.clear()
            hit = self._flags[key] = torch.tensor(key, dtype=self.dtype, device=self.device).reshape(
                len(tinfos), len(TIME_FLAGS))
        return hit

    def time_info_at(self, t: float):
        """time_info evaluated at an arbitrary model time, as host numbers
        (1.0 or 0.0): an eager thermo_step branches on them in Python, so a
        step copies nothing to the device for them (``time_flags`` gives a
        chunk's as one device tensor)."""
        num_steps_in_day = max(1, round(phys.days_in_sec / self.dt))
        step_in_day = 1 + round(num_steps_in_day * (t % 1.0))
        md = dates.datenum_to_string(t, "%m%d")
        midnight = abs(t % 1.0) < 1e-9
        reset_md = self.cfg["age.reset_date"]
        flags = {
            "is_day_start": step_in_day == 1,
            "is_day_end": step_in_day == num_steps_in_day,
            "is_0915": md == "0915" and midnight,
            "is_0801": md == "0801" and midnight,
            "is_myi_reset_date": md == reset_md and midnight,
        }
        return {k: 1.0 if v else 0.0 for k, v in flags.items()}
