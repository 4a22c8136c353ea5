"""The Simulator: init -> step loop (the counterpart of
nextsim_tpu/model/simulator.py, main path only).

One model step, as FiniteElement::step (reference: model/finiteelement.cpp:
7963-8289) with thermodynamics off:

    dynamics (momentum substeps)  ->  transport (advection + ridging)  ->
    checkFieldsFast violations

PyTorch runs eagerly, so there is no jit and no scan: ``step`` runs one step
and ``step_chunk`` runs ``tpu.steps_per_call`` steps as a Python loop. The
violation flags are maxed on the device and read back once per chunk (or per
``tpu.check_interval`` steps), never per step inside a chunk.

The subsystems the JAX Simulator wires up beyond this path raise
``NotImplementedError`` naming the ROADMAP item that ports them; none is
skipped silently. The options that tune JAX's compilation and TPU kernels
(``tpu.donate_state``, ``tpu.compilation_cache_dir``, ``tpu.substep_kernel``,
``tpu.substep_unroll``, ``tpu.pallas_*``) have no counterpart here.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from nextsim_tpu_torch.config import Config
from nextsim_tpu_torch.core import constants as phys
from nextsim_tpu_torch.forcing.providers import make_provider
from nextsim_tpu_torch.grid.grid import Grid
from nextsim_tpu_torch.model import checks, init_state, params
from nextsim_tpu_torch.ops import momentum, transport
from nextsim_tpu_torch.utils import dates

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _unported(cfg) -> Optional[str]:
    """The first configured subsystem the port does not have yet, as
    'option (ROADMAP item)', or None."""
    drifters = [k for k in cfg.as_dict()
                if k.startswith("drifters.use_") and k.endswith("_drifters") and cfg[k]]
    restarts = ("restart.start_from_restart", "restart.write_final_restart",
                "restart.write_interval_restart", "restart.write_initial_restart")
    rules = [
        (cfg["thermo.use_thermo_forcing"], "thermo.use_thermo_forcing=true (ROADMAP A.7, thermodynamics)"),
        (cfg["moorings.use_moorings"], "moorings.use_moorings=true (ROADMAP A.8, outputs)"),
        (bool(drifters), f"{drifters[0] if drifters else ''}=true (ROADMAP A.8, outputs)"),
        (cfg["output.output_per_day"] != 0, "output.output_per_day != 0 (ROADMAP A.8, outputs)"),
        (any(cfg[k] for k in restarts), "restart reading/writing (ROADMAP A.8, outputs)"),
        (cfg["debugging.check_fields"] or cfg["debugging.check_velocity_fields"],
         "debugging.check_fields / check_velocity_fields (ROADMAP A.8, outputs)"),
        (cfg["nesting.use_nesting"], "nesting.use_nesting=true (ROADMAP A.9, datasets and nesting)"),
        (cfg["wave_coupling.num_fsd_bins"] > 0, "wave_coupling.num_fsd_bins > 0 (ROADMAP A.10, waves)"),
        (cfg["nextwim.use_wim"], "nextwim.use_wim=true (ROADMAP A.10, waves)"),
        (cfg["statevector.ensemble_member"] > 0, "statevector.ensemble_member > 0 (ROADMAP A.11, ensembles)"),
        (cfg["setup.ocean-type"] == "coupled" or cfg["coupler.with_waves"],
         "the coupler (ROADMAP A.12, coupling)"),
        (str(cfg["tpu.mesh_shape"]).lower().strip() not in ("", "1x1")
         or cfg["tpu.partition_mode"] != "gspmd" or cfg["tpu.halo_depth"] != 1,
         "a device mesh (ROADMAP A.14, multi-device)"),
        (cfg["tpu.dtype"] == "bfloat16", "tpu.dtype=bfloat16 (ROADMAP A.16, bfloat16 state)"),
    ]
    for on, what in rules:
        if on:
            return what
    return None


class Simulator:
    def __init__(self, cfg: Config, device="cpu"):
        what = _unported(cfg)
        if what is not None:
            raise NotImplementedError(f"the PyTorch port does not have {what} yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _DTYPES[cfg["tpu.dtype"]]
        self.grid = Grid.from_config(cfg)

        # --- time bookkeeping (host) -------------------------------------
        self.dt = float(cfg["simul.timestep"])  # seconds
        time_init_str = cfg["simul.time_init"]
        self.time_init = dates.string_to_datenum(time_init_str) if time_init_str else 0.0
        self.pcpt = 0  # step counter (reference pcpt)

        # --- parameters ---------------------------------------------------
        self.dyn = params.dyn_params(cfg, self.grid.dx)
        self.c_fix, self.c_alea = params.cohesion_params(cfg, self.grid.dx)
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
        self.forcing_provider = make_provider(cfg, self.grid, self.dtype, self.device)
        self.diag = {}
        self._pending_viol = None
        self._last_check_pcpt = 0

    # ------------------------------------------------------------------
    def _step_fn(self, state, forcing):
        """One model step on the device: (state', diag, violation flags)."""
        ga = dict(self.grid_arrays)
        # cohesion field for this step (reference: calcCohesion, fe.cpp:3909-3914)
        ga["cohesion"] = self.c_fix + self.c_alea * state.random_number
        dyn = self.dyn
        diag = {}
        # ---- dynamics (reference: fe.cpp:8197-8221) ----------------------
        if dyn.dynamics_type in ("bbm", "evp", "mevp"):
            state, mdiag = momentum.explicit_solve(state, forcing, ga, self.dt, dyn)
            diag.update(mdiag)
        elif dyn.dynamics_type == "free_drift":
            state = momentum.free_drift(state, forcing, ga, self.dt, dyn)
        # ---- transport + ridging (fe.cpp:8221, 3919) ---------------------
        if dyn.dynamics_type != "no_motion":
            state, vdiag = transport.transport_and_ridge(
                state, ga, self.dt, self.transport_params
            )
            diag.update(vdiag)
        return state, diag, checks.violations(state, use_young_ice=dyn.use_young_ice)

    def _next_forcing(self):
        return self.forcing_provider(
            self.current_time + self.dt * dates.DAYS_IN_SEC, self.time_init
        )

    def _accumulate_viol(self, viol) -> None:
        prev = self._pending_viol
        self._pending_viol = viol if prev is None else torch.maximum(prev, viol)

    def step(self) -> None:
        """Advance one model step."""
        self.state, self.diag, viol = self._step_fn(self.state, self._next_forcing())
        self.pcpt += 1
        if self.check_fast:
            self._accumulate_viol(viol)
            interval = self.cfg["tpu.check_interval"]
            if interval <= 1 or self.pcpt - self._last_check_pcpt >= interval:
                self._flush_pending_viol()

    def step_chunk(self, k: Optional[int] = None) -> None:
        """Advance ``k`` steps (default ``tpu.steps_per_call``), reading the
        violation flags back once at the end of the chunk."""
        k = self._chunk_k if k is None else k
        for _ in range(k):
            self.state, self.diag, viol = self._step_fn(self.state, self._next_forcing())
            self.pcpt += 1
            if self.check_fast:
                self._accumulate_viol(viol)
        if self.check_fast:
            interval = max(self.cfg["tpu.check_interval"], k)
            if self.pcpt - self._last_check_pcpt >= interval:
                self._flush_pending_viol()

    def _flush_pending_viol(self) -> None:
        """Read the accumulated violation flags back and raise on any hit
        (reference: checkFieldsFast throw, fe.cpp:14647-14654)."""
        self._last_check_pcpt = self.pcpt
        pv, self._pending_viol = self._pending_viol, None
        if pv is None:
            return
        flags = pv.cpu().numpy()
        if flags.any():
            msgs = checks.describe(flags, self.dyn.use_young_ice)
            stats = checks.field_stats(self.state)
            raise RuntimeError("; ".join(msgs) + f"; field stats: {stats}")

    # ------------------------------------------------------------------
    @property
    def current_time(self) -> float:
        """Model time in days since 1900-01-01 (reference M_current_time)."""
        return self.time_init + self.pcpt * self.dt * dates.DAYS_IN_SEC

    def time_info(self):
        """Per-step scalar time flags for the thermo tracers (reference:
        fe.cpp:5655-5660 step_in_day; 5999, 6061, 6050 date checks)."""
        return self.time_info_at(self.current_time)

    def time_info_at(self, t: float):
        """time_info evaluated at an arbitrary model time."""
        num_steps_in_day = max(1, round(phys.days_in_sec / self.dt))
        step_in_day = 1 + round(num_steps_in_day * (t % 1.0))
        md = dates.datenum_to_string(t, "%m%d")
        midnight = abs(t % 1.0) < 1e-9
        reset_md = self.cfg["age.reset_date"]

        def flag(b):
            return torch.tensor(1.0 if b else 0.0, dtype=self.dtype, device=self.device)

        return {
            "is_day_start": flag(step_in_day == 1),
            "is_day_end": flag(step_in_day == num_steps_in_day),
            "is_0915": flag(md == "0915" and midnight),
            "is_0801": flag(md == "0801" and midnight),
            "is_myi_reset_date": flag(md == reset_md and midnight),
        }
