"""Batched ensemble (the counterpart of nextsim_tpu/ensemble/batched.py).

The reference runs ensemble members as separate MPI jobs (reference:
scripts/ensemble/run_ensemble.sh; modules/enkf perturbations applied per
process under #ifdef ENSEMBLE, externaldata.cpp:244-278). Here all members
live in one process and on one device: every ``State`` field is stacked on a
leading member axis, as in the JAX package, so the ensemble mean, spread and
statistics are reductions over axis 0.

The step itself is not batched. The port's operators are written for 2-D
planes and the substep kernel takes one state, so each member steps in turn
through the template Simulator's ``_step_fn`` on the views ``x[k]`` of the
stack, and the result is written back into it. N members cost N model steps
(and one forcing call); ``python -m nextsim_tpu_torch.ensemble.run_ensemble``
runs members as separate Simulators instead.

Member 0 is the unperturbed control; members 1..N-1 carry independent AR(1)
spectral forcing perturbations (ensemble/perturbation.py). Member m's stream
is the one a ``Simulator`` with ``statevector.ensemble_member=m`` and the
same seed draws, so batched member m equals that Simulator's run.

Checkpoints are one ``restart_<name>.npz`` (the JAX package writes an orbax
directory; the port has no orbax): the stacked state, the AR(1) carry and
every member generator's state, so a resumed ensemble continues the same
noise stream.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from nextsim_tpu_torch.core.state import State
from nextsim_tpu_torch.ensemble.perturbation import EnsembleForcing, PerturbationParams, member_generator
from nextsim_tpu_torch.utils import dates


def _fields(state):
    return [f.name for f in dataclasses.fields(state) if getattr(state, f.name) is not None]


class BatchedEnsemble:
    """N members on a leading axis, stepped one after the other."""

    def __init__(self, cfg, n_members: int, seed: int = 11,
                 params: Optional[PerturbationParams] = None, device="cuda"):
        from nextsim_tpu_torch.model.simulator import Simulator

        from nextsim_tpu_torch.parallel.seam import mesh_shape

        if n_members < 1:
            raise ValueError("n_members must be >= 1")
        if mesh_shape(cfg) != (1, 1):
            raise NotImplementedError(
                "the PyTorch port does not have the batched ensemble on a device mesh "
                "(ROADMAP A.14b) yet"
            )
        if cfg["statevector.ensemble_member"] > 0:
            raise ValueError(
                "BatchedEnsemble manages perturbations itself: leave "
                "statevector.ensemble_member at 0"
            )
        self.n = n_members
        self.sim = Simulator(cfg, device=device)  # template: control provider, step fn, grid
        self.states = self.sim.state.replace(**{
            name: torch.stack([getattr(self.sim.state, name)] * n_members) for name in _fields(self.sim.state)
        })
        # one perturbation engine (its _draw_stack and _advance), one
        # generator a perturbed member
        self._pert = EnsembleForcing(
            self.sim.forcing_provider, self.sim.grid, cfg, params=params, seed=seed,
            dtype=self.sim.dtype, device=self.sim.device,
        )
        self.generators = [member_generator(seed, m, self.sim.device) for m in range(1, n_members)]
        self._ran = None  # AR(1) carry, (n-1, 4, ny, nx)
        self.pcpt = 0

    # -- forcing ----------------------------------------------------------
    def _member_forcings(self, t_days: float) -> list:
        """The shared base forcing (one provider call), then each perturbed
        member's, its AR(1) carry advanced with a fresh draw of its stream."""
        base = self.sim.forcing_provider(t_days, self.sim.time_init)
        if self.n == 1:
            return [base]
        if self._ran is None:
            self._ran = torch.stack([self._pert._draw_stack(g) for g in self.generators])
        out, ran = [base], []
        for k, g in enumerate(self.generators):
            r, f = self._pert._advance(self._ran[k], self._pert._draw_stack(g), base)
            ran.append(r)
            out.append(f)
        self._ran = torch.stack(ran)
        return out

    # -- stepping ---------------------------------------------------------
    def step(self) -> None:
        sim = self.sim
        t_next = sim.time_init + (self.pcpt + 1) * sim.dt * dates.DAYS_IN_SEC
        forcings = self._member_forcings(t_next)
        tinfo = sim.time_info_at(sim.time_init + self.pcpt * sim.dt * dates.DAYS_IN_SEC)
        names = _fields(self.states)
        for k, forcing in enumerate(forcings):
            member = self.states.replace(**{name: getattr(self.states, name)[k] for name in names})
            out, _diag, _viol = sim._step_fn(member, forcing, tinfo)
            for name in names:
                getattr(self.states, name)[k].copy_(getattr(out, name))
        self.pcpt += 1
        if sim.moorings is not None:
            self._maybe_output_stats()

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step()

    # -- outputs ----------------------------------------------------------
    @property
    def current_time(self) -> float:
        return self.sim.time_init + self.pcpt * self.sim.dt * dates.DAYS_IN_SEC

    def _stat_fields(self):
        """Per-variable ensemble mean and spread (population std) on the
        model grid, keyed ``<nc_name>_mean`` / ``<nc_name>_std`` — the
        ensemble-statistics observability channel (the reference runs full
        per-member jobs and computes statistics offline;
        scripts/ensemble/run_ensemble.sh)."""
        from nextsim_tpu_torch.output.moorings import MOORING_VARIABLES, VECTOR_VARIABLES

        states = self.states
        out = {}

        def add(nc_name, a):
            out[nc_name + "_mean"] = torch.mean(a, dim=0)
            out[nc_name + "_std"] = torch.std(a, dim=0, correction=0)

        for name in self.sim.moorings.names:
            if name in VECTOR_VARIABLES:
                (unm, *_, uf), (vnm, *_, vf) = VECTOR_VARIABLES[name]
                u, v = getattr(states, uf), getattr(states, vf)
                if not self.sim.moorings.false_easting:
                    # rotate each member to east/north before the statistics:
                    # the mean commutes with the rotation, the component std
                    # does not. _write_record rotates only the bare siu/siv
                    # keys, so *_mean/*_std arrive oriented; the angle is the
                    # model nodes'
                    c, s = self._node_rot()
                    u, v = c * u - s * v, s * u + c * v
                add(unm, u)
                add(vnm, v)
                continue
            mv = MOORING_VARIABLES.get(name)
            if mv is None or mv.source != "state":
                continue  # diag/forcing channels are per-member quantities
            a = getattr(states, mv.field, None)
            if a is None:
                continue
            if mv.index is not None:
                a = a[:, mv.index]  # component axis sits after the member axis
            add(mv.nc_name, a)
        return out

    def _node_rot(self):
        """(cos, sin) of the east/north rotation angle at the model nodes
        (reference: rotateVectors' true-easting branch, rotation - lon;
        gridoutput.cpp:596-615)."""
        rot = getattr(self, "_node_rot_cache", None)
        if rot is None:
            _, node_lon = self.sim.grid.node_latlon()
            ang = np.deg2rad(self.sim.grid.projection.lon0) - np.deg2rad(np.asarray(node_lon))
            on_dev = lambda a: torch.as_tensor(a, dtype=self.sim.dtype, device=self.sim.device)  # noqa: E731
            rot = (on_dev(np.cos(ang)), on_dev(np.sin(ang)))
            self._node_rot_cache = rot
        return rot

    def _maybe_output_stats(self) -> None:
        """Write an ensemble-statistics moorings record when the configured
        moorings window closes (snapshot statistics at the output instants,
        through the Moorings grid, remap, rollover and append)."""
        moor = self.sim.moorings
        t = self.current_time
        if t - moor._last_output_time < moor.output_dt_days - 1e-9:
            return
        stats = self._stat_fields()
        if not stats:
            return
        moor._accum = stats
        moor._count = 1
        moor._last_output_time = t
        moor._write_record(t)

    def _restart_file(self, name: str) -> str:
        return os.path.join(self.sim.cfg["output.exporter_path"], "restart", f"restart_{name}.npz")

    def write_restart(self, name: str = "batched") -> str:
        """One checkpoint of the whole ensemble: the stacked state, the
        AR(1) carry and every member generator's state, so a resumed
        ensemble continues the same forcing-noise stream."""
        from nextsim_tpu_torch.core.state import to_host
        from nextsim_tpu_torch.output.restart import save_npz_restart

        fname = self._restart_file(name)
        os.makedirs(os.path.dirname(fname), exist_ok=True)
        arrays = {f"state_{k}": to_host(getattr(self.states, k)) for k in _fields(self.states)}
        if self._ran is not None:
            arrays["ran"] = to_host(self._ran)
        if self.generators:
            arrays["generators"] = np.stack([g.get_state().numpy() for g in self.generators])
        meta = {"pcpt": self.pcpt, "n_members": self.n, "time_init": self.sim.time_init}
        return save_npz_restart(fname, meta, arrays)

    def read_restart(self, name: str = "batched") -> None:
        """Restore a checkpoint written by ``write_restart``."""
        fname = self._restart_file(name)
        with np.load(fname, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            if int(meta["n_members"]) != self.n:
                raise ValueError(
                    f"checkpoint {fname} holds {meta['n_members']} members; "
                    f"this ensemble was built with n_members={self.n}"
                )
            if abs(float(meta["time_init"]) - self.sim.time_init) > 1e-9:
                raise ValueError(
                    f"checkpoint time_init {meta['time_init']} != configured "
                    f"simul.time_init ({self.sim.time_init})"
                )
            on_dev = lambda a, dt=self.sim.dtype: torch.as_tensor(np.array(a), dtype=dt, device=self.sim.device)  # noqa: E731
            kw = {}
            for f in dataclasses.fields(self.states):
                key, cur = f"state_{f.name}", getattr(self.states, f.name)
                kw[f.name] = on_dev(data[key], cur.dtype if cur is not None else self.sim.dtype) if key in data else None
            self.states = State(**kw)
            self._ran = on_dev(data["ran"]) if "ran" in data else None
            for g, st in zip(self.generators, data["generators"] if self.generators else ()):
                g.set_state(torch.from_numpy(np.array(st)))
        self.pcpt = int(meta["pcpt"])
        if self.sim.moorings is not None:
            # re-anchor the stats cadence on the absolute output grid, as if
            # the run had been unbroken
            moor = self.sim.moorings
            w = moor.output_dt_days
            elapsed = self.current_time - self.sim.time_init
            moor._last_output_time = self.sim.time_init + math.floor(elapsed / w + 1e-9) * w

    def export_member_restarts(self, name: str = "final") -> list:
        """Per-member standard restarts: member k's state is written as
        ``mem_<k>/restart/restart_<name>.npz`` in the ensemble output tree,
        loadable by a plain Simulator of either package
        (restart.start_from_restart=true) — so the per-process driver
        (ensemble/run_ensemble.py) can resume a forecast cycle that was
        advanced batched (the per-member outputs of the reference's
        scripts/ensemble/run_ensemble.sh)."""
        from nextsim_tpu_torch.core.state import to_host
        from nextsim_tpu_torch.output.restart import restart_meta, save_npz_restart

        base = self.sim.cfg["output.exporter_path"]
        # the counters live on the ensemble, not the template Simulator
        meta = dict(restart_meta(self.sim), pcpt=self.pcpt, current_time=self.current_time)
        written = []
        for k in range(self.n):
            st = self.member_state(k)
            arrays = {name: to_host(getattr(st, name)) for name in _fields(st)}
            path = os.path.join(base, f"mem_{k}", "restart")
            os.makedirs(path, exist_ok=True)
            written.append(save_npz_restart(os.path.join(path, f"restart_{name}.npz"), meta, arrays))
        return written

    # -- analysis ---------------------------------------------------------
    def member_state(self, k: int) -> State:
        """Member k's State (0 = control): views into the stack."""
        return self.states.replace(**{name: getattr(self.states, name)[k] for name in _fields(self.states)})

    def spread(self, fields=("conc", "thick", "vt_u", "vt_v")) -> Dict[str, float]:
        """Domain-mean ensemble standard deviation per field (the usual
        spread diagnostic for perturbation sanity)."""
        out = {}
        for name in fields:
            x = getattr(self.states, name)
            if x is None:
                continue
            out[name] = float(x.to(torch.float32).std(dim=0, correction=0).mean())
        return out

    def mean_state(self) -> State:
        """Ensemble-mean State (the EnKF forecast mean)."""
        return self.states.replace(**{
            name: getattr(self.states, name).mean(dim=0).to(getattr(self.states, name).dtype)
            for name in _fields(self.states)
        })
