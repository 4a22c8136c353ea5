"""Batched ensemble (the counterpart of nextsim_tpu/ensemble/batched.py).

The reference runs ensemble members as separate MPI jobs (reference:
scripts/ensemble/run_ensemble.sh; modules/enkf perturbations applied per
process under #ifdef ENSEMBLE, externaldata.cpp:244-278). Here the members
live in one process and on one device: every ``State`` field is stacked on a
leading member axis, as in the JAX package, so the ensemble mean, spread and
statistics are reductions over axis 0.

The step advances all members at once, the JAX package's ``jax.vmap`` of
``raw_step_fn``: ``Simulator.batched_step_fn`` runs the model step once on
the stack, with the member axis moved just before the plane's two axes for
the step (``core.state.member_minor``: a plane ``(N, ny, nx)``, ``tice``
``(3, N, ny, nx)``; the operators take planes with leading axes, so
``tice[0]`` and ``torch.stack`` keep their meaning) and moved back after.
The grid arrays and the forcing fields that no member perturbs stay planes
and broadcast; the perturbed ones are stacked (``perturbation.
stack_forcings``). On the card the substep kernel runs every member in the
same launches (its grid holds N x the tiles), and the whole batched step is
one replay of a captured CUDA graph (``model/captured.py``), its inputs the
stack, the stacked forcing and the time flags. On the CPU the same body
runs eagerly. Member m equals the member stepped alone bitwise.

``step`` runs the batched step for every configuration, as the JAX
package's ``_vstep`` does: FSD Roach welding (one call of its kernel for
all members), the WIM, the coupler and nesting (whose exchanges, received
fields and outer runs are not run per member, in either package: the step
takes the provider's forcing) and block layouts (below). ``step_members``
keeps the member loop: each member in turn through the template
Simulator's ``raw_step_fn`` on the views ``x[k]`` of the stack. It is the
batched step's oracle. ``python -m nextsim_tpu_torch.ensemble.run_ensemble``
runs members as separate Simulators instead.

Member 0 is the unperturbed control; members 1..N-1 carry independent AR(1)
spectral forcing perturbations (ensemble/perturbation.py). Member m's stream
is the one a ``Simulator`` with ``statevector.ensemble_member=m`` and the
same seed draws, so batched member m equals that Simulator's run. The
draws stay outside the captured step: one ``torch.Generator`` a member,
called on the host before each step.

A member mesh (``mesh``, the JAX ``('member',)`` and ``('member', 'y',
'x')`` meshes) is a shape: ``(P,)`` or ``(P, dpy, dpx)``, one
torch.distributed rank a device, P * dpy * dpx ranks (``tpu.mesh_shape``
alone is ``(1, dpy, dpx)``). The ranks form P groups of dpy x dpx
(``multihost.member_groups``); group g holds members g*N/P .. (g+1)*N/P - 1,
steps them through its own template Simulator on its blocks, with the
group's ``seam.Seam`` as its exchanger, and draws their noise from their
own generators, seeded as everywhere, so member m's draws do not depend on
the layout. Every group runs the batched step over its members; on blocks
its rings carry all of the group's members in one exchange, and the step
stays eager (the rings go through torch.distributed) but batched. What
reads the whole ensemble (``member_state``, ``spread``, ``mean_state``, the
statistics records, the checkpoint) gathers the members' global planes from
the groups (collective: every rank calls it).

Checkpoints are one ``restart_<name>.npz`` (the JAX package writes an orbax
directory; the port has no orbax): the stacked state, the AR(1) carry and
every member generator's state, so a resumed ensemble continues the same
noise stream. Under a member mesh, rank 0 writes the same single npz of
global planes, and every rank reads its members from it: a checkpoint
crosses member layouts both ways. The JAX package refuses a checkpoint of
padded planes written under another 3-D mesh; the port's npz holds logical
global planes only, so that refusal has nothing to guard here.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nextsim_tpu_torch.core.state import State, file_arrays, host_array, host_tensor
from nextsim_tpu_torch.ensemble.perturbation import (EnsembleForcing, PerturbationParams, member_generator,
                                                     stack_forcings)
from nextsim_tpu_torch.model.captured import Captured
from nextsim_tpu_torch.utils import dates


def _fields(state):
    return [f.name for f in dataclasses.fields(state) if getattr(state, f.name) is not None]


def member_layout(cfg, n_members: int, mesh) -> Tuple[int, int, int]:
    """(P, dpy, dpx) of a ``BatchedEnsemble``'s ``mesh`` argument and its
    config's ``tpu.mesh_shape`` (module docstring); raises ValueError on a
    shape of another form, on a config that disagrees, on a world whose
    size is not P * dpy * dpx, and when P does not divide the members."""
    from nextsim_tpu_torch.parallel import multihost
    from nextsim_tpu_torch.parallel.seam import mesh_shape

    cfg_blocks = mesh_shape(cfg)
    if mesh is None:
        layout = (1,) + cfg_blocks
    else:
        layout = tuple(int(v) for v in mesh)
        if len(layout) == 1:
            layout = layout + (1, 1)
        if len(layout) != 3 or min(layout) < 1:
            raise ValueError(f"BatchedEnsemble mesh must be (P,) or (P, dpy, dpx), not {mesh!r}: "
                             "members, or members x domain decomposition")
        if cfg_blocks != (1, 1) and cfg_blocks != layout[1:]:
            raise ValueError(f"BatchedEnsemble mesh {tuple(mesh)} disagrees with "
                             f"tpu.mesh_shape={cfg_blocks[0]}x{cfg_blocks[1]}")
    size = multihost.process_count()
    ranks = math.prod(layout)
    if ranks != size:
        raise ValueError(
            f"a BatchedEnsemble on the member mesh {layout} runs one rank a device, {ranks} ranks, "
            f"and this world has {size}: start it with torchrun --nproc-per-node {ranks} (or set "
            "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in each process)")
    if n_members % layout[0]:
        raise ValueError(f"the mesh's member axis ({layout[0]} device groups) must divide "
                         f"n_members={n_members}")
    return layout


class BatchedEnsemble:
    """N members on a leading axis, advanced by one batched step (one graph
    replay on the card); on a member mesh, each group of ranks steps its
    share of them (module docstring)."""

    def __init__(self, cfg, n_members: int, seed: int = 11,
                 params: Optional[PerturbationParams] = None, device="cuda", mesh=None):
        from nextsim_tpu_torch.model.simulator import Simulator
        from nextsim_tpu_torch.parallel import multihost

        if n_members < 1:
            raise ValueError("n_members must be >= 1")
        if n_members > 1 and cfg["tpu.dtype"] == "bfloat16":
            from nextsim_tpu_torch.model.simulator import _BF16_FAILS_IN_JAX

            raise NotImplementedError("the PyTorch port does not run a BatchedEnsemble of more than "
                                      "one member in tpu.dtype=bfloat16 (perturbed forcing)"
                                      + _BF16_FAILS_IN_JAX)
        if cfg["statevector.ensemble_member"] > 0:
            raise ValueError(
                "BatchedEnsemble manages perturbations itself: leave "
                "statevector.ensemble_member at 0"
            )
        self.n = n_members
        self.member_mesh = member_layout(cfg, n_members, mesh)
        P, dpy, dpx = self.member_mesh
        group, self.group_index = None, 0
        if P > 1:
            groups, self.group_index = multihost.member_groups(P)
            group = groups[self.group_index]
        self._blocks_a_group = dpy * dpx
        per = n_members // P
        self.members = list(range(self.group_index * per, (self.group_index + 1) * per))
        if (dpy, dpx) != (1, 1):
            cfg = copy.deepcopy(cfg)
            cfg.set("tpu.mesh_shape", f"{dpy}x{dpx}")
        # template: control provider, step fn, grid; this group's blocks
        self.sim = Simulator(cfg, device=device, group=group)
        self.states = self.sim.state.replace(**{
            name: torch.stack([getattr(self.sim.state, name)] * per) for name in _fields(self.sim.state)
        })
        # one perturbation engine (its _draw_stack and _advance), one
        # generator a perturbed member of this group
        self._pert = EnsembleForcing(
            self.sim.forcing_provider, self.sim.grid, cfg, params=params, seed=seed,
            dtype=self.sim.dtype, device=self.sim.device,
        )
        self.generators = [member_generator(seed, m, self.sim.device) for m in self.members if m > 0]
        self._ran = None  # AR(1) carry of this group's perturbed members, (n_p, 4, ny, nx)
        self.pcpt = 0
        # the batched step: one graph replay a step on the card, the eager
        # batched body where the template's eager_reason says why (a block
        # layout)
        self._program = Captured(self._batched_body, name="ensemble step program", log=self.sim.log,
                                 capture=self.sim.eager_reason is None)
        self.violations = None  # the last batched step's flags, (members of this group, checks)

    @property
    def sharded(self) -> bool:
        """True on a member mesh or a block layout: more than one rank."""
        return math.prod(self.member_mesh) > 1

    # -- forcing ----------------------------------------------------------
    def _member_forcings(self, t_days: float) -> list:
        """The shared base forcing (one provider call), then the forcing of
        each of this group's members: the base for the control, else the
        base perturbed by the member's AR(1) carry advanced with a fresh
        draw of its stream. Global planes."""
        base = self.sim.forcing_provider(t_days, self.sim.time_init)
        if not self.generators:
            return [base] * len(self.members)
        if self._ran is None:
            self._ran = torch.stack([self._pert._draw_stack(g) for g in self.generators])
        out, ran = [base] if self.members[0] == 0 else [], []
        for k, g in enumerate(self.generators):
            r, f = self._pert._advance(self._ran[k], self._pert._draw_stack(g), base)
            ran.append(r)
            out.append(f)
        self._ran = torch.stack(ran)
        return out

    # -- stepping ---------------------------------------------------------
    def step(self) -> None:
        """Advance every member one step: the batched step, one graph replay
        on the card (on blocks, the eager batched body)."""
        sim = self.sim
        t_next = sim.time_init + (self.pcpt + 1) * sim.dt * dates.DAYS_IN_SEC
        forcing = sim.to_blocks(stack_forcings(self._member_forcings(t_next)))
        flags = sim.time_flags([sim.time_info_at(sim.time_init + self.pcpt * sim.dt * dates.DAYS_IN_SEC)])
        self.states, self.violations = self._program(self.states, forcing, flags)
        self._after_step()

    def _batched_body(self, states, forcing, flags):
        """The captured program: ``Simulator.batched_step_fn`` on the stack,
        the time flags ``flags[0]`` in ``TIME_FLAGS`` order: (states',
        violation flags)."""
        from nextsim_tpu_torch.model.simulator import TIME_FLAGS

        tinfo = {key: flags[0, j] for j, key in enumerate(TIME_FLAGS)}
        states, _diag, viol = self.sim.batched_step_fn(states, forcing, tinfo)
        return states, viol

    def step_members(self) -> None:
        """Advance every member one step, one after the other, through the
        template Simulator's ``raw_step_fn`` on the views of the stack (the
        batched step's oracle)."""
        sim = self.sim
        t_next = sim.time_init + (self.pcpt + 1) * sim.dt * dates.DAYS_IN_SEC
        forcings = self._member_forcings(t_next)
        tinfo = sim.time_info_at(sim.time_init + self.pcpt * sim.dt * dates.DAYS_IN_SEC)
        names = _fields(self.states)
        blocks = {}
        for k, forcing in enumerate(forcings):
            if id(forcing) not in blocks:  # the control's base is cut once
                blocks[id(forcing)] = sim.to_blocks(forcing)
            member = self.states.replace(**{name: getattr(self.states, name)[k] for name in names})
            out, _diag, _viol = sim.raw_step_fn(member, blocks[id(forcing)], tinfo)
            for name in names:
                getattr(self.states, name)[k].copy_(getattr(out, name))
        self._after_step()

    def _after_step(self) -> None:
        self.pcpt += 1
        if self.sim.moorings is not None:
            self._maybe_output_stats()

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step()

    # -- the whole ensemble on every rank ----------------------------------
    def _gather_members(self, ks) -> Dict[str, np.ndarray]:
        """Host copies of the global planes of members ``ks`` of every field,
        stacked in that order, on every rank (collective on a member mesh or
        a block layout)."""
        from nextsim_tpu_torch.parallel import multihost

        names = _fields(self.states)
        per = len(self.members)
        if not self.sharded:
            return {name: host_array(getattr(self.states, name)[list(ks)]) for name in names}
        parts = {}
        for g in range(self.member_mesh[0]):
            mine = [k for k in ks if k // per == g]
            if not mine:
                continue
            if g == self.group_index:
                local = {name: getattr(self.states, name)[[k - g * per for k in mine]] for name in names}
                host = self.sim.gather(local)
            else:
                host = {name: np.zeros((len(mine),) + shape, dtype)
                        for name, (shape, dtype) in self._global_planes().items()}
            if self.member_mesh[0] > 1:
                host = multihost.broadcast_host(host, src=g * self._blocks_a_group)
            for i, k in enumerate(mine):
                parts[k] = {name: host[name][i] for name in names}
        return {name: np.stack([parts[k][name] for k in ks]) for name in names}

    def _global_planes(self):
        """{field: (global shape of a member's plane, numpy dtype)}."""
        lay = None if self.sim.mesh is None else self.sim.mesh.layout
        out = {}
        for name in _fields(self.states):
            x = getattr(self.states, name)[0]
            kind = None if lay is None else lay.block_kind(x)
            shape = tuple(x.shape) if kind is None else tuple(x.shape[:-2]) + lay.global_shape(kind == "node")
            out[name] = (shape, _numpy_dtype(x.dtype))
        return out

    def _stack(self) -> State:
        """Every member's state, global planes stacked on the device: the
        stack itself on one rank, gathered from the groups otherwise."""
        if not self.sharded:
            return self.states
        host = self._gather_members(range(self.n))
        return self.states.replace(**{name: torch.as_tensor(a, device=self.sim.device,
                                                            dtype=getattr(self.states, name).dtype)
                                      for name, a in host.items()})

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

        states = self._stack()
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
        through the Moorings grid, remap, rollover and append; rank 0
        writes)."""
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

    def _noise_arrays(self) -> Dict[str, np.ndarray]:
        """The AR(1) carry (once drawn) and the generators' states of members
        1..N-1, in member order, on every rank (broadcast from the groups'
        first ranks on a member mesh)."""
        from nextsim_tpu_torch.parallel import multihost

        ran = None if self._ran is None else host_array(self._ran)
        gens = [g.get_state().numpy() for g in self.generators]
        if self.member_mesh[0] == 1:
            out = {} if ran is None else {"ran": ran}
            return dict(out, generators=np.stack(gens)) if gens else out
        per = len(self.members)
        ran_shape = (len(EnsembleForcing.FIELDS),) + tuple(self.sim.grid.shape)
        gen_len = len(member_generator(0, 1, self.sim.device).get_state())
        parts = []
        for g in range(self.member_mesh[0]):
            n_p = per - (1 if g == 0 else 0)  # the control draws no noise
            if n_p == 0:
                continue
            host = {"ran": np.zeros((n_p,) + ran_shape, _numpy_dtype(self.sim.dtype)),
                    "has_ran": np.zeros(1, np.uint8), "generators": np.zeros((n_p, gen_len), np.uint8)}
            if g == self.group_index:
                host["generators"] = np.stack(gens)
                if ran is not None:
                    host["ran"], host["has_ran"][0] = ran, 1
            parts.append(multihost.broadcast_host(host, src=g * self._blocks_a_group))
        if not parts:
            return {}
        out = {"generators": np.concatenate([q["generators"] for q in parts])}
        if all(q["has_ran"][0] for q in parts):
            out["ran"] = np.concatenate([q["ran"] for q in parts])
        return out

    def write_restart(self, name: str = "batched") -> str:
        """One checkpoint of the whole ensemble: the stacked state, the
        AR(1) carry and every member generator's state, so a resumed
        ensemble continues the same forcing-noise stream. On a member mesh
        every rank gathers, rank 0 writes the npz of global planes."""
        from nextsim_tpu_torch.output.restart import save_npz_restart
        from nextsim_tpu_torch.parallel import multihost

        fname = self._restart_file(name)
        arrays = file_arrays({f"state_{k}": v for k, v in self._gather_members(range(self.n)).items()},
                             self.sim.dtype)
        arrays.update(self._noise_arrays())
        if not multihost.is_writer():
            return fname
        os.makedirs(os.path.dirname(fname), exist_ok=True)
        meta = {"pcpt": self.pcpt, "n_members": self.n, "time_init": self.sim.time_init}
        return save_npz_restart(fname, meta, arrays)

    def read_restart(self, name: str = "batched") -> None:
        """Restore a checkpoint written by ``write_restart`` under any member
        layout: each group keeps its members, cut to its blocks."""
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
            on_dev = lambda a, dt=self.sim.dtype: host_tensor(a).to(dtype=dt, device=self.sim.device)  # noqa: E731
            kw = {}
            for f in dataclasses.fields(self.states):
                key, cur = f"state_{f.name}", getattr(self.states, f.name)
                kw[f.name] = (on_dev(data[key][self.members], cur.dtype if cur is not None else self.sim.dtype)
                              if key in data else None)
            self.states = self.sim.to_blocks(State(**kw))
            noisy = [m - 1 for m in self.members if m > 0]
            self._ran = on_dev(data["ran"][noisy]) if "ran" in data and noisy else None
            for g, st in zip(self.generators, data["generators"][noisy] if self.generators else ()):
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
        scripts/ensemble/run_ensemble.sh). On a member mesh every rank
        gathers, rank 0 writes."""
        from nextsim_tpu_torch.output.restart import restart_meta, save_npz_restart
        from nextsim_tpu_torch.parallel import multihost

        base = self.sim.cfg["output.exporter_path"]
        # the counters live on the ensemble, not the template Simulator
        meta = dict(restart_meta(self.sim), pcpt=self.pcpt, current_time=self.current_time)
        stack = self._gather_members(range(self.n))
        written = []
        for k in range(self.n):
            path = os.path.join(base, f"mem_{k}", "restart")
            fname = os.path.join(path, f"restart_{name}.npz")
            if multihost.is_writer():
                os.makedirs(path, exist_ok=True)
                fname = save_npz_restart(fname, meta, file_arrays({n: a[k] for n, a in stack.items()},
                                                                  self.sim.dtype))
            written.append(fname)
        return written

    # -- analysis ---------------------------------------------------------
    def member_state(self, k: int) -> State:
        """Member k's State (0 = control): views into the stack on one
        rank; on a member mesh its global planes on the device, on every
        rank (collective)."""
        if not self.sharded:
            return self.states.replace(**{name: getattr(self.states, name)[k] for name in _fields(self.states)})
        host = self._gather_members([k])
        return self.states.replace(**{name: torch.as_tensor(a[0], device=self.sim.device,
                                                            dtype=getattr(self.states, name).dtype)
                                      for name, a in host.items()})

    def spread(self, fields=("conc", "thick", "vt_u", "vt_v")) -> Dict[str, float]:
        """Domain-mean ensemble standard deviation per field (the usual
        spread diagnostic for perturbation sanity)."""
        states = self._stack()
        out = {}
        for name in fields:
            x = getattr(states, name)
            if x is None:
                continue
            out[name] = float(x.to(torch.float32).std(dim=0, correction=0).mean())
        return out

    def mean_state(self) -> State:
        """Ensemble-mean State (the EnKF forecast mean), global planes."""
        states = self._stack()
        return states.replace(**{
            name: getattr(states, name).mean(dim=0).to(getattr(states, name).dtype)
            for name in _fields(states)
        })


def _numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype's host copy (float32 for bfloat16)."""
    return host_array(torch.empty((), dtype=dtype)).dtype
