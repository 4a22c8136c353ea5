"""A BatchedEnsemble: ``BatchedEnsemble.step()`` a call, every member one
step, the members' noise drawn inside the graph.

The program refuses bfloat16 with more than one member, so the control is
the reference in bfloat16 put in the program's place. The check follows
each member from its own state, its noise recomputed from its AR(1) carry
and its generator's state before the step; the worst member is taken.
"""

from __future__ import annotations

import dataclasses
import time

from benchmark.drivers import DAYS_IN_SEC, Span


def steps_a_call_bound(opts: dict, traffic: dict) -> int:
    return 1


class Driver:
    def __init__(self, opts: dict, traffic: dict, device, seed: int):
        from nextsim_tpu_torch import Config
        from nextsim_tpu_torch.ensemble.batched import BatchedEnsemble

        t0 = time.perf_counter()
        self.seed = seed
        self.ens = BatchedEnsemble(Config(overrides=opts), n_members=int(traffic["members"]),
                                   seed=seed, device=device)
        self.init_s = time.perf_counter() - t0
        self.k = 1
        self.members = self.ens.n
        self.spans = {}
        self.provider = Span(self.ens.sim.forcing_provider, "forcing", self.spans)
        self.ens.sim.forcing_provider = self.provider
        self.dtype = str(self.ens.sim.dtype).removeprefix("torch.")
        self.timer = self.ens.sim.timer
        self.prev = None

    @property
    def sim(self):
        return self.ens.sim

    @property
    def shape(self):
        return self.ens.sim.grid.shape

    def seed_cohesion(self, field) -> None:
        self.ens.states.random_number.copy_(field.expand_as(self.ens.states.random_number))
        self.initial = self.ens.states

    def time_after_call(self) -> float:
        sim = self.ens.sim
        return sim.time_init + (self.ens.pcpt + 1) * sim.dt * DAYS_IN_SEC

    def call(self) -> int:
        self.prev = (self.ens.states, self.ens._ran, [g.get_state() for g in self.ens.generators],
                     self.ens.pcpt)
        self.ens.step()
        return 1

    def capture_stats(self) -> list:
        return [g.stats for g in getattr(self.ens._program, "graphs", {}).values()]

    def result(self) -> dict:
        from nextsim_tpu_torch.core.state import to_host

        states0, ran0, gens0, pcpt0 = self.prev
        return {"kind": "ensemble", "k": 1, "pcpt0": pcpt0, "state0": to_host(states0),
                "state1": to_host(self.ens.states), "forcing": to_host(self.provider.last),
                "ran0": None if ran0 is None else ran0.detach().cpu(), "generators0": gens0,
                "draw_dtype": self.ens.sim.dtype, "seed": self.seed,
                "initial": to_host(dataclasses.replace(self.initial, **{
                    f.name: getattr(self.initial, f.name)[0] for f in dataclasses.fields(self.initial)
                    if getattr(self.initial, f.name) is not None}))}


def compare(ref, got: dict, device, control: bool) -> dict:
    import torch

    from benchmark.check import host_planes, in_dtype, low_precision, reference_state
    from benchmark.reference.model import planes, relative_gaps, state_gaps

    pcpt = got["pcpt0"]
    base = ref.forcing(pcpt)
    program_forcing = planes(in_dtype(base, torch.bfloat16)) if control else host_planes(got["forcing"])
    out = {"forcing_gap": relative_gaps(program_forcing, planes(base))}
    tinfo = ref.time_info(ref.time_after(pcpt))
    engine = ref.noise(got["seed"])
    low = low_precision(ref, torch.bfloat16) if control else None
    for m in range(got["state1"].conc.shape[0]):
        forcing = base
        if m > 0:
            _, forcing = ref.perturb(engine, base, got["ran0"][m - 1].to(device), got["generators0"][m - 1],
                                     got["draw_dtype"])
        state0 = reference_state(got["state0"], device, m)
        reference = planes(ref.step(state0, forcing, tinfo))
        if control:
            program = planes(low.step(in_dtype(state0, torch.bfloat16), in_dtype(forcing, torch.bfloat16), tinfo))
        else:
            program = host_planes(got["state1"], m)
        for name, gaps in state_gaps(program, reference).items():
            out.setdefault(name, {}).update({f"member {m} {plane}": v for plane, v in gaps.items()})
    return out
