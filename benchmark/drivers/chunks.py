"""A Simulator driven in chunks: ``Simulator.step_chunk(k)`` a call.

The mix's ``chunk`` is a number of steps, or ``"clamped"``: the length
``Simulator.run`` takes for ``tpu.steps_per_call``, clamped by the program
itself to the output cadences. The check follows the call from the state
it started from, each step's forcing recomputed from the raw inputs. The
control is the reference in bfloat16 put in the program's place, over the
same call from the same state: the program's own bfloat16 path
(``tpu.dtype``) crashes in its field checks within a run's window, and a
control that crashes gives no number.
"""

from __future__ import annotations

import time

from benchmark.drivers import Span


def steps_a_call_bound(opts: dict, traffic: dict) -> int:
    chunk = traffic["chunk"]
    return int(opts["tpu.steps_per_call"]) if chunk == "clamped" else int(chunk)


class Driver:
    def __init__(self, opts: dict, traffic: dict, device, seed: int):
        from nextsim_tpu_torch import Config, Simulator

        t0 = time.perf_counter()
        self.sim = Simulator(Config(overrides=opts), device=device)
        self.init_s = time.perf_counter() - t0
        chunk = traffic["chunk"]
        self.k = self.sim._clamped_chunk(int(opts["tpu.steps_per_call"])) if chunk == "clamped" else int(chunk)
        self.members = 1
        self.spans = {}
        self.sim.forcing_provider = Span(self.sim.forcing_provider, "forcing", self.spans)
        self.dtype = str(self.sim.dtype).removeprefix("torch.")
        self.timer = self.sim.timer
        self.prev = None

    @property
    def shape(self):
        return self.sim.grid.shape

    def seed_cohesion(self, field) -> None:
        self.sim.state.random_number.copy_(field)
        self.initial = self.sim.state

    def time_after_call(self) -> float:
        return self.sim.time_after(self.k)

    def call(self) -> int:
        self.prev = (self.sim.state, self.sim.pcpt)
        self.sim.step_chunk(self.k)
        return self.k

    def capture_stats(self) -> list:
        return [g.stats for g in getattr(self.sim._program, "graphs", {}).values()]

    def result(self) -> dict:
        """The state the last call started from and its step count, the
        state after it, the last step's forcing, the initial state."""
        from nextsim_tpu_torch.core.state import to_host

        state0, pcpt0 = self.prev
        return {"kind": "chunks", "k": self.k, "pcpt0": pcpt0, "state0": to_host(state0),
                "state1": to_host(self.sim.state), "forcing": to_host(self.sim.last_forcing),
                "initial": to_host(self.initial)}


def compare(ref, got: dict, device, control: bool) -> dict:
    import torch

    from benchmark.check import host_planes, in_dtype, low_precision, reference_state
    from benchmark.reference.model import planes, relative_gaps, state_gaps

    state0 = reference_state(got["state0"], device)
    state, forcing = ref.follow(state0, got["pcpt0"], got["k"])
    if control:
        low, low_state = low_precision(ref, torch.bfloat16), in_dtype(state0, torch.bfloat16)
        for i in range(got["k"]):
            t = got["pcpt0"] + i
            low_forcing = in_dtype(ref.forcing(t), torch.bfloat16)
            low_state = low.step(low_state, low_forcing, ref.time_info(ref.time_after(t)))
        program, program_forcing = planes(low_state), planes(low_forcing)
    else:
        program, program_forcing = host_planes(got["state1"]), host_planes(got["forcing"])
    out = state_gaps(program, planes(state))
    out["forcing_gap"] = relative_gaps(program_forcing, planes(forcing))
    return out
