"""Device milliseconds a model step of the thermodynamics: the replays'
entries that the step program's phase table puts in the phase ``thermo``
(``thermo.thermo_step``; ``benchmark/phases.py``)."""

from benchmark import phases


def read(ctx):
    return phases.ms_per_step(ctx, ["thermo"])
