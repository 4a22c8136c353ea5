"""Device milliseconds a model step of transport and ridging: the replays'
entries in the phase ``transport`` (``transport.transport_and_ridge``;
``benchmark/phases.py``)."""

from benchmark import phases


def read(ctx):
    return phases.ms_per_step(ctx, ["transport"])
