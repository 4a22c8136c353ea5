"""Device milliseconds a model step of the momentum solver outside the
substep kernel: the replays' entries in the phases ``momentum.setup``
(``substep_setup`` and the loop's planes) and ``momentum.smoother`` (the
open-water smoother, drag and the state update after the loop;
``benchmark/phases.py``). The substep kernel is ``substep_roofline``'s."""

from benchmark import phases


def read(ctx):
    return phases.ms_per_step(ctx, ["momentum.setup", "momentum.smoother"])
