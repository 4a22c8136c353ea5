"""Host milliseconds of the forcing layer a model step: the program's Timer
node ``forcing`` where the program ticks it (a Simulator's chunk: the
provider's k calls and the inputs' gathering), else the benchmark's span
around the provider call (a batched ensemble's one call a step)."""


def read(ctx):
    seconds = ctx.timer.get("forcing") or ctx.spans.get("forcing")
    if not seconds or not ctx.steps:
        return None
    return 1e3 * seconds / ctx.steps
