"""Device kernels a model step: the kernels (not copies or memsets) in the
trace of the window's first calls, over the model steps they made."""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.steps:
        return None
    n = len(trace.kernels)
    return n / trace.steps if n else None
