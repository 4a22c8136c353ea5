"""The substep kernel's share of its roofline: the least time an H100 could
take for one step's 120-substep loop of every member (``bounds.
kernel_bound_ms``, operations and bytes counted from shapes) over the
substep kernel's device time a step in the trace (kernels named
``blocked_substeps``)."""

from benchmark import bounds

KERNEL = "blocked_substeps"


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.steps:
        return None
    kernel_s = trace.device_time(KERNEL)
    if kernel_s <= 0.0:
        return None
    ny, nx = ctx.shape
    bound_ms = bounds.kernel_bound_ms(ny, nx, ctx.substeps, ctx.dtype, ctx.dyn_type, ctx.members)[0]
    return 100.0 * bound_ms * 1e-3 * trace.steps / kernel_s
