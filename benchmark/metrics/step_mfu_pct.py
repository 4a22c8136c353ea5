"""The whole step's share of the H100's peak: the substep loop's operations
a step (``bounds.substep_ops``: every cell and node, 120 substeps, every
member), counted from shapes alone, over the measured wall time a step of
the untraced stretch, at the peak of the state's dtype (float32: 67
TFLOP/s). The rest of the step is not counted, so this is a lower bound of
the true share."""

from benchmark import bounds


def read(ctx):
    if ctx.device != "cuda" or not ctx.steps or ctx.window_s <= 0.0:
        return None
    ny, nx = ctx.shape
    ops = bounds.substep_ops(ny, nx, ctx.substeps, ctx.dyn_type, ctx.members) * ctx.steps
    return 100.0 * ops / ctx.window_s / bounds.PEAK_OPS_PER_S[ctx.dtype]
