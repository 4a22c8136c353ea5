"""The device's busy share of the traced calls: the union of its activity
intervals over the host wall of those calls, synchronized at both ends."""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device or trace.wall_s <= 0.0:
        return None
    return 100.0 * trace.busy_s / trace.wall_s
