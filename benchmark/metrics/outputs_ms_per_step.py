"""Host milliseconds of the run loop's outputs a model step: the program's
Timer node ``outputs`` (``Simulator._after_steps``: moorings records,
drifters, snapshots, restarts), over the untraced stretch of the window."""


def read(ctx):
    seconds = ctx.timer.get("outputs")
    if seconds is None or not ctx.steps:
        return None
    return 1e3 * seconds / ctx.steps
