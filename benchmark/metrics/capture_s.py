"""Seconds of set-up spent capturing and instantiating the step program's
CUDA graphs: ``capture_s + instantiate_s`` of every graph set-up captured
(``Captured.stats``); nothing where the program captured none."""


def read(ctx):
    if not ctx.capture:
        return None
    return sum(s.get("capture_s", 0.0) + s.get("instantiate_s", 0.0) for s in ctx.capture)
