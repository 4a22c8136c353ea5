"""Seconds of set-up spent in the eager warm-up call that precedes each
capture (``Captured.stats["warmup_s"]``, up to its synchronize), summed
over set-up's graphs; nothing where the program captured none or does not
time it."""


def read(ctx):
    times = [s["warmup_s"] for s in ctx.capture if "warmup_s" in s]
    return sum(times) if times else None
