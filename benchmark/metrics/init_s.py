"""Seconds of the program's constructor (Simulator or BatchedEnsemble):
grid and ETOPO, the ice init and its interpolation weights, parameters,
providers and output subsystems; a span of the benchmark's own."""


def read(ctx):
    return ctx.init_s
