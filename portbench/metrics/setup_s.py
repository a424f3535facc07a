"""Seconds from the start of the process to the first unit of the window:
imports, data, weights, the kernels' build on a checkout's first run, the
checked first steps and the warm-up."""


def read(ctx):
    return ctx.setup_s
