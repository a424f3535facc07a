"""Training samples (trajectory windows) completed in the window over its
seconds, the window closing at the end of the first step to end after
``--seconds``."""


def read(ctx):
    return sum(ctx.work) / (ctx.ends[-1] - ctx.t0)
