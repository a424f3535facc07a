"""Device kernels a train step in the traced units (copies and fills left out)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    return ctx.trace.launches / ctx.traced_units
