"""Model FLOPs of the traced steps (forward and backward, three forwards,
recomputation not counted, from the configuration's shapes) over the
traced seconds, as a share of the card's peak at the configuration's
precision, in %."""
from portbench import counting


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    B, T, L = ctx.driver.shapes()
    flops = counting.train_flops(ctx.cfg, B, T, L) * ctx.traced_units
    return 100.0 * flops / ctx.trace.window_s / ctx.meta["peak_flops_per_s"][ctx.cfg["precision"]]
