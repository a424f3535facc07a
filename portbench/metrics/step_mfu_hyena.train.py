"""Model FLOPs of the traced steps of a Hyena trunk (forward and backward,
three forwards, recomputation not counted, ``counting_hyena.train_flops``:
``counting.py``'s count with each frame attention replaced by the Hyena
operator) over the traced seconds, as a share of the card's peak at the
configuration's precision, in %. None for a configuration without
``hyena``."""
from portbench import counting_hyena


def read(ctx):
    if ctx.trace is None or not ctx.traced_units or not ctx.cfg.get("hyena"):
        return None
    B, T, L = ctx.driver.shapes()
    flops = counting_hyena.train_flops(ctx.cfg, B, T, L) * ctx.traced_units
    return 100.0 * flops / ctx.trace.window_s / ctx.meta["peak_flops_per_s"][ctx.cfg["precision"]]
