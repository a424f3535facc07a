"""Host ms a step of the Hyena operators' forwards (span ``model.hyena``,
one a trunk layer, inside ``train.forward``), the mean over the window's
untraced units (``spans``). None on a program without the span."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, ctx.meta["spans"])
