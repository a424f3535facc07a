"""Host ms a step of the loss's forward: tokenization, batch prep and the
transport loss (span ``train.forward``), the mean over the window's untraced
units (``spans``)."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, ctx.meta["spans"])
