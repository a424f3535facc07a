"""Host ms a step that the consumer waits on the loader's queue (span
``data.wait``), the mean over the window's untraced units (``spans``)."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, ctx.meta["spans"])
