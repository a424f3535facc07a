"""Host ms a step of a batch's copy to the device, ``runtime.batch_to_device``
(span ``data.to_device``), the mean over the window's untraced units
(``spans``)."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, ctx.meta["spans"])
