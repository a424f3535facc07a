"""Host ms a step of the gradient norm, clip and Adam (span
``train.optimizer``) and the EMA (span ``train.ema``), the mean over the
window's untraced units (``spans``)."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, ctx.meta["spans"])
