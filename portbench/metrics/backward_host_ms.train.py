"""Host ms a step of ``torch.autograd.grad`` and the fill of unused
gradients (span ``train.backward``), the mean over the window's untraced
units (``spans``)."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, ctx.meta["spans"])
