"""Host ms a step of the program's whole ``TrainRuntime.train_step`` (span
``train.step``), the mean over the window's untraced units (``spans``)."""
from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, ctx.meta["spans"])
