"""The least time for the traced steps' frame-attention work (forward and
backward, ``counting.flash_work``) over the device time of the kernels that
do it (named in ``flash_roofline.train.json``), in %. None when those
kernels did not run."""
from portbench import counting


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    spent = ctx.trace.kernel_seconds(ctx.meta["kernels"])
    if spent <= 0:
        return None
    B, T, L = ctx.driver.shapes()
    itemsize = 2 if ctx.cfg["precision"] == "bf16-mixed" else 4
    ops, nbytes = counting.flash_work(ctx.cfg, B, T, L, itemsize)
    least, _ = counting.least_seconds(ops * ctx.traced_units, nbytes * ctx.traced_units,
                                      ctx.meta["peak_flops_per_s"][ctx.cfg["precision"]],
                                      ctx.meta["hbm_bytes_per_s"])
    return 100.0 * least / spent
