"""The least time for the traced steps' trunk residue attention (forward
and backward, ``counting_residue.residue_attn_work``) over the device time
of the short-attention kernels that do it (named in
``residue_attn_roofline.train.json``), in %. None when those kernels did
not run."""
from portbench import counting, counting_residue


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    spent = ctx.trace.kernel_seconds(ctx.meta["kernels"])
    if spent <= 0:
        return None
    B, T, L = ctx.driver.shapes()
    itemsize = 2 if ctx.cfg["precision"] == "bf16-mixed" else 4
    ops, nbytes = counting_residue.residue_attn_work(ctx.cfg, B, T, L, itemsize)
    least, _ = counting.least_seconds(ops * ctx.traced_units, nbytes * ctx.traced_units,
                                      ctx.meta["peak_flops_per_s"], ctx.meta["hbm_bytes_per_s"])
    return 100.0 * least / spent
