"""The least time for the traced steps' FFT work over the device time of
the cuFFT kernels that do it (named in ``fftconv_roofline.train.json``), in
%. The work is the window's ``fftconv`` calls a step (the program's counter)
times each call's transforms, forward and backward
(``counting_hyena.fft_work``), over the traced steps. None without the
counter, without a call or when those kernels did not run."""
from portbench import counting, counting_hyena


def read(ctx):
    calls = ctx.counters.get("fftconv")
    if ctx.trace is None or not ctx.traced_units or not calls:
        return None
    spent = ctx.trace.kernel_seconds(ctx.meta["kernels"])
    if spent <= 0:
        return None
    B, T, L = ctx.driver.shapes()
    ops, nbytes = counting_hyena.fft_work(ctx.cfg, B, T, L)
    n = calls / len(ctx.ends) * ctx.traced_units
    least, _ = counting.least_seconds(ops * n, nbytes * n, ctx.meta["peak_flops_per_s"],
                                      ctx.meta["hbm_bytes_per_s"])
    return 100.0 * least / spent
