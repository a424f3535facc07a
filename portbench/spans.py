"""The program's own spans (``mdgen_tpu_torch.tracing``) over the window's
untraced units, for the host-time metrics.

The window's units after the traced ones run from the end of the last
traced unit (the window's start when none was traced) to the end of the
last unit; a span counts when it starts and ends inside that interval. Both
clocks are ``time.perf_counter``'s, so the spans are selected by time. These
units ran with no profiler, so their figures carry none of its overhead.
A program without the module or without such spans gives None."""
from __future__ import annotations


def host_ms(ctx, names) -> float | None:
    """Mean host ms a unit that the spans named ``names`` took, summed, over
    the window's units after the traced ones; None where none was recorded."""
    try:
        from mdgen_tpu_torch import tracing
    except ImportError:
        return None
    units = len(ctx.ends) - ctx.traced_units
    if units <= 0:
        return None
    lo = ctx.ends[ctx.traced_units - 1] if ctx.traced_units else ctx.t0
    lo_ns, hi_ns = lo * 1e9, ctx.ends[-1] * 1e9
    took = [t1 - t0 for name, _, _, _, t0, t1 in tracing.records()
            if name in names and lo_ns <= t0 and t1 <= hi_ns]
    return sum(took) / 1e6 / units if took else None
