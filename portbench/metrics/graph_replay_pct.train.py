"""Share of the window's untraced units whose step (span ``train.step``)
holds a CUDA graph's replay (span ``train.graph_replay``), in %. The units
are those ``spans.host_ms`` reads. None on a program that records neither a
replay nor a capture (``train.graph_capture``): one that has no graph."""


def read(ctx):
    try:
        from mdgen_tpu_torch import tracing
    except ImportError:
        return None
    units = len(ctx.ends) - ctx.traced_units
    if units <= 0:
        return None
    records = tracing.records()
    meta = ctx.meta
    if not any(r[0] in (meta["replay"], meta["capture"]) for r in records):
        return None
    lo = ctx.ends[ctx.traced_units - 1] if ctx.traced_units else ctx.t0
    lo_ns, hi_ns = lo * 1e9, ctx.ends[-1] * 1e9
    steps = [(t0, t1) for name, _, _, _, t0, t1 in records
             if name == meta["step"] and lo_ns <= t0 and t1 <= hi_ns]
    replays = [(t0, t1) for name, _, parent, _, t0, t1 in records
               if name == meta["replay"] and parent == meta["step"]]
    held = sum(any(s0 <= r0 and r1 <= s1 for r0, r1 in replays) for s0, s1 in steps)
    return 100.0 * held / units
