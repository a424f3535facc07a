"""Reduction of a ``torch.profiler`` trace to what the metrics read.

The traced window runs from the start of the first ``portbench.unit`` span
to the end of the last, on the profiler's clock. The device is busy where
the union of its activity intervals (kernels, copies, fills) covers the
window; the rest is idle. Each idle gap is named by what the host was
doing at its middle: the benchmark's span around the call into a layer
(``data``, ``train_step``) and the innermost
operation the profiler recorded on that thread.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SPAN = "portbench."
COPIES = ("Memcpy", "Memset")


def short(name: str) -> str:
    """A kernel's name without return type, namespace and template
    arguments (``void ns::ffn_up_kernel<...>(...)`` -> ``ffn_up_kernel``)."""
    base = name.split("<")[0].replace("(anonymous namespace)::", "").split("(")[0].strip()
    return (base.removeprefix("void ").split("::")[-1] or name)[:60]


def union(spans):
    """Length of the union of [start, end) intervals, and its gaps."""
    spans = sorted(spans)
    if not spans:
        return 0.0, []
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, gaps


@dataclass
class Summary:
    window_s: float  # the traced window, first unit's start to last unit's end
    busy_s: float  # device activity's union within it
    kernels: dict = field(default_factory=dict)  # short name -> [seconds, launches]
    launches: int = 0  # device kernels, copies and fills left out
    idle_by_host: list = field(default_factory=list)  # [(label, seconds)], longest first

    def kernel_seconds(self, names) -> float:
        return sum(self.kernels[n][0] for n in names if n in self.kernels)

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(((k, v[0]) for k, v in self.kernels.items()), key=lambda kv: -kv[1])
        return {"device_ops": [[k, s] for k, s in ops[:n]],
                "idle_gaps": [[k, s] for k, s in self.idle_by_host[:n]]}


def summarize(prof) -> Summary | None:
    """The traced window of ``prof`` (a stopped ``torch.profiler.profile``),
    or None when the profiler saw no unit span or no device activity."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # a span of the host's (record_function) mirrored on the device's
            # timeline covers the kernels under it: not device activity
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN)):
                dev.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    units = [e for e in host if e.name == SPAN + "unit"]
    if not units or not dev:
        return None
    w0 = min(e.time_range.start for e in units)
    w1 = max(e.time_range.end for e in units)
    kernels: dict = {}
    spans = []
    launches = 0
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        spans.append((s, t))
        k = kernels.setdefault(short(e.name), [0.0, 0])
        k[0] += (t - s) / 1e6
        k[1] += 1
        launches += not e.name.startswith(COPIES)
    busy, gaps = union(spans)
    if spans:  # idle before the first and after the last activity of the window
        first, last = min(s for s, _ in spans), max(t for _, t in spans)
        gaps = [(w0, first)] * (first > w0) + gaps + [(last, w1)] * (w1 > last)
    tid = units[0].thread
    main = sorted((e for e in host if e.thread == tid),
                  key=lambda e: e.time_range.start)
    ours = [e for e in main if e.name.startswith(SPAN) and e.name != SPAN + "unit"]
    ops = [e for e in main if not e.name.startswith(SPAN)]
    starts = [e.time_range.start for e in ops]
    idle: dict = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        mid = (g0 + g1) / 2
        span = next((e.name[len(SPAN):] for e in ours
                     if e.time_range.start <= mid <= e.time_range.end), "harness")
        op, i = "python", bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if ops[j].time_range.end >= mid:
                op = short(ops[j].name)
                break
        label = f"{span}/{op}"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return Summary(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, kernels=kernels,
                   launches=launches,
                   idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]))
