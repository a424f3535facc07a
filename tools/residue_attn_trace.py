#!/usr/bin/env python3
"""Which device kernels of a train step belong to its residue attention.

    python3 tools/residue_attn_trace.py [--workload train-4aa-b8] [--seed 1]
        [--steps 3] [--out build/residue_attn_trace.json]

Sets up a benchmark cell (``portbench``'s driver, its data, weights and
warm-up) with every step run eagerly (no CUDA graph, so the profiler sees
each launch under the host operation that made it), then profiles
``--steps`` steps. Every ``RoPEAttention`` call over the residue axis runs
under a ``record_function`` span, ``residue_attn.trunk`` (4-D input) or
``residue_attn.tower`` (the IPA tower's 3-D input); its two projections
(``qkv_proj``, ``out_proj``) under ``residue_attn.proj``, which is left out.
The forward's share is the device time of the kernels launched under the
span; the backward's, that of the kernels launched by the autograd nodes
whose sequence numbers the span's forward operations carry.

Prints one JSON line: per step, the device ms of every kernel (short names,
as ``portbench.trace`` shortens them) over the whole step and under each
span, forward and backward, and of the step's eight largest kernels by the
host operation that launched them (and the autograd node above it), with
the card's name and power limit; writes the same to ``--out``. Needs a
CUDA device.
"""
import argparse
import collections
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _patch(attention):
    """Wrap residue-axis calls of ``RoPEAttention.forward`` and the module's
    projections in ``record_function`` spans."""
    import torch

    rf = torch.profiler.record_function
    forward, dense = attention.RoPEAttention.forward, attention.dense

    def spanned_forward(self, x, mask=None, axis=-2, *a, **kw):
        if x.ndim == 3 or axis in (2, -2):
            with rf("residue_attn." + ("tower" if x.ndim == 3 else "trunk")):
                return forward(self, x, mask, axis, *a, **kw)
        return forward(self, x, mask, axis, *a, **kw)

    def spanned_dense(*a, **kw):
        with rf("residue_attn.proj"):
            return dense(*a, **kw)

    attention.RoPEAttention.forward = spanned_forward
    attention.dense = spanned_dense


def _subtree(e, skip=None):
    """``e`` and its host descendants, without the subtrees named ``skip``."""
    out, stack = [], [e]
    while stack:
        x = stack.pop()
        if skip is not None and x is not e and x.name == skip:
            continue
        out.append(x)
        stack.extend(x.cpu_children)
    return out


def attribute(prof, steps: int) -> dict:
    """{"total": {kernel: ms a step}, "<span>.fwd" / "<span>.bwd": {...}}."""
    from torch.autograd import DeviceType

    from portbench.trace import short

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    total = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(("portbench.", "residue")):
            if not getattr(e, "is_user_annotation", False):
                total[short(e.name)] += e.time_range.elapsed_us() / 1e3
    out = {"total": total}
    for span in ("residue_attn.trunk", "residue_attn.tower"):
        roots = [e for e in events if e.name == span]
        fwd = {id(x): x for r in roots for x in _subtree(r, skip="residue_attn.proj")}
        seq = {x.sequence_nr for x in fwd.values() if x.sequence_nr >= 0}
        bwd = {}
        for e in events:
            if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in seq:
                bwd.update((id(x), x) for x in _subtree(e))
        for part, evs in (("fwd", fwd), ("bwd", bwd)):
            c = collections.Counter()
            for x in evs.values():
                for k in x.kernels:
                    c[short(k.name)] += k.duration / 1e3
            out[f"{span}.{part}"] = c
    # who launches the step's largest kernels: the innermost host operation
    # and the autograd node above it, if any
    top = [k for k, _ in total.most_common(8)]
    origin = collections.Counter()
    for e in events:
        for k in e.kernels:
            name = short(k.name)
            if name in top:
                node, up = None, e.cpu_parent
                while up is not None and node is None:
                    if up.name.startswith("autograd::engine::evaluate_function"):
                        node = up.name.split(": ")[-1]
                    up = up.cpu_parent
                origin[f"{name} <- {e.name}" + (f" < {node}" if node else "")] += k.duration / 1e3
    out["origins"] = origin
    return {key: {k: v / steps for k, v in sorted(c.items(), key=lambda kv: -kv[1])}
            for key, c in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="train-4aa-b8")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "residue_attn_trace.json"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdgen_tpu_torch.models import attention
    from portbench import harness
    from portbench.drivers import train

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)

    class Eager(cell.driver):
        def make_runtime(self):
            rt = super().make_runtime()
            rt._graphable = lambda batch: False
            return rt

    assert issubclass(Eager, train.Driver)
    drv = Eager(cell, args.seed, "cuda")
    try:
        drv.setup()
        _patch(attention)
        drv.unit()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                drv.unit()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    finally:
        drv.close()
    res = attribute(prof, args.steps)
    sums = {k: sum(v.values()) for k, v in res.items()}
    line = {"workload": args.workload, "seed": args.seed, "steps": args.steps,
            "card": harness.power_limit(), "wall_ms_a_step_profiled": 1e3 * wall,
            "ms_a_step": sums, "kernels": {k: dict(list(v.items())[:25]) for k, v in res.items()}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(line, fh, indent=1)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
