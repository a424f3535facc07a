#!/usr/bin/env python3
"""ms per train step of the 4AA recipe for several checkouts, in turns.

    python3 tools/train_step_ab.py ROOT [ROOT ...]
    python3 tools/train_step_ab.py --profile ROOT

Each ROOT is a checkout of this repository (a commit to compare with is
unpacked by `git archive` into a directory that .gitignore lists). Each runs
the training phase of its own `chip_smoke.py` (batch 8, T=1000, f32, on
synthetic data, 40 steps) in a fresh process, in the order given, so that
two trees compare on one card when listed in turns (A B B A). Each process
then runs one torch.profiler session (CPU and CUDA activity) over a few
matrix products and trains again: the second figure shows what such a
session leaves behind for the rest of the process. Prints one JSON line per
process, with the card's name and power limit. Needs a CUDA device and the
CUDA toolkit (each checkout builds its own kernels).

--profile: one checkout trains 20 steps through its own
`mdgen_tpu_torch.train --profile_steps 5`, with the recipe's argv from this
script's checkout (`chip_smoke.train_argv`, which an older checkout may
lack), and the trace of steps 10-15 is summed: device ms per step, the
device's busy share of the span from its first kernel to its last, launches
per step, and the kernels by device time, with the flash kernels' share.
"""
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 40
PROFILED_STEPS = 5


def _one(root):
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from mdgen_tpu_torch.ops import _build

    cs.TRAIN_EPOCHS = STEPS
    _, _, smi = cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    res = {"root": root, "steps": STEPS, "card": smi}
    res["ms_per_step"] = cs.phase_training(torch, smi)[1]
    x = torch.randn(1024, 1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(10):
            x = torch.tanh(x @ x)
        torch.cuda.synchronize()
    res["ms_per_step_after_profiler"] = cs.phase_training(torch, smi)[1]
    print("[train_step_ab]", json.dumps(res), flush=True)


def _profile(root):
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # imports nothing of the port until called
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from mdgen_tpu_torch import train
    from mdgen_tpu_torch.ops import _build

    _, _, smi = cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    with tempfile.TemporaryDirectory(prefix="mdgen_profile_") as work:
        train.main(cs.train_argv(work) + ["--profile_steps", str(PROFILED_STEPS)])
        with open(os.path.join(work, "run", "trace", "trace.json")) as fh:
            trace = json.load(fh)
    kernels = [e for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    per = {}
    for e in kernels:
        ms, n = per.get(cs._short(e["name"]), (0.0, 0))
        per[cs._short(e["name"])] = (ms + e["dur"] / 1e3, n + 1)
    busy, span = cs.busy_ms([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    total = sum(ms for ms, _ in per.values())
    flash = sum(ms for name, (ms, _) in per.items() if "flash_" in name)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    res = {"root": root, "card": smi, "steps": PROFILED_STEPS,
           "device_ms_per_step": total / PROFILED_STEPS,
           "launches_per_step": len(kernels) / PROFILED_STEPS,
           "busy_share_of_span": busy / span, "span_ms_per_step": span / PROFILED_STEPS,
           "flash_ms_per_step": flash / PROFILED_STEPS, "flash_share": flash / total,
           "top": [{"name": n, "ms_per_step": ms / PROFILED_STEPS, "share": ms / total,
                    "launches_per_step": c / PROFILED_STEPS} for n, (ms, c) in top]}
    print("[train_step_profile]", json.dumps(res), flush=True)


def main(argv):
    if not argv or argv[0].startswith("-") and argv[0] not in ("--one", "--profile"):
        raise SystemExit(__doc__)
    if argv[0] == "--one":  # one checkout, in this process
        return _one(os.path.abspath(argv[1]))
    if argv[0] == "--profile":
        return _profile(os.path.abspath(argv[1]))
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
