#!/usr/bin/env python3
"""ms per train step of the 4AA recipe for several checkouts, in turns.

    python3 tools/train_step_ab.py ROOT [ROOT ...]

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
"""
import json
import os
import subprocess
import sys

STEPS = 40


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


def main(argv):
    if not argv or argv[0].startswith("-") and argv[0] != "--one":
        raise SystemExit(__doc__)
    if argv[0] == "--one":  # one checkout, in this process
        return _one(os.path.abspath(argv[1]))
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
