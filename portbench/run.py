"""The benchmark of the PyTorch and CUDA port (``mdgen_tpu_torch``) on
NVIDIA GPUs.

    python3 -m portbench.run --workload train-4aa-b8 --seed 7 --seconds 30 --trace 0

Runs one cell of ``BENCHMARK.json`` in this process on the cards it asks
for: set-up (data, seeded weights on the device, the first steps that the
check follows, warm-up), then a window of ``--seconds`` of whole units
(train steps), then the check of the window's output
against the plain reference in ``portbench/reference/``. The last line of
standard output is the result, a JSON object; the numbers compared, each
with its limit, close standard error. ``--trace 1`` traces the first units
of the window with ``torch.profiler`` and reports the per-layer metrics
instead of the end-to-end ones.

Without a CUDA device, with fewer devices than the cell asks for, or when
the program or its files are missing, the run exits non-zero and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    from . import harness

    args = parse(argv)
    try:
        cell = harness.load_cell(args.workload)
    except (harness.Refused, OSError, KeyError, ValueError) as e:
        log(f"refused: {e}")
        return 2
    harness.cache_dirs()
    if importlib.util.find_spec("mdgen_tpu_torch") is None:
        log("refused: the program (mdgen_tpu_torch) is not beside the benchmark")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"refused: the cell needs {cell.chips} CUDA device(s), this machine has {n}")
        return 3
    log(f"{args.workload} seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"{harness.power_limit()}")
    res = harness.measure(cell, args.seed, args.seconds, bool(args.trace), T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"refused: the process holds {', '.join(found)}")
        return 4
    correct = harness.verdict(res["numbers"]) and res["failed"] == 0
    for n, v, lim in res["numbers"]:
        print(f"{n} {v!r} limit {lim!r}", file=sys.stderr)
    print(harness.result_line(res, correct), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
