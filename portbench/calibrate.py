"""Readings that the limits of ``correct`` are set from, at a cell's own
size, many seeds in one process (not run by the benchmark's own runs):

    python3 -m portbench.calibrate --workload train-4aa-b8 --seeds 1,2,3 \\
        --control_seeds 1,2,3 [--diagnose] [--out FILE]

For each seed the program's set-up runs as a run's does (the checked first
steps, then one step in place of the window) and its gaps to the float32
reference are read: the lower readings. On the control seeds the
reference in the precision one step below the configuration's
(``reference.precision.control_mode``) is read in the program's place: the
upper readings; and a planted fault, the reference given half of each
batch (the mean over the rest). ``--diagnose`` adds the leaves whose change
departs most from the reference's, program and control alike. One JSON
line a seed on standard output and in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from . import harness
    from .reference import precision as rprec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--diagnose", action="store_true",
                   help="the leaves of the worst change gaps, with their size, their share of "
                        "the median leaf's gradient and change, the first gradient's relative "
                        "error and the share of elements whose change has the other sign")
    args = p.parse_args(argv)
    harness.cache_dirs()
    import torch

    from .drivers.train import gaps

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "w") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        drv = cell.driver(cell, seed, "cuda")
        drv.trace = False
        drv.keep_tensors = args.diagnose
        rec = {"workload": args.workload, "seed": seed}
        try:
            drv.setup()
            drv.unit()  # a window of one step
            drv.memory_peak()
            drv.release()
            rec["failed"] = drv.failed
            ctrl = rprec.Precision(rprec.control_mode(drv.cfg["precision"]),
                                   low=drv.cfg["precision"] == "bf16-mixed")
            ref = drv.reference(keep=args.diagnose)
            prog = drv.readings()
            rec["program"] = gaps(prog, ref)
            med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
            rec["excluded"] = [n for n, v in ref["grad"].items() if v < 1e-3 * med]
            if args.diagnose:
                prog["grad_t"] = dict(zip(drv.names, drv.prog_grad_t))
                prog["change_t"] = dict(zip(drv.names, drv.prog_change_t))
                rec["program_leaves"] = worst_leaves(prog, ref)
            if seed in controls:
                ctl = drv.reference(ctrl, keep=args.diagnose)
                rec["control"] = gaps(ctl, ref)
                if args.diagnose:
                    rec["control_leaves"] = worst_leaves(ctl, ref)
                B = drv.traffic["batch_size"]
                if B >= 2:
                    rec["half_batch"] = gaps(drv.reference(rows=B // 2), ref)
        finally:
            drv.close()
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


def worst_leaves(side: dict, ref: dict, n: int = 6) -> list:
    """The ``n`` counted leaves whose change's norm departs most from the
    reference's (``drivers.common.leaf_gaps``), each with its number of
    elements, its gradient's and change's norms over the median leaf's in
    the reference, the ratio of the change's norms, the relative error of
    the first gradient, and the share of elements whose change has the
    other sign than the reference's."""
    import numpy as np
    import torch

    from .drivers.common import leaf_gaps

    med_g = float(np.median(list(ref["grad"].values())))
    counted = [k for k, v in ref["grad"].items() if v >= 1e-3 * med_g]
    med_c = float(np.median([ref["change"][k] for k in counted]))
    gaps = leaf_gaps(side["change"], ref["change"], counted)
    rows = []
    for k in sorted(gaps, key=lambda k: -gaps[k])[:n]:
        g, rg = side["grad_t"][k], ref["grad_t"][k]
        c, rc = side["change_t"][k], ref["change_t"][k]
        rows.append({"leaf": k, "gap": gaps[k], "numel": rg.numel(),
                     "ref_grad_over_median": ref["grad"][k] / med_g,
                     "ref_change_over_median": ref["change"][k] / med_c,
                     "change_ratio": side["change"][k] / ref["change"][k],
                     "grad_rel_err": float(torch.linalg.vector_norm(g - rg)
                                           / torch.linalg.vector_norm(rg)),
                     "sign_flips": float(((c * rc) < 0).float().mean())})
    return rows


if __name__ == "__main__":
    sys.exit(main())
