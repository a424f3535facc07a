"""Design evaluation: sequence recovery from the design CLI's metadata.

Port of the repository's ``scripts/analyze_peptide_design.py``:

  python -m mdgen_tpu_torch.analyze_peptide_design --pdbdir OUT

For each ``OUT/{name}_metadata.json`` (``design_inference``'s output) it
prints the recovery of the designed positions, of the conditioning
positions, of the per-position consensus over the samples (designed
positions) and of the most frequent designed middle pair, then their
means over the peptides: the original script's lines.
"""
from __future__ import annotations

import argparse
import json
import os
from collections import Counter

import numpy as np

from .tasks import COND_IDX, DESIGN_IDX


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pdbdir", type=str, required=True, help="design_inference output dir")
    p.add_argument("--pdb_id", nargs="*", default=[])
    return p.parse_args(argv)


def recoveries(meta: list) -> dict:
    """One peptide's {designed, cond, consensus, mode_pair} recovery."""
    true_seq = meta[0]["seqres"]
    preds = [m["aa_out"] for m in meta]
    cons = "".join(Counter(p[i] for p in preds).most_common(1)[0][0]
                   for i in range(len(true_seq)))
    pair = Counter("".join(p[i] for i in DESIGN_IDX) for p in preds).most_common(1)[0][0]
    truth_pair = "".join(true_seq[i] for i in DESIGN_IDX)
    return {
        "designed": np.mean([np.mean([p[i] == true_seq[i] for i in DESIGN_IDX]) for p in preds]),
        "cond": np.mean([np.mean([p[i] == true_seq[i] for i in COND_IDX]) for p in preds]),
        "consensus": np.mean([cons[i] == true_seq[i] for i in DESIGN_IDX]),
        "mode_pair": np.mean([pair[k] == truth_pair[k] for k in range(len(pair))]),
    }


def main(argv=None) -> dict:
    """Returns {"per_peptide": {name: recoveries}, and the means over the
    peptides: "designed", "cond", "consensus", "mode_pair"}."""
    args = parse_args(argv)
    names = args.pdb_id or [f.replace("_metadata.json", "") for f in os.listdir(args.pdbdir)
                            if f.endswith("_metadata.json")]
    per = {}
    for name in names:
        with open(f"{args.pdbdir}/{name}_metadata.json") as fh:
            r = per[name] = recoveries(json.load(fh))
        print(f"{name}: designed {r['designed']:.3f} cond {r['cond']:.3f} "
              f"consensus {r['consensus']:.3f} mode-pair {r['mode_pair']:.3f}")
    overall = {k: float(np.mean([r[k] for r in per.values()]))
               for k in ("designed", "cond", "consensus", "mode_pair")}
    print(f"OVERALL: designed {overall['designed']:.4f} cond {overall['cond']:.4f} "
          f"consensus {overall['consensus']:.4f} mode-pair {overall['mode_pair']:.4f}")
    return {"per_peptide": {k: {m: float(v) for m, v in r.items()} for k, r in per.items()},
            **overall}


if __name__ == "__main__":
    main()
