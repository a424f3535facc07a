"""Summarize an upsampling acf pickle into one headline number (a copy of
the repository's ``scripts/summarize_upsampling.py``; standard library and
numpy only; ``tests/test_torch_selfcontained.py`` holds it to the original).

Input: the ``upsampling_out.pkl`` written by
``python -m mdgen_tpu_torch.analyze_upsampling --save`` (per-torsion
truth/gen/naive autocorrelation curves).

Stat: for each scored torsion, error = mean over lags 0..max_lag of
|acf_gen - acf_truth| at full frame resolution. Torsions are split by truth
lag-1 autocorrelation: ``live`` (> 0.5 — dynamics slower than the kept-frame
interval, so the interpolation task is solvable) vs ``sub_nyquist`` (<= 0.5
— faster than the kept interval; any interpolant over-smooths these).

    python -m mdgen_tpu_torch.summarize_upsampling --pkl SAMPDIR/upsampling_out.pkl
"""
import argparse
import json
import pickle

import numpy as np


def summarize(pkl_path: str, max_lag: int = 20):
    with open(pkl_path, "rb") as fh:
        results = pickle.load(fh)
    groups = {"live": [], "sub_nyquist": []}
    per_peptide = {}
    skipped_nonfinite = 0
    for name, sections in results.items():
        pep = {"live": [], "sub_nyquist": []}
        for section in ("backbone", "sidechain"):
            for key, d in sections[section].items():
                truth = np.asarray(d["truth"], np.float32)
                gen = np.asarray(d["gen"], np.float32)
                n = min(len(truth), len(gen), max_lag + 1)
                diff = np.abs(gen[:n] - truth[:n])
                finite = np.isfinite(diff)
                # frozen torsions (circular std ~0) normalize the acf by
                # 1 - baseline ~ 0 -> inf/nan lags; score the finite lags
                if not finite.any() or not np.isfinite(truth[1]):
                    skipped_nonfinite += 1
                    continue
                err = float(np.mean(diff[finite]))
                grp = "live" if truth[1] > 0.5 else "sub_nyquist"
                groups[grp].append(err)
                pep[grp].append(err)
        per_peptide[name] = {
            g: (round(float(np.mean(v)), 4) if v else None)
            for g, v in pep.items()
        }
    return {
        "max_lag": max_lag,
        "live_mean_acf_err": round(float(np.mean(groups["live"])), 4)
        if groups["live"] else None,
        "live_n": len(groups["live"]),
        "sub_nyquist_mean_acf_err":
            round(float(np.mean(groups["sub_nyquist"])), 4)
            if groups["sub_nyquist"] else None,
        "sub_nyquist_n": len(groups["sub_nyquist"]),
        "skipped_nonfinite": skipped_nonfinite,
        "per_peptide": per_peptide,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pkl", type=str, required=True)
    p.add_argument("--max_lag", type=int, default=20)
    args = p.parse_args()
    print(json.dumps(summarize(args.pkl, args.max_lag), indent=2))


if __name__ == "__main__":
    main()
