"""Dirichlet-flow temperature sweep for the design task.

The port of ``scripts/design_temp_sweep.py``. ``dirichlet_flow_temp`` is a
train-time hyperparameter used only by the Dirichlet-flow vector field at
sampling, so the sweep needs no retraining: it is overridden at inference
(``python -m mdgen_tpu_torch.design_inference --dirichlet_flow_temp T``) and
recovery is scored with the reference metric set (designed / conditioning
/ consensus / mode-pair, ``python -m mdgen_tpu_torch.analyze_peptide_design``).
The per-peptide MSM depends only on the MD data, so the first temperature's
is shared with the rest.

    python -m mdgen_tpu_torch.design_temp_sweep --ckpt workdir/quality_design \\
        --out workdir/temp_sweep --temps 1.0,0.5,0.2,0.1

Writes ``OUT/temp_sweep.json`` ({temp: {designed, cond, consensus,
mode-pair}}) and prints it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PEPTIDES = ["ACDE", "WYNK", "GSVL", "FHMT", "RQIP", "DKYA", "NEWS", "LCTV"]


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)


def overall_metrics(stdout: str) -> dict:
    """The analysis prints "OVERALL: designed X cond Y consensus Z mode-pair W"."""
    metrics = {}
    for line in stdout.splitlines():
        if line.startswith("OVERALL:"):
            toks = line.split()[1:]  # [k1, v1, k2, v2, ...]
            metrics = {toks[i]: float(toks[i + 1]) for i in range(0, len(toks), 2)}
    return metrics


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, required=True,
                   help="design run dir (config.json + step_* checkpoints)")
    p.add_argument("--out", type=str, default="workdir/temp_sweep")
    p.add_argument("--temps", type=str, default="0.2,0.5,1.0,2.0")
    p.add_argument("--md_frames", type=int, default=5000)
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--num_batches", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--tica_lag", type=int, default=100)
    p.add_argument("--msm_lag", type=int, default=10)
    p.add_argument("--rigid_data", action="store_true",
                   help="rigid-sidechain synthetic data instead of rotamer dynamics")
    p.add_argument("--data_dir", type=str, default=None,
                   help="reuse an existing dataset instead of regenerating")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    temps = [float(t) for t in args.temps.split(",")]
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)

    data_dir = os.path.abspath(args.data_dir or os.path.join(out_dir, "data"))
    split = os.path.join(data_dir, "split.csv")
    if args.data_dir and os.path.exists(split):
        print("reusing dataset:", split, flush=True)
    else:
        from .data import write_synthetic_dataset

        split = write_synthetic_dataset(data_dir, [(s, s) for s in PEPTIDES],
                                        num_frames=args.md_frames, seed=0,
                                        rotamers=not args.rigid_data)

    results = {}
    msm_dir = None  # first temp's out_dir: its MSM pickles seed the rest
    for temp in temps:
        tdir = os.path.join(out_dir, f"temp_{temp:g}")
        os.makedirs(tdir, exist_ok=True)
        if msm_dir is not None:
            for s in PEPTIDES:
                src = os.path.join(msm_dir, f"{s}_metadata.pkl")
                dst = os.path.join(tdir, f"{s}_metadata.pkl")
                if os.path.exists(src) and not os.path.exists(dst):
                    os.symlink(src, dst)
        run([
            sys.executable, "-m", "mdgen_tpu_torch.design_inference",
            "--sim_ckpt", os.path.abspath(args.ckpt),
            "--data_dir", data_dir, "--split", split,
            "--num_frames", str(args.num_frames),
            "--num_batches", str(args.num_batches),
            "--batch_size", str(args.batch_size),
            "--tica_lag", str(args.tica_lag),
            "--msm_lag", str(args.msm_lag),
            "--random_start_idx",
            "--dirichlet_flow_temp", str(temp),
            "--out_dir", tdir,
            "--device", args.device,
        ])
        msm_dir = msm_dir or tdir
        out = subprocess.run(
            [sys.executable, "-m", "mdgen_tpu_torch.analyze_peptide_design", "--pdbdir", tdir],
            check=True, cwd=REPO, capture_output=True, text=True,
        )
        print(out.stdout, flush=True)
        results[temp] = overall_metrics(out.stdout)

    with open(os.path.join(out_dir, "temp_sweep.json"), "w") as fh:
        json.dump(results, fh, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
